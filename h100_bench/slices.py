"""A profiled slice of a run, reduced to plain lists: the device's kernels
and copies, with their start and end on one clock, and the host's ranges.
The per-layer readers (layer_metrics/) and the breakdown read only this.

`Slice` is what the readers get:
  device: [(name, start_us, end_us, kind)] kind "kernel", "memcpy" or
          "memset", sorted by start;
  host: [(name, start_us, end_us)] the host's operations and the
        benchmark's own ranges;
  window_us, start_us: the slice (between its two marks) on the same clock;
  steps, images: the train steps or requests in the slice, and their
        images.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# the benchmark's own host ranges (host_range, Profiled's marks)
LABELS = {"train_epoch", "serve_request", "bench_slice_start", "bench_slice_end"}


@dataclass
class Slice:
    device: List[Tuple[str, float, float, str]]
    host: List[Tuple[str, float, float]]
    window_us: float
    steps: int
    images: int
    start_us: float = 0.0


def kind_of(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_intervals(sl: Slice):
    """The device's busy spans (kernels and copies) clipped to the slice."""
    lo, hi = sl.start_us, sl.start_us + sl.window_us
    return [(max(s, lo), min(e, hi)) for _, s, e, _ in sl.device if e > lo and s < hi]


def gaps(sl: Slice) -> List[Tuple[float, float]]:
    """The idle spans between the device's busy spans inside the slice."""
    out, cursor = [], sl.start_us
    for s, e in sorted(busy_intervals(sl)):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    end = sl.start_us + sl.window_us
    if end > cursor:
        out.append((cursor, end))
    return out


def host_labels(sl: Slice, spans: List[Tuple[float, float]]) -> List[str]:
    """What the host was doing in each span: the shortest host range that
    covers the span's middle, or "none"."""
    if not sl.host:
        return ["none"] * len(spans)
    starts = np.array([h[1] for h in sl.host])
    ends = np.array([h[2] for h in sl.host])
    lengths = ends - starts
    out = []
    for s, e in spans:
        mid = 0.5 * (s + e)
        inside = np.flatnonzero((starts <= mid) & (ends > mid))
        out.append(sl.host[inside[np.argmin(lengths[inside])]][0] if len(inside) else "none")
    return out


def breakdown(sl: Slice, top: int = 10, labelled: int = 1000) -> dict:
    """The device operations that took most time, and the idle time of the
    `labelled` longest gaps summed by what the host was doing, in seconds
    over the slice."""
    per_name: Dict[str, float] = {}
    for name, s, e, _ in sl.device:
        per_name[name] = per_name.get(name, 0.0) + (e - s)
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(sl), key=lambda g: g[0] - g[1])[:labelled]
    per_gap: Dict[str, float] = {}
    for (s, e), label in zip(longest, host_labels(sl, longest)):
        per_gap[label] = per_gap.get(label, 0.0) + (e - s)
    idle = sorted(per_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[short_name(n), v / 1e6] for n, v in ops],
            "idle_gaps": [[short_name(n), v / 1e6] for n, v in idle]}


def short_name(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def load_group(group: str, root: str = os.path.join(HERE, "kernel_groups")):
    """A kernel group: the union of the regular expressions in every file of
    kernel_groups/<group>/ (one per line; '#' starts a comment)."""
    patterns = []
    for path in sorted(glob.glob(os.path.join(root, group, "*.txt"))):
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    patterns.append(line)
    if not patterns:
        raise FileNotFoundError(f"kernel group {group!r} has no patterns under {root}")
    return re.compile("|".join(f"(?:{p})" for p in patterns))


def in_group(name: str, group) -> bool:
    return group.search(name) is not None


@contextlib.contextmanager
def host_range(label: str):
    """A named range on the host, which the profiler records when it runs
    (and which costs nothing otherwise)."""
    from torch.profiler import record_function
    with record_function(label):
        yield


class Profiled:
    """torch.profiler (CPU and CUDA) over a stretch of a run; `reduce`
    turns it into a Slice."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self.prof.__enter__()
        return self

    def mark_start(self):
        self._mark("bench_slice_start")

    def mark_end(self):
        import torch
        torch.cuda.synchronize()
        self._mark("bench_slice_end")

    def _mark(self, label):
        from torch.profiler import record_function
        with record_function(label):
            pass

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def reduce(self, steps: int, images: int) -> Slice:
        from torch.autograd import DeviceType
        device, host, marks = [], [], {}
        for e in self.prof.events():
            s, t = float(e.time_range.start), float(e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                # a range named on the host shows on the device's timeline
                # too, as an annotation over the work it spans: no work
                if not getattr(e, "is_user_annotation", False) and e.name not in LABELS:
                    device.append((e.name, s, t, kind_of(e.name)))
            else:
                if e.name in ("bench_slice_start", "bench_slice_end"):
                    marks[e.name] = s
                host.append((e.name, s, t))
        device.sort(key=lambda d: d[1])
        start = marks.get("bench_slice_start", min((d[1] for d in device), default=0.0))
        end = marks.get("bench_slice_end", max((d[2] for d in device), default=start))
        inside = [d for d in device if d[2] > start and d[1] < end]
        return Slice(device=inside, host=host, window_us=end - start, steps=steps,
                     images=images, start_us=start)
