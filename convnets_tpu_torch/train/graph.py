"""StepGraph: one train or eval step captured as a CUDA graph over static
device buffers and replayed once per batch (the port's counterpart of the
JAX engine's whole-epoch `lax.scan`, convnets_tpu/train/engine.py:350-451).

The static inputs are the split on the device (a `DeviceCacheLoader`'s
resident arrays, or a `ShardRotationLoader`'s chunk buffer), the epoch's
(rows, batch) index and weight matrices, which `run` refills with one copy
each, and a device step counter that the step advances itself. The step
gathers its batch at the counter's row, runs the step body, and writes its
loss and correct count (and, for an eval step that collects them, its
predictions) at that row of static output buffers, which the caller reads
back once per epoch.

On the card the first WARMUP_STEPS steps run eagerly on the capture stream
(they are the epoch's real first steps, so they change nothing in the
trajectory); the next step is captured, which executes nothing, and then
replayed as that step; every later step is one replay. Before each step
the host runs the prologue: it reseeds the step's generators
(`StepGenerators`, registered with the graph) and fills the per-step
scalars (`StepScalars`). A capture that fails raises, naming the step;
nothing falls back to eager steps. The kernel wrappers count their
launches when they are called, so once during the capture: that delta is
taken off the counters and added again at every replay, so that
`LAUNCHES` / `ROUTE_LAUNCHES` count the kernels that ran.

On the CPU there is no graph: the same step runs eagerly, step by step,
over the same static buffers.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from convnets_tpu_torch.ops import kernels

# eager steps on the capture stream before the capture: the first call of
# each kernel sets its shared-memory opt-in, cuBLAS and cuDNN make their
# handles and workspaces for the stream
WARMUP_STEPS = 2


def _launch_counts():
    return dict(kernels.LAUNCHES), {k: dict(v) for k, v in kernels.ROUTE_LAUNCHES.items()}


def _add_launches(delta, sign: int = 1) -> None:
    counts, routes = delta
    for name, n in counts.items():
        kernels.LAUNCHES[name] += sign * n
    for name, per_route in routes.items():
        for route, n in per_route.items():
            kernels.ROUTE_LAUNCHES[name][route] += sign * n


def _put(dst: torch.Tensor, a: np.ndarray) -> None:
    """One host-to-device copy of `a` into `dst` (from pinned memory on the
    card, so the host does not wait for the device)."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class StepGraph:
    """A step over static buffers, captured once on the card and replayed.

    kind: "train" or "eval" (named in errors); body(x, y, w) -> outputs, the
    step's device work: the loss and correct count (0-d) and, with
    `preds`, the predictions (batch,); data, labels: the split on the
    device the body gathers from; rows, batch: the index matrix's shape;
    prologue(epoch, step): the host's work before each step (the body
    changes nothing on the host: a replay does not run it); generators:
    the StepGenerators the body draws from (registered before the
    capture); on_capture: called before the capture (the Trainer waits for
    its checkpoint writer there: no other thread may call CUDA during a
    capture), after which dead Python cycles are collected and the
    collector is held off until the capture ends, so that no earlier graph
    is freed during it; capture_error_mode:
    torch.cuda.graph's, "thread_local" for a step with NCCL collectives,
    whose process group's watchdog thread queries events during the
    capture."""

    def __init__(self, kind: str, body: Callable, data: torch.Tensor, labels: torch.Tensor,
                 rows: int, batch: int, *, preds: bool = False,
                 prologue: Optional[Callable[[int, int], None]] = None,
                 generators=None, on_capture: Optional[Callable[[], None]] = None,
                 capture_error_mode: str = "global"):
        dev = data.device
        self.capture_error_mode = capture_error_mode
        self.kind, self.body, self.data, self.labels = kind, body, data, labels
        self.prologue, self.generators, self.on_capture = prologue, generators, on_capture
        self.idx = torch.zeros((rows, batch), dtype=torch.int32, device=dev)
        self.w = torch.zeros((rows, batch), dtype=torch.float32, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.outputs = [torch.zeros(rows, dtype=torch.float32, device=dev),
                        torch.zeros(rows, dtype=torch.float32, device=dev)]
        if preds:
            self.outputs.append(torch.zeros((rows, batch), dtype=torch.int64, device=dev))
        self.cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.graph = None
        self.eager_steps = 0
        self.per_replay = None  # the launches of one step, counted at the capture
        self.capture_s = None  # host seconds the capture took

    def _device_step(self) -> None:
        i = self.counter
        idx = self.idx.index_select(0, i).view(-1).long()
        w = self.w.index_select(0, i).view(-1)
        outs = self.body(self.data.index_select(0, idx), self.labels.index_select(0, idx), w)
        for buf, v in zip(self.outputs, outs):
            buf.index_copy_(0, i, v.reshape(1, *buf.shape[1:]).to(buf.dtype))
        self.counter.add_(1)

    def _capture(self) -> None:
        if self.on_capture is not None:
            self.on_capture()
        # a dead reference cycle that holds an earlier CUDA graph is freed
        # now, and the collector is held off until the capture ends: freeing
        # a graph and its memory pool in the capturing thread invalidates
        # the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        if self.generators is not None:
            self.generators.register(graph)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode=self.capture_error_mode):
                self._device_step()
        except Exception as e:
            raise RuntimeError(f"capturing the {self.kind} step as a CUDA graph failed: "
                               f"{e}") from e
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        after = _launch_counts()
        self.per_replay = ({k: after[0][k] - before[0][k] for k in after[0]},
                           {k: {r: after[1][k][r] - before[1][k][r] for r in after[1][k]}
                            for k in after[1]})
        _add_launches(self.per_replay, -1)
        self.graph = graph

    def step(self, epoch: int, index: int) -> None:
        """Step `index` of global epoch `epoch`: the prologue, then the step
        (eager, or captured and replayed, or replayed)."""
        if self.prologue is not None:
            self.prologue(epoch, index)
        if not self.cuda:
            self._device_step()
        elif self.graph is None and self.eager_steps < WARMUP_STEPS:
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                self._device_step()
            torch.cuda.current_stream().wait_stream(self.stream)
            self.eager_steps += 1
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            _add_launches(self.per_replay)

    def run(self, idx_mat: np.ndarray, w_mat: np.ndarray, epoch: int, first: int = 0,
            steps: Optional[int] = None) -> Sequence[torch.Tensor]:
        """Load the (rows, batch) index and weight matrices, run the first
        `steps` rows (all by default) as steps first, first + 1, ... of
        `epoch`, and return the output buffers' first `steps` rows (views:
        the next run overwrites them)."""
        _put(self.idx, idx_mat)
        _put(self.w, w_mat)
        self.counter.zero_()
        steps = len(idx_mat) if steps is None else int(steps)
        for s in range(steps):
            self.step(epoch, first + s)
        return [o[:steps] for o in self.outputs]
