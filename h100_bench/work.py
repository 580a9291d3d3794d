"""The work of a configuration, from its widths alone: every conv's shape,
its operations and bytes, the forward's FLOPs and each conv's roofline
bound on one H100. Nothing here asks the program how it computes.

A multiply and an add count as two operations. A conv's bytes are its
input read once, its weight read once and its output written once, each
in the compute dtype (bf16: 2 bytes a value).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def load_peaks(path: str = os.path.join(HERE, "peaks.json")) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Conv:
    """One conv site: (h, w) its input size, cin -> cout, a k x k window at
    `stride` and `padding`, in `groups` groups."""
    name: str
    h: int
    w: int
    cin: int
    cout: int
    k: int
    stride: int
    padding: int
    groups: int = 1

    @property
    def out_hw(self):
        oh = (self.h + 2 * self.padding - self.k) // self.stride + 1
        ow = (self.w + 2 * self.padding - self.k) // self.stride + 1
        return oh, ow

    def flops(self, batch: int) -> float:
        oh, ow = self.out_hw
        return 2.0 * batch * oh * ow * self.cout * (self.cin // self.groups) * self.k * self.k

    def bytes(self, batch: int, itemsize: int = 2) -> float:
        oh, ow = self.out_hw
        x = batch * self.h * self.w * self.cin
        wt = self.k * self.k * (self.cin // self.groups) * self.cout
        y = batch * oh * ow * self.cout
        return float(itemsize * (x + wt + y))

    def bound_s(self, batch: int, peaks: dict, itemsize: int = 2) -> float:
        """The conv's time at the card's peak: the larger of its bytes over
        the memory bandwidth and its operations over the bf16 tensor rate."""
        return max(self.bytes(batch, itemsize) / peaks["hbm_bytes_per_s"],
                   self.flops(batch) / peaks["bf16_flops_per_s"])


def block_plan(cfg: dict) -> List[dict]:
    """The bottleneck blocks in order: (inner width, stride, input channels,
    output channels, whether a projection shortcut is there)."""
    blocks, cin = [], cfg["stem"]["out"]
    for width, repeats, stride in cfg["stages"]:
        cout = width * cfg["expansion"]
        for r in range(repeats):
            s = stride if r == 0 else 1
            blocks.append({"width": width, "stride": s, "cin": cin, "cout": cout,
                           "project": s != 1 or cin != cout})
            cin = cout
    return blocks


def convs(cfg: dict) -> List[Conv]:
    """Every conv of the forward, in the order it runs: the stem, then per
    block its three body convs and its projection shortcut."""
    c, h, w = cfg["input_size"]
    st = cfg["stem"]
    out: List[Conv] = [Conv("stem", h, w, c, st["out"], st["kernel"], st["stride"],
                            st["padding"])]
    oh, ow = out[0].out_hw
    p = st["pool"]
    h = (oh + 2 * p["padding"] - p["kernel"]) // p["stride"] + 1
    w = (ow + 2 * p["padding"] - p["kernel"]) // p["stride"] + 1
    for i, b in enumerate(block_plan(cfg)):
        s = b["stride"]
        out.append(Conv(f"b{i}.c1", h, w, b["cin"], b["width"], 1, 1, 0))
        out.append(Conv(f"b{i}.c2", h, w, b["width"], b["width"], 3, s, 1, cfg["groups"]))
        h2, w2 = out[-1].out_hw
        out.append(Conv(f"b{i}.c3", h2, w2, b["width"], b["cout"], 1, 1, 0))
        if b["project"]:
            out.append(Conv(f"b{i}.sc", h, w, b["cin"], b["cout"], 1, s, 0))
        h, w = h2, w2
    return out


def head_features(cfg: dict) -> int:
    """The linear head's input width: the last stage's channels after a
    global pool, or the whole last map when the head flattens it."""
    last = convs(cfg)[-1]
    oh, ow = last.out_hw
    return last.cout if cfg["head"] == "global_avg_pool" else oh * ow * last.cout


def conv_flops_per_image(cfg: dict) -> float:
    return sum(c.flops(1) for c in convs(cfg))


def head_flops_per_image(cfg: dict) -> float:
    return 2.0 * head_features(cfg) * cfg["num_classes"]


def forward_flops_per_image(cfg: dict) -> float:
    """The forward's operations per image: the convs and the linear head
    (pools, BN and activations are left out, as is usual)."""
    return conv_flops_per_image(cfg) + head_flops_per_image(cfg)


def train_flops_per_image(cfg: dict) -> float:
    """A train step's operations per image: the forward and a backward of
    twice its work, with no recompute."""
    return 3.0 * forward_flops_per_image(cfg)


def conv_bounds_s(cfg: dict, batch: int, peaks: dict) -> Dict[str, float]:
    """Each conv's roofline bound in seconds at `batch`, in bf16."""
    return {c.name: c.bound_s(batch, peaks) for c in convs(cfg)}
