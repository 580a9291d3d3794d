"""The arithmetic the per-layer readers share. Each reader in
layer_metrics/ is one call of these on a Slice (slices.py) and the cell's
context; each returns None where the slice holds nothing to read.
"""

from __future__ import annotations

from typing import Optional

import slices as tr
import work


def idle_share_pct(sl: tr.Slice) -> Optional[float]:
    """100 x (1 - the union of the device's busy spans / the slice)."""
    if sl.window_us <= 0 or not sl.device:
        return None
    return 100.0 * (1.0 - tr.union_us(tr.busy_intervals(sl)) / sl.window_us)


def mfu_pct(sl: tr.Slice, flops_per_image: float, peaks: dict) -> Optional[float]:
    """100 x the slice's images x their operations / (its length x the bf16
    peak)."""
    if sl.window_us <= 0 or sl.images <= 0:
        return None
    return 100.0 * sl.images * flops_per_image / (sl.window_us * 1e-6 * peaks["bf16_flops_per_s"])


def kernels(sl: tr.Slice):
    return [d for d in sl.device if d[3] == "kernel"]


def group_us(sl: tr.Slice, group: str) -> float:
    g = tr.load_group(group)
    return sum(e - s for name, s, e, _ in kernels(sl) if tr.in_group(name, g))


def conv_us(sl: tr.Slice, with_reductions: bool) -> float:
    """Device time of the port's conv kernels and, with_reductions, of each
    statistics reduction that directly follows one of them."""
    conv, red = tr.load_group("port_conv"), tr.load_group("port_conv_reduce")
    total, prev = 0.0, None
    for name, s, e, _ in kernels(sl):
        if tr.in_group(name, conv):
            total += e - s
        elif with_reductions and tr.in_group(name, red) and prev is not None \
                and tr.in_group(prev, conv):
            total += e - s
        prev = name
    return total


def conv_roofline_pct(sl: tr.Slice, cfg: dict, batch: int, peaks: dict,
                      with_reductions: bool) -> Optional[float]:
    """100 x the sum of the forward convs' bounds over the slice's steps /
    the device time of the port's conv kernels (and their reductions)."""
    measured = conv_us(sl, with_reductions)
    if measured <= 0 or sl.steps <= 0:
        return None
    bound_us = sl.steps * 1e6 * sum(work.conv_bounds_s(cfg, batch, peaks).values())
    return 100.0 * bound_us / measured


def eager_ms_per_step(sl: tr.Slice) -> Optional[float]:
    """Device ms per step in kernels that are neither the port's nor
    cuDNN's or cuBLAS's."""
    if sl.steps <= 0 or not sl.device:
        return None
    port, lib = tr.load_group("port"), tr.load_group("library")
    us = sum(e - s for name, s, e, _ in kernels(sl)
             if not tr.in_group(name, port) and not tr.in_group(name, lib))
    return us / 1e3 / sl.steps


def library_ms_per_step(sl: tr.Slice) -> Optional[float]:
    if sl.steps <= 0:
        return None
    us = group_us(sl, "library")
    return us / 1e3 / sl.steps if us > 0 else None


def kernels_per_step(sl: tr.Slice) -> Optional[float]:
    if sl.steps <= 0 or not sl.device:
        return None
    return len(kernels(sl)) / sl.steps


def h2d_ms_per_request(sl: tr.Slice) -> Optional[float]:
    if sl.steps <= 0:
        return None
    us = sum(e - s for name, s, e, kind in sl.device
             if kind == "memcpy" and "htod" in name.lower().replace(" ", ""))
    return us / 1e3 / sl.steps if us > 0 else None
