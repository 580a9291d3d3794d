"""Pooling: the wrappers of csrc/pool.cu, their plain PyTorch versions, the
plan that picks their route, and the trainable pool.

Replaces convnets_tpu/ops/pallas/pool.py:max_pool2d (:88), avg_pool2d
(:94) and pool2d_train (:100). In max mode padding taps are -inf and the
window's first maximum in row-major order wins; in avg mode they count as
zeros (the divisor is always kh·kw) and the fp32 window sum is multiplied
by fp32 1/(kh·kw) and rounded once. The kernels are memory-bound on the
H100 (one read of x, one write of y). `pool_plan` picks the route by
shape: "vector" (C % 8 == 0: 8 channels per thread in 16-byte loads, a
strip of outputs along W where windows overlap) or "loop" (one thread per
element).

`pool2d_train` saves no x: its max forward also writes the uint8 tap of
each window's first maximum (the routing of XLA's select-and-scatter), and
its backward is a kernel of its own (`pool2d_backward`) that gathers dx
from g and those taps (avg: from g alone), in fp32, rounded once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k

PLAIN_POOLS = {"max": ops.max_pool2d, "avg": ops.avg_pool2d}
_ROUTES = {"loop": 0, "vector": 1}
_MODES = {"max": 0, "avg": 1}


class WindowPlan(NamedTuple):
    """How a depthwise or pool kernel call runs. route: "vector" (8
    channels per thread, 16-byte vectors) or "loop" (one thread per
    element). A vector tile is `th` output rows × `tw` columns × `cb`
    channels, each thread's block `ry` rows × `r` columns of it: a CTA's
    tile for the depthwise conv, one thread's strip (1 × r × 8) for the
    pools."""

    route: str
    cb: int = 1
    th: int = 1
    tw: int = 1
    r: int = 1
    ry: int = 1

    def args(self):
        """The plan as the depthwise entry point takes it: route, cb, th,
        tw, r, ry."""
        return _ROUTES[self.route], self.cb, self.th, self.tw, self.r, self.ry


def _check_dtype(name, dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")


def pool_plan(n, h, w, c, kh, kw, stride, padding, dtype, aligned: bool = True) -> WindowPlan:
    """The plan of a pool (forward or backward) over NHWC (n, h, w, c) in
    `dtype`: the vector route iff C % 8 == 0 and the operands are 16-byte
    aligned (`aligned`), each thread 8 channels of a strip of 2 outputs
    along W where windows overlap (kw > stride), else of 1; the loop
    otherwise."""
    _check_dtype("pool_plan", dtype)
    _, sw = to_pair(stride)
    if c % 8 or not aligned:
        return WindowPlan("loop")
    r = 2 if kw > sw else 1
    return WindowPlan("vector", 8, 1, r, r)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _geometry(x, kernel, stride, padding):
    n, h, w, c = x.shape
    kh, kw = to_pair(kernel)
    sh, sw = to_pair(kernel if stride is None else stride)
    ph, pw = to_pair(padding)
    if kh * kw > 255:
        raise ValueError(f"pool: a {kh}x{kw} window has more taps than a uint8 holds")
    return n, h, w, c, conv_out_size(h, kh, sh, ph), conv_out_size(w, kw, sw, pw), kh, kw, sh, \
        sw, ph, pw


def max_pool2d_plain(x, kernel, stride=None, padding=0, taps=False):
    """The plain max pool; with `taps`, (y, taps): per output element the
    uint8 row-major tap ky·kw + kx of its window's first maximum (padding
    taps never win), found tap by tap, the last tap first, so that the
    first match is kept."""
    y = ops.max_pool2d(x, kernel, stride, padding)
    if not taps:
        return y
    n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw = _geometry(x, kernel, stride, padding)
    xp = torch.nn.functional.pad(x, (0, 0, pw, pw, ph, ph), value=float("-inf"))
    inside = torch.zeros(1, h + 2 * ph, w + 2 * pw, 1, dtype=torch.bool, device=x.device)
    inside[:, ph:ph + h, pw:pw + w] = True
    first = torch.zeros(y.shape, dtype=torch.uint8, device=x.device)
    for t in reversed(range(kh * kw)):
        ky, kx = divmod(t, kw)
        win = (slice(None), slice(ky, ky + sh * (oh - 1) + 1, sh),
               slice(kx, kx + sw * (ow - 1) + 1, sw))
        first = torch.where((xp[win] == y) & inside[win], t, first)
    return y, first


def avg_pool2d_plain(x, kernel, stride=None, padding=0):
    return ops.avg_pool2d(x, kernel, stride, padding)


def _forward(mode, x, kernel, stride, padding, with_taps=False, route=None):
    """Launch the max or avg pool kernel; (y, taps or None). `route` forces
    one (the on-card comparison of the two routes)."""
    name = f"{mode}_pool2d"
    _k.check_cuda_operand(f"{name} x", x)
    n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw = _geometry(x, kernel, stride, padding)
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    taps = torch.empty(y.shape, dtype=torch.uint8, device=x.device) if with_taps else None
    plan = WindowPlan("loop") if route == "loop" else pool_plan(
        n, h, w, c, kh, kw, (sh, sw), (ph, pw), x.dtype, route == "vector" or _aligned(x, y))
    geo = (n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, _ROUTES[plan.route], plan.r,
           _k.stream_ptr(x))
    lib = _k.lib()
    if mode == "max":
        rc = lib.max_pool_launch(_k.DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
                                 None if taps is None else taps.data_ptr(), *geo)
    else:
        rc = lib.avg_pool_launch(_k.DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), *geo)
    _k.check_launch(name, rc)
    _k.count_launch(name, plan.route)
    return y, taps


def max_pool2d(x, kernel, stride=None, padding=0, taps=False):
    """x (N, H, W, C) NHWC, float32 or bfloat16; torch MaxPool2d semantics.
    With `taps`, (y, taps): the same launch also writes the uint8 tap of
    each window's first maximum (pool2d_train's forward)."""
    if x.device.type == "cpu":
        return max_pool2d_plain(x, kernel, stride, padding, taps)
    y, first = _forward("max", x, kernel, stride, padding, with_taps=taps)
    return (y, first) if taps else y


def avg_pool2d(x, kernel, stride=None, padding=0):
    """x (N, H, W, C) NHWC, float32 or bfloat16; torch AvgPool2d semantics
    with count_include_pad."""
    if x.device.type == "cpu":
        return avg_pool2d_plain(x, kernel, stride, padding)
    return _forward("avg", x, kernel, stride, padding)[0]


def pool2d_backward_plain(mode, g, taps, in_hw, dtype, kernel, stride=None, padding=0):
    """dx (N, H, W, C) in `dtype` of the max pool (from its taps) or the
    avg pool (from g alone), with g cast to `dtype` first (pool.py:116).
    Tap by tap in row-major order, each window's share is added to an fp32
    sum over the padded input (max: g where the tap is the window's; avg:
    g·fp32 1/(kh·kw), the product rounded first), then cropped and rounded
    once."""
    n, oh, ow, c = g.shape
    h, w = in_hw
    kh, kw = to_pair(kernel)
    sh, sw = to_pair(kernel if stride is None else stride)
    ph, pw = to_pair(padding)
    gf = g.to(dtype).float()
    if mode == "avg":
        gf = gf * np.float32(1.0 / (kh * kw))
    dxp = torch.zeros(n, h + 2 * ph, w + 2 * pw, c, dtype=torch.float32, device=g.device)
    for t in range(kh * kw):
        ky, kx = divmod(t, kw)
        win = (slice(None), slice(ky, ky + sh * (oh - 1) + 1, sh),
               slice(kx, kx + sw * (ow - 1) + 1, sw))
        dxp[win] += gf if mode == "avg" else torch.where(taps == t, gf, 0.0)
    return dxp[:, ph:ph + h, pw:pw + w].to(dtype).contiguous()


def pool2d_backward(mode, g, taps, in_hw, dtype, kernel, stride=None, padding=0, route=None):
    """The pool's VJP as a kernel (csrc/pool.cu pool_bwd_kernel): dx in gather
    form from g and, for max, the taps of max_pool2d(..., taps=True). `route` forces
    one (the on-card comparison of the two routes)."""
    if g.device.type == "cpu":
        return pool2d_backward_plain(mode, g, taps, in_hw, dtype, kernel, stride, padding)
    g = g.to(dtype).contiguous()
    _k.check_cuda_operand("pool2d_backward g", g)
    if mode == "max":
        _k.check_cuda_operand("pool2d_backward taps", taps, torch.uint8)
        if taps.shape != g.shape:
            raise ValueError(f"pool2d_backward: taps {tuple(taps.shape)} != g {tuple(g.shape)}")
    n, oh, ow, c = g.shape
    h, w = in_hw
    kh, kw = to_pair(kernel)
    sh, sw = to_pair(kernel if stride is None else stride)
    ph, pw = to_pair(padding)
    if (conv_out_size(h, kh, sh, ph), conv_out_size(w, kw, sw, pw)) != (oh, ow) or kh * kw > 255:
        raise ValueError(f"pool2d_backward: g {tuple(g.shape)} is not the output of a "
                         f"{kh}x{kw}/{sh} p{ph} pool over {h}x{w}")
    dx = torch.empty((n, h, w, c), dtype=dtype, device=g.device)
    plan = WindowPlan(route) if route is not None else pool_plan(
        n, h, w, c, kh, kw, (sh, sw), (ph, pw), dtype,
        _aligned(g, dx) and (taps is None or taps.data_ptr() % 8 == 0))
    rc = _k.lib().pool_backward_launch(
        _k.DTYPE_CODES[dtype], _MODES[mode], g.data_ptr(),
        None if mode == "avg" else taps.data_ptr(), dx.data_ptr(), n, h, w, c, oh, ow, kh, kw,
        sh, sw, ph, pw, _ROUTES[plan.route], _k.stream_ptr(g))
    _k.check_launch("pool2d_backward", rc)
    _k.count_launch("pool2d_backward", plan.route)
    return dx


class _Pool2dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode, kernel, stride, padding):
        ctx.mode = mode
        ctx.conf = (kernel, stride, padding)
        ctx.input = (tuple(x.shape[1:3]), x.dtype)
        if mode == "avg":
            return _k.avg_pool2d(x, kernel, stride, padding)
        y, taps = _k.max_pool2d(x, kernel, stride, padding, taps=True)
        ctx.save_for_backward(taps)
        return y

    @staticmethod
    def backward(ctx, g):
        # the VJP of pool.py:111-116 from what the forward kept: max routes
        # each window's g to its first maximum (XLA's select-and-scatter),
        # avg spreads g·1/(kh·kw) over each window's taps
        taps = ctx.saved_tensors[0] if ctx.mode == "max" else None
        dx = _k.pool2d_backward(ctx.mode, g, taps, *ctx.input, *ctx.conf)
        return dx, None, None, None, None


def pool2d_train(x, mode: str, kernel, stride=None, padding=0):
    """Trainable pool: forward through the max pool kernel (which also
    writes the taps) or the avg pool kernel, backward the pool2d_backward
    kernel; x is not kept."""
    if mode not in PLAIN_POOLS:
        raise ValueError(f"pool2d_train mode must be 'max' or 'avg', got {mode!r}")
    return _Pool2dTrain.apply(x, mode, kernel, stride, padding)
