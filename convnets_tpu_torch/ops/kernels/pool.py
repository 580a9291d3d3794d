"""Pooling: the wrappers of csrc/pool.cu, their plain PyTorch versions, and
the trainable pool.

Replaces convnets_tpu/ops/pallas/pool.py:max_pool2d (:88), avg_pool2d
(:94) and pool2d_train (:100). The kernel runs one thread per output
element with the channel innermost; in max mode padding taps are -inf, in
avg mode they count as zeros (the divisor is always kh·kw) and the fp32
window sum is multiplied by fp32 1/(kh·kw) and rounded once. It is
memory-bound on the H100 (one read of x, one write of y).
"""

from __future__ import annotations

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k

PLAIN_POOLS = {"max": ops.max_pool2d, "avg": ops.avg_pool2d}


def max_pool2d_plain(x, kernel, stride=None, padding=0):
    return ops.max_pool2d(x, kernel, stride, padding)


def avg_pool2d_plain(x, kernel, stride=None, padding=0):
    return ops.avg_pool2d(x, kernel, stride, padding)


def _pool(mode: str, x, kernel, stride, padding):
    name = f"{mode}_pool2d"
    _k.check_cuda_operand(f"{name} x", x)
    n, h, w, c = x.shape
    kh, kw = to_pair(kernel)
    sh, sw = to_pair(kernel if stride is None else stride)
    ph, pw = to_pair(padding)
    oh = conv_out_size(h, kh, sh, ph)
    ow = conv_out_size(w, kw, sw, pw)
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    rc = getattr(_k.lib(), f"{mode}_pool_launch")(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow,
        kh, kw, sh, sw, ph, pw, _k.stream_ptr(x))
    _k.check_launch(name, rc)
    _k.LAUNCHES[name] += 1
    return y


def max_pool2d(x, kernel, stride=None, padding=0):
    """x (N, H, W, C) NHWC, float32 or bfloat16; torch MaxPool2d semantics."""
    if x.device.type == "cpu":
        return max_pool2d_plain(x, kernel, stride, padding)
    return _pool("max", x, kernel, stride, padding)


def avg_pool2d(x, kernel, stride=None, padding=0):
    """x (N, H, W, C) NHWC, float32 or bfloat16; torch AvgPool2d semantics
    with count_include_pad."""
    if x.device.type == "cpu":
        return avg_pool2d_plain(x, kernel, stride, padding)
    return _pool("avg", x, kernel, stride, padding)


class _Pool2dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode, kernel, stride, padding):
        ctx.save_for_backward(x)
        ctx.mode = mode
        ctx.conf = (kernel, stride, padding)
        wrapper = _k.max_pool2d if mode == "max" else _k.avg_pool2d
        return wrapper(x, kernel, stride, padding)

    @staticmethod
    def backward(ctx, g):
        # the plain pool's VJP recomputed from x, with the cotangent cast to
        # x.dtype (pool.py:111-116). Max: each window's gradient goes to its
        # first maximum in row-major order, as XLA's select-and-scatter
        # routes ties. Avg: g·1/(kh·kw) spread over each window's taps.
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            y = PLAIN_POOLS[ctx.mode](xr, *ctx.conf)
            (dx,) = torch.autograd.grad(y, xr, g.to(x.dtype))
        return dx.contiguous(), None, None, None, None


def pool2d_train(x, mode: str, kernel, stride=None, padding=0):
    """Trainable pool: forward through the max_pool2d or avg_pool2d kernel,
    backward the plain pool's VJP."""
    if mode not in PLAIN_POOLS:
        raise ValueError(f"pool2d_train mode must be 'max' or 'avg', got {mode!r}")
    return _Pool2dTrain.apply(x, mode, kernel, stride, padding)
