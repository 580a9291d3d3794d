"""Max pool: the wrapper of csrc/pool.cu, its plain PyTorch version, and
the trainable pool.

Replaces convnets_tpu/ops/pallas/pool.py:max_pool2d (:88) and, in max
mode, pool2d_train (:100). The kernel runs one thread per output element
with the channel innermost; padding taps are -inf. It is memory-bound on
the H100 (one read of x, one write of y).
"""

from __future__ import annotations

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k


def max_pool2d_plain(x, kernel, stride=None, padding=0):
    return ops.max_pool2d(x, kernel, stride, padding)


def max_pool2d(x, kernel, stride=None, padding=0):
    """x (N, H, W, C) NHWC, float32 or bfloat16; torch MaxPool2d semantics."""
    if x.device.type == "cpu":
        return max_pool2d_plain(x, kernel, stride, padding)
    _k.check_cuda_operand("max_pool2d x", x)
    n, h, w, c = x.shape
    kh, kw = to_pair(kernel)
    sh, sw = to_pair(kernel if stride is None else stride)
    ph, pw = to_pair(padding)
    oh = conv_out_size(h, kh, sh, ph)
    ow = conv_out_size(w, kw, sw, pw)
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    rc = _k.lib().max_pool_launch(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow,
        kh, kw, sh, sw, ph, pw, _k.stream_ptr(x))
    _k.check_launch("max_pool2d", rc)
    _k.LAUNCHES["max_pool2d"] += 1
    return y


class _MaxPool2dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        ctx.save_for_backward(x)
        ctx.conf = (kernel, stride, padding)
        return _k.max_pool2d(x, kernel, stride, padding)

    @staticmethod
    def backward(ctx, g):
        # the plain max-pool VJP recomputed from x (pool.py:111-116): each
        # window's gradient goes to its first maximum in row-major order,
        # as XLA's select-and-scatter routes ties
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            y = ops.max_pool2d(xr, *ctx.conf)
            (dx,) = torch.autograd.grad(y, xr, g.to(x.dtype))
        return dx.contiguous(), None, None, None


def pool2d_train(x, mode: str, kernel, stride=None, padding=0):
    """Trainable pool: forward through the max_pool2d kernel, backward the
    plain max-pool VJP. Mode "avg" needs the avg_pool2d kernel."""
    if mode != "max":
        raise NotImplementedError(
            f"pool2d_train mode {mode!r}: the avg_pool2d kernel (PERF.md kernel table "
            f"row 3) is not ported yet (ROADMAP.md: kernels avg_pool2d)")
    return _MaxPool2dTrain.apply(x, kernel, stride, padding)
