"""Depthwise conv: the wrapper of csrc/depthwise.cu, its plain PyTorch
version, and the trainable depthwise conv.

Replaces convnets_tpu/ops/pallas/conv.py:
- `depthwise_conv2d` (:755): per-channel K×K multiply-accumulate, fp32
  accumulation, one rounding to x.dtype, channel multiplier 1; w
  (kh, kw, 1, C) is cast to x.dtype (:779).
- `depthwise_train` (:702): an autograd Function whose forward is the
  kernel and whose backward is plain PyTorch (dx/dw by grouped transposed
  convolution, cuDNN on the card), as the JAX package leaves it to XLA.

The kernel runs one thread per output element with the channel innermost;
it is memory-bound on the H100 (one read of x, one write of y).
"""

from __future__ import annotations

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k
from convnets_tpu_torch.ops.kernels.conv import conv2d_backward


def depthwise_conv2d_plain(x, w, *, stride=1, padding=0):
    """The kernel's contract in plain PyTorch: fp32 grouped conv, one cast
    to x.dtype."""
    return ops.conv2d_depthwise(x, w.to(x.dtype), stride=stride, padding=padding)


def depthwise_conv2d(x, w, *, stride=1, padding=0):
    """x (N, H, W, C) NHWC, float32 or bfloat16; w (kh, kw, 1, C) HWIO.
    Any stride and padding. Returns (N, OH, OW, C) in x.dtype."""
    n, h, wd, c = x.shape
    kh, kw, one, wc = w.shape
    if one != 1 or wc != c:
        raise ValueError(f"depthwise_conv2d: expects w (kh, kw, 1, {c}), got {tuple(w.shape)}")
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, w, stride=stride, padding=padding)
    _k.check_cuda_operand("depthwise_conv2d x", x)
    wt = w.to(x.dtype).reshape(kh * kw, c).contiguous()
    _k.check_cuda_operand("depthwise_conv2d w", wt, x.dtype)
    sh, sw = to_pair(stride)
    ph, pw = to_pair(padding)
    oh = conv_out_size(h, kh, sh, ph)
    ow = conv_out_size(wd, kw, sw, pw)
    if n * oh * ow * c >= 2 ** 31:
        raise ValueError(f"depthwise_conv2d: output of {n * oh * ow * c} elements exceeds "
                         f"the kernel's 32-bit indexing")
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    rc = _k.lib().depthwise_launch(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), wt.data_ptr(), y.data_ptr(), n, h, wd, c,
        oh, ow, kh, kw, sh, sw, ph, pw, _k.stream_ptr(x))
    _k.check_launch("depthwise_conv2d", rc)
    _k.LAUNCHES["depthwise_conv2d"] += 1
    return y


class _DepthwiseTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        return _k.depthwise_conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_backward(x, w.to(x.dtype), g, *ctx.conf,
                                 need=ctx.needs_input_grad[:2], groups=x.shape[-1])
        return dx, None if dw is None else dw.to(w.dtype), None, None


def depthwise_train(x, w, stride=1, padding=0):
    """Trainable depthwise conv (conv.py:depthwise_train): forward through
    the depthwise_conv2d kernel, dx and dw by the grouped conv's VJP in
    plain PyTorch with the cotangent cast to x.dtype (conv.py:712-719)."""
    return _DepthwiseTrain.apply(x, w, stride, padding)
