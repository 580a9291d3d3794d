"""Depthwise conv: the wrapper of csrc/depthwise.cu, its plain PyTorch
version, the plan that picks its route and tile, and the trainable
depthwise conv.

Replaces convnets_tpu/ops/pallas/conv.py:
- `depthwise_conv2d` (:755): per-channel K×K multiply-accumulate, fp32
  accumulation, one rounding to x.dtype; w (kh, kw, 1, C) is cast to
  x.dtype (:779). Widened to the depthwise convs the JAX package runs on
  lax (`fits_depthwise`): a channel multiplier m (w (kh, kw, 1, m·C),
  output channel o reading input channel o // m) and dilation.
- `depthwise_train` (:702): an autograd Function whose forward is the
  kernel and whose backward is plain PyTorch (dx/dw by grouped transposed
  convolution, cuDNN on the card), as the JAX package leaves it to XLA.

The kernel is memory-bound on the H100 (one read of x, one write of y).
`depthwise_plan` picks its route by shape: "vector" (multiplier 1, C % 8
== 0, 3×3, stride 1 or 2, dilation 1, 2 or 4: a CTA copies its output
tile's input halo into shared memory once, 16 bytes at a time, and each
thread computes 8 channels of a block of outputs from there, 2 rows × 4
columns at stride 1, its weights in registers) or "loop" (one thread per
output element; every multiplier, window, stride and dilation).
"""

from __future__ import annotations

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k
from convnets_tpu_torch.ops.kernels.conv import conv2d_backward
from convnets_tpu_torch.ops.kernels.pool import WindowPlan, _aligned, _check_dtype

_SMS = 132  # the H100 SXM's SMs
_MAX_THREADS = 256  # a vector CTA's threads (the kernel's launch bound)
_MAX_HALO = 48 * 1024  # bytes of one of a vector CTA's two halo buffers
_MAX_TW = 32  # output columns of a vector tile
VECTOR_DILATIONS = (1, 2)  # the vector route's instantiations (csrc/depthwise.cu)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def depthwise_plan(n, h, w, c, kh, kw, stride, padding, dtype, aligned: bool = True, *,
                   dilation=1, multiplier: int = 1) -> WindowPlan:
    """The plan of a depthwise conv over NHWC (n, h, w, c) in `dtype`,
    `multiplier` filters per channel.

    The vector route takes multiplier 1, C % 8 == 0, a 3×3 window, stride 1
    or 2 and dilation d in VECTOR_DILATIONS (each the same along H and W),
    any padding, and 16-byte aligned operands (`aligned`); every other
    shape takes the loop. A vector tile is th × tw outputs × cb channels,
    each thread's block ry × r outputs: 2 × 4 at stride 1, 1 × 2 at stride
    2 (cb/8 · th/ry · tw/r threads):
    - cb: 64 or the largest of 32, 16, 8 that divides C;
    - tw: the output width cut into the fewest pieces of at most 32
      columns, rounded up to a multiple of r;
    - th: a multiple of ry, as many rows as 256 threads hold, fewer while
      the input halo, ((th−1)·s+2d+1) × ((tw−1)·s+2d+1) × cb, is over 48
      KB, then evened out over the tile rows it needs;
    - while the grid has fewer than two CTAs per SM (small N, 7² or 14²
      maps), cb halves, down to 16.
    """
    _check_dtype("depthwise_plan", dtype)
    sh, sw = to_pair(stride)
    ph, pw = to_pair(padding)
    dh, dw = to_pair(dilation)
    if (multiplier != 1 or c % 8 or not aligned or (kh, kw) != (3, 3) or sh != sw
            or sh not in (1, 2) or dh != dw or dh not in VECTOR_DILATIONS):
        return WindowPlan("loop")
    oh, ow = conv_out_size(h, kh, sh, ph, dh), conv_out_size(w, kw, sw, pw, dw)
    r, ry = (4, 2) if sh == 1 else (2, 1)
    itemsize = torch.finfo(dtype).bits // 8
    cb = next(b for b in (64, 32, 16, 8) if c % b == 0)
    tw = _cdiv(_cdiv(ow, _cdiv(ow, _MAX_TW)), r) * r

    ext = (kh - 1) * dh + 1  # the window's extent

    def halo(th, tw, cb):
        return ((th - 1) * sh + ext) * ((tw - 1) * sw + ext) * cb * itemsize

    th = ry * max(1, min(_cdiv(oh, ry), _MAX_THREADS // ((cb // 8) * (tw // r))))
    while th > ry and halo(th, tw, cb) > _MAX_HALO:
        th -= ry
    while tw > r and halo(th, tw, cb) > _MAX_HALO:
        tw -= r
    th = _cdiv(_cdiv(oh, _cdiv(oh, th)), ry) * ry
    while n * _cdiv(oh, th) * _cdiv(ow, tw) * (c // cb) < 2 * _SMS and cb > 16:
        cb //= 2
    return WindowPlan("vector", cb, th, tw, r, ry)


def depthwise_conv2d_plain(x, w, *, stride=1, padding=0, dilation=1):
    """The kernel's contract in plain PyTorch: fp32 grouped conv (groups =
    C, w (kh, kw, 1, m·C)), one cast to x.dtype."""
    return ops.conv2d_depthwise(x, w.to(x.dtype), stride=stride, padding=padding,
                                dilation=dilation)


def depthwise_conv2d(x, w, *, stride=1, padding=0, dilation=1, route=None):
    """x (N, H, W, C) NHWC, float32 or bfloat16; w (kh, kw, 1, m·C) HWIO,
    output channel o reading input channel o // m. Any stride, padding and
    dilation. Returns (N, OH, OW, m·C) in x.dtype. `route` forces the loop
    or the vector route on the card (the on-card comparison of the two)."""
    c = x.shape[-1]
    _, _, one, cout = w.shape
    if one != 1 or cout % c or cout == 0:
        raise ValueError(f"depthwise_conv2d: expects w (kh, kw, 1, m·{c}), got "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, w, stride=stride, padding=padding, dilation=dilation)
    return _launch(x, w, stride, padding, dilation, route)


def _launch(x, w, stride, padding, dilation, route=None):
    """Check the operands, then launch depthwise_launch with its plan
    (`route` forces one) and count it on its route; returns y."""
    n, h, wd, c = x.shape
    kh, kw, _, cout = w.shape
    _k.check_cuda_operand("depthwise_conv2d x", x)
    wt = w.to(x.dtype).reshape(kh * kw, cout).contiguous()
    _k.check_cuda_operand("depthwise_conv2d w", wt, x.dtype)
    sh, sw = to_pair(stride)
    ph, pw = to_pair(padding)
    dh, dw = to_pair(dilation)
    if min(sh, sw, dh, dw) < 1:
        raise ValueError(f"depthwise_conv2d: stride {(sh, sw)}, dilation {(dh, dw)} (each >= 1)")
    oh = conv_out_size(h, kh, sh, ph, dh)
    ow = conv_out_size(wd, kw, sw, pw, dw)
    if n * oh * ow * cout >= 2 ** 31:
        raise ValueError(f"depthwise_conv2d: output of {n * oh * ow * cout} elements exceeds "
                         f"the kernel's 32-bit indexing")
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    plan = WindowPlan("loop") if route == "loop" else depthwise_plan(
        n, h, wd, c, kh, kw, (sh, sw), (ph, pw), x.dtype,
        route == "vector" or _aligned(x, wt, y), dilation=(dh, dw), multiplier=cout // c)
    rc = _k.lib().depthwise_launch(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), wt.data_ptr(), y.data_ptr(), n, h, wd, c,
        oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw, *plan.args(), _k.stream_ptr(x))
    _k.check_launch("depthwise_conv2d", rc)
    _k.count_launch("depthwise_conv2d", plan.route)
    return y


class _DepthwiseTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        ctx.dilation = dilation
        return _k.depthwise_conv2d(x, w, stride=stride, padding=padding, dilation=dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_backward(x, w.to(x.dtype), g, *ctx.conf,
                                 need=ctx.needs_input_grad[:2], groups=x.shape[-1],
                                 dilation=ctx.dilation)
        return dx, None if dw is None else dw.to(w.dtype), None, None, None


def depthwise_train(x, w, stride=1, padding=0, dilation=1):
    """Trainable depthwise conv (conv.py:depthwise_train), any multiplier
    and dilation: forward through the depthwise_conv2d kernel, dx and dw
    by the grouped conv's VJP (groups = C) in plain PyTorch with the
    cotangent cast to x.dtype (conv.py:712-719)."""
    return _DepthwiseTrain.apply(x, w, stride, padding, dilation)
