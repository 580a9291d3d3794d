"""Conv kernels: the wrappers of csrc/conv_fused.cu, their plain PyTorch
versions, and the trainable conv.

Replaces convnets_tpu/ops/pallas/conv.py:
- `conv2d_fused` (:391): implicit-GEMM direct convolution that addresses
  strides and padding itself, accumulates in fp32, applies y·scale +
  shift in fp32, then ReLU, then rounds once to x.dtype.
- `conv2d_stats` (:543): the same main loop with a statistics epilogue:
  y rounded once and stored, plus per-channel Σy and Σy² of the stored
  values, reduced across blocks in a fixed order by a second kernel.
- `conv2d_train` (:675): an autograd Function whose forward is
  `conv2d_fused` without epilogue and whose backward is plain PyTorch.

The kernels run on the CUDA cores (fp32 FMA), so on the H100 they are
compute-bound well below the tensor-core rate; wgmma/TMA tiles are later
work (see the source note in csrc/conv_fused.cu).
"""

from __future__ import annotations

from typing import Optional

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k

def _epilogue_operands(scale, shift, cout, device):
    """Both per-channel fp32 vectors, or (None, None) for a plain conv."""
    if scale is None and shift is None:
        return None, None
    if scale is None:
        scale = torch.ones(cout, dtype=torch.float32, device=device)
    if shift is None:
        shift = torch.zeros(cout, dtype=torch.float32, device=device)
    return scale.float().reshape(cout), shift.float().reshape(cout)


def _conv_geometry(name, x, w, stride, padding):
    """Check the operands of a conv kernel; return its shape arguments
    (n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw)."""
    n, h, wd, cin = x.shape
    kh, kw, wc, cout = w.shape
    if wc != cin:
        raise ValueError(f"{name}: weight expects Cin={wc}, input has {cin}")
    sh, sw = to_pair(stride)
    ph, pw = to_pair(padding)
    if not _k.fits_conv((sh, sw), 1, 1):
        raise NotImplementedError(f"{name}: stride {(sh, sw)} (1 or 2 only)")
    _k.check_cuda_operand(f"{name} x", x)
    _k.check_cuda_operand(f"{name} w", w, x.dtype)
    oh = conv_out_size(h, kh, sh, ph)
    ow = conv_out_size(wd, kw, sw, pw)
    if n * oh * ow * cout >= 2 ** 31:
        raise ValueError(f"{name}: output of {n * oh * ow * cout} elements exceeds the "
                         f"kernels' 32-bit indexing")
    return n, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw


def conv2d_fused_plain(x, w, scale: Optional[torch.Tensor] = None,
                       shift: Optional[torch.Tensor] = None, *, stride=1, padding=0,
                       relu: bool = False):
    """The kernel's contract in plain PyTorch: fp32 conv, fp32 epilogue,
    one cast to x.dtype."""
    scale, shift = _epilogue_operands(scale, shift, w.shape[-1], x.device)
    y = ops.conv2d(x.float(), w.float(), stride=stride, padding=padding)
    if scale is not None:
        y = y * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def conv2d_fused(x, w, scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None, *, stride=1, padding=0,
                 relu: bool = False):
    """x (N, H, W, Cin) NHWC, w (kh, kw, Cin, Cout) HWIO in x.dtype;
    scale/shift (Cout,) fp32 — the BN-folded multiplier and offset of a
    conv → BN(inference) → ReLU block — or None for a plain conv.
    Stride 1 or 2 (each axis), any padding. Returns (N, OH, OW, Cout)."""
    if x.device.type == "cpu":
        return conv2d_fused_plain(x, w, scale, shift, stride=stride, padding=padding,
                                  relu=relu)
    geo = _conv_geometry("conv2d_fused", x, w, stride, padding)
    n, _, _, _, oh, ow, cout = geo[:7]
    scale, shift = _epilogue_operands(scale, shift, cout, x.device)
    if scale is not None:
        scale, shift = scale.contiguous(), shift.contiguous()
        _k.check_cuda_operand("conv2d_fused scale", scale, torch.float32)
        _k.check_cuda_operand("conv2d_fused shift", shift, torch.float32)
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    rc = _k.lib().conv_fused_launch(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), y.data_ptr(),
        *geo, int(relu), _k.stream_ptr(x))
    _k.check_launch("conv2d_fused", rc)
    _k.LAUNCHES["conv2d_fused"] += 1
    return y


def conv2d_stats_plain(x, w, *, stride=1, padding=0):
    """The statistics kernel's contract in plain PyTorch: y as
    conv2d_fused_plain gives it, and Σ, Σ² over (N, OH, OW) of y.float()."""
    y = conv2d_fused_plain(x, w, stride=stride, padding=padding)
    yf = y.float()
    return y, yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def conv2d_stats(x, w, *, stride=1, padding=0):
    """Conv forward plus the per-channel batch statistics of its STORED
    output: returns (y, Σy, Σy²), y (N, OH, OW, Cout) in x.dtype, the sums
    fp32 (Cout,) over N·OH·OW (conv.py:534-538: the sums of the rounded y
    keep the fused path consistent with conv → BN over y). Two launches:
    the conv with per-block partial sums, then their fixed-order sum."""
    if x.device.type == "cpu":
        return conv2d_stats_plain(x, w, stride=stride, padding=padding)
    geo = _conv_geometry("conv2d_stats", x, w, stride, padding)
    n, _, _, _, oh, ow, cout = geo[:7]
    lib = _k.lib()
    blocks = -(-(n * oh * ow) // lib.conv_block_rows())
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    partial = torch.empty((blocks, 2, cout), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    stream = _k.stream_ptr(x)
    rc = lib.conv_stats_launch(_k.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                               y.data_ptr(), partial.data_ptr(), *geo, stream)
    _k.check_launch("conv2d_stats", rc)
    _k.LAUNCHES["conv2d_stats"] += 1
    rc = lib.stats_reduce_launch(partial.data_ptr(), sums.data_ptr(), blocks, cout, stream)
    _k.check_launch("conv2d_stats_reduce", rc)
    _k.LAUNCHES["conv2d_stats_reduce"] += 1
    return y, sums[0], sums[1]


def conv2d_backward(x, w, g, stride, padding, need=(True, True), groups=1):
    """(dx, dw) of y = conv(x, w) for the cotangent g, NHWC / HWIO in
    x.dtype; an entry is None where `need` says so. Plain PyTorch
    (aten.convolution_backward on channels_last views; cuDNN on the card):
    the JAX package leaves these transposed convs to XLA (conv.py:688-695,
    :712-719, fused.py:99-102), outside any Pallas kernel."""
    wc = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)  # OIHW, channels_last
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.to(x.dtype).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, None,
        list(to_pair(stride)), list(to_pair(padding)), [1, 1], False, [0, 0], groups,
        [bool(need[0]), bool(need[1]), False])
    if dx is not None:
        dx = dx.permute(0, 2, 3, 1).contiguous()
    if dw is not None:
        dw = dw.permute(2, 3, 1, 0).contiguous()
    return dx, dw


class _Conv2dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        return _k.conv2d_fused(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_backward(x, w, g, *ctx.conf, need=ctx.needs_input_grad[:2])
        return dx, dw, None, None


def conv2d_train(x, w, stride=1, padding=0):
    """Trainable conv (conv.py:conv2d_train): forward through the
    conv2d_fused kernel with no epilogue, dx and dw by transposed
    convolution in plain PyTorch."""
    return _Conv2dTrain.apply(x, w, stride, padding)
