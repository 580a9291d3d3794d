"""Fused conv (+ scale/shift epilogue) (+ ReLU): the wrapper of
csrc/conv_fused.cu and its plain PyTorch version.

Replaces convnets_tpu/ops/pallas/conv.py:conv2d_fused. The kernel is an
implicit-GEMM direct convolution that addresses strides and padding
itself, accumulates in fp32, applies y·scale + shift in fp32, then ReLU,
then rounds once to x.dtype. It runs on the CUDA cores (fp32 FMA), so on
the H100 it is compute-bound well below the tensor-core rate; wgmma/TMA
tiles are later work (see the source note in csrc/conv_fused.cu).
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
    n, h, wd, cin = x.shape
    kh, kw, wc, cout = w.shape
    if wc != cin:
        raise ValueError(f"conv2d_fused: weight expects Cin={wc}, input has {cin}")
    sh, sw = to_pair(stride)
    ph, pw = to_pair(padding)
    if not _k.fits_conv((sh, sw), 1, 1):
        raise NotImplementedError(f"conv2d_fused: stride {(sh, sw)} (1 or 2 only)")
    _k.check_cuda_operand("conv2d_fused x", x)
    _k.check_cuda_operand("conv2d_fused w", w, x.dtype)
    scale, shift = _epilogue_operands(scale, shift, cout, x.device)
    if scale is not None:
        scale, shift = scale.contiguous(), shift.contiguous()
        _k.check_cuda_operand("conv2d_fused scale", scale, torch.float32)
        _k.check_cuda_operand("conv2d_fused shift", shift, torch.float32)
    oh = conv_out_size(h, kh, sh, ph)
    ow = conv_out_size(wd, kw, sw, pw)
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    _k.check_cuda_operand("conv2d_fused y", y)
    rc = _k.lib().conv_fused_launch(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), y.data_ptr(),
        n, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, int(relu),
        _k.stream_ptr(x))
    _k.check_launch("conv2d_fused", rc)
    _k.LAUNCHES["conv2d_fused"] += 1
    return y
