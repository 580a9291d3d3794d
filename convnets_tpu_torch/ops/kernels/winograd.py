"""Winograd F(m,3) conv on the card: the wrappers of csrc/winograd.cu, their
plain versions (ops/winograd.py), the plan of the output kernel, and the
trainable conv.

Replaces no Pallas kernel: convnets_tpu/ops/winograd.py:conv2d_winograd
(:117-168) is an einsum composition. Its two transforms are the kernels
here, and its a² batched product (V·U with an fp32 M) the batched cuBLAS
call of `ops/winograd.py:batched_product`, as the JAX package leaves that
einsum to XLA:
- `winograd_input`: x (N, H, W, C) → V (a², P, C) in x.dtype;
- `winograd_output`: M (a², P, O) fp32 → y (N, OH, OW, O) with the bias
  epilogue (the bare Conv2d) or the folded-BN one (·scale + shift, ReLU;
  the eval ConvBNReLU site);
- `winograd_output_stats`: the same with the statistics epilogue: y and
  per-block partial rows of Σy, Σy² of the stored y, then conv_fused.cu's
  stats_reduce_kernel, counted as `conv2d_stats_reduce` (the train-mode
  ConvBNReLU site: the (y, sums) that bn_act_forward takes).
`winograd_conv2d` and `winograd_conv2d_stats` compose them; the
trainable `winograd_conv2d_train` saves only x and w, and its backward is
the direct conv's (`conv2d_backward`): in exact arithmetic the Winograd
map is the convolution, and JAX's default CONVNETS_TPU_WINOGRAD_REMAT=1
keeps only x and w too.

Every wrapper computes its plain version for a CPU tensor and, for a CUDA
tensor, launches its kernel or raises: nothing falls back to the plain
composition or to the direct conv.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from convnets_tpu_torch.core.shapes import to_pair
from convnets_tpu_torch.ops import kernels as _k
from convnets_tpu_torch.ops import winograd as _w
from convnets_tpu_torch.ops.kernels.conv import _with_sums, conv2d_backward

_EPI = {"bias": 0, "affine": 1, "stats": 2}
M_TILES = (2, 4)


class Geometry(NamedTuple):
    """A Winograd conv's shapes: batch, output size, the m×m tiles (th ×
    tw) that cover it, m and the output channels."""

    n: int
    oh: int
    ow: int
    th: int
    tw: int
    m: int
    o: int

    @property
    def tiles(self) -> int:
        return self.n * self.th * self.tw


def geometry(x_shape, o: int, padding, m: int) -> Geometry:
    if m not in M_TILES:
        raise ValueError(f"winograd: m={m} (F(2,3) or F(4,3))")
    n, h, w, _ = x_shape
    oh, ow, th, tw = _w.tiling(h, w, to_pair(padding), m)
    return Geometry(n, oh, ow, th, tw, m, o)


class OutputPlan(NamedTuple):
    """How winograd_output runs: `vec` 4 channels a thread (16-byte loads
    of M) or 1; a block of tx channel units × ty tiles; `blocks` its rows of
    tiles (the statistics epilogue's partial rows)."""

    vec: int
    tx: int
    ty: int
    blocks: int


def output_plan(tiles: int, o: int, aligned: bool = True) -> OutputPlan:
    """vec 4 iff O % 4 == 0 and M and y are 16-byte aligned; tx = min(units,
    32), ty = 256 // tx."""
    vec = 4 if o % 4 == 0 and aligned else 1
    tx = min(o // vec if vec == 4 else o, 32)
    ty = 256 // tx
    return OutputPlan(vec, tx, ty, -(-tiles // ty))


def input_vec(c: int, dtype, aligned: bool = True) -> bool:
    """The input kernel's 16-byte route: C a multiple of 16 bytes' worth of
    values (8 bf16, 4 fp32) and x and V 16-byte aligned."""
    return c % (16 // dtype.itemsize) == 0 and aligned


def _check_numel(name, *counts):
    for count in counts:
        if count >= 2 ** 31:
            raise ValueError(f"{name}: {count} elements exceed the kernels' 32-bit indexing")


def winograd_input(x, m: int, padding=1):
    """x (N, H, W, C) NHWC → V (a², N·th·tw, C) in x.dtype: Bᵀ d B of each
    (m+2)² tile of the padded input, in fp32, one rounding."""
    padding = to_pair(padding)
    if x.device.type == "cpu":
        return _w.input_transform_plain(x, m, padding)
    n, h, w, c = x.shape
    g = geometry(x.shape, c, padding, m)
    _k.check_cuda_operand("winograd_input x", x)
    a = m + 2
    _check_numel("winograd_input", a * a * g.tiles * c)
    v = torch.empty((a * a, g.tiles, c), dtype=x.dtype, device=x.device)
    vec = input_vec(c, x.dtype, x.data_ptr() % 16 == 0)
    rc = _k.lib().winograd_input_launch(_k.DTYPE_CODES[x.dtype], x.data_ptr(), v.data_ptr(),
                                        n, h, w, c, g.th, g.tw, *padding, m, int(vec),
                                        _k.stream_ptr(x))
    _k.check_launch("winograd_input", rc)
    _k.LAUNCHES["winograd_input"] += 1
    return v


def _launch_output(name, mm, g: Geometry, dtype, epi, a, b, relu, partial_rows=False):
    _k.check_cuda_operand(f"{name} M", mm, torch.float32)
    side = g.m + 2
    if tuple(mm.shape) != (side * side, g.tiles, g.o):
        raise ValueError(f"{name}: M has shape {tuple(mm.shape)}, expected "
                         f"{(side * side, g.tiles, g.o)}")
    if dtype not in _k.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    _check_numel(name, mm.numel(), g.n * g.oh * g.ow * g.o)
    for what, t in (("bias" if epi == "bias" else "scale", a), ("shift", b)):
        if t is not None:
            _k.check_cuda_operand(f"{name} {what}", t, torch.float32)
            if t.shape != (g.o,):
                raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, expected ({g.o},)")
    y = torch.empty((g.n, g.oh, g.ow, g.o), dtype=dtype, device=mm.device)
    plan = output_plan(g.tiles, g.o, mm.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    partial = (torch.empty((plan.blocks + 1, 2, g.o), dtype=torch.float32, device=mm.device)
               if partial_rows else None)
    rc = _k.lib().winograd_output_launch(
        _k.DTYPE_CODES[dtype], mm.data_ptr(), y.data_ptr(),
        None if a is None else a.data_ptr(), None if b is None else b.data_ptr(),
        None if partial is None else partial.data_ptr(), g.n, g.oh, g.ow, g.o, g.th, g.tw, g.m,
        int(plan.vec == 4), _EPI[epi], int(relu), plan.tx, plan.ty, _k.stream_ptr(mm))
    _k.check_launch(name, rc)
    _k.LAUNCHES["winograd_output"] += 1
    return y, partial, plan


def _fp32_vector(t, o):
    return None if t is None else t.float().reshape(o).contiguous()


def winograd_output(mm, g: Geometry, dtype, bias: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
                    relu: bool = False):
    """M (a², P, O) fp32 → y (N, OH, OW, O) in `dtype`: Aᵀ M A in fp32, then
    + bias (or none), or ·scale + shift and ReLU if `relu` (the folded BN
    of an eval site; ReLU only with scale and shift), in fp32, one
    rounding; only the valid outputs are written."""
    affine = scale is not None or shift is not None
    if affine and (scale is None or shift is None or bias is not None):
        raise ValueError("winograd_output: a bias, or both scale and shift, not both")
    if relu and not affine:
        raise ValueError("winograd_output: ReLU only in the scale/shift epilogue")
    if mm.device.type == "cpu":
        return _w.output_transform_plain(mm, g.n, g.oh, g.ow, g.m, dtype, bias, scale, shift,
                                         relu)
    if affine:
        y, _, _ = _launch_output("winograd_output", mm, g, dtype, "affine",
                                 _fp32_vector(scale, g.o), _fp32_vector(shift, g.o), relu)
    else:
        y, _, _ = _launch_output("winograd_output", mm, g, dtype, "bias",
                                 _fp32_vector(bias, g.o), None, False)
    return y


def winograd_output_stats(mm, g: Geometry, dtype):
    """winograd_output with the statistics epilogue: (y, sums), sums the
    fp32 (2, O) row [Σy; Σy²] over N·OH·OW of the STORED y (the contract of
    conv2d_stats). Two launches: the transform with per-block partial rows,
    then their fixed-order reduction."""
    if mm.device.type == "cpu":
        return _with_sums(_w.output_transform_plain(mm, g.n, g.oh, g.ow, g.m, dtype))
    y, partial, plan = _launch_output("winograd_output", mm, g, dtype, "stats", None, None,
                                      False, partial_rows=True)
    sums = partial[plan.blocks]
    rc = _k.lib().stats_reduce_launch(partial.data_ptr(), sums.data_ptr(), plan.blocks, g.o,
                                      _k.stream_ptr(mm))
    _k.check_launch("conv2d_stats_reduce", rc)
    _k.LAUNCHES["conv2d_stats_reduce"] += 1
    return y, sums


def _product(x, w, padding, m):
    """(M, geometry): the input transform and the batched product."""
    if tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[-1]:
        raise ValueError(f"winograd: weight {tuple(w.shape)} for input {tuple(x.shape)} "
                         f"(3, 3, Cin, Cout)")
    g = geometry(x.shape, w.shape[-1], padding, m)
    v = winograd_input(x, m, padding)
    a = m + 2
    u = _w.transform_weight(w, m, x.dtype).reshape(a * a, w.shape[2], w.shape[3])
    return _w.batched_product(v, u), g


def winograd_conv2d(x, w, bias=None, scale=None, shift=None, *, padding=1, m: int = 4,
                    relu: bool = False):
    """3x3 stride-1 dense conv through F(m,3): x (N, H, W, Cin), w (3, 3,
    Cin, Cout) in x.dtype; the bias (rounded to x.dtype by the caller, added
    in fp32) or the folded BN scale/shift (fp32) and ReLU as
    winograd_output takes them. Returns (N, OH, OW, Cout) in x.dtype; on
    the CPU, ops/winograd.py's plain composition."""
    mm, g = _product(x, w, padding, m)
    return winograd_output(mm, g, x.dtype, bias, scale, shift, relu)


def winograd_conv2d_stats(x, w, *, padding=1, m: int = 4):
    """winograd_conv2d with the statistics epilogue: (y, sums) as
    conv2d_stats gives them."""
    mm, g = _product(x, w, padding, m)
    return winograd_output_stats(mm, g, x.dtype)


def winograd_conv2d_plain(x, w, bias=None, scale=None, shift=None, *, padding=1, m: int = 4,
                          relu: bool = False):
    """winograd_conv2d's contract in plain PyTorch on any device
    (ops/winograd.py:conv2d_winograd_plain); the card's reference for the
    kernels."""
    return _w.conv2d_winograd_plain(x, w, bias, padding=padding, m=m, scale=scale, shift=shift,
                                    relu=relu)


def winograd_conv2d_stats_plain(x, w, *, padding=1, m: int = 4):
    """winograd_conv2d_stats' contract in plain PyTorch: y as
    winograd_conv2d_plain gives it, and the (2, Cout) row of Σ, Σ² of
    y.float()."""
    return _with_sums(winograd_conv2d_plain(x, w, padding=padding, m=m))


class _WinogradConv2dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, padding, m):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.has_bias = padding, bias is not None
        return _k.winograd_conv2d(x, w, bias, padding=padding, m=m)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_backward(x, w, g, 1, ctx.padding, need=ctx.needs_input_grad[:2])
        db = g.float().sum(dim=(0, 1, 2)).to(g.dtype) if ctx.has_bias else None
        return dx, dw, db, None, None


def winograd_conv2d_train(x, w, bias=None, padding=1, m: int = 4):
    """Trainable winograd_conv2d: forward through the Winograd kernels;
    dx and dw by the direct conv's transposed convolutions
    (conv2d_backward), the bias gradient the cotangent's fp32 sum; only x
    and w are kept for the backward."""
    return _WinogradConv2dTrain.apply(x, w, bias, padding, m)
