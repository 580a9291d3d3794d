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
- `grouped_conv2d_train` (:647) and the grouped ConvBNReLU paths, which
  the JAX package runs through the two dense kernels on a block-diagonal
  weight (`block_diag_weight`, :628): here `grouped_conv2d_fused` and
  `grouped_conv2d_stats`, with the same two epilogues; the weight stays
  (kh, kw, Cin/G, Cout).

`conv_plan` chooses how a dense call runs. bf16 runs on the tensor cores
(csrc/conv_wgmma.cu: wgmma from a 3-slot cp.async ring loaded 1 stage
ahead, 128 output pixels × 32, 64 or 128 channels per CTA), with the
16-byte gather where Cin % 8 == 0 and a scalar gather into the same tiles
otherwise (the 3-channel stems). fp32 runs the CUDA-core loop of
csrc/conv_fused.cu: only the fp32 checks take it, and tensor-core TF32
would not hold their bars.

`grouped_plan` does the same for a grouped call. bf16 at Cin/G = Cout/G
in {4, 8, 16, 32} with Cin % 64 == 0 runs the grouped mode of the same
tensor-core loop ("wgmma"): 64 output channels (whole groups) per CTA, one
tap per stage, the block-diagonal weight built in shared memory only and
MMAs only on its blocks that hold weights (`grouped_slices`). Every other
bf16 shape but Cin/G = 2 (ShuffleNet's grouped 1x1s among them: Cin/G
12-400, Cout/G 12-400) runs csrc/grouped_wgmma.cuh ("wgmma_wide"):
persistent CTAs, each keeping one column tile (whole groups packed up to
128 accumulator columns, or one piece of a wider group) over row tiles of
128 output pixels, each group its own chain of MMAs on its own depth
padded to 16 (`grouped_wide_tiles`).
fp32, and bf16 at Cin/G = 2, run the CUDA-core loop of
csrc/grouped_conv.cu ("simt"), which sums each group's own products,
walking a wide group's input channels in chunks of 32.

Every conv kernel takes any stride and dilation per axis, and the grouped
ones any number of groups: the shape arguments of the C entry points (`geo`) are n, h, w, cin, oh, ow,
cout, kh, kw, sh, sw, ph, pw, dh, dw, and the tap (ky, kx) of output
pixel (oy, ox) reads input row oy·sh − ph + ky·dh, column ox·sw − pw +
kx·dw.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k

_ROUTES = {"simt": 0, "wgmma": 1, "wgmma_wide": 2}
_GATHERS = {"scalar": 0, "vector": 1}
_SMS = 132  # the H100 SXM's SMs: a layer with fewer 128-wide tiles takes 64-wide ones


class ConvPlan(NamedTuple):
    """How a dense conv kernel call runs. route: "wgmma" (bf16, the
    tensor-core loop of csrc/conv_wgmma.cu) or "simt" (fp32, the CUDA-core
    loop of csrc/conv_fused.cu). A CTA owns `bm` output pixels × `bn`
    output channels. gather: "vector" copies the implicit im2col tile 8
    channels (16 bytes) at a time, "scalar" one value at a time."""

    route: str
    bm: int
    bn: int
    gather: str

    def partial_rows(self, m: int) -> int:
        """Rows of per-CTA partial sums conv2d_stats writes for M pixels."""
        return -(-m // self.bm)

    def args(self):
        """The plan as the C entry points take it: route, bm, bn, gather."""
        return _ROUTES[self.route], self.bm, self.bn, _GATHERS[self.gather]


def conv_plan(dtype, m: int, cin: int, cout: int, aligned: bool = True) -> ConvPlan:
    """The plan of a dense conv of M = N·OH·OW output pixels, Cin → Cout,
    in `dtype`. bf16: the tensor-core loop, 128 × BN tiles with BN 32 for
    Cout ≤ 32, 64 for Cout ≤ 64 or where 128-wide tiles would leave SMs
    idle, else 128; the vector gather iff Cin % 8 == 0 and x is 16-byte
    aligned (`aligned`). fp32: the CUDA-core loop (128 × 64, scalar)."""
    if dtype == torch.float32:
        return ConvPlan("simt", 128, 64, "scalar")
    if dtype != torch.bfloat16:
        raise TypeError(f"conv_plan: dtype {dtype} not supported (float32, bfloat16)")
    if cout <= 32:
        bn = 32
    elif cout <= 64 or -(-m // 128) * -(-cout // 128) < _SMS:
        bn = 64
    else:
        bn = 128
    return ConvPlan("wgmma", 128, bn, "vector" if cin % 8 == 0 and aligned else "scalar")


GROUPED_WGMMA_CG = (4, 8, 16, 32)  # Cin/G = Cout/G of the grouped tensor-core plan


def grouped_slices(cg: int):
    """The grouped tensor-core loop's map of one stage, as csrc/conv_wgmma.cu
    (grouped_mma) runs it: for each k16 slice kk of the CTA's 64-channel
    input slab, (kk, first output column, end column, first accumulator)
    of the one MMA it feeds. Columns are the CTA's 64 (whole groups); the
    n64 fragment keeps columns 8j .. 8j+7 in accumulators 4j .. 4j+3. For
    Cin/G ≤ 16 (dividing 16) slice kk meets columns 16kk .. 16kk+15
    (m64n16k16); for 32, columns 32·(kk//2) .. +31 (m64n32k16)."""
    if cg <= 16 and 16 % cg == 0:
        cols = [(16 * kk, 16 * kk + 16) for kk in range(4)]
    elif cg == 32:
        cols = [(32 * (kk // 2), 32 * (kk // 2) + 32) for kk in range(4)]
    else:
        raise ValueError(f"grouped_slices: Cin/G={cg} has no slice map (2, 4, 8, 16, 32)")
    return tuple((kk, lo, hi, lo // 2) for kk, (lo, hi) in enumerate(cols))


WIDE_NA = 128  # accumulator columns of a "wgmma_wide" CTA
WIDE_NW = (16, 32, 64, 128)  # its accumulator columns per group


class WideTile(NamedTuple):
    """One column tile of the "wgmma_wide" route (csrc/grouped_wgmma.cuh):
    its groups, the columns col0 .. col0+width-1 of each, the depth kp of
    one group per tap (Cin/G padded with zeros to a multiple of 16), the
    wgmma width nw of each group's MMAs (group j's accumulators start at
    column j·nw), and the output channels c_lo .. c_hi-1 it writes, which
    are contiguous in y."""

    groups: tuple
    col0: int
    width: int
    kp: int
    nw: int
    c_lo: int
    c_hi: int


def grouped_wide_tiles(cin: int, cout: int, groups: int):
    """The column tiles of the "wgmma_wide" route, as csrc/grouped_wgmma.cuh
    (wide_plan) cuts a grouped conv Cin → Cout in `groups` groups; a work
    item is 128 output pixels of one tile, and a CTA keeps its tile over
    several row tiles of pixels. Cout/G ≤ 128: tiles of whole
    groups, nw the smallest of WIDE_NW that holds Cout/G, up to
    WIDE_NA / nw groups a tile, balanced over the tiles. Wider groups:
    ceil(Cout/G / 128) pieces of each group, each a multiple of 8 columns
    (the last one the rest), nw 128."""
    if groups < 1 or cin % groups or cout % groups:
        raise ValueError(f"grouped_wide_tiles: Cin={cin}, Cout={cout} in {groups} groups")
    cgi, cgo = cin // groups, cout // groups
    kp = -(-cgi // 16) * 16
    tiles = []
    if cgo <= WIDE_NA:
        nw = next(n for n in WIDE_NW if cgo <= n)
        n_ct = -(-groups // (WIDE_NA // nw))
        gp = -(-groups // n_ct)
        for g0 in range(0, groups, gp):
            gs = tuple(range(g0, min(groups, g0 + gp)))
            tiles.append(WideTile(gs, 0, cgo, kp, nw, g0 * cgo, (gs[-1] + 1) * cgo))
    else:
        pieces = -(-cgo // WIDE_NA)
        pwid = -(-(-(-cgo // pieces)) // 8) * 8
        nw = next(n for n in WIDE_NW if pwid <= n)
        for g in range(groups):
            for p in range(pieces):
                col0 = p * pwid
                width = min(pwid, cgo - col0)
                tiles.append(WideTile((g,), col0, width, kp, nw, g * cgo + col0,
                                      g * cgo + col0 + width))
    return tuple(tiles)


class GroupedPlan(NamedTuple):
    """How a grouped conv kernel call runs. route: "wgmma" (bf16, the
    grouped mode of csrc/conv_wgmma.cu), "wgmma_wide" (bf16,
    csrc/grouped_wgmma.cu) or "simt" (the CUDA-core loop of
    csrc/grouped_conv.cu). cg = Cin/G. A CTA owns `bm` output pixels ×
    `bn` output (wgmma_wide: accumulator) columns."""

    route: str
    cg: int
    bm: int = 128
    bn: int = 64

    def partial_rows(self, m: int) -> int:
        """Rows of per-CTA partial sums grouped_conv2d_stats writes for M pixels."""
        return -(-m // self.bm)

    def args(self):
        """The plan as the C entry points take it: route."""
        return (_ROUTES[self.route],)

    def slices(self):
        """The k16 slice map of the wgmma route (`grouped_slices`); none for the others."""
        return grouped_slices(self.cg) if self.route == "wgmma" else ()


def _route_plan(route: str, cg: int) -> GroupedPlan:
    return GroupedPlan(route, cg, 128, WIDE_NA if route == "wgmma_wide" else 64)


def grouped_plan(dtype, cin: int, cout: int, groups: int, aligned: bool = True) -> GroupedPlan:
    """The plan of a grouped conv, Cin → Cout in `groups` groups, in
    `dtype`, dilated or not. bf16 with Cin/G = Cout/G in GROUPED_WGMMA_CG,
    Cin % 64 == 0 and x and w 16-byte aligned (`aligned`): the grouped mode
    of the tensor-core loop ("wgmma"). Every other bf16 shape of
    `fits_grouped` but Cin/G = 2 (Cout/G ≠ Cin/G, Cin/G above 32, Cin not a
    multiple of 64, a misaligned operand): the tensor-core loop of
    csrc/grouped_wgmma.cu ("wgmma_wide"). fp32, and bf16 at Cin/G = 2
    (faster there on the CUDA cores), the CUDA-core loop ("simt")."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped_plan: dtype {dtype} not supported (float32, bfloat16)")
    cg = cin // groups
    if dtype == torch.float32:
        return _route_plan("simt", cg)
    if (cin == cout and cin % 64 == 0 and cin % groups == 0 and cg in GROUPED_WGMMA_CG
            and aligned):
        return _route_plan("wgmma", cg)
    return _route_plan("simt" if cg == 2 else "wgmma_wide", cg)


def _grouped_plan(x, w, geo, groups, route=None) -> GroupedPlan:
    """The plan of a grouped call; `route` forces one (the on-card
    comparison of the main loops), which the library refuses where it is
    not built."""
    cin, cout = geo[3], geo[6]
    if route is not None:
        return _route_plan(route, cin // groups)
    return grouped_plan(x.dtype, cin, cout, groups,
                        aligned=x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def _dense_plan(x, geo) -> ConvPlan:
    n, _, _, cin, oh, ow, cout = geo[:7]
    return conv_plan(x.dtype, n * oh * ow, cin, cout, aligned=x.data_ptr() % 16 == 0)


def _epilogue_operands(scale, shift, cout, device):
    """Both per-channel fp32 vectors, or (None, None) for a plain conv."""
    if scale is None and shift is None:
        return None, None
    if scale is None:
        scale = torch.ones(cout, dtype=torch.float32, device=device)
    if shift is None:
        shift = torch.zeros(cout, dtype=torch.float32, device=device)
    return scale.float().reshape(cout), shift.float().reshape(cout)


def _conv_geometry(name, x, w, stride, padding, groups=1, dilation=1):
    """Check the operands of a conv kernel (dense, or grouped when groups >
    1); return its shape arguments (n, h, w, cin, oh, ow, cout, kh, kw, sh,
    sw, ph, pw, dh, dw)."""
    n, h, wd, cin = x.shape
    kh, kw, wc, cout = w.shape
    if wc * groups != cin:
        raise ValueError(f"{name}: weight expects Cin={wc * groups}, input has {cin}")
    sh, sw = to_pair(stride)
    ph, pw = to_pair(padding)
    dh, dw = to_pair(dilation)
    if groups > 1 and (cout % groups or wc < 2):
        raise ValueError(f"{name}: groups={groups} with Cin={cin}, Cout={cout}: the grouped "
                         f"kernels take groups dividing Cout and Cin/G >= 2 (Cin/G = 1 is "
                         f"depthwise_conv2d's)")
    if not _k.fits_conv((sh, sw), (dh, dw), 1):
        raise ValueError(f"{name}: stride {(sh, sw)}, dilation {(dh, dw)} (each >= 1)")
    _k.check_cuda_operand(f"{name} x", x)
    _k.check_cuda_operand(f"{name} w", w, x.dtype)
    oh = conv_out_size(h, kh, sh, ph, dh)
    ow = conv_out_size(wd, kw, sw, pw, dw)
    if n * oh * ow * cout >= 2 ** 31:
        raise ValueError(f"{name}: output of {n * oh * ow * cout} elements exceeds the "
                         f"kernels' 32-bit indexing")
    return n, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw


def _fused_plain(x, w, scale, shift, stride, padding, relu, groups, dilation=1):
    """The fused kernels' contract in plain PyTorch: fp32 (grouped) conv,
    fp32 epilogue, one cast to x.dtype."""
    scale, shift = _epilogue_operands(scale, shift, w.shape[-1], x.device)
    y = ops.conv2d(x.float(), w.float(), stride=stride, padding=padding, dilation=dilation,
                   groups=groups)
    if scale is not None:
        y = y * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def _with_sums(y):
    """(y, sums), sums the (2, Cout) row [Σ; Σ²] over (N, OH, OW) of
    y.float(): the statistics kernels' contract on the y their plain
    version gives."""
    yf = y.float()
    return y, torch.stack([yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))])


def _count(name, plan, groups):
    """One launch of `name`; a grouped one also under its route."""
    if groups > 1:
        _k.count_launch(name, plan.route)
    else:
        _k.LAUNCHES[name] += 1


def _launch_fused(name, x, w, scale, shift, stride, padding, relu, groups=1, route=None,
                  dilation=1):
    """Check the operands, then launch conv_fused_launch with its plan, or
    grouped_fused_launch with its (groups > 1; `route` forces one), and
    count it under `name`; returns y (N, OH, OW, Cout)."""
    geo = _conv_geometry(name, x, w, stride, padding, groups, dilation)
    n, _, _, _, oh, ow, cout = geo[:7]
    scale, shift = _epilogue_operands(scale, shift, cout, x.device)
    if scale is not None:
        scale, shift = scale.contiguous(), shift.contiguous()
        _k.check_cuda_operand(f"{name} scale", scale, torch.float32)
        _k.check_cuda_operand(f"{name} shift", shift, torch.float32)
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    plan = _grouped_plan(x, w, geo, groups, route) if groups > 1 else _dense_plan(x, geo)
    symbol, extra = (("grouped_fused_launch", (int(groups), *plan.args())) if groups > 1
                     else ("conv_fused_launch", plan.args()))
    rc = getattr(_k.lib(), symbol)(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), y.data_ptr(),
        *geo, *extra, int(relu), _k.stream_ptr(x))
    _k.check_launch(name, rc)
    _count(name, plan, groups)
    return y


def _launch_stats(name, x, w, stride, padding, groups=1, route=None, dilation=1):
    """Check the operands, then launch conv_stats_launch with its plan, or
    grouped_stats_launch with its (groups > 1; `route` forces one): y and
    per-CTA partial sums, one row per tile of output pixels; then the
    fixed-order reduction kernel. Counts both. Returns (y, sums): sums the
    (2, Cout) fp32 row [Σy; Σy²] that the reduction writes."""
    geo = _conv_geometry(name, x, w, stride, padding, groups, dilation)
    n, _, _, _, oh, ow, cout = geo[:7]
    lib = _k.lib()
    if groups > 1:
        plan = _grouped_plan(x, w, geo, groups, route)
        symbol, extra, rows = "grouped_stats_launch", (int(groups), *plan.args()), plan.bm
    else:
        plan = _dense_plan(x, geo)
        symbol, extra, rows = "conv_stats_launch", plan.args(), plan.bm
    blocks = -(-(n * oh * ow) // rows)
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    # rows 0..blocks-1: the per-CTA partial sums; row `blocks`: their reduction
    partial = torch.empty((blocks + 1, 2, cout), dtype=torch.float32, device=x.device)
    sums = partial[blocks]
    stream = _k.stream_ptr(x)
    rc = getattr(lib, symbol)(_k.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                              y.data_ptr(), partial.data_ptr(), *geo, *extra, stream)
    _k.check_launch(name, rc)
    _count(name, plan, groups)
    rc = lib.stats_reduce_launch(partial.data_ptr(), sums.data_ptr(), blocks, cout, stream)
    _k.check_launch("conv2d_stats_reduce", rc)
    _k.LAUNCHES["conv2d_stats_reduce"] += 1
    return y, sums


def conv2d_fused_plain(x, w, scale: Optional[torch.Tensor] = None,
                       shift: Optional[torch.Tensor] = None, *, stride=1, padding=0,
                       relu: bool = False, dilation=1):
    """The kernel's contract in plain PyTorch: fp32 conv, fp32 epilogue,
    one cast to x.dtype."""
    return _fused_plain(x, w, scale, shift, stride, padding, relu, 1, dilation)


def conv2d_fused(x, w, scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None, *, stride=1, padding=0,
                 relu: bool = False, dilation=1):
    """x (N, H, W, Cin) NHWC, w (kh, kw, Cin, Cout) HWIO in x.dtype;
    scale/shift (Cout,) fp32 — the BN-folded multiplier and offset of a
    conv → BN(inference) → ReLU block — or None for a plain conv.
    Any stride and dilation (each axis), any padding. Returns (N, OH, OW,
    Cout)."""
    if x.device.type == "cpu":
        return conv2d_fused_plain(x, w, scale, shift, stride=stride, padding=padding,
                                  relu=relu, dilation=dilation)
    return _launch_fused("conv2d_fused", x, w, scale, shift, stride, padding, relu,
                         dilation=dilation)


def conv2d_stats_plain(x, w, *, stride=1, padding=0, dilation=1):
    """The statistics kernel's contract in plain PyTorch: y as
    conv2d_fused_plain gives it, and the (2, Cout) row of Σ, Σ² over
    (N, OH, OW) of y.float()."""
    return _with_sums(conv2d_fused_plain(x, w, stride=stride, padding=padding,
                                         dilation=dilation))


def conv2d_stats(x, w, *, stride=1, padding=0, dilation=1):
    """Conv forward plus the per-channel batch statistics of its STORED
    output: returns (y, sums), y (N, OH, OW, Cout) in x.dtype, sums the
    fp32 (2, Cout) row [Σy; Σy²] over N·OH·OW (conv.py:534-538: the sums
    of the rounded y keep the fused path consistent with conv → BN over
    y), one buffer that a mesh all-reduces in place. Two launches: the
    conv with per-block partial sums, then their fixed-order sum."""
    if x.device.type == "cpu":
        return conv2d_stats_plain(x, w, stride=stride, padding=padding, dilation=dilation)
    return _launch_stats("conv2d_stats", x, w, stride, padding, dilation=dilation)


def grouped_conv2d_fused_plain(x, w, groups: int, scale: Optional[torch.Tensor] = None,
                               shift: Optional[torch.Tensor] = None, *, stride=1, padding=0,
                               relu: bool = False, dilation=1):
    """The grouped kernel's contract in plain PyTorch: fp32 grouped conv,
    fp32 epilogue, one cast to x.dtype."""
    return _fused_plain(x, w, scale, shift, stride, padding, relu, groups, dilation)


def grouped_conv2d_fused(x, w, groups: int, scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None, *, stride=1, padding=0,
                         relu: bool = False, dilation=1):
    """conv2d_fused for a grouped conv: x (N, H, W, Cin), w (kh, kw, Cin/G,
    Cout) in x.dtype, output channel c reading group c // (Cout/G) only.
    Envelope `fits_grouped` (Cin/G >= 2, any number of groups, stride and
    dilation); the main loop is the one `grouped_plan` picks. Returns (N,
    OH, OW, Cout)."""
    if x.device.type == "cpu":
        return grouped_conv2d_fused_plain(x, w, groups, scale, shift, stride=stride,
                                          padding=padding, relu=relu, dilation=dilation)
    return _launch_fused("grouped_conv2d_fused", x, w, scale, shift, stride, padding, relu,
                         groups, dilation=dilation)


def grouped_conv2d_stats_plain(x, w, groups: int, *, stride=1, padding=0, dilation=1):
    """The grouped statistics kernel's contract in plain PyTorch."""
    return _with_sums(grouped_conv2d_fused_plain(x, w, groups, stride=stride, padding=padding,
                                                 dilation=dilation))


def grouped_conv2d_stats(x, w, groups: int, *, stride=1, padding=0, dilation=1):
    """conv2d_stats for a grouped conv: (y, sums) of the stored y, sums the
    (2, Cout) row [Σy; Σy²]. Two launches: the grouped conv with per-block
    partial sums, then the same fixed-order reduction kernel as
    conv2d_stats."""
    if x.device.type == "cpu":
        return grouped_conv2d_stats_plain(x, w, groups, stride=stride, padding=padding,
                                          dilation=dilation)
    return _launch_stats("grouped_conv2d_stats", x, w, stride, padding, groups,
                         dilation=dilation)


def conv2d_backward(x, w, g, stride, padding, need=(True, True), groups=1, dilation=1):
    """(dx, dw) of y = conv(x, w) for the cotangent g, NHWC / HWIO in
    x.dtype; an entry is None where `need` says so. Plain PyTorch
    (aten.convolution_backward on channels_last views; cuDNN on the card):
    the JAX package leaves these transposed convs to XLA (conv.py:688-695,
    :712-719, fused.py:99-102), outside any Pallas kernel. g and x are made
    dense NHWC first: a cotangent that autograd hands back as a slice of a
    concat along C (DenseNet's, e.g. (2, 1, 1, 32) with strides (1024,
    1024, 1024, 1)) is no channels_last tensor, and ATen's backward must
    not be given one."""
    wc = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)  # OIHW, channels_last
    g, x = g.to(x.dtype).contiguous(), x.contiguous()
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, None,
        list(to_pair(stride)), list(to_pair(padding)), list(to_pair(dilation)), False, [0, 0],
        groups,
        [bool(need[0]), bool(need[1]), False])
    if dx is not None:
        dx = dx.permute(0, 2, 3, 1).contiguous()
    if dw is not None:
        dw = dw.permute(2, 3, 1, 0).contiguous()
    return dx, dw


class _Conv2dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, groups, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        ctx.groups, ctx.dilation = groups, dilation
        if groups == 1:
            return _k.conv2d_fused(x, w, stride=stride, padding=padding, dilation=dilation)
        return _k.grouped_conv2d_fused(x, w, groups, stride=stride, padding=padding,
                                       dilation=dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_backward(x, w, g, *ctx.conf, need=ctx.needs_input_grad[:2],
                                 groups=ctx.groups, dilation=ctx.dilation)
        return dx, dw, None, None, None, None


def conv2d_train(x, w, stride=1, padding=0, dilation=1):
    """Trainable conv (conv.py:conv2d_train): forward through the
    conv2d_fused kernel with no epilogue, dx and dw by transposed
    convolution in plain PyTorch."""
    return _Conv2dTrain.apply(x, w, stride, padding, 1, dilation)


def grouped_conv2d_train(x, w, groups: int, stride=1, padding=0, dilation=1):
    """Trainable grouped conv (conv.py:grouped_conv2d_train): forward
    through the grouped_conv2d_fused kernel with no epilogue, dx and dw by
    the grouped conv's VJP in plain PyTorch with the cotangent cast to
    x.dtype (conv.py:662-668); dw comes back (kh, kw, Cin/G, Cout)."""
    return _Conv2dTrain.apply(x, w, stride, padding, groups, dilation)
