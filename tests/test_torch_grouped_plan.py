"""The grouped conv kernels' dispatch (`grouped_plan`, ops/kernels/conv.py)
and the slice map of its tensor-core route, on the CPU.

`grouped_plan` maps dtype and shape to the main loop that runs a grouped
conv on the card: bf16 at Cin/G = Cout/G in {4, 8, 16, 32} with Cin % 64
== 0 on the tensor cores (the grouped mode of csrc/conv_wgmma.cu), the
other bf16 shapes but Cin/G = 2 on the tensor cores of
csrc/grouped_wgmma.cu, fp32 and bf16 Cin/G = 2 on the CUDA cores
(csrc/grouped_conv.cu). The
card's kernels cannot run here; chip_smoke.py holds each route against
the plain version there. These tests walk every grouped conv of the
port's ResNeXt kinds at 224² (module shapes only, no weights), check the
wrappers' launch arguments against a recording stand-in for the library,
and check the k16 slice map that the tensor-core route multiplies by:
its blocks cover every nonzero of the JAX package's block-diagonal weight
(ops/pallas/conv.py:block_diag_weight) exactly once, and a product over
those blocks alone equals the JAX grouped conv. Inputs are made with
numpy from a seed.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from convnets_tpu.ops.conv import conv2d as jax_conv2d
from convnets_tpu.ops.pallas.conv import block_diag_weight
from convnets_tpu_torch import nn
from convnets_tpu_torch.core.precision import policy_from_setting
from convnets_tpu_torch.core.shapes import conv_out_size
from convnets_tpu_torch.models import base
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.ops.kernels import conv as kconv

KINDS = ["26", "50", "101"]


def _grouped_convs(kind):
    """(H, W, Cin, Cout, k, stride, pad, groups) of every grouped conv of
    ResNeXt `kind` at 224², from its unbuilt modules."""
    setting = chip_smoke.model_setting("resnext", 0, True, kind=kind)
    with nn.use_policy(policy_from_setting(setting)):
        model = base._REGISTRY["resnext"](setting)
    return [(h, w, cin, cout, k, s, p, g) for kind_, h, w, cin, cout, k, s, p, _, g
            in chip_smoke.model_layers(model) if kind_ == "gconv"]


@pytest.mark.parametrize("batch", [1, 8, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_every_resnext_grouped_conv_has_a_tensor_core_plan(kind, batch):
    convs = _grouped_convs(kind)
    assert convs and all(g == 32 for *_, g in convs)
    if kind == chip_smoke.FAMILIES["resnext"]:  # phase 9's kind: one grouped_conv2d_fused
        # launch per grouped layer of a forward
        assert len(convs) == chip_smoke.SERVE_LAUNCHES["resnext"]["grouped_conv2d_fused"]
    if kind == chip_smoke.GROUPED_SHAPES_KIND:  # phases 8 and 8b's shapes
        assert len(convs) == chip_smoke.GROUPED_SHAPES_LAYERS
    for h, w, cin, cout, k, s, p, g in convs:
        assert kernels.fits_grouped(cin, cout, s, 1, g)
        m = batch * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
        bf = kernels.grouped_plan(torch.bfloat16, cin, cout, g)
        assert bf == kernels.GroupedPlan("wgmma", cin // g, 128, 64)
        assert bf.args() == (1,) and bf.partial_rows(m) == -(-m // 128)
        assert bf.slices() == kernels.grouped_slices(cin // g)
        fp = kernels.grouped_plan(torch.float32, cin, cout, g)
        assert fp == kernels.GroupedPlan("simt", cin // g)
        assert fp.args() == (0,) and fp.slices() == ()


def test_resnext_grouped_widths_reach_every_tensor_core_width():
    cgs = {cin // g for kind in KINDS for _, _, cin, _, _, _, _, g in _grouped_convs(kind)}
    assert cgs == set(kconv.GROUPED_WGMMA_CG)


@pytest.mark.parametrize("cin,cout,groups,aligned,why,route,code", [
    (64, 64, 32, True, "Cin/G = 2", "simt", 0),
    (128, 256, 32, True, "Cout/G != Cin/G", "wgmma_wide", 2),
    (96, 96, 24, True, "Cin not a multiple of 64", "wgmma_wide", 2),
    (128, 128, 32, False, "a misaligned operand", "wgmma_wide", 2),
    (136, 544, 4, True, "Cin/G above 32 (ShuffleNet-g4)", "wgmma_wide", 2),
    (68, 248, 4, True, "odd Cin/G (ShuffleNet-g4)", "wgmma_wide", 2),
])
def test_bf16_shapes_off_the_plan_take_the_cuda_cores(cin, cout, groups, aligned, why, route,
                                                      code):
    """bf16 shapes off the grouped mode's plan: Cin/G = 2 stays on the
    CUDA-core loop; every other one runs on the tensor cores of
    csrc/grouped_wgmma.cu ("wgmma_wide")."""
    assert kernels.fits_grouped(cin, cout, 1, 1, groups)
    plan = kernels.grouped_plan(torch.bfloat16, cin, cout, groups, aligned=aligned)
    assert plan.route == route and plan.args() == (code,), why


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_grouped_plan_raises_for_other_dtypes(dtype):
    with pytest.raises(TypeError):
        kernels.grouped_plan(dtype, 128, 128, 32)


@pytest.mark.parametrize("cg", [3, 64])
def test_slice_map_raises_for_widths_it_cannot_tile(cg):
    with pytest.raises(ValueError):
        kernels.grouped_slices(cg)


@pytest.mark.parametrize("cg", [2, 4, 8, 16, 32])
def test_slice_map_covers_the_block_diagonal_once(cg):
    """At Cin = Cout = 128 (two CTAs of 64 columns), every nonzero (k, c)
    of block_diag_weight lies in the slab of its column tile (k // 64 ==
    c // 64) and in exactly one block (k16 slice × column range) of that
    CTA's slice map; each block's accumulators start where the n64
    fragment keeps its first column (c / 2)."""
    cin = 128
    w = np.random.RandomState(cg).randn(1, 1, cg, cin).astype(np.float32) + 3.0  # no zeros
    dense = np.asarray(block_diag_weight(jnp.asarray(w), cin // cg))[0, 0]
    rows, cols = np.nonzero(dense)
    assert len(rows) == cg * cin
    assert (rows // 64 == cols // 64).all()
    cover = np.zeros((64, 64), np.int64)
    slices = kernels.grouped_slices(cg)
    assert [kk for kk, *_ in slices] == [0, 1, 2, 3]
    for kk, lo, hi, acc in slices:
        assert acc == lo // 2 and hi - lo in (16, 32)
        cover[16 * kk:16 * kk + 16, lo:hi] += 1
    assert (cover[rows % 64, cols % 64] == 1).all()
    # the blocks hold no more than the MMAs multiply: 16 or 32 columns per slice
    assert cover.sum() == sum(16 * (hi - lo) for _, lo, hi, _ in slices)


def _sliced_grouped_conv(x, w, groups, stride, padding):
    """The tensor-core route's arithmetic in plain PyTorch, fp32: per CTA
    column tile j (64 output channels), per tap, the tap's block-diagonal
    64 × 64 B built from w as stored, and per k16 slice of the input slab
    one product into the accumulator columns the slice map names."""
    n, h, wd, cin = x.shape
    kh, kw, cg, cout = w.shape
    oh, ow = conv_out_size(h, kh, stride, padding), conv_out_size(wd, kw, stride, padding)
    xp = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    acc = torch.zeros(n * oh * ow, cout)
    plan = kernels.grouped_plan(torch.bfloat16, cin, cout, groups)
    assert plan.route == "wgmma" or cg == 2
    for ky in range(kh):
        for kx in range(kw):
            tap = xp[:, ky:ky + stride * (oh - 1) + 1:stride,
                     kx:kx + stride * (ow - 1) + 1:stride].reshape(-1, cin)
            for j in range(cout // 64):
                b = torch.zeros(64, 64)
                for c in range(64):
                    g = c // cg  # the CTA's local group; its slab rows g*cg .. g*cg+cg-1
                    b[g * cg:g * cg + cg, c] = w[ky, kx, :, 64 * j + c]
                slab = tap[:, 64 * j:64 * j + 64]
                for kk, lo, hi, _ in kernels.grouped_slices(cg):
                    acc[:, 64 * j + lo:64 * j + hi] += (slab[:, 16 * kk:16 * kk + 16]
                                                       @ b[16 * kk:16 * kk + 16, lo:hi])
    return acc.reshape(n, oh, ow, cout)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cg", [2, 4, 8, 16, 32])
def test_product_over_the_slice_blocks_matches_jax_grouped_conv(cg, stride):
    cin = 128
    groups = cin // cg
    rng = np.random.RandomState(10 * cg + stride)
    x = rng.randn(2, 7, 7, cin).astype(np.float32)
    w = (rng.randn(3, 3, cg, cin) / np.sqrt(9 * cg)).astype(np.float32)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=1,
                                 groups=groups))
    got = _sliced_grouped_conv(torch.from_numpy(x), torch.from_numpy(w), groups, stride, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


class _RecordingLib:
    """Stands in for the kernel library: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recording_lib(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(kernels, "lib", lambda: lib)
    monkeypatch.setattr(kernels, "check_cuda_operand", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    saved = dict(kernels.LAUNCHES)
    yield lib
    kernels.LAUNCHES.update(saved)


@pytest.mark.parametrize("dtype,cin,route", [
    (torch.bfloat16, 128, 1), (torch.float32, 128, 0), (torch.bfloat16, 64, 0)])
def test_wrappers_pass_the_plan_route(recording_lib, dtype, cin, route):
    """The launch arguments end (…, groups, route, relu, stream) for the
    fused entry and (…, groups, route, stream) for the statistics entry,
    whose partial rows are one per 128 output pixels."""
    groups = 32
    x = torch.zeros(3, 10, 10, cin, dtype=dtype)
    w = torch.zeros(3, 3, cin // groups, cin, dtype=dtype)
    kconv._launch_fused("grouped_conv2d_fused", x, w, None, None, 2, 1, True, groups)
    kconv._launch_stats("grouped_conv2d_stats", x, w, 2, 1, groups)
    (fname, fargs), (sname, sargs), (rname, rargs) = recording_lib.calls
    assert (fname, sname, rname) == ("grouped_fused_launch", "grouped_stats_launch",
                                     "stats_reduce_launch")
    assert fargs[-4:] == (groups, route, 1, 0)
    assert sargs[-3:] == (groups, route, 0)
    assert fargs[6:19] == sargs[5:18] == (3, 10, 10, cin, 5, 5, cin, 3, 3, 2, 2, 1, 1)
    assert rargs[2:4] == (-(-3 * 5 * 5 // 128), cin)
