"""The "wgmma_wide" route of the grouped conv kernels (csrc/grouped_wgmma.cu)
on the CPU: its plan, its tile map, a product over that map, and the
wrappers' launch arguments.

`grouped_plan` sends every bf16 grouped conv off the grouped mode of
csrc/conv_wgmma.cu but Cin/G = 2 to the route: ShuffleNet-v1's grouped
1x1s (Cin/G 12-400, Cout/G 12-400) at every kind, fp32 to the CUDA-core
loop. `grouped_wide_tiles` mirrors the kernel's tile map (wide_plan): the
CTA's column tiles of whole groups or of pieces of a wide group, each
group's depth padded to 16 per tap and its own chain of MMAs into nw
accumulator columns. The card's kernel cannot run here; chip_smoke.py
phase 14 holds it against the plain version there. These tests check the
map's coverage and that a product over the map, with its zero padding,
packs and splits, equals the JAX package's grouped conv: its Pallas kernel
in interpret mode on the block-diagonal weight where Cin/G <= 32, XLA's
grouped conv above (what the JAX package runs at each). Inputs are made
with numpy from a seed.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from convnets_tpu.ops.conv import conv2d as jax_conv2d
from convnets_tpu.ops.pallas.conv import grouped_conv2d_train as jax_grouped_conv2d_train
from convnets_tpu_torch.core.shapes import conv_out_size
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.ops.kernels import conv as kconv
from convnets_tpu_torch.settings import Settings
from test_torch_grouped_plan import recording_lib  # noqa: F401  (fixture)

SHUFFLE_KINDS = ("g2", "g3", "g4", "g8")
IMAGES = (32, 224)
# grouped convs of one ShuffleNet-v1 forward (every kind: 16 units, the
# first one's compress conv dense)
SHUFFLE_GROUPED = 31


def _shuffle_convs(kind, image):
    """(H, W, Cin, Cout, k, stride, pad, dilation, groups) of every grouped
    conv of ShuffleNet-v1 `kind` at image², read off its modules (built on
    the CPU, no weights drawn)."""
    model = build_model("shufflenet_v1", Settings(kind=kind, input_size=(3, image, image),
                                                  num_classes=10), device="cpu")
    return [(h, w, cin, cout, k, s, p, d, g) for layer, h, w, cin, cout, k, s, p, _, g, d
            in chip_smoke.model_layers(model, with_dilation=True) if layer.endswith("gconv")]


_SHAPES = {(kind, image): _shuffle_convs(kind, image) for kind in SHUFFLE_KINDS
           for image in IMAGES}
# every distinct (Cin, Cout, groups) of the four kinds
CHANNELS = sorted({(c[2], c[3], c[8]) for convs in _SHAPES.values() for c in convs})


@pytest.mark.parametrize("image", IMAGES)
@pytest.mark.parametrize("kind", SHUFFLE_KINDS)
def test_every_shufflenet_grouped_conv_takes_the_wide_route(kind, image):
    convs = _SHAPES[(kind, image)]
    assert len(convs) == SHUFFLE_GROUPED
    for h, w, cin, cout, k, s, p, d, g in convs:
        assert (k, s, p, d) == (1, 1, 0, 1) and cout // g != cin // g
        assert kernels.fits_grouped(cin, cout, s, d, g)
        bf = kernels.grouped_plan(torch.bfloat16, cin, cout, g)
        assert bf == kernels.GroupedPlan("wgmma_wide", cin // g, 128, 128)
        assert bf.args() == (2,) and bf.slices() == ()
        m = 256 * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
        assert bf.partial_rows(m) == -(-m // 128)
        # a misaligned operand keeps the route: it copies what the alignment allows
        assert kernels.grouped_plan(torch.bfloat16, cin, cout, g, aligned=False) == bf
        fp = kernels.grouped_plan(torch.float32, cin, cout, g)
        assert fp == kernels.GroupedPlan("simt", cin // g) and fp.args() == (0,)


def test_shufflenet_reaches_narrow_and_wide_groups():
    """The route serves both what the JAX package runs on its Pallas kernel
    (Cin/G <= 32) and what it leaves to XLA (Cin/G > 32), odd Cin/G
    (2-byte aligned slabs) and Cout/G above 128 (split groups)."""
    cgis = {cin // g for cin, _, g in CHANNELS}
    cgos = {cout // g for _, cout, g in CHANNELS}
    assert {12, 17, 20, 24, 25} <= cgis and {34, 48, 68, 100, 400} <= cgis
    assert any(c % 2 for c in cgis) and max(cgos) == 400 and min(cgos) == 12


@pytest.mark.parametrize("kind", ["26", "50"])
def test_resnext_keeps_the_grouped_mode(kind):
    """ResNeXt's grouped 3x3s (Cin/G = Cout/G, Cin % 64 == 0) stay on the
    grouped mode of csrc/conv_wgmma.cu."""
    model = build_model("resnext", Settings(kind=kind, input_size=(3, 224, 224),
                                            num_classes=10), device="cpu")
    convs = [(cin, cout, g) for layer, _, _, cin, cout, *_, g in chip_smoke.model_layers(model)
             if layer == "gconv"]
    assert convs
    for cin, cout, g in convs:
        assert kernels.grouped_plan(torch.bfloat16, cin, cout, g).route == "wgmma"


def _check_tiles(cin, cout, groups):
    """The tile map of one shape: every (group, output channel) in exactly
    one tile, each tile's columns contiguous in y and at most 256 wide (at
    most 128 accumulator columns here), each group's depth its own input
    channels padded with zeros to a multiple of 16."""
    cgi, cgo = cin // groups, cout // groups
    tiles = kernels.grouped_wide_tiles(cin, cout, groups)
    cover = np.zeros(cout, np.int64)
    for t in tiles:
        assert t.kp % 16 == 0 and cgi <= t.kp < cgi + 16
        assert t.nw in kconv.WIDE_NW and t.width <= t.nw
        assert len(t.groups) * t.nw <= kconv.WIDE_NA <= 256
        assert t.c_hi - t.c_lo == len(t.groups) * t.width <= 256
        assert list(t.groups) == list(range(t.groups[0], t.groups[-1] + 1))
        assert len(t.groups) == 1 or (t.col0, t.width) == (0, cgo)
        for j, g in enumerate(t.groups):
            # accumulator columns j*nw .. j*nw+width-1 hold channels g*cgo+col0 ..
            chans = g * cgo + t.col0 + np.arange(t.width)
            assert (chans == t.c_lo + j * t.width + np.arange(t.width)).all()
            assert (chans // cgo == g).all()
            cover[chans] += 1
            # pack depth j*kp + k reads input channel g*cgi + k for k < cgi, zero after
            depth = _pack_depth(t, cgi)[j * t.kp:(j + 1) * t.kp]
            assert (depth[:cgi] == g * cgi + np.arange(cgi)).all()
            assert (depth[cgi:] == -1).all()
    assert (cover == 1).all()
    return tiles


def _pack_depth(tile, cgi):
    """The input channel each depth position of a tile's pack reads (-1:
    a zero of the padding)."""
    depth = np.full(len(tile.groups) * tile.kp, -1)
    for j, g in enumerate(tile.groups):
        depth[j * tile.kp:j * tile.kp + cgi] = g * cgi + np.arange(cgi)
    return depth


@pytest.mark.parametrize("cin,cout,groups", CHANNELS)
def test_tile_map_covers_every_shufflenet_channel_once(cin, cout, groups):
    tiles = _check_tiles(cin, cout, groups)
    cgo = cout // groups
    if cgo > 128:  # split into pieces of a multiple of 8 columns, the last the rest
        assert all(len(t.groups) == 1 and t.nw == 128 for t in tiles)
        assert all(t.width % 8 == 0 for t in tiles if t.col0 + t.width < cgo)
    else:  # packed whole groups, the smallest width that holds a group
        assert all(t.nw == min(n for n in kconv.WIDE_NW if n >= cgo) for t in tiles)


@pytest.mark.parametrize("cin,cout,groups", [
    (64, 64, 32), (64, 128, 32), (96, 96, 24), (200, 600, 2), (258, 774, 2), (45, 90, 3),
    (512, 512, 64), (30, 1290, 5)])
def test_tile_map_covers_other_shapes_once(cin, cout, groups):
    """Shapes beyond ShuffleNet's: Cin/G = 2, Cin not a multiple of 64,
    three pieces, odd widths, 64 groups."""
    _check_tiles(cin, cout, groups)


def _tile_product(x, w, groups, stride, padding, dilation):
    """The route's arithmetic in plain PyTorch, fp32: per column tile and
    tap, the tile's pack of A (each group's Cin/G channels padded with
    zeros to kp) times each group's own B (kp x nw: its weights as stored,
    zero rows past Cin/G and zero columns past its width) into that
    group's accumulators, then the accumulators' columns of each group to
    the tile's contiguous output channels."""
    n, h, wd, cin = x.shape
    kh, kw, cgi, cout = w.shape
    oh = conv_out_size(h, kh, stride, padding, dilation)
    ow = conv_out_size(wd, kw, stride, padding, dilation)
    xp = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    cgo = cout // groups
    y = torch.full((n * oh * ow, cout), float("nan"))
    for t in kernels.grouped_wide_tiles(cin, cout, groups):
        acc = torch.zeros(n * oh * ow, len(t.groups) * t.nw)
        depth = _pack_depth(t, cgi)
        for ky in range(kh):
            for kx in range(kw):
                r0, c0 = ky * dilation, kx * dilation
                tap = xp[:, r0:r0 + stride * (oh - 1) + 1:stride,
                         c0:c0 + stride * (ow - 1) + 1:stride].reshape(-1, cin)
                a = torch.zeros(tap.shape[0], len(depth))
                a[:, depth >= 0] = tap[:, depth[depth >= 0]]
                for j, g in enumerate(t.groups):
                    b = torch.zeros(t.kp, t.nw)
                    col = g * cgo + t.col0
                    b[:cgi, :t.width] = w[ky, kx, :, col:col + t.width]
                    # k16 slices of the group's depth, each one MMA into its columns
                    for q in range(t.kp // 16):
                        rows = slice(j * t.kp + 16 * q, j * t.kp + 16 * q + 16)
                        acc[:, j * t.nw:(j + 1) * t.nw] += a[:, rows] @ b[16 * q:16 * q + 16]
        for j, g in enumerate(t.groups):
            lo = t.c_lo + j * t.width
            y[:, lo:lo + t.width] = acc[:, j * t.nw:j * t.nw + t.width]
    return y.reshape(n, oh, ow, cout)


def _shuffle_channels(kind):
    return sorted({(c[2], c[3], c[8]) for image in IMAGES for c in _SHAPES[(kind, image)]})


@pytest.mark.parametrize("cin,cout,groups", _shuffle_channels("g4") + _shuffle_channels("g8"))
def test_product_over_the_tile_map_matches_jax_grouped_conv(cin, cout, groups):
    """ShuffleNet-g4's and g8's channel widths at a tiny N·H·W (2 x 3 x 3,
    the 1x1 at stride 1 as the model runs it): fp32, only the order of
    the sums differs."""
    cgi = cin // groups
    rng = np.random.RandomState(cin + 7 * cout + groups)
    x = rng.randn(2, 3, 3, cin).astype(np.float32)
    w = (rng.randn(1, 1, cgi, cout) / np.sqrt(cgi)).astype(np.float32)
    if cgi <= 32:  # the JAX package's Pallas kernel on the block-diagonal weight
        want = jax_grouped_conv2d_train(jnp.asarray(x), jnp.asarray(w), groups, 1, 0,
                                        interpret=True)
    else:  # XLA's grouped conv, which the JAX package runs there
        want = jax_conv2d(jnp.asarray(x), jnp.asarray(w), groups=groups)
    want = np.asarray(want)
    got = _tile_product(torch.from_numpy(x), torch.from_numpy(w), groups, 1, 0, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cin,cout,groups,k,stride,padding,dilation", [
    (34, 102, 2, 3, 2, 1, 1), (68, 24, 4, 3, 1, 2, 2), (400, 600, 2, 1, 2, 0, 1)])
def test_product_over_the_tile_map_with_taps_matches_jax(cin, cout, groups, k, stride,
                                                          padding, dilation):
    """The taps, strides and dilation the route takes beyond ShuffleNet's
    1x1s (odd Cin/G, a split group), against XLA's grouped conv."""
    cgi = cin // groups
    rng = np.random.RandomState(k + cin)
    x = rng.randn(2, 6, 5, cin).astype(np.float32)
    w = (rng.randn(k, k, cgi, cout) / np.sqrt(k * k * cgi)).astype(np.float32)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding,
                                 dilation=dilation, groups=groups))
    got = _tile_product(torch.from_numpy(x), torch.from_numpy(w), groups, stride, padding,
                        dilation).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("h,cin,cout,groups", [(28, 68, 248, 4), (7, 1536, 384, 8),
                                               (14, 100, 400, 2)])
def test_wrappers_pass_the_wide_route(recording_lib, h, cin, cout, groups):
    """The launch arguments end (…, groups, 2, relu, stream) for the fused
    entry and (…, groups, 2, stream) for the statistics entry, whose
    partial rows are one per 128 output pixels; each launch is counted
    under its route."""
    x = torch.zeros(3, h, h, cin, dtype=torch.bfloat16)
    w = torch.zeros(1, 1, cin // groups, cout, dtype=torch.bfloat16)
    saved = {k: dict(v) for k, v in kernels.ROUTE_LAUNCHES.items()}
    kernels.reset_launches()
    try:
        kconv._launch_fused("grouped_conv2d_fused", x, w, None, None, 1, 0, True, groups)
        kconv._launch_stats("grouped_conv2d_stats", x, w, 1, 0, groups)
        routes = {k: dict(kernels.ROUTE_LAUNCHES[k])
                  for k in ("grouped_conv2d_fused", "grouped_conv2d_stats")}
    finally:
        for k, v in saved.items():
            kernels.ROUTE_LAUNCHES[k].update(v)
    (fname, fargs), (sname, sargs), (rname, rargs) = recording_lib.calls
    assert (fname, sname, rname) == ("grouped_fused_launch", "grouped_stats_launch",
                                     "stats_reduce_launch")
    assert fargs[-4:] == (groups, 2, 1, 0) and sargs[-3:] == (groups, 2, 0)
    assert fargs[6:21] == sargs[5:20] == (3, h, h, cin, h, h, cout, 1, 1, 1, 1, 0, 0, 1, 1)
    assert rargs[2:4] == (-(-3 * h * h // 128), cout)
    assert routes == {name: {"wgmma": 0, "wgmma_wide": 1, "simt": 0} for name in routes}
