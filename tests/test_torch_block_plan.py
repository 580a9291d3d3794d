"""The whole-bottleneck-block kernel's dispatch (`block_plan`,
ops/kernels/block.py) and the tiled dataflow of its tensor-core route, on
the CPU.

`block_plan` maps dtype and shape to the route that runs a block on the
card: bf16 at Cmid in {64, 128, 256} with Cin % 64 == 0 on the tensor cores
(csrc/block_wgmma.cu: a CTA owns th whole output rows of one image, h1
covers them and the row above and below, three chained wgmma products with
h1 and h2 in shared memory), fp32 and the other bf16 shapes on the CUDA
cores (csrc/block.cu). The card's kernels cannot run here; chip_smoke.py
holds each route against the plain version there. These tests check the
plan at RN50's identity shapes, compute the block tile by tile exactly as
the plan cuts it (`_tiled_block`) against the plain version and the JAX
package, and check the wrapper's launch arguments against a recording
stand-in for the library. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from convnets_tpu.ops.pallas.block import bottleneck_block as jax_bottleneck_block
from convnets_tpu.ops.pallas.block import bottleneck_block_reference
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.ops.kernels import block as kblock

MAX_SMEM = 232448  # the H100's shared memory per block
# RN50's identity bottlenecks inside the envelope: (H, Cin, Cmid), the th
# that the plan gives, and the share of MMA rows that hold no pixel: conv1's
# (m1 − (th + 2)·W) / m1, and conv2/conv3's (128 − th·W) / 128
RN50_IDENTITY = [
    ((56, 256, 64), 2, 32 / 256, 16 / 128),
    ((28, 512, 128), 4, 24 / 192, 16 / 128),
    ((14, 1024, 256), 7, 2 / 128, 30 / 128),
]


@pytest.mark.parametrize("batch", [8, 256])
@pytest.mark.parametrize("shape,th,pad1,pad23", RN50_IDENTITY)
def test_rn50_identity_shapes_take_the_tensor_cores(shape, th, pad1, pad23, batch):
    h, cin, cmid = shape
    assert shape in chip_smoke.BLOCK_CHECK_SHAPES
    plan = kernels.block_plan(torch.bfloat16, batch, h, h, cin, cmid)
    assert plan.route == "wgmma" and plan.th == th
    assert plan.args() == (1, th)
    # the tiles cover the image's rows exactly once
    rows = [r for r0, n in plan.tiles(h) for r in range(r0, r0 + n)]
    assert rows == list(range(h))
    assert plan.smem <= MAX_SMEM
    # conv1's MMA rows: (th + 2)·W h1 pixels in 64-row blocks, at most 2
    # blocks at Cmid = 256, 4 below; conv2/conv3's 128 rows hold th·W
    assert plan.m1 == 64 * -(-(th + 2) * h // 64) <= (128 if cmid == 256 else 256)
    assert th * h <= 128
    assert (plan.m1 - (th + 2) * h) / plan.m1 == pad1
    assert (128 - th * h) / 128 == pad23
    # the MMAs' work over the useful work (conv1 over the tile's pixels)
    useful = th * h * (2 * cin * cmid + 9 * cmid * cmid)
    done = plan.m1 * cin * cmid + 128 * (9 * cmid * cmid + cmid * cin)
    assert 1.0 < done / useful < 1.45


@pytest.mark.parametrize("dtype,shape,aligned", [
    (torch.float32, (56, 256, 64), True), (torch.float32, (14, 1024, 256), True),
    (torch.bfloat16, (14, 1024, 32), True), (torch.bfloat16, (14, 96, 64), True),
    (torch.bfloat16, (28, 512, 128), False), (torch.bfloat16, (150, 256, 64), True),
    (torch.bfloat16, (56, 1024, 256), True)])
def test_other_shapes_take_the_cuda_cores(dtype, shape, aligned):
    """fp32; Cmid = 32; Cin % 64 != 0; a misaligned operand; a width with no
    tile (W > 128; W > 42 at Cmid = 256)."""
    h, cin, cmid = shape
    plan = kernels.block_plan(dtype, 8, h, h, cin, cmid, aligned)
    assert plan == kernels.BlockPlan("simt") and plan.args() == (0, 0) and plan.tiles(h) == ()


def test_outside_the_envelope_raises():
    with pytest.raises(NotImplementedError):
        kernels.block_plan(torch.bfloat16, 8, 7, 7, 2048, 512)
    x = torch.zeros(1, 7, 7, 2048, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError):
        kernels.bottleneck_block(x, torch.zeros(2048, 512, device="meta"), None, None,
                                 torch.zeros(3, 3, 512, 512, device="meta"), None, None,
                                 torch.zeros(512, 2048, device="meta"), None, None)
    with pytest.raises(TypeError):
        kernels.block_plan(torch.float16, 8, 14, 14, 1024, 256)


# --- the tiled dataflow -----------------------------------------------------

def _tiled_block(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, th, relu_out=True):
    """The block as the tensor-core route computes it, in torch on the CPU:
    per image, per tile of th output rows, h1 over the tile's rows and the
    row above and below (zero rows outside the image) with zero border
    columns, conv2 as 9 shifted products over that bordered tile, conv3
    plus the residual. Rounds where the kernel does: h1, h2, out."""
    n, h, w, cin = x.shape
    cmid = w1.shape[1]
    s1, b1, s2, b2 = (v.float()[:cmid] for v in (s1, b1, s2, b2))
    out = torch.empty_like(x)
    for r0, rows in kernels.BlockPlan("wgmma", th).tiles(h):
        lo, hi = max(r0 - 1, 0), min(r0 + rows + 1, h)  # the halo, clipped
        h1 = torch.zeros((n, rows + 2, w + 2, cmid))
        xs = x[:, lo:hi].float().reshape(-1, cin)
        v = torch.clamp_min(xs @ w1.float() * s1 + b1, 0.0).to(x.dtype).float()
        h1[:, lo - (r0 - 1):hi - (r0 - 1), 1:w + 1] = v.reshape(n, hi - lo, w, cmid)
        acc = torch.zeros((n * rows * w, cmid))
        for ky in range(3):
            for kx in range(3):
                tap = h1[:, ky:ky + rows, kx:kx + w].reshape(-1, cmid)
                acc += tap @ w2[ky, kx].float()
        h2 = torch.clamp_min(acc * s2 + b2, 0.0).to(x.dtype).float()
        y = (h2 @ w3.float() * s3.float() + b3.float()
             + x[:, r0:r0 + rows].float().reshape(-1, cin))
        if relu_out:
            y = torch.clamp_min(y, 0.0)
        out[:, r0:r0 + rows] = y.reshape(n, rows, w, cin).to(x.dtype)
    return out


def _block_inputs(seed, n, h, cin, cmid):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, h, h, cin).astype(np.float32),
            (rng.randn(cin, cmid) / np.sqrt(cin)).astype(np.float32),
            rng.uniform(0.5, 1.5, cmid).astype(np.float32),
            (0.1 * rng.randn(cmid)).astype(np.float32),
            (rng.randn(3, 3, cmid, cmid) / np.sqrt(9 * cmid)).astype(np.float32),
            rng.uniform(0.5, 1.5, cmid).astype(np.float32),
            (0.1 * rng.randn(cmid)).astype(np.float32),
            (rng.randn(cmid, cin) / np.sqrt(cmid)).astype(np.float32),
            rng.uniform(0.5, 1.5, cin).astype(np.float32),
            (0.1 * rng.randn(cin)).astype(np.float32)]


def _torch(args, dtype=torch.float32):
    weights = (0, 1, 4, 7)  # x and the weights in the compute dtype
    return [torch.from_numpy(a).to(dtype) if i in weights else torch.from_numpy(a)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("shape,th", [((56, 256, 64), 2), ((28, 512, 128), 4),
                                      ((14, 1024, 256), 7), ((14, 128, 64), 5)])
@pytest.mark.parametrize("relu_out", [True, False])
def test_tiled_block_matches_plain_f32(shape, th, relu_out):
    """The plan's tiles at RN50's identity shapes, and a tile that does not
    divide H (14 rows in tiles of 5, 5, 4), against the plain version."""
    h, cin, cmid = shape
    args = _torch(_block_inputs(1, 1, h, cin, cmid))
    got = _tiled_block(*args, th, relu_out=relu_out)
    want = kernels.bottleneck_block_plain(*args, relu_out=relu_out)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_tiled_block_matches_plain_bf16():
    """bf16 at chip_smoke.py's bar (5e-2 + 5e-2·|ref|): h1 and h2 round at the
    same points; only the order of the fp32 sums differs."""
    h, cin, cmid = 28, 512, 128
    args = _torch(_block_inputs(2, 1, h, cin, cmid), torch.bfloat16)
    plan = kernels.block_plan(torch.bfloat16, 1, h, h, cin, cmid)
    got = _tiled_block(*args, plan.th).float().numpy()
    want = kernels.bottleneck_block_plain(*args).float().numpy()
    atol, rtol = chip_smoke.BLOCK_TOL["bfloat16"]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_tiled_block_zero_halo():
    """W1 = 0 and b1 > 0: h1 = ReLU(b1) inside the image, 0 outside, so a
    corner differs from an interior pixel, as in the plain version."""
    args = _torch(_block_inputs(3, 1, 28, 512, 128))
    args[0] = torch.zeros_like(args[0])
    args[1] = torch.zeros_like(args[1])
    args[3] = args[3].abs() + 0.5
    got = _tiled_block(*args, 4, relu_out=False)
    want = kernels.bottleneck_block_plain(*args, relu_out=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got[0, 0, 0], got[0, 14, 14])


@pytest.mark.parametrize("shape", [(2, 14, 128, 32), (2, 7, 256, 64), (1, 8, 64, 16)])
def test_tiled_block_matches_jax_f32(shape):
    """tests/test_torch_grouped.py's block shapes, tiled as the route's rule
    cuts them, against the JAX package's kernel (interpret mode) and its lax
    oracle."""
    n, h, cin, cmid = shape
    args = _block_inputs(4, n, h, cin, cmid)
    th = kblock.wgmma_rows(h, h, cmid)
    assert 1 <= th <= h
    got = _tiled_block(*_torch(args), th).numpy()
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jax_bottleneck_block(*jargs, interpret=True))
    oracle = np.asarray(bottleneck_block_reference(*jargs))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


def test_tiled_block_matches_jax_at_56():
    """RN50's 56²×256/64 cut to N=1, in the plan's tiles of 2 rows, against
    the JAX package's lax oracle (its Pallas kernel finds no batch tile for
    this shape: _pick_bt's VMEM budget)."""
    args = _block_inputs(5, 1, 56, 256, 64)
    plan = kernels.block_plan(torch.bfloat16, 1, 56, 56, 256, 64)
    got = _tiled_block(*_torch(args), plan.th).numpy()
    oracle = np.asarray(bottleneck_block_reference(*[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


# --- the route and tile the wrapper passes ----------------------------------

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
    saved_routes = {k: dict(v) for k, v in kernels.ROUTE_LAUNCHES.items()}
    kernels.reset_launches()
    yield lib
    kernels.LAUNCHES.update(saved)
    for k, v in saved_routes.items():
        kernels.ROUTE_LAUNCHES[k].update(v)


@pytest.mark.parametrize("dtype,shape,force,route,th", [
    (torch.bfloat16, (14, 1024, 256), None, "wgmma", 7),
    (torch.bfloat16, (28, 512, 128), None, "wgmma", 4),
    (torch.bfloat16, (28, 512, 128), "simt", "simt", 0),
    (torch.float32, (14, 1024, 256), None, "simt", 0),
    (torch.bfloat16, (14, 256, 32), None, "simt", 0)])
def test_wrapper_passes_the_plan(recording_lib, dtype, shape, force, route, th):
    """bottleneck_launch's arguments end (…, N, H, W, Cin, Cmid, relu_out,
    route, th, stream), and the launch counts under its route."""
    h, cin, cmid = shape
    x = torch.zeros(2, h, h, cin, dtype=dtype)
    w1, w3 = torch.zeros(cin, cmid, dtype=dtype), torch.zeros(cmid, cin, dtype=dtype)
    w2 = torch.zeros(3, 3, cmid, cmid, dtype=dtype)
    vec = torch.zeros(cin)
    out = kblock._launch_block(x, w1, vec, vec, w2, vec, vec, w3, vec, vec, relu_out=False,
                               route=force)
    assert out.shape == x.shape and out.dtype == dtype
    ((name, args),) = recording_lib.calls
    assert name == "bottleneck_launch"
    assert args[0] == kernels.DTYPE_CODES[dtype]
    assert args[7:] == (2, h, h, cin, cmid, 0, 1 if route == "wgmma" else 0, th, 0)
    assert kernels.LAUNCHES["bottleneck_block"] == 1
    assert kernels.ROUTE_LAUNCHES["bottleneck_block"] == {"wgmma": int(route == "wgmma"),
                                                          "simt": int(route == "simt")}
