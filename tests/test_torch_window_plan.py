"""The window kernels' dispatch (`depthwise_plan`, `pool_plan`) and the
plain versions that pool2d_train's kernels are held to, on the CPU.

`depthwise_plan` and `pool_plan` map dtype and shape to the route that
runs a depthwise conv or a pool on the card: "vector" (8 channels per
thread in 16-byte vectors; for the depthwise conv a CTA's output tile
whose input halo is copied into shared memory once) or "loop" (one thread
per element, for C not a multiple of 8). The card's kernels cannot run
here; chip_smoke.py holds each route against the plain version and the two
routes against each other there. These tests walk every depthwise conv of
MobileNet-v1@224 and every pool of RN50, MobileNet-v1, DenseNet-121 and
ResNeXt-50 at 224² (module shapes only, no weights) and check that each
takes the vector route with a tiling that covers its output exactly once.
Then they hold pool2d_train's new plain parts, the tap of each window's
first maximum and the gather-form backward, against the JAX package's
pool2d_train VJP in interpret mode, with ties and all-negative inputs.
Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import chip_smoke
from convnets_tpu.ops.pallas import pool2d_train as jax_pool2d_train
from convnets_tpu_torch import nn
from convnets_tpu_torch.core.precision import policy_from_setting
from convnets_tpu_torch.core.shapes import conv_out_size
from convnets_tpu_torch.models import base
from convnets_tpu_torch.ops import kernels

FAMILIES = ["resnet", "mobilenet_v1", "densenet", "resnext"]
DTYPES = [torch.float32, torch.bfloat16]
SMS = 132


def _layers(arch, kinds):
    """(H, W, C, k, stride, pad) of every layer of `kinds` of `arch` at 224²,
    from its unbuilt modules."""
    setting = chip_smoke.model_setting(arch, 0, True)
    with nn.use_policy(policy_from_setting(setting)):
        model = base._REGISTRY[arch](setting)
    return [(h, w, cin, k, s, p) for kind, h, w, cin, _, k, s, p, _, _
            in chip_smoke.model_layers(model) if kind in kinds]


def _cdiv(a, b):
    return -(-a // b)


def _check_tiling(plan, n, oh, ow, c):
    """The vector tiles th × tw × cb, ry × r outputs per thread, cover the
    (n, oh, ow, c) output exactly once: the last tile row, column and
    channel block each start inside the output."""
    assert plan.route == "vector"
    assert plan.cb % 8 == 0 and c % plan.cb == 0
    assert plan.tw % plan.r == 0 and plan.th % plan.ry == 0 and plan.th >= 1
    tiles_h, tiles_w = _cdiv(oh, plan.th), _cdiv(ow, plan.tw)
    assert (tiles_h - 1) * plan.th < oh <= tiles_h * plan.th
    assert (tiles_w - 1) * plan.tw < ow <= tiles_w * plan.tw
    covered = np.zeros((oh, ow, c), np.int32)
    for ty in range(tiles_h):
        for tx in range(tiles_w):
            for cb in range(c // plan.cb):
                covered[ty * plan.th:(ty + 1) * plan.th, tx * plan.tw:(tx + 1) * plan.tw,
                        cb * plan.cb:(cb + 1) * plan.cb] += 1
    assert (covered == 1).all()
    return n * tiles_h * tiles_w * (c // plan.cb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 8, 256])
def test_every_mobilenet_depthwise_conv_takes_the_vector_route(batch, dtype):
    layers = _layers("mobilenet_v1", ("dwconv",))
    assert len(layers) == chip_smoke.SERVE_LAUNCHES["mobilenet_v1"]["depthwise_conv2d"] == 13
    assert len(set(layers)) == 9
    itemsize = torch.finfo(dtype).bits // 8
    for h, w, c, k, s, p in set(layers):
        plan = kernels.depthwise_plan(batch, h, w, c, k, k, s, p, dtype)
        oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
        ctas = _check_tiling(plan, batch, oh, ow, c)
        assert (plan.ry, plan.r) == ((2, 4) if s == 1 else (1, 2))
        threads = plan.cb // 8 * plan.th // plan.ry * plan.tw // plan.r
        assert 1 <= threads <= 256
        halo = ((plan.th - 1) * s + k) * ((plan.tw - 1) * s + k) * plan.cb * itemsize
        assert halo <= 48 * 1024
        if batch >= 8:  # the smallest layer still fills the card
            assert ctas >= SMS, (h, c, s, plan)
        assert plan.args() == (1, plan.cb, plan.th, plan.tw, plan.r, plan.ry)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 8, 256])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_pool_takes_the_vector_route(arch, batch, dtype):
    layers = _layers(arch, ("maxpool", "avgpool"))
    want = chip_smoke.SERVE_LAUNCHES[arch]
    assert len(layers) == want.get("max_pool2d", 0) + want.get("avg_pool2d", 0)
    for h, w, c, k, s, p in layers:
        plan = kernels.pool_plan(batch, h, w, c, k, k, s, p, dtype)
        # a strip of 2 outputs where windows overlap (the stem's 3x3/2)
        assert plan == kernels.WindowPlan("vector", 8, 1, 2 if k > s else 1, 2 if k > s else 1)
        _check_tiling(plan, batch, conv_out_size(h, k, s, p), conv_out_size(w, k, s, p), c)


def test_pool_shapes_of_the_four_families():
    """The stem 3x3/2 p1 at 112²×64 (RN50, DN121, ResNeXt-50) and DN121's
    2x2/2 transitions; MobileNet-v1 has no pool."""
    shapes = {arch: sorted(set(_layers(arch, ("maxpool", "avgpool")))) for arch in FAMILIES}
    stem = (112, 112, 64, 3, 2, 1)
    assert shapes["resnet"] == shapes["resnext"] == [stem] and shapes["mobilenet_v1"] == []
    assert shapes["densenet"] == sorted([stem, (56, 56, 128, 2, 2, 0), (28, 28, 256, 2, 2, 0),
                                         (14, 14, 512, 2, 2, 0)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [12, 27])
def test_channels_off_the_vector_take_the_loop(c, dtype):
    assert kernels.depthwise_plan(8, 28, 28, c, 3, 3, 1, 1, dtype) == kernels.WindowPlan("loop")
    assert kernels.depthwise_plan(8, 28, 28, c, 3, 3, 2, 1, dtype).route == "loop"
    assert kernels.pool_plan(8, 28, 28, c, 3, 3, 2, 1, dtype) == kernels.WindowPlan("loop")
    assert kernels.pool_plan(8, 28, 28, c, 2, 2, 2, 0, dtype).route == "loop"
    assert kernels.WindowPlan("loop").args()[0] == 0


@pytest.mark.parametrize("k,stride,aligned,why", [
    (5, 1, True, "a 5x5 window"), (3, 3, True, "stride 3"), (3, (1, 2), True, "unequal strides"),
    (3, 1, False, "a misaligned operand")])
def test_depthwise_shapes_off_the_vector_take_the_loop(k, stride, aligned, why):
    plan = kernels.depthwise_plan(8, 28, 28, 64, k, k, stride, 1, torch.bfloat16, aligned)
    assert plan.route == "loop", why


def test_the_plans_refuse_other_dtypes():
    with pytest.raises(TypeError):
        kernels.depthwise_plan(1, 7, 7, 8, 3, 3, 1, 1, torch.float16)
    with pytest.raises(TypeError):
        kernels.pool_plan(1, 7, 7, 8, 3, 3, 2, 1, torch.float16)


def _inputs(kind, c, seed):
    rng = np.random.RandomState(seed)
    if kind == "ties":  # small integers: many tied maxima, exact in bf16
        return rng.randint(-2, 3, (2, 16, 16, c)).astype(np.float32)
    return -np.abs(rng.randn(2, 16, 16, c)).astype(np.float32) - 0.5  # all negative


def _first_max_taps(x, k, s, p):
    """numpy: per output element, the row-major tap of its window's first
    maximum over the taps inside the input."""
    n, h, w, c = x.shape
    oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
    taps = np.zeros((n, oh, ow, c), np.uint8)
    for oy in range(oh):
        for ox in range(ow):
            best = np.full((n, c), -np.inf, np.float32)
            found = np.zeros((n, c), bool)
            for t in range(k * k):
                iy, ix = oy * s - p + t // k, ox * s - p + t % k
                if 0 <= iy < h and 0 <= ix < w:
                    v = x[:, iy, ix]
                    take = ~found | (v > best)
                    best = np.where(take, v, best)
                    taps[:, oy, ox][take] = t
                    found |= True
    return taps


@pytest.mark.parametrize("kind", ["ties", "negative"])
@pytest.mark.parametrize("c", [8, 12])
def test_plain_taps_are_the_first_maxima(c, kind):
    x = _inputs(kind, c, 20)
    y, taps = kernels.max_pool2d_plain(torch.from_numpy(x), 3, 2, 1, taps=True)
    assert taps.dtype == torch.uint8 and taps.shape == y.shape
    np.testing.assert_array_equal(taps.numpy(), _first_max_taps(x, 3, 2, 1))
    if kind == "negative":  # -inf padding: no tap in the padding wins
        assert (y.numpy() < 0).all()


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["ties", "negative"])
@pytest.mark.parametrize("c", [8, 12])
@pytest.mark.parametrize("mode,k,stride,padding", [("max", 3, 2, 1), ("avg", 2, 2, 0),
                                                   ("avg", 3, 2, 1)])
def test_plain_gather_backward_matches_jax(mode, k, stride, padding, c, kind, dtype):
    """dx from the taps (max) or from g alone (avg) against JAX's
    pool2d_train VJP. Integer cotangents keep every sum exact, so max and
    the non-overlapping avg agree bit for bit; the overlapping avg rounds
    g·1/9 and may sum up to four of them in another order: fp32 1e-6, bf16
    one ulp (2^-8 relative)."""
    x = _inputs(kind, c, 21)
    jd = _jax_dtype(dtype)
    want, vjp = jax.vjp(lambda a: jax_pool2d_train(a, mode, k, stride, padding, True),
                        jnp.asarray(x, jd))
    g = np.random.RandomState(22).randint(-3, 4, want.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(g, jd))
    xt = torch.from_numpy(x).to(dtype)
    if mode == "max":
        y, taps = kernels.max_pool2d_plain(xt, k, stride, padding, taps=True)
    else:
        y, taps = kernels.avg_pool2d_plain(xt, k, stride, padding), None
    dx = kernels.pool2d_backward_plain(mode, torch.from_numpy(g), taps, (16, 16), dtype, k,
                                       stride, padding)
    assert dx.dtype == dtype and dx.shape == xt.shape and dx.is_contiguous()
    if mode == "max" or k == stride:
        np.testing.assert_array_equal(_np(y), _np(want))
        np.testing.assert_array_equal(_np(dx), _np(jdx))
    else:
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
        np.testing.assert_allclose(_np(y), _np(want), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(dx), _np(jdx), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool2d_train_keeps_no_input(mode):
    """The Function saves the uint8 taps (max) or nothing (avg), not x."""
    x = torch.from_numpy(_inputs("ties", 8, 23)).requires_grad_()
    y = kernels.pool2d_train(x, mode, 3, 2, 1)
    saved = y.grad_fn.saved_tensors
    if mode == "max":
        assert len(saved) == 1 and saved[0].dtype == torch.uint8 and saved[0].shape == y.shape
    else:
        assert saved == ()


def test_pool2d_backward_refuses_a_non_cuda_tensor():
    """Off the CPU the wrapper launches its kernel or raises: no fallback."""
    g = torch.empty(1, 4, 4, 8, device="meta")
    taps = torch.empty(1, 4, 4, 8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pool2d_backward("max", g, taps, (8, 8), torch.float32, 3, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool2d(torch.empty(1, 8, 8, 8, device="meta"), 3, 2, 1, taps=True)
    assert kernels._lib is None
