"""The port's Winograd F(2,3) / F(4,3) path against the JAX package's
(convnets_tpu/ops/winograd.py and the gate of nn/layers.py:126-146) on the
CPU, where every wrapper of ops/kernels/winograd.py computes its plain
version: the composition of ops/winograd.py at every shape of
tests/test_winograd.py, bf16 and its error band, the trainable conv's
gradient against jax.grad through JAX's checkpointed gate, `fits` and
`route` under each value of the gate, Conv2d and ConvBNReLU in train and
eval mode, one SGD step of RN18@32 at gate 2 and gate 4 against the JAX
engine, and the wrapper calls per forward with the gate unset and set.

Each JAX call runs under jax.jit (one trace per shape), and the RN18
weights are drawn with numpy in the layout jax.eval_shape gives, to keep
the file within seconds."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnets_tpu import ops as jops
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.nn import layers as jlayers
from convnets_tpu.ops import winograd as jwin
from convnets_tpu.train.engine import Trainer
from convnets_tpu.train.state import create_train_state as jax_train_state
from convnets_tpu_torch import bridge, nn
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.ops import kernels, winograd
from convnets_tpu_torch.ops.kernels import winograd as wk
from convnets_tpu_torch.train import build_train_step, create_train_state
from test_torch_train import _batches, _check_moments, _check_variables, _settings, _t
from test_torch_zoo_attention import numpy_variables
from torch_one_thread import one_intra_op_thread  # noqa: F401

GATE, TABLE = "CONVNETS_TPU_WINOGRAD", "CONVNETS_TPU_WINOGRAD_TABLE"
# tests/test_winograd.py's shapes: (N, H, W, C, O, padding)
SHAPES = [(2, 8, 8, 8, 16, 1), (2, 14, 14, 16, 8, 1), (1, 7, 9, 4, 4, 1), (2, 6, 6, 3, 5, 0),
          (1, 5, 5, 2, 3, 2)]
# fp32, port against JAX, |Δ| ≤ tol + tol·|ref|: the same arithmetic in
# another summation order; F(4,3)'s constants (1/24 .. 8) round, so its bar
# is wider
FP32_TOL = {2: 1e-5, 4: 5e-5}
CONV_TOL_BF16 = 1e-2  # |Δ| ≤ 1e-2 + 1e-2·|ref|: both round V, U and y at the same points
GRAD_TOL = 5e-3  # tests/test_winograd.py:64-67's bar, Winograd against the direct conv's VJP
LAYER_TOL = 1e-4  # fp32 forward of a layer against JAX's


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_winograd(padding, m):
    return jax.jit(lambda x, w, b: jwin.conv2d_winograd(x, w, b, padding=padding, m=m))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_fp32(m, shape):
    n, h, w, c, o, pad = shape
    rng = np.random.default_rng(hash((m, shape)) % 2 ** 31)
    x, wt, b = _rand(rng, n, h, w, c), _rand(rng, 3, 3, c, o, scale=0.1), _rand(rng, o)
    ref = np.asarray(_jax_winograd(pad, m)(x, wt, b))
    got = winograd.conv2d_winograd_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                         torch.from_numpy(b), padding=pad, m=m)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=FP32_TOL[m], atol=FP32_TOL[m])
    # the wrappers' CPU route is that composition
    assert torch.equal(wk.winograd_conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                                          torch.from_numpy(b), padding=pad, m=m), got)


@pytest.mark.parametrize("m", [2, 4])
def test_bf16_matches_jax_and_its_band(m):
    """bf16 against JAX's bf16 Winograd within the bf16 conv bar, and the
    error band of tests/test_winograd.py:72-97 against the fp32 direct
    conv: mean |Δ| / mean |ref| below band × the bf16 direct conv's and
    below 2.5%.

    F(4,3)'s G holds 1/6 and 1/24, which round in fp32, so the two fp32
    einsums of the weight transform (another contraction order than XLA's)
    round about 0.3% of U's elements to the neighbouring bf16 value; its
    output transform (constants up to 8 on both axes) carries such a
    one-ulp step of U to ~0.07 of a y of ~0.5. So the composition is held
    elementwise to the bar from the same U (JAX's), and its own U to JAX's
    within one bf16 ulp (or fp32 noise where U's terms cancel); at m = 2
    (G exact in binary) the whole composition is held elementwise, and at
    m = 4 its mean |Δ| / mean |ref| to the bar."""
    rng = np.random.default_rng(11)
    x32, w32 = _rand(rng, 2, 14, 14, 32), _rand(rng, 3, 3, 32, 32, scale=0.1)
    xb, wb = jnp.asarray(x32, jnp.bfloat16), jnp.asarray(w32, jnp.bfloat16)
    want = np.asarray(_jax_winograd(1, m)(xb, wb, None)).astype(np.float32)
    tx, tw = torch.from_numpy(x32).bfloat16(), torch.from_numpy(w32).bfloat16()
    got = winograd.conv2d_winograd_plain(tx, tw, padding=1, m=m)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ju = np.asarray(jax.jit(lambda w: jwin.transform_weight(w, m, jnp.bfloat16))(wb))
    ju = ju.astype(np.float32)
    u = winograd.transform_weight(tw, m, torch.bfloat16).float().numpy()
    # one bf16 ulp at most, or fp32 noise where the terms cancel (JAX 0, the port 5e-10)
    assert (np.abs(u - ju) <= np.abs(ju) * 2.0 ** -7 + 2.0 ** -20 * np.abs(ju).max()).all()
    a = m + 2
    v = winograd.input_transform_plain(tx, m, (1, 1))
    mm = winograd.batched_product(v, torch.from_numpy(ju).bfloat16().reshape(a * a, 32, 32))
    same_u = winograd.output_transform_plain(mm, 2, 14, 14, m, torch.bfloat16).float().numpy()
    np.testing.assert_allclose(same_u, want, rtol=CONV_TOL_BF16, atol=CONV_TOL_BF16)
    if m == 2:
        np.testing.assert_allclose(got, want, rtol=CONV_TOL_BF16, atol=CONV_TOL_BF16)
    else:
        assert np.abs(got - want).mean() <= CONV_TOL_BF16 * np.abs(want).mean()
    conv = jax.jit(lambda x, w: jops.conv2d(x, w, None, stride=1, padding=1))
    oracle = np.asarray(conv(x32, w32))
    direct = np.asarray(conv(xb, wb)).astype(np.float32)
    scale = np.abs(oracle).mean()
    err_direct = np.abs(direct - oracle).mean() / scale
    err = np.abs(got - oracle).mean() / scale
    band = {2: 2.5, 4: 8.0}[m]
    assert err < band * max(err_direct, 1e-3) and err < 0.025, (err, err_direct)


@pytest.mark.parametrize("m", [2, 4])
def test_gradient_matches_jax_checkpointed_gate(m):
    """dx, dw, db of sum(y²) through the port's trainable conv (its backward
    the direct conv's transposed convs) against jax.grad through
    jax.checkpoint(conv2d_winograd), as JAX's gate runs it by default
    (CONVNETS_TPU_WINOGRAD_REMAT=1)."""
    rng = np.random.default_rng(7 + m)
    x, wt, b = _rand(rng, 2, 10, 10, 6), _rand(rng, 3, 3, 6, 8, scale=0.1), _rand(rng, 8)
    f = jax.checkpoint(functools.partial(jwin.conv2d_winograd, padding=1, m=m))
    want = jax.jit(jax.grad(lambda x, w, b: jnp.sum(f(x, w, b) ** 2), argnums=(0, 1, 2)))(
        x, wt, b)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, wt, b))
    (wk.winograd_conv2d_train(tx, tw, tb, (1, 1), m) ** 2).sum().backward()
    for got, ref in zip((tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=GRAD_TOL, atol=GRAD_TOL)


ROUTE_SHAPES = [(8, 64, 64), (4, 128, 128), (56, 64, 64), (14, 256, 256), (2, 512, 512),
                (32, 3, 64)]
GATES = [None, "", "0", "off", "2", "4", " 4 ", "auto", "AUTO", "3", "on"]


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("table", [None, '{"8,64,64": 2, "14,256,256": 4}'])
def test_fits_and_route_match_jax(gate, table, monkeypatch):
    for name, value in ((GATE, gate), (TABLE, table)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for shape in ROUTE_SHAPES:
        assert winograd.route(*shape) == jwin.route(*shape), (gate, table, shape)
    for args in (((3, 3), (1, 1), (1, 1), 1), ((3, 3), (2, 2), (1, 1), 1),
                 ((1, 1), (1, 1), (1, 1), 1), ((3, 3), (1, 1), (2, 2), 1),
                 ((3, 3), (1, 1), (1, 1), 32), ((3, 3), (1, 2), (1, 1), 1)):
        assert winograd.fits(*args) == jwin.fits(*args)


def _jax_grads(layer, variables, x, cot, train):
    """JAX's output, new state and the gradients of sum(y·cot) w.r.t. x and
    the params, under jax.jit."""
    def loss(params, x):
        y, new_state = layer.apply({"params": params, "state": variables["state"]}, x,
                                   train=train)
        return jnp.sum(y * cot), (y, new_state)

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, (y, new_state)), (gp, gx) = fn(variables["params"], x)
    return np.asarray(y), new_state, gp, np.asarray(gx)


def _layer_pair(batch_norm, seed):
    jl = jlayers.conv_block(8, 3, padding=1, batch_norm=batch_norm, act=True)
    tl = nn.conv_block(8, 3, padding=1, batch_norm=batch_norm, act=True)
    shapes = jax.eval_shape(lambda k: jl.init(k, (2, 9, 11, 5)), jax.random.key(0))
    rng = np.random.RandomState(seed)
    variables = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32) * 0.3, shapes)
    if batch_norm:
        variables["state"]["1"]["var"] = np.abs(variables["state"]["1"]["var"]) + 0.5
    else:
        variables["state"] = {}
    tl.init(torch.Generator().manual_seed(0), (2, 9, 11, 5))
    bridge.load_jax_variables(tl, variables)
    return jl, tl, variables


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("batch_norm", [False, True], ids=["Conv2d", "ConvBNReLU"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_layers_match_jax_with_the_gate(m, batch_norm, train, monkeypatch):
    """Conv2d (with its bias) and ConvBNReLU at 9x11, Cin 5, gate m on
    both sides, against the JAX layers with the gate on (Pallas off, so
    JAX's ConvBNReLU runs Winograd conv, then BatchNorm2d): the output, the
    BN running statistics, and in train mode the gradients of x and every
    parameter."""
    monkeypatch.setenv(GATE, str(m))
    monkeypatch.delenv(TABLE, raising=False)
    jl, tl, variables = _layer_pair(batch_norm, 3 + m)
    rng = np.random.RandomState(m)
    x, cot = rng.randn(2, 9, 11, 5).astype(np.float32), rng.randn(2, 9, 11, 8).astype(np.float32)
    y, new_state, gp, gx = _jax_grads(jl, variables, jnp.asarray(x), jnp.asarray(cot), train)
    calls = []
    real = wk.winograd_input
    monkeypatch.setattr(wk, "winograd_input", lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    tl.train(train)
    tx = torch.from_numpy(x).requires_grad_(train)
    got = tl(tx)
    assert calls == [m]
    np.testing.assert_allclose(got.detach().numpy(), y, rtol=LAYER_TOL, atol=LAYER_TOL)
    if batch_norm:
        bn, stats = tl._modules["1"], (new_state if train else variables["state"])["1"]
        for name, want in (("running_mean", stats["mean"]), ("running_var", stats["var"])):
            np.testing.assert_allclose(getattr(bn, name).numpy(), np.asarray(want),
                                       rtol=LAYER_TOL, atol=LAYER_TOL)
    if not train:
        return
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=GRAD_TOL, atol=GRAD_TOL)
    grads = bridge.export_jax_variables(tl, {path: getattr(mod, t).grad for path, (mod, t)
                                             in bridge.jax_layout(tl).items()
                                             if path[0] == "params"})["params"]
    flat_want = jax.tree_util.tree_leaves_with_path(gp)
    assert len(flat_want) == len(jax.tree_util.tree_leaves(grads))
    for path, want in flat_want:
        mine = functools.reduce(lambda t, k: t[k.key], path, grads)
        np.testing.assert_allclose(mine, np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=str(path))


@pytest.fixture(scope="module")
def rn18():
    """RN18@32 (10 classes, fp32, SGD) and numpy weights in the JAX layout."""
    setting = _settings("sgd", 1e-3)
    jm = jax_build_model("resnet", setting)
    variables = numpy_variables(jax.eval_shape(jm.init, jax.random.key(0)), 18)
    return setting, jm, variables


@pytest.mark.parametrize("m", [2, 4])
def test_rn18_sgd_step_matches_jax_with_the_gate(rn18, m, monkeypatch):
    """One SGD step of RN18@32 at b4 with gate m on both sides (every dense
    3x3 stride-1 conv on Winograd: 13 of RN18's 20) against the JAX
    engine's step: loss to 1e-4, params and BN statistics to 1e-4, the SGD
    velocity (the step's gradient) per leaf to 1e-3 of its largest element,
    the bars of test_torch_train.py's direct-conv step."""
    monkeypatch.setenv(GATE, str(m))
    monkeypatch.delenv(TABLE, raising=False)
    setting, jm, variables = rn18
    trainer = Trainer(jm, use_mesh=False)
    trainer.state = jax_train_state(jax.tree.map(jnp.asarray, variables), setting, "sgd")
    step = trainer._get_train_step(augment=False, norm=True)
    x, y, w = _batches(1)[0]
    js, loss, _ = step(trainer.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                       jax.random.key(0))
    model = build_model("resnet", setting, device="cpu")
    bridge.load_jax_variables(model, variables)
    state = create_train_state(model)
    calls = []
    real = wk.winograd_input
    monkeypatch.setattr(wk, "winograd_input", lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    tloss, _ = build_train_step(state, norm=True)(state, _t(x, torch.uint8),
                                                  _t(y, torch.int64), _t(w))
    assert calls == [m] * 13
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    _check_variables(model, js, 1e-4)
    _check_moments(model, state, js, ("momentum",), 1e-3)


def _count_calls(monkeypatch):
    calls = {}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    for name in ("conv2d_fused", "conv2d_stats", "max_pool2d"):
        counting(kernels, name)
    for name in ("winograd_input", "winograd_output", "winograd_output_stats"):
        counting(wk, name)
    return calls


# wrapper calls of one RN18@32 forward: 20 dense convs (the 3x3 stem at
# stride 1, 16 block convs, 3 shortcuts), 13 of them 3x3 stride 1 (the stem
# among them: Cin 3, the input kernel's scalar route), and the stem pool
DIRECT = {"eval": {"conv2d_fused": 20, "max_pool2d": 1},
          "train": {"conv2d_stats": 20, "max_pool2d": 1}}
GATED = {"eval": {"conv2d_fused": 7, "max_pool2d": 1, "winograd_input": 13,
                  "winograd_output": 13},
         "train": {"conv2d_stats": 7, "max_pool2d": 1, "winograd_input": 13,
                   "winograd_output_stats": 13}}


@pytest.mark.parametrize("gate", [None, "0", "off", "2", "auto"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_wrapper_calls_per_forward(gate, mode, monkeypatch):
    """With the gate unset (or 0, off, or auto with its empty table) the
    calls are the direct path's, as before the gate existed; with it set,
    each dense 3x3 stride-1 conv calls the two transforms instead."""
    monkeypatch.delenv(TABLE, raising=False)
    if gate is None:
        monkeypatch.delenv(GATE, raising=False)
    else:
        monkeypatch.setenv(GATE, gate)
    calls = _count_calls(monkeypatch)
    model = build_model("resnet", _settings("sgd", 1e-3), device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32))
    if mode == "train":
        model.train()(x).sum().backward()
    else:
        with torch.inference_mode():
            model.eval()(x)
    assert calls == (GATED if gate == "2" else DIRECT)[mode]


def test_route_table_sends_each_shape_its_own_m(monkeypatch):
    """CONVNETS_TPU_WINOGRAD=auto with a table: the layer asks route() with
    (H, Cin, Cout) of its input, as the JAX layer does."""
    monkeypatch.setenv(GATE, "auto")
    monkeypatch.setenv(TABLE, json.dumps({"9,5,8": 4}))
    _, tl, _ = _layer_pair(False, 0)
    seen = []
    real = wk.winograd_input
    monkeypatch.setattr(wk, "winograd_input", lambda *a, **k: seen.append(a[1]) or real(*a, **k))
    x = torch.zeros(1, 9, 11, 5)
    tl.eval()(x)
    monkeypatch.setenv(TABLE, json.dumps({"11,5,8": 4}))
    tl(x)
    assert seen == [4]


def test_winograd_output_takes_a_bias_or_both_scale_and_shift():
    """The output transform's epilogues are the bias (or none) and the
    folded BN (scale and shift, ReLU if asked); ReLU alone, half a folded
    BN, or a bias beside it is refused before any work."""
    g = wk.geometry((1, 4, 4, 2), 3, 1, 2)
    mm = torch.zeros(16, g.tiles, 3)
    one = torch.ones(3)
    for kw in (dict(relu=True), dict(scale=one), dict(shift=one, relu=True),
               dict(bias=one, scale=one, shift=one)):
        with pytest.raises(ValueError):
            wk.winograd_output(mm, g, torch.float32, **kw)
    y = wk.winograd_output(mm, g, torch.float32, scale=one, shift=one, relu=True)
    assert y.shape == (1, 4, 4, 3) and torch.equal(y, torch.ones(1, 4, 4, 3))
