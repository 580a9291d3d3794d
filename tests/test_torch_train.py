"""The port's train side (ops/norm, ops/losses, ops/activations dropout,
train/optim, train/state, train/engine, the bridge's reverse direction)
against the JAX package on the CPU.

The whole step is held against the JAX engine's own _build_train_step
through Trainer(model, use_mesh=False); on the CPU test mesh the JAX
Pallas path is off, so the JAX side is its lax composition. Weights start
from the JAX init and cross by the bridge; batches are numpy from a seed.
fp32 gradients of a batch-4 RN18 carry ~2.5e-4 relative noise from the
batch-4 statistics of its last stage: the JAX package's lax and Pallas
paths differ from each other by that much. So SGD runs at lr 1e-3 (the
params then agree to 1e-4) and Adam, whose g/√v turns noise at near-zero
gradients into whole steps, at lr 2e-4 (params to 1e-3, the bar of
tests/test_epoch_scan.py).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu import ops as jops
from convnets_tpu.core.precision import LossScale as JaxLossScale
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.settings import Settings
from convnets_tpu.train import optim as joptim
from convnets_tpu.train.engine import Trainer
from convnets_tpu_torch import bridge, ops
from convnets_tpu_torch.core.precision import LossScale
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.ops.norm import batch_norm_train
from convnets_tpu_torch.train import build_train_step, create_train_state, optim
from convnets_tpu_torch.train.engine import data_rng
from torch_one_thread import one_intra_op_thread  # noqa: F401

RNG = np.random.RandomState(0)


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a)).to(dtype).requires_grad_(grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_train_matches_jax(dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 5, 5, 16) * 2 + 0.5).astype(np.float32)
    rm, rv = (0.1 * rng.randn(16)).astype(np.float32), rng.uniform(0.5, 1.5, 16).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), (0.1 * rng.randn(16)).astype(np.float32)
    g = rng.randn(4, 5, 5, 16).astype(np.float32)

    def fn(x_, s_, b_):
        return jops.batch_norm_train(x_, jnp.asarray(rm), jnp.asarray(rv), s_, b_)

    want, vjp = jax.vjp(fn, jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias))
    jgrads = vjp((jnp.asarray(g, jd), jnp.zeros(16), jnp.zeros(16)))
    ins = [_t(x, dtype, True), _t(scale, grad=True), _t(bias, grad=True)]
    got = batch_norm_train(ins[0], _t(rm), _t(rv), ins[1], ins[2])
    tgrads = torch.autograd.grad(got[0], ins, _t(g, dtype))
    assert got[0].dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=tol, atol=tol)
    for i in (1, 2):  # the running update is fp32 in both dtypes
        np.testing.assert_allclose(_np(got[i]), _np(want[i]), rtol=1e-6, atol=1e-6)
    for a, b, name in zip(tgrads, jgrads, ("dx", "dscale", "dbias")):
        scale_ = float(np.abs(_np(b)).max())
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol * scale_, err_msg=name)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_sum_and_correct_count_match_jax(smoothing):
    logits = (RNG.randn(6, 10) * 3).astype(np.float32)
    labels = RNG.randint(0, 10, 6).astype(np.int32)
    labels[0] = logits[0].argmax()
    weights = np.array([1, 1, 0, 1, 1, 0], np.float32)
    for w in (None, weights):
        want = jops.cross_entropy_sum(jnp.asarray(logits), jnp.asarray(labels),
                                      None if w is None else jnp.asarray(w), smoothing)
        got = ops.cross_entropy_sum(_t(logits, torch.bfloat16), _t(labels, torch.int64),
                                    None if w is None else _t(w), smoothing)
        want_bf = jops.cross_entropy_sum(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
                                         None if w is None else jnp.asarray(w), smoothing)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want_bf), rtol=1e-6)
        got32 = ops.cross_entropy_sum(_t(logits), _t(labels, torch.int64),
                                      None if w is None else _t(w), smoothing)
        np.testing.assert_allclose(_np(got32), _np(want), rtol=1e-6)
        np.testing.assert_array_equal(
            _np(ops.correct_count(_t(logits), _t(labels, torch.int64), None if w is None else _t(w))),
            _np(jops.correct_count(jnp.asarray(logits), jnp.asarray(labels),
                                   None if w is None else jnp.asarray(w))))


def _tree():
    rng = np.random.RandomState(3)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": {"c": rng.randn(5).astype(np.float32)}}
    grads = [{"a": rng.randn(3, 4).astype(np.float32),
              "b": {"c": (rng.randn(5) * 1e-3).astype(np.float32)}} for _ in range(3)]
    return params, grads


def _flat(tree):
    return {"/".join(k): v for k, v in bridge._flatten(tree).items()}


def _close(port, jtree, tol=1e-6):
    want = _flat(jax.tree.map(np.asarray, jtree))
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(port[k]), want[k], rtol=tol, atol=tol, err_msg=k)


def test_adam_update_matches_jax():
    params, grads = _tree()
    jp, js = params, joptim.adam_init(params)
    tp = {k: _t(v) for k, v in _flat(params).items()}
    ts = optim.adam_init(tp)
    for g in grads:
        jp, js = joptim.adam_update(g, js, jp, lr=0.01, weight_decay=1e-2)
        tp, ts = optim.adam_update({k: _t(v) for k, v in _flat(g).items()}, ts, tp, lr=0.01,
                                   weight_decay=1e-2)
    assert ts.count == int(js.count) == 3
    _close(tp, jp)
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_update_matches_jax(nesterov):
    params, grads = _tree()
    jp, js = params, joptim.sgd_init(params)
    tp = {k: _t(v) for k, v in _flat(params).items()}
    ts = optim.sgd_init(tp)
    for g in grads:
        kw = dict(lr=0.1, weight_decay=1e-2, momentum=0.9, nesterov=nesterov)
        jp, js = joptim.sgd_update(g, js, jp, **kw)
        tp, ts = optim.sgd_update({k: _t(v) for k, v in _flat(g).items()}, ts, tp, **kw)
    _close(tp, jp)
    _close(ts.momentum, js.momentum)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clipping_matches_jax(max_norm):
    _, grads = _tree()
    g = grads[0]
    tg = {k: _t(v) for k, v in _flat(g).items()}
    np.testing.assert_allclose(_np(optim.global_norm(tg)), _np(joptim.global_norm(g)), rtol=1e-6)
    _close(optim.clip_by_global_norm(tg, max_norm), joptim.clip_by_global_norm(g, max_norm))
    _close(optim.clip_by_value(tg, 0.3), joptim.clip_by_value(g, 0.3))


def test_loss_scale_shim_matches_jax():
    grads = {"a": torch.ones(3) * 4.0}
    for scale in (1.0, 4.0):
        ls, jls = LossScale(scale), JaxLossScale(scale)
        assert float(ls.scale_loss(torch.tensor(2.0))) == float(jls.scale_loss(2.0))
        np.testing.assert_array_equal(_np(ls.unscale_grads(grads)["a"]),
                                      np.asarray(jls.unscale_grads({"a": jnp.ones(3) * 4.0})["a"]))
        assert LossScale.from_state(ls.to_state()) == ls and ls.to_state() == jls.to_state()


def test_dropout_keep_rate_and_scale():
    """The masks cannot match JAX's bits; the keep rate and the 1/(1-p)
    scale must, and a seeded generator must repeat its mask."""
    x = torch.full((64, 64, 32), 3.0)
    for rate in (0.25, 0.5):
        y = ops.dropout(x, rate, torch.Generator().manual_seed(0), train=True)
        kept = y != 0
        assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
        np.testing.assert_allclose(_np(y[kept]), 3.0 / (1 - rate), rtol=1e-6)
        again = ops.dropout(x, rate, torch.Generator().manual_seed(0), train=True)
        assert torch.equal(y, again)
    yb = ops.dropout(x.to(torch.bfloat16), 0.5, torch.Generator().manual_seed(1), train=True)
    assert yb.dtype == torch.bfloat16 and set(torch.unique(yb).tolist()) <= {0.0, 6.0}


# --- the whole step -------------------------------------------------------

def _settings(optimizer, lr, batch_norm=True, kind="18"):
    return Settings(kind=kind, input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                    dropout_rate=0.0, optimizer=optimizer, learning_rate=lr, weight_decay=1e-4,
                    batch_norm=batch_norm, data_augment=False, data_norm=True, nesterov=True)


@functools.lru_cache(maxsize=None)
def _batches(steps):
    rng = np.random.RandomState(7)
    return [(rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8),
             rng.randint(0, 10, 4).astype(np.int32), np.ones(4, np.float32))
            for _ in range(steps)]


def _run_both(setting, steps, arch="resnet"):
    """(jax final state, jax [(loss, correct)], port model, port state, port [(loss, correct)])."""
    trainer = Trainer(jax_build_model(arch, setting), use_mesh=False)
    trainer.init_state()
    step = trainer._get_train_step(augment=False, norm=True)
    model = build_model(arch, setting, device="cpu")
    bridge.load_jax_variables(model, {"params": jax.tree.map(np.asarray, trainer.state.params),
                                      "state": jax.tree.map(np.asarray, trainer.state.model_state)})
    state = create_train_state(model)
    port_step = build_train_step(state, norm=True)
    js, jout, tout = trainer.state, [], []
    for i, (x, y, w) in enumerate(_batches(steps)):
        js, loss, correct = step(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                 jax.random.key(i))
        jout.append((float(loss), float(correct)))
        loss, correct = port_step(state, _t(x, torch.uint8), _t(y, torch.int64), _t(w))
        tout.append((float(loss), float(correct)))
    return js, jout, model, state, tout


def _check_variables(model, js, tol):
    got = bridge.export_jax_variables(model)
    for coll, tree in (("params", js.params), ("state", js.model_state)):
        want = _flat(jax.tree.map(np.asarray, tree))
        mine = _flat(got[coll])
        assert set(mine) == set(want)
        for k in want:
            np.testing.assert_allclose(mine[k], want[k], rtol=tol, atol=tol, err_msg=f"{coll}/{k}")


def _check_moments(model, state, js, keys, rel):
    """Optimizer trees through the bridge: each leaf to `rel` of its
    largest element."""
    got = bridge.export_jax_opt_state(model, state.opt_state)
    for key in keys:
        want = _flat(jax.tree.map(np.asarray, getattr(js.opt_state, key)))
        mine = _flat(got[key])
        assert set(mine) == set(want)
        for k in want:
            bound = rel * float(np.abs(want[k]).max()) + 1e-12
            assert float(np.abs(mine[k] - want[k]).max()) <= bound, (key, k)
    return got


def test_train_step_matches_jax_one_sgd_step():
    js, jout, model, state, tout = _run_both(_settings("sgd", 1e-3), 1)
    np.testing.assert_allclose(tout, jout, rtol=1e-4)
    _check_variables(model, js, 1e-4)
    # the velocity is the first gradient: its noise is ~2.5e-4 of the leaf
    _check_moments(model, state, js, ("momentum",), 1e-3)


def test_train_step_matches_jax_two_adam_steps():
    js, jout, model, state, tout = _run_both(_settings("adam", 2e-4), 2)
    np.testing.assert_allclose(tout, jout, rtol=1e-3)
    _check_variables(model, js, 1e-3)
    # the moments hold the second step's gradient, taken at params that
    # already differ by Adam's noise (up to 8% of a leaf here), so only their
    # layout is compared; the Adam arithmetic itself is held at 1e-6 by
    # test_adam_update_matches_jax
    got = bridge.export_jax_opt_state(model, state.opt_state)
    assert int(got["count"]) == int(js.opt_state.count) == 2
    for key in ("mu", "nu"):
        want = _flat(jax.tree.map(np.asarray, getattr(js.opt_state, key)))
        assert {k: v.shape for k, v in _flat(got[key]).items()} == \
            {k: v.shape for k, v in want.items()}


def test_train_step_matches_jax_without_batch_norm():
    js, jout, model, _, tout = _run_both(_settings("sgd", 1e-3, batch_norm=False), 1)
    assert not bridge.export_jax_variables(model)["state"]
    np.testing.assert_allclose(tout, jout, rtol=1e-5)
    _check_variables(model, js, 1e-5)


def test_bridge_round_trip_of_variables_and_optimizer_state():
    setting = _settings("adam", 1e-3)
    jm = jax_build_model("resnet", setting)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    rng = np.random.RandomState(2)
    opt = joptim.adam_init(variables["params"])
    opt = opt._replace(count=jnp.asarray(5, jnp.int32),
                       mu=jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), opt.mu))
    model = build_model("resnet", setting, device="cpu")
    bridge.load_jax_variables(model, variables)
    back = bridge.export_jax_variables(model)
    for coll in ("params", "state"):
        want, got = _flat(variables[coll]), _flat(back[coll])
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    port_opt = optim.AdamState(**bridge.load_jax_opt_state(model, opt))
    assert port_opt.count == 5 and set(port_opt.mu) == {n for n, _ in model.named_parameters()}
    back_opt = bridge.export_jax_opt_state(model, port_opt)
    assert back_opt["count"] == 5
    for key in ("mu", "nu"):
        want, got = _flat(jax.tree.map(np.asarray, getattr(opt, key))), _flat(back_opt[key])
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_train_step_refuses_the_data_path():
    """The data path is ported: an augmenting or mixup step refuses to run
    without the step's DataRng, and runs with one."""
    setting = _settings("sgd", 1e-3)
    state = create_train_state(build_model("resnet", setting, device="cpu"))
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (4, 32, 32, 3)).astype(np.uint8))
    y = torch.arange(4)
    rng = data_rng(0, "cpu", 0, 0)
    with pytest.raises(ValueError, match="DataRng"):
        build_train_step(state, augment=True)(state, x, y)
    loss, _ = build_train_step(state, augment=True)(state, x, y, rng=rng)
    assert torch.isfinite(loss)
    state.model.setting = _settings("sgd", 1e-3)
    state.model.setting.mixup = 0.2
    with pytest.raises(ValueError, match="DataRng"):
        build_train_step(state)(state, x, y)
    loss, _ = build_train_step(state)(state, x, y, rng=rng)
    assert torch.isfinite(loss)
