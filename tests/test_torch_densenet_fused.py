"""The port's shared-statistics dense block (models/densenet.py:
DenseBlockFused, ops batch_stats / bn_apply_stats) against the JAX package's,
on the CPU.

Block level at tests/test_densenet_fused.py's size (3 layers, growth 8, 16
input channels, 4×8×8), fp32 and bf16: the train forward, every running
statistic, every gradient (the input's too) and the eval forward after an
update. Model level at 32²: the port's fused DN121 against the port's
standard DN121 under mapped weights, and the bridge both ways on the JAX
fused layout (jax.eval_shape, numpy weights: no JAX compile of the model).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu import ops as jops
from convnets_tpu.core.precision import DEFAULT_POLICY as JFP32, MIXED_POLICY as JBF16
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.models import densenet as jdensenet
from convnets_tpu.nn.module import use_policy as juse_policy
from convnets_tpu.settings import Settings as JSettings
from convnets_tpu.train import checkpoint as jckpt
from convnets_tpu_torch import bridge, nn, ops
from convnets_tpu_torch.core.precision import DEFAULT_POLICY, MIXED_POLICY
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.models.densenet import DenseBlockFused
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer
from test_torch_zoo_attention import numpy_variables
from torch_one_thread import one_intra_op_thread  # noqa: F401

SIZE, GROWTH, C0 = 3, 8, 16
SHAPE = (4, 8, 8, C0)
# (atol, rtol) of port against JAX: fp32 differs by summation order only;
# bf16 by where the two libraries round within a fused elementwise chain
# (one bf16 ulp, 2^-8 relative, moves a value and what follows it)
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)}
GRAD_TOL = {"float32": 5e-5, "bfloat16": 3e-2}  # ‖Δ‖/‖g‖ per gradient leaf (bf16: VJP)
STATS_TOL = 1e-5  # running statistics, fp32 in either policy
POLICIES = {"float32": (DEFAULT_POLICY, JFP32), "bfloat16": (MIXED_POLICY, JBF16)}


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32))


def _l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _randomized(tree, rng):
    """BN scale/bias/statistics away from 1/0, so the normalize is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomized(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.7, 1.3, np.shape(v)).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = (0.1 * rng.randn(*np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _blocks(dname):
    port_policy, jax_policy = POLICIES[dname]
    with juse_policy(jax_policy):
        jblock = jdensenet.DenseBlockFused(SIZE, GROWTH, C0, drop_rate=0.0)
    variables = jax.tree.map(np.asarray, jblock.init(jax.random.key(0), SHAPE))
    variables = _randomized(variables, np.random.RandomState(3))
    with nn.use_policy(port_policy):
        block = DenseBlockFused(SIZE, GROWTH, C0, drop_rate=0.0)
    block.init(torch.Generator().manual_seed(0), SHAPE)
    bridge.load_jax_variables(block, variables)
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    return jblock, block, variables, x


def _assert_close(got, want, dname, what):
    atol, rtol = TOL[dname]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_batch_stats_and_bn_apply_stats_match_jax(dname):
    """The statistics, the forward and the VJP (mean and var get a zero
    cotangent; Σdy·x̂ and Σdy are the scale and bias gradients)."""
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6, 6, 12).astype(np.float32) * 2 + 0.5
    scale = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    bias = rng.randn(12).astype(np.float32) * 0.1
    dy = rng.randn(4, 6, 6, 12).astype(np.float32)
    jd = jnp.float32 if dname == "float32" else jnp.bfloat16
    td = getattr(torch, dname)
    jx, jdy = jnp.asarray(x).astype(jd), jnp.asarray(dy).astype(jd)
    jmean, jvar = jops.batch_stats(jx)
    tx = torch.from_numpy(x).to(td)
    mean, var = ops.batch_stats(tx)
    assert mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(_np(mean), _np(jmean), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(var), _np(jvar), atol=1e-6, rtol=1e-5)
    jy, vjp = jax.vjp(lambda *a: jops.bn_apply_stats(*a, 1e-5), jx, jmean, jvar,
                      jnp.asarray(scale), jnp.asarray(bias))
    jgrads = vjp(jdy)
    args = [tx.clone().requires_grad_(), mean.clone().requires_grad_(),
            var.clone().requires_grad_(), torch.from_numpy(scale).requires_grad_(),
            torch.from_numpy(bias).requires_grad_()]
    y = ops.bn_apply_stats(*args)
    assert y.dtype == td
    _assert_close(y, jy, dname, "y")
    grads = torch.autograd.grad(y, args, torch.from_numpy(dy).to(td))
    for name, g, jg in zip(("dx", "dmean", "dvar", "dscale", "dbias"), grads, jgrads):
        if name in ("dmean", "dvar"):
            assert not np.asarray(jg).any() and not g.any(), name
        else:
            assert _l2(g, jg) <= GRAD_TOL[dname], (name, _l2(g, jg))


@functools.lru_cache(maxsize=None)
def _jax_block_run(dname):
    """JAX's train forward, new state, loss and gradients (params, input).
    fp32 is jitted (one compile instead of an eager dispatch per op); bf16
    runs op by op, since under jit XLA's CPU compiler keeps fused bf16
    chains in fp32 and so moves the rounding points the port follows."""
    jblock, _, variables, x = _blocks(dname)

    def jloss(params, xx):
        y, ns = jblock.apply({"params": params, "state": variables["state"]}, xx, train=True,
                             rng=jax.random.key(2))
        return jnp.mean(jnp.square(y.astype(jnp.float32))), (y, ns)

    run = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)
    (loss, (y, state)), (gp, gx) = (jax.jit(run) if dname == "float32" else run)(
        variables["params"], jnp.asarray(x))
    return loss, y, state, {("input",): gx, **bridge._flatten(gp)}


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_block_matches_jax(dname):
    """Train forward, banks and bn2 statistics, every gradient (input
    included), then eval with the updated statistics. A bf16 gradient leaf
    is held to JAX's own bf16 gradient within max(1e-2, the distance of
    JAX's bf16 gradient from its fp32 one): the bf16 noise of the
    reference itself (up to 7.7e-2 here)."""
    jblock, block, variables, x = _blocks(dname)
    jl, jy, jstate, jgrads = _jax_block_run(dname)
    witness = _jax_block_run("float32")[3] if dname == "bfloat16" else None
    block.train()
    tx = torch.from_numpy(x).requires_grad_()
    y = block(tx)
    loss = y.float().square().mean()
    params = dict(block.named_parameters())
    grads = torch.autograd.grad(loss, [tx, *params.values()])
    _assert_close(y, jy, dname, "train forward")
    assert abs(float(loss.detach()) - float(jl)) <= TOL[dname][1] * abs(float(jl))
    got = bridge.export_jax_variables(block)
    flat_got, flat_want = bridge._flatten(got["state"]), bridge._flatten(jstate)
    assert set(flat_got) == set(flat_want) == set(bridge._flatten(variables["state"]))
    for k, want in flat_want.items():
        np.testing.assert_allclose(flat_got[k], np.asarray(want), atol=STATS_TOL,
                                   rtol=STATS_TOL if dname == "float32" else 1e-2,
                                   err_msg="/".join(k))
    paths = bridge.param_paths(block)
    for path, g in zip([("input",)] + [paths[n] for n in params], grads):
        bar = GRAD_TOL[dname] if witness is None else max(
            1e-2, _l2(jgrads[path], witness[path]))
        assert _l2(g, jgrads[path]) <= bar, (path, _l2(g, jgrads[path]), bar)
    merged = {"params": variables["params"],
              "state": jax.tree.map(np.asarray, jstate)}
    jeval, _ = jblock.apply(merged, jnp.asarray(x), train=False)
    block.eval()
    with torch.no_grad():
        _assert_close(block(torch.from_numpy(x)), jeval, dname, "eval after an update")


def _map_block(std, fused_state):
    """A standard dense block's {params, state} (Sequential of Concat(Identity,
    body)) in the fused layout: body 0, 3, 4, 7 are bn1, conv1, bn2, conv2;
    the banks keep `fused_state`'s."""
    params, state = {}, dict(fused_state)
    for i in range(len(std["params"])):
        body, body_state = std["params"][str(i)]["1"], std["state"][str(i)]["1"]
        params.update({f"bn1_{i}": body["0"], f"conv1_{i}": body["3"], f"bn2_{i}": body["4"],
                       f"conv2_{i}": body["7"]})
        state[f"bn2_{i}"] = body_state["4"]
    return params, state


def _dn121(monkeypatch, fused, **kw):
    with monkeypatch.context() as m:
        m.setenv("CONVNETS_TPU_DENSENET_FUSED", "1" if fused else "0")
        return build_model("densenet", Settings(kind="121", input_size=(3, 32, 32),
                                                num_classes=10, mixed_precision=False,
                                                dropout_rate=0.0, **kw), device="cpu")


def test_fused_dn121_computes_what_the_standard_one_does(monkeypatch):
    """The port's fused DN121@32 against its standard DN121 with the same
    weights: train logits, loss, every gradient, each bank's running
    statistics against the first consumer's bn1 slice, eval logits after
    the update. fp32; the two differ by summation order only."""
    std, fused = _dn121(monkeypatch, False), _dn121(monkeypatch, True)
    assert sum(isinstance(m, DenseBlockFused) for m in fused.modules()) == 4
    sv = bridge.export_jax_variables(std)
    fv = bridge.export_jax_variables(fused)
    blocks = [k for k in sv["params"] if k in fv["params"] and "bank_0" in fv["state"].get(k, {})]
    assert blocks == ["2", "4", "6", "8"]
    for k in blocks:
        fv["params"][k], fv["state"][k] = _map_block(
            {"params": sv["params"][k], "state": sv["state"][k]}, fv["state"][k])
    for k in sv["params"]:
        if k not in blocks:
            fv["params"][k] = sv["params"][k]
    for k in sv["state"]:
        if k not in blocks:
            fv["state"][k] = sv["state"][k]
    bridge.load_jax_variables(fused, fv)
    x = torch.from_numpy(np.random.RandomState(2).rand(4, 32, 32, 3).astype(np.float32))
    y = torch.tensor([1, 3, 5, 7])
    outs = {}
    for name, model in (("std", std), ("fused", fused)):
        model.train()
        logits = model(x)
        loss = ops.cross_entropy_sum(logits, y, torch.ones(4))
        params = dict(model.named_parameters())
        paths = bridge.param_paths(model)
        grads = dict(zip((paths[n] for n in params),
                         torch.autograd.grad(loss, list(params.values()))))
        model.eval()
        with torch.no_grad():
            outs[name] = (logits, loss, grads, model(x), bridge.export_jax_variables(model))
    (ls, lo_s, gs, es, vs), (lf, lo_f, gf, ef, vf) = outs["std"], outs["fused"]
    np.testing.assert_allclose(lf.detach().numpy(), ls.detach().numpy(), atol=1e-5, rtol=1e-4)
    assert abs(float(lo_f.detach()) - float(lo_s.detach())) <= 1e-5 * abs(float(lo_s.detach()))
    mapped = {}
    for path, g in gs.items():
        if path[0] in blocks:
            i, branch, layer = path[1], path[2], path[3]
            assert branch == "1"
            name = {"0": "bn1", "3": "conv1", "4": "bn2", "7": "conv2"}[layer]
            mapped[(path[0], f"{name}_{i}", *path[4:])] = g
        else:
            mapped[path] = g
    assert set(mapped) == set(gf)
    for path, g in gf.items():
        assert _l2(g, mapped[path]) <= 1e-4, (path, _l2(g, mapped[path]))
    np.testing.assert_allclose(ef.numpy(), es.numpy(), atol=1e-5, rtol=1e-4)
    for k in blocks:
        std_state, fused_state = vs["state"][k], vf["state"][k]
        lo = 0
        for j in range(len(std_state)):
            bank = fused_state[f"bank_{j}"]
            w = bank["mean"].shape[0]
            first = std_state[str(j)]["1"]["0"]  # layer j's bn1 first sees block j
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(bank[leaf], first[leaf][lo:lo + w], atol=1e-6,
                                           rtol=1e-5, err_msg=f"{k}/bank_{j}/{leaf}")
            lo += w


def test_the_bridge_carries_the_jax_fused_layout_both_ways(monkeypatch, tmp_path):
    """JAX's fused DN121 variables (layout from jax.eval_shape, numpy
    values) load into the port's fused DN121; the port's export and its
    .ckpt.npz give the same tree back, key for key, as the JAX package
    reads it."""
    monkeypatch.setenv("CONVNETS_TPU_DENSENET_FUSED", "1")
    setting = dict(kind="121", input_size=(3, 32, 32), num_classes=10, mixed_precision=False)
    jm = jax_build_model("densenet", JSettings(**setting))
    variables = numpy_variables(jax.eval_shape(jm.init, jax.random.key(0)), 121)
    assert "bank_5" in variables["state"]["2"] and "bank_6" not in variables["state"]["2"]
    model = build_model("densenet", Settings(**setting, output_dir=str(tmp_path)),
                        device="cpu")
    bridge.load_jax_variables(model, variables)
    want = bridge._flatten(variables)
    got = bridge._flatten(bridge.export_jax_variables(model))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))
    trainer = Trainer(model)
    trainer.init_state()
    bridge.load_jax_variables(model, variables)
    path = trainer.save_checkpoint(str(tmp_path / "fused.ckpt.npz"))
    trees, _ = jckpt.load_checkpoint(path)
    back = bridge._flatten({"params": trees["params"], "state": trees["model_state"]})
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg="/".join(k))
    trainer.close()


def test_a_fused_densenet_artifact_serves_what_the_live_model_serves(monkeypatch, tmp_path):
    """A DenseNet with fused blocks (cut to two blocks of two layers)
    exports as one file whose uint8 requests give the live model's logits
    exactly."""
    from convnets_tpu_torch.models import densenet
    from convnets_tpu_torch.serve import ServingModel, load_artifact, save_artifact

    monkeypatch.setitem(densenet.CONFIG, "121", (8, [2, 2], 16))
    model = _dn121(monkeypatch, True)
    assert sum(isinstance(m, DenseBlockFused) for m in model.modules()) == 2
    stats = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))
    path = str(tmp_path / "fused.pt2")
    save_artifact(path, model, input_dtype="uint8", stats=stats)
    x = np.random.RandomState(0).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    live = ServingModel(model, input_dtype="uint8", stats=stats)
    np.testing.assert_array_equal(np.asarray(load_artifact(path, device="cpu")(x)),
                                  np.asarray(live(x)))
