"""The port's ResNet eval path against the JAX package, on the CPU.

Weights are made by the JAX init, their BN parameters and statistics
randomized with numpy, and carried into the port by the bridge; inputs are
numpy arrays from a seed. fp32 throughout, at the bar of
tests/test_model_parity.py:223 (atol/rtol 1e-4).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu import ops as jax_ops
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.serve.export import _metadata as jax_metadata
from convnets_tpu.serve.export import _serving_forward as jax_serving_forward
from convnets_tpu.settings import Settings
from convnets_tpu.train.checkpoint import save_checkpoint
from convnets_tpu_torch import bridge, nn, ops
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.serve import ServingModel
from convnets_tpu_torch.train import build_train_step, create_train_state, load_jax_checkpoint
from torch_one_thread import one_intra_op_thread  # noqa: F401

TOL = 1e-4
STATS = (np.array([0.49, 0.48, 0.45], np.float32), np.array([0.25, 0.24, 0.26], np.float32))


def _randomize_bn(tree, rng, path=()):
    """Non-trivial BN scale/bias/mean/var, so the epilogue fold is exercised
    (a fresh init has scale 1, bias 0, mean 0, var 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng, path + (k,))
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    setting = Settings(kind=kind, input_size=(3, 32, 32), num_classes=10,
                       mixed_precision=False)
    jm = jax_build_model("resnet", setting)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rng = np.random.RandomState(int(kind))
    variables = {"params": _randomize_bn(variables["params"], rng),
                 "state": _randomize_bn(variables["state"], rng)}
    return setting, jm, variables


def _port(kind, variables=None):
    setting, _, jvars = _jax_model(kind)
    model = build_model("resnet", setting, device="cpu")
    bridge.load_jax_variables(model, jvars if variables is None else variables)
    return model


def _images(n=2, seed=1):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("kind", ["18", "26"])
def test_eval_logits_match_jax(kind):
    _, jm, variables = _jax_model(kind)
    x = _images()
    want, _ = jm.apply(variables, jnp.asarray(x), train=False)
    got = _port(kind)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("input_dtype,output", [("uint8", "logits"), ("float32", "probs")])
def test_serving_forward_matches_jax(input_dtype, output):
    _, jm, variables = _jax_model("18")
    rng = np.random.RandomState(2)
    if input_dtype == "uint8":
        x = rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    else:
        x = rng.rand(3, 32, 32, 3).astype(np.float32)
    fwd = jax_serving_forward(jm, variables, output, STATS, input_dtype)
    want = np.asarray(jax.jit(fwd)(jnp.asarray(x)))
    server = ServingModel(_port("18"), output=output, stats=STATS, input_dtype=input_dtype)
    got = server(x).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert (server.predict(x) == want.argmax(-1)).all()
    assert server(x[0]).shape == (1, 10)  # one HWC image gains the batch axis


@pytest.mark.parametrize("input_dtype,request_dtype", [
    ("uint8", np.float32),    # [0, 1] floats would be cut to 0/1
    ("uint8", np.int64),
    ("float32", np.uint8),    # 0-255 would pass without the /255
    ("float32", np.int32),
])
def test_serving_refuses_a_request_of_another_wire_dtype(input_dtype, request_dtype):
    server = ServingModel(_port("18"), stats=STATS, input_dtype=input_dtype)
    x = np.random.RandomState(4).randint(0, 2, (2, 32, 32, 3)).astype(request_dtype)
    with pytest.raises(TypeError):
        server(x)


@pytest.mark.parametrize("request_dtype", [np.float64, np.float16])
def test_float32_serving_casts_other_floats(request_dtype):
    server = ServingModel(_port("18"), stats=STATS, input_dtype="float32")
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(request_dtype)
    want = server(x.astype(np.float32)).numpy()
    np.testing.assert_array_equal(server(x).numpy(), want)


def test_serving_metadata_has_the_jax_keys():
    setting, jm, _ = _jax_model("18")
    want = jax_metadata(jm, output="logits", batch_size=None, platforms=["cpu"],
                        stats=STATS, input_dtype="uint8")
    got = ServingModel(_port("18"), stats=STATS, input_dtype="uint8").meta
    # the port adds the input contract (ADVICE.md finding 2) to the JAX keys
    assert set(got) - {"torch_version", "input_contract"} == set(want) - {"jax_version"}
    for key in set(want) - {"jax_version"}:
        assert got[key] == want[key], key


def test_class_names_predict():
    names = [f"c{i}" for i in range(10)]
    server = ServingModel(_port("18"), class_names=names)
    x = _images(3, seed=3)
    idx = server(x).argmax(-1).numpy()
    assert server.predict(x) == [names[i] for i in idx]


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    setting, jm, variables = _jax_model("26")
    path = str(tmp_path / "ResNet26-1-best_score.ckpt.npz")
    save_checkpoint(path, params=variables["params"], model_state=variables["state"],
                    opt_state={}, lr=0.01, loss_scale=1.0, epoch_results={},
                    settings_dict=setting.to_dict(), scheduler_state={},
                    optimizer_name="adam")
    loaded = load_jax_checkpoint(path)
    x = _images(seed=4)
    want, _ = jm.apply(variables, jnp.asarray(x), train=False)
    got = _port("26", loaded)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def _edit(variables, edit):
    v = jax.tree.map(np.copy, variables)
    edit(v)
    return v


@pytest.mark.parametrize("case,match", [
    ("missing", "missing leaves"), ("misshaped", "shape"), ("unmapped", "unmapped leaves")])
def test_bridge_raises_on_a_bad_leaf(case, match):
    _, _, variables = _jax_model("18")
    edits = {
        "missing": lambda v: v["state"]["0"]["1"].pop("var"),
        "misshaped": lambda v: v["params"]["0"]["0"].update(
            w=np.transpose(v["params"]["0"]["0"]["w"], (3, 2, 0, 1))),
        "unmapped": lambda v: v["params"]["0"]["0"].update(b=np.zeros(64, np.float32)),
    }
    with pytest.raises(ValueError, match=match):
        _port("18", _edit(variables, edits[case]))


@pytest.mark.parametrize("arch,kind,conv_bn_relus", [
    ("resnet", "50", 53), ("mobilenet_v1", "v1", 27), ("densenet", "121", 1),
    ("resnext", "50", 53)])
def test_rn50_at_224_has_the_jax_variable_layout(arch, kind, conv_bn_relus):
    """The bridge layout of each served configuration at 224² equals the
    tree the JAX init builds (shapes only: nothing is computed)."""
    setting = Settings(kind=kind, input_size=(3, 224, 224), num_classes=1000,
                       mixed_precision=True)
    jm = jax_build_model(arch, setting)
    tree = jax.eval_shape(lambda k: jm.module.init(k, (1, 224, 224, 3)), jax.random.key(0))
    want = {tuple(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    model = build_model(arch, setting, device="cpu")
    got = {path: tuple(getattr(mod, name).shape)
           for path, (mod, name) in bridge.jax_layout(model).items()}
    assert got == want
    assert sum(isinstance(m, nn.ConvBNReLU) for m in model.modules()) == conv_bn_relus
    assert model.policy.compute_dtype == torch.bfloat16


def test_remat_trains_the_fused_densenet_builds_and_the_rest_runs_or_raises(monkeypatch):
    """Train mode runs, Remat in train mode too (its recompute: tests/
    test_torch_remat.py), and CONVNETS_TPU_DENSENET_FUSED=1 builds the
    shared-statistics blocks (tests/test_torch_densenet_fused.py). The
    dilated grouped conv and the one with 64 input channels per group now
    run and equal the plain conv → BN → ReLU; the depthwise conv with a
    channel multiplier of 2, which raised before the depthwise envelope was
    widened, equals JAX's lax conv → BN → ReLU in eval and train. Mixup is
    ported: its step builds, and refuses to run without the step's
    DataRng."""
    remat = build_model("resnet", Settings(kind="18", input_size=(3, 32, 32), num_classes=10,
                                           mixed_precision=False, remat=True), device="cpu")
    assert sum(isinstance(m, nn.Remat) for m in remat.modules()) == 8
    x = torch.from_numpy(_images())
    remat(x)  # eval mode runs the wrapped blocks
    with nn.use_generator(torch.Generator().manual_seed(0)):
        logits = remat.train()(x)
    torch.autograd.grad(logits.sum(), [p for p in remat.parameters()])  # the recompute runs
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
    remat.eval()
    with monkeypatch.context() as m:
        m.setenv("CONVNETS_TPU_DENSENET_FUSED", "1")
        fused = build_model("densenet", Settings(kind="121", input_size=(3, 32, 32),
                                                 num_classes=10), device="cpu")
    assert sum(type(m).__name__ == "DenseBlockFused" for m in fused.modules()) == 4
    mixup = Settings(kind="18", input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                     mixup=0.2)
    mixup_state = create_train_state(build_model("resnet", mixup, device="cpu"))
    with pytest.raises(ValueError, match="DataRng"):
        build_train_step(mixup_state)(mixup_state, x, torch.zeros(2, dtype=torch.int64))
    gen = torch.Generator().manual_seed(0)
    for cin, dilation in ((4, 2), (128, 1)):
        grouped = nn.conv_block(8, 3, padding=dilation, dilation=dilation, groups=2)
        grouped.init(gen, (1, 8, 8, cin))
        conv, bn = grouped._modules["0"], grouped._modules["1"]
        with torch.no_grad():
            bn.running_mean.copy_(0.1 * torch.randn(8, generator=gen))
            bn.running_var.uniform_(0.7, 1.3, generator=gen)
        xg = torch.randn(2, 8, 8, cin, generator=gen)
        y = ops.conv2d(xg, conv.weight, padding=dilation, dilation=dilation, groups=2)
        want = ops.relu(ops.batch_norm_inference(y, bn.running_mean, bn.running_var,
                                                 bn.weight, bn.bias))
        with torch.no_grad():
            np.testing.assert_allclose(grouped.eval()(xg).numpy(), want.numpy(), rtol=TOL,
                                       atol=TOL)
            want = ops.relu(ops.batch_norm_train(y, bn.running_mean, bn.running_var,
                                                 bn.weight, bn.bias)[0])
            np.testing.assert_allclose(grouped.train()(xg).numpy(), want.numpy(), rtol=TOL,
                                       atol=TOL)
    multiplier = nn.conv_block(16, 3, padding=1, groups=8)
    multiplier.init(gen, (1, 8, 8, 8))
    conv, bn = multiplier._modules["0"], multiplier._modules["1"]
    with torch.no_grad():
        bn.running_mean.copy_(0.1 * torch.randn(16, generator=gen))
        bn.running_var.uniform_(0.7, 1.3, generator=gen)
    xm = torch.randn(2, 8, 8, 8, generator=gen)
    y = torch.from_numpy(np.array(jax_ops.conv2d(
        jnp.asarray(xm.numpy()), jnp.asarray(conv.weight.detach().numpy()), padding=1,
        groups=8)))
    with torch.no_grad():
        want = ops.relu(ops.batch_norm_inference(y, bn.running_mean, bn.running_var,
                                                 bn.weight, bn.bias))
        np.testing.assert_allclose(multiplier.eval()(xm).numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
        want = ops.relu(ops.batch_norm_train(y, bn.running_mean, bn.running_var, bn.weight,
                                             bn.bias)[0])
        np.testing.assert_allclose(multiplier.train()(xm).numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
