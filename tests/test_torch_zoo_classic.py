"""The port's LeNet, ConvNet, the template net (`mynetwork`), VGG-16,
SqueezeNet 1.1 and InceptionNet-v1 against the JAX package, on the CPU.

Eval and serving: weights from the JAX init with BN randomized by numpy,
carried into the port by the bridge; fp32 logits at atol/rtol 1e-4 (the
bar of tests/test_torch_zoo.py). Parameter counts: the JAX init's.
Dispatch: the kernel wrapper calls per eval forward and per train step
(forward and backward), the launches chip_smoke.py phase 12 demands on the
card. Train: one SGD step of LeNet, a three-Fire SqueezeNet 1.1 and a
two-block InceptionNet-v1 (patched into both packages' CONFIG and BLOCKS)
against the JAX engine's own step, and one of the whole SqueezeNet 1.1
against JAX's loss and an fp64 twin's gradient. SqueezeNet 1.0 collapses at 32² (its
third 3x3/2 pool sees 2x2), so it is only checked as a shape at 224².
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.models import inceptionnet_v1 as jax_inceptionnet_v1
from convnets_tpu.models import squeezenet as jax_squeezenet
from convnets_tpu.serve.export import _serving_forward as jax_serving_forward
from convnets_tpu.settings import Settings
from convnets_tpu.train.engine import Trainer as JaxTrainer
from convnets_tpu_torch import bridge, nn
from convnets_tpu_torch.core.precision import Policy
from convnets_tpu_torch.models import build_model, inceptionnet_v1, squeezenet
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.serve import ServingModel
from convnets_tpu_torch.train import build_train_step, create_train_state
from test_torch_resnet import STATS, _randomize_bn
from test_torch_train import _check_moments, _check_variables, _flat, _settings, _t
from torch_one_thread import one_intra_op_thread  # noqa: F401

TOL = 1e-4
LR = 5e-5
FAMILIES = [("lenet", "0"), ("convnet", "0"), ("mynetwork", "base"), ("vggnet", "16"),
            ("squeezenet", "1.1"), ("inceptionnet_v1", "v1")]


def _setting(kind, **kw):
    return Settings(kind=kind, input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                    **kw)


@functools.lru_cache(maxsize=None)
def _jax_model(arch, kind):
    setting = _setting(kind)
    jm = jax_build_model(arch, setting)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rng = np.random.RandomState(len(arch))
    variables = {"params": _randomize_bn(variables["params"], rng),
                 "state": _randomize_bn(variables["state"], rng)}
    return setting, jm, variables


def _port(arch, kind):
    setting, _, variables = _jax_model(arch, kind)
    model = build_model(arch, setting, device="cpu")
    bridge.load_jax_variables(model, variables)
    return model


@pytest.mark.parametrize("arch,kind", FAMILIES)
def test_eval_logits_match_jax(arch, kind):
    _, jm, variables = _jax_model(arch, kind)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    want, _ = jm.apply(variables, jnp.asarray(x), train=False)
    got = _port(arch, kind)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,kind", FAMILIES)
def test_uint8_serving_forward_matches_jax(arch, kind):
    _, jm, variables = _jax_model(arch, kind)
    x = np.random.RandomState(2).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    fwd = jax_serving_forward(jm, variables, "logits", STATS, "uint8")
    want = np.asarray(jax.jit(fwd)(jnp.asarray(x)))
    server = ServingModel(_port(arch, kind), stats=STATS, input_dtype="uint8")
    np.testing.assert_allclose(server(x).numpy(), want, atol=TOL, rtol=TOL)
    assert (server.predict(x) == want.argmax(-1)).all()


@pytest.mark.parametrize("arch,kind", FAMILIES)
def test_param_count_matches_jax(arch, kind):
    _, jm, variables = _jax_model(arch, kind)
    model = build_model(arch, _setting(kind), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == jm.num_params(variables)


@pytest.mark.parametrize("arch", ["lenet", "convnet"])
def test_flatten_linear_keeps_the_jax_row_order(arch):
    """Flatten is NHWC, so the bridged classifier weight (JAX (in, out),
    rows in (H, W, C) order) applies unpermuted: the first Linear's output
    is the NHWC features times the JAX weight, and the same weight on the
    NCHW order of those features is far off (the check has teeth)."""
    _, _, variables = _jax_model(arch, "0")
    model = _port(arch, "0")
    children = list(model.module._modules.values())
    at = next(i for i, m in enumerate(children) if isinstance(m, nn.Flatten))
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32))
    with torch.inference_mode():
        feats = x
        for m in children[:at]:
            feats = m(feats)
        got = children[at + 1](children[at](feats)).numpy()
    linear = variables["params"][str(at + 1)]
    w, b = linear["w"], linear["b"]
    assert w.shape[0] == feats[0].numel() and feats.shape[1] * feats.shape[2] > 1
    nhwc = feats.reshape(2, -1).numpy()
    np.testing.assert_allclose(got, nhwc @ w + b, atol=1e-5, rtol=1e-5)
    nchw = feats.permute(0, 3, 1, 2).reshape(2, -1).numpy()
    assert np.abs(nchw @ w + b - got).max() > 100 * 1e-5 * np.abs(got).max()


def test_squeezenet_1_0_shapes_at_224_and_its_collapse_at_32():
    """1.0 at 224² ends in 12x12 → global pool → (N, classes), with the
    JAX init's parameter count (taken at 64², as tests/test_models.py
    builds 1.0: the count does not depend on the input size); at 32² its
    third 3x3/2 pool sees 2x2, whose output size 0 the port refuses."""
    model = build_model("squeezenet", Settings(kind="1.0", input_size=(3, 224, 224),
                                               num_classes=10, mixed_precision=False),
                        device="cpu")
    shapes, shape = [], (1, 224, 224, 3)
    for child in model.module._modules.values():
        shape = child.out_shape(shape)
        shapes.append(shape)
    assert shapes[-1] == (1, 10) and shapes[-3][1:3] == (12, 12)
    jm = jax_build_model("squeezenet", Settings(kind="1.0", input_size=(3, 64, 64),
                                                num_classes=10, mixed_precision=False))
    variables = jax.eval_shape(jm.init, jax.random.key(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree.leaves(variables["params"]))
    pools, shape = [], (1, 32, 32, 3)
    for child in model.module._modules.values():
        if isinstance(child, nn.MaxPool2d):
            pools.append(child)
            if len(pools) == 3:
                break
        shape = child.out_shape(shape)
    assert shape[1:3] == (2, 2)
    with pytest.raises(ValueError, match="output size 0"):
        pools[-1].out_shape(shape)


# wrapper calls per eval forward and per train step (forward + backward) on
# the card: each is one kernel launch, plus one reduction launch per
# conv2d_stats
DISPATCH = {
    "vggnet": {"eval": {"conv2d_fused": 13, "max_pool2d": 5},
               "train": {"conv2d_stats": 13, "max_pool2d": 5, "pool2d_backward": 5}},
    "inceptionnet_v1": {"eval": {"conv2d_fused": 57, "max_pool2d": 13},
                        "train": {"conv2d_stats": 57, "max_pool2d": 13, "pool2d_backward": 13}},
    "squeezenet": {"eval": {"conv2d_fused": 26, "max_pool2d": 3},
                   "train": {"conv2d_stats": 26, "max_pool2d": 3, "pool2d_backward": 3}},
    "lenet": {"eval": {"conv2d_fused": 2, "max_pool2d": 2},
              "train": {"conv2d_stats": 2, "max_pool2d": 2, "pool2d_backward": 2}},
    "convnet": {"eval": {"conv2d_fused": 2, "max_pool2d": 2},
                "train": {"conv2d_stats": 2, "max_pool2d": 2, "pool2d_backward": 2}},
    "mynetwork": {"eval": {"conv2d_fused": 2, "max_pool2d": 2},
                  "train": {"conv2d_stats": 2, "max_pool2d": 2, "pool2d_backward": 2},
                  # batch_norm=False: conv2d_train, forward through conv2d_fused
                  # without epilogue (the tuner's batch_norm: [False, True])
                  "train_nobn": {"conv2d_fused": 2, "max_pool2d": 2, "pool2d_backward": 2}},
}
KINDS = {"vggnet": "16", "inceptionnet_v1": "v1", "squeezenet": "1.1", "lenet": "0",
         "convnet": "0", "mynetwork": "base"}
COUNTED = ("conv2d_fused", "conv2d_stats", "max_pool2d", "avg_pool2d", "pool2d_backward",
           "depthwise_conv2d", "grouped_conv2d_fused", "grouped_conv2d_stats")


@pytest.mark.parametrize("arch,mode", [(a, m) for a, modes in DISPATCH.items() for m in modes])
def test_kernel_dispatch_per_forward_and_step(arch, mode, monkeypatch):
    calls = {}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for name in COUNTED:
        monkeypatch.setattr(kernels, name, counting(name, getattr(kernels, name)))
    setting = _setting(KINDS[arch], dropout_rate=0.0, batch_norm=mode != "train_nobn")
    model = build_model(arch, setting, device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32))
    if mode.startswith("train"):
        model.train()(x).sum().backward()
    else:
        with torch.inference_mode():
            model(x)
    assert calls == DISPATCH[arch][mode]


def _run_both(setting, arch, batch):
    """One SGD step of both engines from the same weights on one uint8
    batch: (jax final state, jax (loss, correct), port model, port state,
    port (loss, correct), the batch (x, y, w), the starting variables)."""
    trainer = JaxTrainer(jax_build_model(arch, setting), use_mesh=False)
    trainer.init_state()
    step = trainer._get_train_step(augment=False, norm=True)
    start = {"params": jax.tree.map(np.asarray, trainer.state.params),
             "state": jax.tree.map(np.asarray, trainer.state.model_state)}
    model = build_model(arch, setting, device="cpu")
    bridge.load_jax_variables(model, start)
    state = create_train_state(model)
    port_step = build_train_step(state, norm=True)
    rng = np.random.RandomState(7)
    x = rng.randint(0, 256, (batch, 32, 32, 3)).astype(np.uint8)
    y = rng.randint(0, 10, batch).astype(np.int32)
    w = np.ones(batch, np.float32)
    js, loss, correct = step(trainer.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                             jax.random.key(0))
    jout = (float(loss), float(correct))
    loss, correct = port_step(state, _t(x, torch.uint8), _t(y, torch.int64), _t(w))
    return js, jout, model, state, (float(loss), float(correct)), (x, y, w), start


# SqueezeNet 1.1's step runs this reduction (its first three Fire modules,
# ending at 3x3), patched into both packages' CONFIG: see the test
SQUEEZENET_TINY = [("conv", 64, 3, 2), ("maxpool", 3, 2), ("fire", 16, 64, 64),
                   ("fire", 16, 64, 64), ("maxpool", 3, 2), ("fire", 32, 128, 128)]


@pytest.mark.parametrize("arch,kind,batch", [("lenet", "0", 4), ("squeezenet", "tiny", 8),
                                             ("inceptionnet_v1", "tiny", 4)])
def test_train_step_matches_jax_one_sgd_step(arch, kind, batch, monkeypatch):
    """The port's step against the JAX engine's _build_train_step (lax on
    the CPU) at 32², with the bars of tests/test_torch_zoo.py: loss to
    1e-4, params to 1e-4, and the SGD velocity (the step's gradient) per
    leaf to 1e-3 of its largest element. InceptionNet-v1 runs its first
    two blocks and the 3x3/2 pool after them, patched into both packages'
    BLOCKS.

    SqueezeNet runs SQUEEZENET_TINY (its first three Fire modules, the
    Fire concat and the unpadded 3x3/2 pools) at batch 8, the batch at
    which the two packages agree to the bars; at batch 4 and 16 they part
    past the velocity bar. The whole 1.1 parts from JAX on the velocity at
    batch 8 too; test_squeezenet_full_step_matches_jax_loss_and_its_fp64_twin
    shows that the JAX step is the one that departs from exact arithmetic
    there, and holds the whole net's gradient against an fp64 twin."""
    blocks = jax_inceptionnet_v1.BLOCKS[:2] + ["M"]
    for module in (jax_inceptionnet_v1, inceptionnet_v1):
        monkeypatch.setattr(module, "BLOCKS", blocks)
    for config in (jax_squeezenet.CONFIG, squeezenet.CONFIG):
        monkeypatch.setitem(config, "tiny", SQUEEZENET_TINY)
    js, jout, model, state, tout, _, _ = _run_both(_settings("sgd", LR, kind=kind), arch,
                                                  batch)
    np.testing.assert_allclose(tout, jout, rtol=1e-4)
    _check_variables(model, js, 1e-4)
    _check_moments(model, state, js, ("momentum",), 1e-3)


def _exact_conv_bn_relu_train(fp32_fn, conditioning):
    """kernels.conv_bn_relu_train with float64 inputs done in exact-ish
    arithmetic: conv, two-pass batch statistics, normalize and ReLU in
    float64 by autograd (not the port's hand-written backward); other
    dtypes go to `fp32_fn`. Appends each call's largest mean²/var to
    `conditioning`, the factor by which a one-pass E[y²] - E[y]² variance
    multiplies the rounding of its sums."""
    def fn(x, w, scale, bias, stride=1, padding=0, eps=1e-5, relu=True, groups=1, dilation=1,
           winograd=None):
        if x.dtype != torch.float64:
            return fp32_fn(x, w, scale, bias, stride, padding, eps, relu, groups=groups,
                           dilation=dilation, winograd=winograd)
        assert winograd is None  # the twin runs with the Winograd gate unset
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                       stride=stride, padding=padding, dilation=dilation,
                                       groups=groups)
        y = y.permute(0, 2, 3, 1)
        mean, var = y.mean((0, 1, 2)), y.var((0, 1, 2), unbiased=False)
        conditioning.append(float((mean * mean / var).max().detach()))
        out = (y - mean) * torch.rsqrt(var + eps) * scale + bias
        return (out.clamp_min(0) if relu else out), mean.detach(), var.detach()
    return fn


def test_squeezenet_full_step_matches_jax_loss_and_its_fp64_twin(monkeypatch):
    """The whole SqueezeNet 1.1 at 32², batch 8, one SGD step. Against the
    JAX engine's step: loss and correct count to 1e-4. Against an fp64
    twin (the same network, weights and batch in float64, its ConvBNReLUs
    by autograd with two-pass statistics): the BN running statistics to
    1e-4 and the velocity (the step's gradient) per leaf to 1e-3 of the
    leaf's largest element, the bars the other steps meet against JAX.

    Why not the gradient against JAX: on this batch the JAX step's
    velocity departs from the twin's, and from the port's, by about a
    quarter of one leaf (fire 11's 1x1-expand BN bias), while the port
    stays within the bar of the twin; one ReLU mask at the 1x1 stages,
    where BN sees only the batch, falls on the other side in the JAX
    forward's fp32 rounding. Its BN statistics are also farther from the
    twin's than the port's. The statistics are well conditioned (mean²/var
    below 1e2 at every ConvBNReLU), so the one-pass variance that both
    packages use is not the cause. The test prints these distances."""
    setting = _settings("sgd", LR, kind="1.1")
    js, jout, model, state, tout, (x, y, w), start = _run_both(setting, "squeezenet", 8)
    np.testing.assert_allclose(tout, jout, rtol=1e-4)

    conditioning = []
    monkeypatch.setattr(kernels, "conv_bn_relu_train",
                        _exact_conv_bn_relu_train(kernels.conv_bn_relu_train, conditioning))
    twin = build_model("squeezenet", setting, device="cpu")
    bridge.load_jax_variables(twin, start)
    twin.double()
    for module in twin.modules():
        if hasattr(module, "policy"):
            module.policy = Policy(compute_dtype=torch.float64)
    twin_state = create_train_state(twin)
    build_train_step(twin_state, norm=True)(twin_state, _t(x, torch.uint8),
                                            _t(y, torch.int64), _t(w, torch.float64))
    assert len(conditioning) == 26

    exact_bn = _flat(bridge.export_jax_variables(twin)["state"])
    port_bn = _flat(bridge.export_jax_variables(model)["state"])
    ref_bn = _flat(jax.tree.map(np.asarray, js.model_state))
    exact = _flat(bridge.export_jax_opt_state(twin, twin_state.opt_state)["momentum"])
    port = _flat(bridge.export_jax_opt_state(model, state.opt_state)["momentum"])
    ref = _flat(jax.tree.map(np.asarray, js.opt_state.momentum))

    def worst(got, want):
        rel = {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) for k in want}
        k = max(rel, key=rel.get)
        return rel[k], k

    print(f"BN running statistics, max |Δ| / max |s|: port vs fp64 twin "
          f"{worst(port_bn, exact_bn)}, JAX vs fp64 twin {worst(ref_bn, exact_bn)}")
    print(f"velocity per leaf, max |Δ| / max |v|: port vs fp64 twin {worst(port, exact)}, "
          f"JAX vs fp64 twin {worst(ref, exact)}, JAX vs port {worst(ref, port)}; "
          f"max mean²/var {max(conditioning):.3g}")
    assert max(conditioning) < 1e3
    for k, want in exact_bn.items():
        np.testing.assert_allclose(port_bn[k], want, rtol=1e-4, atol=1e-4, err_msg=k)
    for k, want in exact.items():
        assert float(np.abs(port[k] - want).max()) <= 1e-3 * float(np.abs(want).max()), k
