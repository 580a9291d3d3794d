"""The port's MobileNet-v1, DenseNet-121 and ResNeXt against the JAX
package, on the CPU.

Eval and serving: weights from the JAX init with BN randomized by numpy,
carried into the port by the bridge; fp32 logits at atol/rtol 1e-4 (the
bar of tests/test_model_parity.py:223). Train: one SGD step of each family
against the JAX engine's own step (DenseNet and ResNeXt reduced to small
entries patched into both packages' CONFIG), bars stated at the test. Dispatch:
which kernel wrapper each layer reaches, counted per forward, so the
launch counts chip_smoke.py demands on the card are checked here first.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.models import densenet as jax_densenet
from convnets_tpu.models import resnext as jax_resnext
from convnets_tpu.serve.export import _serving_forward as jax_serving_forward
from convnets_tpu.settings import Settings
from convnets_tpu_torch import bridge
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.models import densenet, resnext
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.serve import ServingModel
from test_torch_resnet import STATS, _randomize_bn
from test_torch_train import _check_moments, _check_variables, _run_both, _settings
from torch_one_thread import one_intra_op_thread  # noqa: F401

TOL = 1e-4
LR = 5e-5
FAMILIES = [("mobilenet_v1", "v1"), ("densenet", "121"), ("resnext", "26")]


@functools.lru_cache(maxsize=None)
def _jax_model(arch, kind):
    setting = Settings(kind=kind, input_size=(3, 32, 32), num_classes=10,
                       mixed_precision=False)
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


@pytest.mark.parametrize("arch,kind,expected", [("densenet", "121", 6964106),
                                                ("mobilenet_v1", "v1", 3217226),
                                                ("resnext", "26", 13360970)])
def test_param_count_parity(arch, kind, expected):
    """The totals of tests/test_models.py:24-25 (10 classes); ResNeXt-26's
    is the JAX init's at 32² (its classifier reads the flattened 1×1×2048)."""
    model = build_model(arch, Settings(kind=kind, input_size=(3, 32, 32), num_classes=10),
                        device="cpu")
    assert sum(p.numel() for p in model.parameters()) == expected


# wrapper calls per forward on the card: each is one kernel launch (plus one
# reduction launch per conv2d_stats)
DISPATCH = {
    ("mobilenet_v1", "v1", "eval"): {"conv2d_fused": 14, "depthwise_conv2d": 13},
    ("mobilenet_v1", "v1", "train"): {"conv2d_stats": 14, "depthwise_conv2d": 13},
    ("densenet", "121", "eval"): {"conv2d_fused": 120, "max_pool2d": 1, "avg_pool2d": 3},
    ("densenet", "121", "train"): {"conv2d_stats": 1, "conv2d_fused": 119, "max_pool2d": 1,
                                   "avg_pool2d": 3},
    # 37 dense convs (stem, 3 per block less the grouped one, 4 shortcuts)
    # and the 16 grouped 3x3s of ResNeXt-50
    ("resnext", "50", "eval"): {"conv2d_fused": 37, "grouped_conv2d_fused": 16, "max_pool2d": 1},
    ("resnext", "50", "train"): {"conv2d_stats": 37, "grouped_conv2d_stats": 16,
                                 "max_pool2d": 1},
    # batch_norm=False: conv2d_train and grouped_conv2d_train, forwards
    # through the fused kernels without epilogue
    ("resnext", "50", "train_nobn"): {"conv2d_fused": 37, "grouped_conv2d_fused": 16,
                                      "max_pool2d": 1},
}


@pytest.mark.parametrize("arch,kind,mode", list(DISPATCH))
def test_kernel_dispatch_per_forward(arch, kind, mode, monkeypatch):
    calls = {}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for name in ("conv2d_fused", "conv2d_stats", "depthwise_conv2d", "max_pool2d",
                 "avg_pool2d", "grouped_conv2d_fused", "grouped_conv2d_stats"):
        monkeypatch.setattr(kernels, name, counting(name, getattr(kernels, name)))
    setting = Settings(kind=kind, input_size=(3, 32, 32), num_classes=10,
                       mixed_precision=False, dropout_rate=0.0,
                       batch_norm=mode != "train_nobn")
    model = build_model(arch, setting, device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32))
    if mode.startswith("train"):
        model.train()(x).sum().backward()
    else:
        with torch.inference_mode():
            model(x)
    assert calls == DISPATCH[(arch, kind, mode)]


@pytest.mark.parametrize("arch,kind,grad_bar", [("mobilenet_v1", "v1", 1e-2),
                                                ("densenet", "tiny", 1e-3),
                                                ("resnext", "tiny", 1e-3)])
def test_train_step_matches_jax_one_sgd_step(arch, kind, grad_bar, monkeypatch):
    """The port's step against the JAX engine's _build_train_step (lax
    composition on the CPU) at batch 4, 32²: loss to 1e-4, params to 1e-4
    and the SGD velocity (the step's gradient) per leaf to `grad_bar` of its
    largest element. DenseNet runs a two-block entry (growth 8, blocks
    [2, 2], 16 stem features) patched into both packages' CONFIG, at the
    bar of test_torch_train.py (1e-3).

    Gradient elements reach ~460 here (the stem's), so lr is 5e-5 for the
    params to agree to 1e-4. MobileNet's
    last stages run BN over 4 samples at 1×1: the port against itself with
    its conv weights ×(1 + 1e-7·N(0,1)) already differs by up to 1.6e-3 of
    a leaf's largest gradient (2.6e-3 against JAX), so its bar is 1e-2,
    far below the O(1) of a wrong formula. ResNeXt runs a two-stage
    bottleneck entry (64 and 128 filters, one block each: Cin/G = 2 and 4
    at cardinality 32, the grouped kernels' narrowest cases) at 1e-3."""
    for config in (jax_densenet.CONFIG, densenet.CONFIG):
        monkeypatch.setitem(config, "tiny", (8, [2, 2], 16))
    for config in (jax_resnext.CONFIG, resnext.CONFIG):
        monkeypatch.setitem(config, "tiny", ("bottleneck", [(64, 1, 1), (128, 1, 2)]))
    js, jout, model, state, tout = _run_both(_settings("sgd", LR, kind=kind), 1, arch=arch)
    np.testing.assert_allclose(tout, jout, rtol=1e-4)
    _check_variables(model, js, 1e-4)
    _check_moments(model, state, js, ("momentum",), grad_bar)
