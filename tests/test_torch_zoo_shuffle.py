"""The port's ShuffleNet-v1 (g1, g2, g3, g4, g8) and AlexNet (both kinds)
against the JAX package, on the CPU, and the serving artifact of
SK-ResNet-26 and ShuffleNet-v1-g4.

Weights: numpy draws in the JAX init's layout (the tree from
jax.eval_shape, cached per family; test_torch_zoo_attention.numpy_variables)
with BN randomized, carried into the port by the bridge. fp32 logits at
atol/rtol 1e-4 for ShuffleNet g4 and g3 at 32² b2, AlexNet-cifar at 32² b2
and AlexNet-imagenet at 224² b1. Parameter counts and output shapes of the
five ShuffleNet kinds against the JAX model's (eval_shape, out_shape).
`channel_shuffle` against JAX's permutation. One SGD step of a ShuffleNet
g4 cut to three units against the JAX engine's own step. Dispatch: the
kernel wrapper calls per eval forward and per train step. The artifacts:
exported on the CPU, loaded back, served against the live model.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu import ops as jops
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.models import shufflenet_v1 as jax_shufflenet_v1
from convnets_tpu.settings import Settings
from convnets_tpu_torch import bridge, ops
from convnets_tpu_torch.models import build_model, shufflenet_v1
from convnets_tpu_torch.serve import ServingModel, load_artifact, save_artifact
from test_torch_train import _check_variables, _flat, _settings
from test_torch_zoo_attention import count_dispatch, numpy_variables
from test_torch_zoo_classic import _run_both
from torch_one_thread import one_intra_op_thread  # noqa: F401

TOL = 1e-4
LR = 5e-5
KINDS = ("g1", "g2", "g3", "g4", "g8")
# the JAX models' counts at 3x32x32, 10 classes (g4: the reference's
# published count)
PARAMS = {"g1": 960_706, "g2": 940_858, "g3": 914_338, "g4": 890_234, "g8": 913_138}


def _setting(kind, image=32):
    return Settings(kind=kind, input_size=(3, image, image), num_classes=10,
                    mixed_precision=False)


@functools.lru_cache(maxsize=None)
def _jax_model(arch, kind, image=32):
    setting = _setting(kind, image)
    jm = jax_build_model(arch, setting)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    return setting, jm, shapes, numpy_variables(shapes, len(arch) + len(kind))


def _port(arch, kind, image=32):
    setting, _, _, variables = _jax_model(arch, kind, image)
    model = build_model(arch, setting, device="cpu")
    bridge.load_jax_variables(model, variables)
    return model


@pytest.mark.parametrize("kind", KINDS)
def test_shufflenet_shapes_and_param_counts_match_jax(kind):
    """Every unit's output shape (stride-2 units: the pooled identity
    concatenated before the body) and the parameter count, against the
    JAX model's."""
    _, jm, shapes, _ = _jax_model("shufflenet_v1", kind)
    model = build_model("shufflenet_v1", _setting(kind), device="cpu")
    mine, theirs = (1, 32, 32, 3), (1, 32, 32, 3)
    for port_child, jax_child in zip(model.module._modules.values(),
                                     jm.module.layers.values()):
        mine, theirs = port_child.out_shape(mine), jax_child.out_shape(theirs)
        assert mine == tuple(theirs)
    assert mine == (1, 10)
    want = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want == PARAMS[kind]


@pytest.mark.parametrize("arch,kind,image,batch", [
    ("shufflenet_v1", "g4", 32, 2), ("shufflenet_v1", "g3", 32, 2), ("alexnet", "cifar", 32, 2),
    ("alexnet", "imagenet", 224, 1)])
def test_eval_logits_match_jax(arch, kind, image, batch):
    _, jm, _, variables = _jax_model(arch, kind, image)
    x = np.random.RandomState(1).rand(batch, image, image, 3).astype(np.float32)
    want, _ = jax.jit(functools.partial(jm.apply, train=False))(variables, jnp.asarray(x))
    got = _port(arch, kind, image)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (batch, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("groups,dtype", [(1, torch.float32), (2, torch.float32),
                                          (3, torch.float32), (4, torch.bfloat16),
                                          (8, torch.float32)])
def test_channel_shuffle_matches_jax(groups, dtype):
    """The NHWC permutation of convnets_tpu/ops/activations.py:32 (not
    NCHW's view order), exact in either dtype; channels that do not divide
    raise."""
    x = np.random.RandomState(groups).randn(2, 3, 3, 24 * groups).astype(np.float32)
    want = np.asarray(jops.channel_shuffle(jnp.asarray(x), groups))
    got = ops.channel_shuffle(torch.from_numpy(x).to(dtype), groups)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(want.copy()).to(dtype).float().numpy())
    if groups > 1:
        with pytest.raises(ValueError, match="not divisible"):
            ops.channel_shuffle(torch.zeros(1, 1, 1, 24 * groups + 1), groups)


def test_shufflenet_train_step_matches_jax_one_sgd_step(monkeypatch):
    """One SGD step of a ShuffleNet g4 cut to three units (a stride-2 unit
    with the ungrouped first compress, a stride-1 unit, a stride-2 unit with
    a wide-group compress, Cin/G 68, and its pooled identity; patched into
    both packages' CONFIG) against the JAX engine's _build_train_step at
    32², batch 8, with the bars of tests/test_torch_train.py: loss to 1e-4,
    params and BN statistics to 1e-4, the SGD velocity per leaf to 1e-3 of
    its largest element. One kind of leaf is held to 1e-3 of the step's
    largest velocity element instead: the bias of each depthwise conv's
    BN. That BN feeds the expand conv's BN, which removes any per-channel
    constant, so its true gradient is 0 and both steps hold only rounding
    noise there (~1e-8, against velocities up to ~1e-1)."""
    units = [(2, 1, 272), (1, 1, 272), (2, 1, 544)]
    for module in (jax_shufflenet_v1, shufflenet_v1):
        monkeypatch.setitem(module.CONFIG, "g4", units)
    js, jout, model, state, tout, _, _ = _run_both(_settings("sgd", LR, kind="g4"),
                                                  "shufflenet_v1", 8)
    np.testing.assert_allclose(tout, jout, rtol=1e-4)
    _check_variables(model, js, 1e-4)
    mine = _flat(bridge.export_jax_opt_state(model, state.opt_state)["momentum"])
    want = _flat(jax.tree.map(np.asarray, js.opt_state.momentum))
    assert set(mine) == set(want)
    largest = max(float(np.abs(v).max()) for v in want.values())
    cancelled = [k for k in want if k.endswith("depthwise/1/bias")]
    assert len(cancelled) == 3
    for k in want:
        scale = largest if k in cancelled else float(np.abs(want[k]).max())
        assert float(np.abs(mine[k] - want[k]).max()) <= 1e-3 * scale + 1e-12, k


# wrapper calls per eval forward and per train step (forward + backward):
# ShuffleNet-g4, 16 units: the stem conv and the first unit's ungrouped
# compress (dense), 15 grouped compresses and 16 grouped expands, 16
# depthwise 3x3s, the stem max pool and the 3 pooled identities (their
# backward through pool2d_backward, as the max pool's); AlexNet: 5 convs
# and 3 max pools
DISPATCH = {
    ("shufflenet_v1", "g4", 32): {
        "eval": {"conv2d_fused": 2, "grouped_conv2d_fused": 31, "depthwise_conv2d": 16,
                 "max_pool2d": 1, "avg_pool2d": 3},
        "train": {"conv2d_stats": 2, "grouped_conv2d_stats": 31, "depthwise_conv2d": 16,
                  "max_pool2d": 1, "avg_pool2d": 3, "pool2d_backward": 4},
        "train_nobn": {"conv2d_fused": 2, "grouped_conv2d_fused": 31, "depthwise_conv2d": 16,
                       "max_pool2d": 1, "avg_pool2d": 3, "pool2d_backward": 4}},
    ("alexnet", "imagenet", 224): {
        "eval": {"conv2d_fused": 5, "max_pool2d": 3},
        "train": {"conv2d_stats": 5, "max_pool2d": 3, "pool2d_backward": 3}},
}


@pytest.mark.parametrize("arch,kind,image,mode",
                         [(*key, m) for key, modes in DISPATCH.items() for m in modes])
def test_kernel_dispatch_per_forward_and_step(arch, kind, image, mode, monkeypatch):
    got = count_dispatch(monkeypatch, arch, kind, mode, image)
    assert got == DISPATCH[(arch, kind, image)][mode]


@pytest.mark.parametrize("arch,kind", [("sk_resnet", "26"), ("shufflenet_v1", "g4")])
def test_cpu_artifact_serves_as_the_live_model(arch, kind, tmp_path):
    """Exported on the CPU (uint8 wire, symbolic batch), loaded back: SK's
    stack, path sum and softmax, the dilated grouped conv op, and
    ShuffleNet's channel shuffle, pooled identity and concat trace; b3 and
    b5 from the one file equal the live ServingModel."""
    model = build_model(arch, _setting(kind), device="cpu")
    path = str(tmp_path / f"{arch}.bin")
    save_artifact(path, model, input_dtype="uint8")
    served = load_artifact(path, device="cpu")
    live = ServingModel(model, input_dtype="uint8")
    rng = np.random.RandomState(9)
    for batch in (3, 5):
        x = rng.randint(0, 256, (batch, 32, 32, 3)).astype(np.uint8)
        got, want = served(x), live(x)
        assert got.shape == (batch, 10)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
