"""The port's public model API against the JAX package's, on the CPU.

- Builder.conv(set_output=): the channel count after True and False, and a
  small Builder network with two set_output=False branches, nn.ChannelShuffle
  and nn.Sigmoid, its fp32 eval logits against its JAX twin at 1e-4 (the
  weights numpy draws in the JAX layout, carried over by the bridge).
- nn.Sigmoid and nn.ChannelShuffle against JAX's layers (values, out_shape).
- Model.summary() against the JAX Model.summary() line for line, for every
  registered family at its smallest kind at 32² (SqueezeNet 1.0 at 64²: its
  32² input is too small in both packages), the JAX variables from
  jax.eval_shape (no JAX init runs), and for the fused DenseNet block,
  Remat and a BN-free net; Trainer.print_summary prints the same text.
- nn.count_params, nn.count_state, Model.out_shape and Model.num_params
  against the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch

from convnets_tpu import models as jax_models
from convnets_tpu import nn as jnn
from convnets_tpu.models.base import Builder as JaxBuilder
from convnets_tpu.models.base import Model as JaxModel
from convnets_tpu.settings import Settings as JaxSettings
from convnets_tpu_torch import bridge, nn
from convnets_tpu_torch.models import Builder, Model, available_models, build_model
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer
from torch_one_thread import one_intra_op_thread  # noqa: F401

LOGIT_TOL = 1e-4
# each registered family at its smallest usable kind (ResNeXt's basic kinds
# 18/34 are shape-inconsistent in both packages), at 32²
FAMILIES = [("alexnet", "cifar", 32), ("convnet", "0", 32), ("densenet", "121", 32),
            ("inceptionnet_v1", "v1", 32), ("lenet", "0", 32), ("mobilenet_v1", "v1", 32),
            ("mynetwork", "base", 32), ("resnet", "18", 32), ("resnext", "26", 32),
            ("se_resnet", "18", 32), ("senet", "26", 32), ("shufflenet_v1", "g1", 32),
            ("sk_resnet", "26", 32), ("sknet", "26", 32), ("squeezenet", "1.1", 32),
            ("squeezenet", "1.0", 64), ("vggnet", "11", 32)]
# the layouts a setting or the build-time gate changes: DenseBlockFused,
# Remat (whose children count 0 in both), a BN-free net
VARIANTS = [("densenet", "121", {"CONVNETS_TPU_DENSENET_FUSED": "1"}, {}),
            ("densenet", "121", {"CONVNETS_TPU_DENSENET_FUSED": "1"}, {"remat": True}),
            ("resnet", "18", {}, {"remat": True}),
            ("resnet", "18", {}, {"batch_norm": False})]


def _fields(kind, image=32, **kw):
    return dict(kind=kind, input_size=(3, image, image), num_classes=10, **kw)


def _draw(shapes, seed):
    """JAX variables of the tree `shapes` (jax.eval_shape of an init) drawn
    by numpy: conv weights He normal (fan-out), linear weights N(0, 0.01),
    biases 0.1·N(0, 1), BN scales and running vars U(0.5, 1.5), BN biases
    and running means 0.1·N(0, 1)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        shape, name = tuple(leaf.shape), path[-1].key
        if name == "w" and len(shape) == 4:
            kh, kw, _, o = shape
            return (rng.randn(*shape) * np.sqrt(2.0 / (o * kh * kw))).astype(np.float32)
        if name == "w":
            return (rng.randn(*shape) * 0.01).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def builder_net(layers_nn, builder_cls, model_cls, setting):
    """A user's network written the template-net way with the layers this
    port adds: a grouped conv_block, ChannelShuffle, a Concat of two bare
    b.conv(..., set_output=False) branches (then in_channels set to their
    sum), a depthwise block whose groups come from in_channels, Sigmoid."""
    b = builder_cls(setting)
    layers = [b.conv_block(8, kernel=3, padding=1),
              b.conv_block(8, kernel=3, padding=1, groups=2),
              layers_nn.ChannelShuffle(2)]
    branches = [b.conv(6, kernel=1, set_output=False),
                b.conv(10, kernel=3, padding=1, set_output=False)]
    assert b.in_channels == 8
    b.in_channels = 16
    layers += [layers_nn.Concat(branches), b.conv_block_depthwise(padding=1), layers_nn.Sigmoid(),
               layers_nn.GlobalAvgPool2d(), b.linear(10)]
    return model_cls("BuilderNet", setting, layers_nn.Sequential(layers))


@pytest.mark.parametrize("bn", [True, False])
def test_builder_conv_set_output(bn):
    for builder_cls, settings_cls in ((Builder, Settings), (JaxBuilder, JaxSettings)):
        b = builder_cls(settings_cls(**_fields("0", batch_norm=bn)))
        conv = b.conv(8, kernel=3, set_output=False)
        assert b.in_channels == 3 and conv.out_channels == 8 and conv.use_bias == (not bn)
        b.conv(16, kernel=1)
        assert b.in_channels == 16
        b.conv(4, kernel=1, set_output=True)
        assert b.in_channels == 4


@pytest.mark.parametrize("bn", [True, False])
def test_builder_net_logits_match_jax(bn):
    jm = builder_net(jnn, JaxBuilder, JaxModel, JaxSettings(**_fields("0", batch_norm=bn)))
    model = builder_net(nn, Builder, Model, Settings(**_fields("0", batch_norm=bn)))
    model.init().eval()
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0)), 5)
    bridge.load_jax_variables(model, variables)
    x = np.random.RandomState(6).rand(4, 32, 32, 3).astype(np.float32)
    want, _ = jm.apply(variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert tuple(got.shape) == model.out_shape(4) == tuple(jm.out_shape(4)) == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * float(np.abs(want).max()))
    assert model.summary(batch_size=4) == jm.summary(variables, batch_size=4)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_sigmoid_and_channel_shuffle_match_jax(groups):
    x = np.random.RandomState(groups).randn(2, 5, 3, 8).astype(np.float32)
    for layer, jlayer in ((nn.Sigmoid(), jnn.Sigmoid()),
                          (nn.ChannelShuffle(groups), jnn.ChannelShuffle(groups))):
        want, _ = jlayer.apply({"params": {}, "state": {}}, x)
        got = layer(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert layer.out_shape(x.shape) == jlayer.out_shape(x.shape) == x.shape
        assert layer.summary_label() == repr(jlayer)
        assert not list(layer.parameters())
    # the shuffle is a permutation: channel j·g + i of the result is channel i·(C/g) + j
    got = nn.ChannelShuffle(groups)(torch.from_numpy(x)).numpy()
    c = x.shape[-1] // groups
    for i in range(groups):
        for j in range(c):
            np.testing.assert_array_equal(got[..., j * groups + i], x[..., i * c + j])


def _summaries(arch, kind, image, batch=1, **kw):
    jm = jax_models.build_model(arch, JaxSettings(**_fields(kind, image, **kw)))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    model = build_model(arch, Settings(**_fields(kind, image, **kw)), device="cpu")
    return model, jm, shapes, model.summary(batch_size=batch), jm.summary(shapes, batch_size=batch)


def test_families_are_all_covered():
    assert sorted({arch for arch, _, _ in FAMILIES}) == available_models() \
        == jax_models.available_models()


@pytest.mark.parametrize("arch,kind,image", FAMILIES, ids=lambda v: str(v))
def test_summary_matches_jax_line_for_line(arch, kind, image):
    model, jm, shapes, got, want = _summaries(arch, kind, image)
    got_lines, want_lines = got.splitlines(), want.splitlines()
    for i, (g, w) in enumerate(zip(got_lines, want_lines)):
        assert g == w, f"line {i}:\n  port {g!r}\n  JAX  {w!r}"
    assert len(got_lines) == len(want_lines)
    # the total line counts what the models hold
    n_params, n_state = nn.count_params(model.module), nn.count_state(model.module)
    assert got_lines[-1] == f"total params: {n_params:,}   total state: {n_state:,}"
    assert n_params == jnn.count_params(shapes["params"]) == model.num_params()
    assert n_state == jnn.count_state(shapes["state"])


@pytest.mark.parametrize("arch,kind,env,kw", VARIANTS, ids=lambda v: str(v))
def test_summary_variants_match_jax(arch, kind, env, kw, monkeypatch):
    for name, value in env.items():  # read when the model is built, in both packages
        monkeypatch.setenv(name, value)
    model, jm, shapes, got, want = _summaries(arch, kind, 32, batch=4, **kw)
    assert got == want
    # variables given: the JAX package's tree, and the port's own through the bridge
    assert model.summary(shapes, batch_size=4) == want
    assert model.summary(bridge.export_jax_variables(model), batch_size=4) == want


def test_trainer_print_summary_prints_the_jax_text(tmp_path, capsys):
    fields = _fields("0", output_dir=str(tmp_path), mixed_precision=False)
    trainer = Trainer(build_model("lenet", Settings(**fields), device="cpu"))
    trainer.print_summary()
    got = capsys.readouterr().out
    trainer.close()
    # the JAX Trainer prints jm.summary(), whose counts are the shapes of
    # an init's variables: eval_shape's (an eager JAX init takes ~9 s)
    jm = jax_models.build_model("lenet", JaxSettings(**fields))
    assert got == jm.summary(jax.eval_shape(jm.init, jax.random.key(0))) + "\n"


@pytest.mark.parametrize("arch,kind", [("resnet", "18"), ("shufflenet_v1", "g2"),
                                       ("sk_resnet", "26")])
def test_counts_out_shape_and_num_params_match_jax(arch, kind):
    jm = jax_models.build_model(arch, JaxSettings(**_fields(kind)))
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0)), 7)
    model = build_model(arch, Settings(**_fields(kind)), device="cpu")
    bridge.load_jax_variables(model, variables)
    for batch in (1, 8):
        assert model.out_shape(batch) == tuple(jm.out_shape(batch)) == (batch, 10)
    assert nn.count_params(model.module) == nn.count_params(variables["params"]) \
        == jnn.count_params(variables["params"]) == sum(p.numel() for p in model.parameters())
    assert nn.count_state(model.module) == nn.count_state(variables["state"]) \
        == jnn.count_state(variables["state"])
    assert model.num_params() == model.num_params(variables) == jm.num_params(variables)
    exported = bridge.export_jax_variables(model)
    assert nn.count_params(exported["params"]) == model.num_params(exported)
    # BN's running mean and var are the state: two per channel of each BN
    bn = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    assert nn.count_state(model.module) == sum(2 * m.running_mean.numel() for m in bn)
