"""The port's SEUnit and SKConv, SENet-26, SE-ResNet-26, SKNet-26 and
SK-ResNet-26 against the JAX package, on the CPU.

Eval and serving: weights drawn by numpy in the layout and distributions
of the JAX init (the tree from jax.eval_shape, one per family, cached;
He normal convs, N(0, 0.01) linears) with BN randomized, carried into the
port by the bridge; fp32 logits
at atol/rtol 1e-4, the bar of tests/test_torch_zoo_classic.py. The blocks
alone also in train mode (batch statistics, the BN running update).
Parameter counts: the JAX model's, read with jax.eval_shape, which are the
reference's published counts for SE-ResNet-26 and SK-ResNet-26. Dispatch:
the kernel wrapper calls per eval forward and per train step, the launches
chip_smoke.py phase 14 demands on the card. Train: one SGD step of an
SK-ResNet and an SENet cut to two stages of one block (patched into both
packages' CONFIG) against the JAX engine's own step.

SKConv's dilated path runs fused here (conv_bn_relu_train / the folded
conv2d epilogue), unfused in the JAX package (lax conv, then BatchNorm2d):
the values agree in fp32, which is all these tests compare.
"""

import copy
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu.models import base as jax_base
from convnets_tpu.models import blocks as jax_blocks
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.models import senet as jax_senet
from convnets_tpu.models import sk_resnet as jax_sk_resnet
from convnets_tpu.serve.export import _serving_forward as jax_serving_forward
from convnets_tpu.settings import Settings
from convnets_tpu_torch import bridge
from convnets_tpu_torch.core.precision import Policy
from convnets_tpu_torch.models import base, blocks, build_model, senet, sk_resnet
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.serve import ServingModel
from test_torch_resnet import STATS, _randomize_bn
from test_torch_train import _check_moments, _check_variables, _settings
from test_torch_zoo_classic import COUNTED, _exact_conv_bn_relu_train, _run_both

TOL = 1e-4
LR = 5e-5
FAMILIES = [("senet", "26"), ("se_resnet", "26"), ("sknet", "26"), ("sk_resnet", "26")]
# the JAX models' counts at 3x32x32, 10 classes (SE-ResNet-26 and SK-ResNet-26:
# the reference's published counts)
PARAMS = {"senet": 14_753_610, "se_resnet": 15_359_306, "sknet": 14_725_578,
          "sk_resnet": 8_283_978}


def _setting(kind, **kw):
    return Settings(kind=kind, input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                    **kw)


def numpy_variables(shapes, seed):
    """JAX variables of the tree `shapes` (jax.eval_shape of an init) drawn
    by numpy from `seed` with the JAX init's distributions: conv weights He
    normal (fan-out), linear and SE weights N(0, 0.01), biases 0; then the
    BN parameters and statistics randomized. A JAX init of a 26-layer SK net
    takes 11-14 s on the CPU; this takes milliseconds."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        shape = tuple(leaf.shape)
        if path[-1].key == "w" and len(shape) == 4:
            kh, kw, _, o = shape
            return (rng.randn(*shape) * np.sqrt(2.0 / (o * kh * kw))).astype(np.float32)
        if path[-1].key in ("w", "w1", "w2"):
            return (rng.randn(*shape) * 0.01).astype(np.float32)
        if path[-1].key in ("scale", "var"):
            return np.ones(shape, np.float32)
        return np.zeros(shape, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return {"params": _randomize_bn(tree["params"], rng),
            "state": _randomize_bn(tree["state"], rng)}


@functools.lru_cache(maxsize=None)
def _jax_model(arch, kind):
    setting = _setting(kind)
    jm = jax_build_model(arch, setting)
    return setting, jm, numpy_variables(jax.eval_shape(jm.init, jax.random.key(0)), len(arch))


def _port(arch, kind):
    setting, _, variables = _jax_model(arch, kind)
    model = build_model(arch, setting, device="cpu")
    bridge.load_jax_variables(model, variables)
    return model


@pytest.mark.parametrize("arch,kind", FAMILIES)
def test_eval_logits_match_jax(arch, kind):
    _, jm, variables = _jax_model(arch, kind)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    want, _ = jax.jit(functools.partial(jm.apply, train=False))(variables, jnp.asarray(x))
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
    jm = jax_build_model(arch, _setting(kind))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes["params"]))
    model = build_model(arch, _setting(kind), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want == PARAMS[arch]


def _block_pair(which):
    """(JAX block, its variables, port block with those weights, input
    shape): SEUnit on 64 channels (reduction 16), or SKConv on 64 channels
    in 8 groups (Cin/G 8), stride 2, its descriptor 32 wide; BN randomized."""
    setting = _setting("26")
    if which == "seunit":
        jblock, block, shape = jax_blocks.SEUnit(64, 16), blocks.SEUnit(64, 16), (2, 6, 6, 64)
    else:
        jb, b = jax_base.Builder(setting), base.Builder(setting)
        jb.in_channels = b.in_channels = 64
        jblock = jax_blocks.SKConv(jb, groups=8, stride=2)
        block = blocks.SKConv(b, groups=8, stride=2)
        shape = (2, 7, 7, 64)
    variables = jax.tree.map(np.asarray, jblock.init(jax.random.key(3), shape))
    rng = np.random.RandomState(5)
    variables = {"params": _randomize_bn(variables["params"], rng),
                 "state": _randomize_bn(variables["state"], rng)}
    block.init(torch.Generator().manual_seed(0), shape)
    bridge.load_jax_variables(block, variables)
    return jblock, variables, block, shape


@pytest.mark.parametrize("which,train", [("seunit", False), ("seunit", True),
                                         ("skconv", False), ("skconv", True)])
def test_attention_blocks_match_jax(which, train):
    """The block's output and, in train mode, its BN running statistics
    (SKConv's two paths and its descriptor at 1x1 spatial, whose batch
    statistics are over the N values of each channel).

    SKConv in train mode sits on a knife-edge of fp32 rounding, so this
    file keeps torch's default thread count. Its descriptor's BN sees N = 2
    values per channel, and on this input one channel has mean²/var =
    5.3e6 (the two values -2.862 and -2.8595). Both packages take the
    variance as E[y²] - mean² in fp32, whose rounding there is of the
    variance's own size. Against an fp64 twin of the block
    (test_skconv_train_against_fp64_twin) the max |Δ| of the output
    (max |out| 2.90) is 2.71e-3 for JAX, and for the port 2.74e-3 at
    eight torch threads and 1.64e-3 at one: a one-ulp change of the conv's
    output with the thread count moves that variance by ~40%. The port is
    no farther from exact arithmetic than JAX at either count; the 1e-4
    bar against JAX holds at eight threads (2.7e-5) and not at one
    (4.35e-3)."""
    jblock, variables, block, shape = _block_pair(which)
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    want, new_state = jblock.apply(variables, jnp.asarray(x), train=train,
                                   rng=jax.random.key(1) if train else None)
    block.train(train)
    got = block(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(jblock.out_shape(shape)) == tuple(block.out_shape(shape))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    state = bridge.export_jax_variables(block)["state"]
    want_state = new_state if train else variables["state"]
    flat = bridge._flatten(state)
    assert set(flat) == set(bridge._flatten(want_state))
    for k, v in bridge._flatten(want_state).items():
        np.testing.assert_allclose(flat[k], np.asarray(v), atol=TOL, rtol=TOL, err_msg=str(k))



@pytest.mark.parametrize("threads", [1, 8])
def test_skconv_train_against_fp64_twin(threads):
    """SKConv's train-mode output, the port's at `threads` torch threads
    and JAX's, against an fp64 twin: the port's block in float64, its
    ConvBNReLUs by autograd with two-pass statistics
    (test_torch_zoo_classic._exact_conv_bn_relu_train). The descriptor's BN
    is ill-conditioned on this input (mean²/var above 1e6 over N = 2
    values), which makes both packages' fp32 outputs part from the twin by
    ~1e-3; the port stays within twice JAX's distance. `-s` prints the
    distances (recorded in test_attention_blocks_match_jax)."""
    jblock, variables, block, shape = _block_pair("skconv")
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    want, _ = jblock.apply(variables, jnp.asarray(x), train=True, rng=jax.random.key(1))
    conditioning = []
    exact = _exact_conv_bn_relu_train(kernels.conv_bn_relu_train, conditioning)
    twin = copy.deepcopy(block).double().train(True)
    for module in twin.modules():
        if hasattr(module, "policy"):
            module.policy = Policy(compute_dtype=torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "conv_bn_relu_train", exact)
        ref = twin(torch.from_numpy(x.astype(np.float64))).detach().numpy()
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = block.train(True)(torch.from_numpy(x)).detach().numpy()
    finally:
        torch.set_num_threads(saved)
    port_d = float(np.abs(got - ref).max())
    jax_d = float(np.abs(np.asarray(want, np.float64) - ref).max())
    print(f"SKConv train, {threads} threads: max|port - twin| {port_d:.3e}, "
          f"max|JAX - twin| {jax_d:.3e}, max|twin| {np.abs(ref).max():.3e}, "
          f"descriptor mean²/var {max(conditioning):.3g}")
    assert len(conditioning) == 3 and max(conditioning) > 1e6
    assert port_d <= 2 * jax_d

# wrapper calls per eval forward and per train step (forward + backward) on
# the card: each is one kernel launch, plus one reduction launch per
# conv2d_stats / grouped_conv2d_stats. The 26s: 29 dense ConvBNReLUs (stem,
# 1x1s, shortcuts; SK's descriptors among them), SENet's 8 grouped 3x3s,
# SK's 16 grouped paths (8 dilated) and 16 attention convs (plain Conv2d with
# bias: conv2d_fused in eval, conv2d_train's forward in train)
DISPATCH = {
    "se_resnet": {"eval": {"conv2d_fused": 29, "max_pool2d": 1},
                  "train": {"conv2d_stats": 29, "max_pool2d": 1, "pool2d_backward": 1}},
    "senet": {"eval": {"conv2d_fused": 21, "grouped_conv2d_fused": 8, "max_pool2d": 1},
              "train": {"conv2d_stats": 21, "grouped_conv2d_stats": 8, "max_pool2d": 1,
                        "pool2d_backward": 1}},
    "sknet": {"eval": {"conv2d_fused": 45, "grouped_conv2d_fused": 16, "max_pool2d": 1},
              "train": {"conv2d_stats": 29, "grouped_conv2d_stats": 16, "conv2d_fused": 16,
                        "max_pool2d": 1, "pool2d_backward": 1}},
    "sk_resnet": {"eval": {"conv2d_fused": 45, "grouped_conv2d_fused": 16, "max_pool2d": 1},
                  "train": {"conv2d_stats": 29, "grouped_conv2d_stats": 16, "conv2d_fused": 16,
                            "max_pool2d": 1, "pool2d_backward": 1},
                  # batch_norm=False: every conv through conv2d_train /
                  # grouped_conv2d_train, forward without epilogue
                  "train_nobn": {"conv2d_fused": 45, "grouped_conv2d_fused": 16,
                                 "max_pool2d": 1, "pool2d_backward": 1}},
}


def count_dispatch(monkeypatch, arch, kind, mode, image=32):
    """The wrapper calls of one eval forward or one train step (forward and
    backward) of `arch` at image², batch 2, dropout 0."""
    calls = {}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for name in COUNTED:
        monkeypatch.setattr(kernels, name, counting(name, getattr(kernels, name)))
    setting = Settings(kind=kind, input_size=(3, image, image), num_classes=10,
                       mixed_precision=False, dropout_rate=0.0,
                       batch_norm=mode != "train_nobn")
    model = build_model(arch, setting, device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).rand(2, image, image, 3).astype(np.float32))
    if mode.startswith("train"):
        model.train()(x).sum().backward()
    else:
        with torch.inference_mode():
            model(x)
    return calls


@pytest.mark.parametrize("arch,mode", [(a, m) for a, modes in DISPATCH.items() for m in modes])
def test_kernel_dispatch_per_forward_and_step(arch, mode, monkeypatch):
    assert count_dispatch(monkeypatch, arch, "26", mode) == DISPATCH[arch][mode]


@pytest.mark.parametrize("arch,stages", [("sk_resnet", [(64, 1, 1), (128, 1, 2)]),
                                         ("senet", [(128, 1, 1), (256, 1, 2)])])
def test_train_step_matches_jax_one_sgd_step(arch, stages, monkeypatch):
    """The port's step against the JAX engine's _build_train_step (lax on
    the CPU) at 32², batch 8, the net cut to two stages of one block
    ("tiny", patched into both packages' CONFIG), with the bars of
    tests/test_torch_train.py: loss to 1e-4, params and BN statistics to
    1e-4, the SGD velocity (the step's gradient) per leaf to 1e-3 of its
    largest element. SK-ResNet's step runs both SK paths (one dilated),
    the descriptor's batch statistics over 8 values and the attention
    convs' conv2d_train; SENet's the grouped 3x3 and the SEUnit."""
    for module in ((jax_sk_resnet, sk_resnet) if arch == "sk_resnet" else (jax_senet, senet)):
        monkeypatch.setitem(module.CONFIG, "tiny", stages)
    js, jout, model, state, tout, _, _ = _run_both(_settings("sgd", LR, kind="tiny"), arch, 8)
    np.testing.assert_allclose(tout, jout, rtol=1e-4)
    _check_variables(model, js, 1e-4)
    _check_moments(model, state, js, ("momentum",), 1e-3)
