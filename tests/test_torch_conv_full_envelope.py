"""Every conv the JAX package's Conv2d accepts runs in the port, on the CPU:
the four kinds its Pallas envelopes leave to lax (more than 64 groups, a
stride of 3 or different strides per axis, a depthwise channel
multiplier, a dilated depthwise conv), each held against the JAX
package's lax path.

- The plain `ops.conv2d`, each kernel wrapper's CPU path and the eval
  path's custom op against `convnets_tpu/ops/conv.py:conv2d`, fp32, 1e-5.
- The shape ints and the route each wrapper hands its C entry point,
  through a recording stand-in for the kernel library (the launch a CUDA
  tensor makes), and the launch counted on that route.
- The trainable functions (depthwise_train, grouped_conv2d_train,
  conv_bn_relu_train): forward and gradients against jax.vjp of the lax
  conv (then batch-stat BN and ReLU).
- `conv_block` in eval and train against JAX's with the same weights
  through the bridge: fp32 at 1e-5; bf16 at 1e-2, where a fused grouped
  site rounds y once and JAX (unfused on lax) rounds the conv output and
  then the BN output.
- `_check_conv_envelope` names a family, in the JAX order, for every conv
  whose groups divide both channel counts.
- A network built as `template_net.py` shows (Builder.conv_block layers,
  one of each kind, a BN site on each, registered for the test only):
  eval logits and one SGD step against its JAX twin.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu import nn as jnn
from convnets_tpu.core.precision import DEFAULT_POLICY as JAX_DEFAULT
from convnets_tpu.core.precision import MIXED_POLICY as JAX_MIXED
from convnets_tpu.models import base as jax_base
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.ops.conv import conv2d as jax_conv2d
from convnets_tpu.settings import Settings
from convnets_tpu.train.engine import Trainer as JaxTrainer
from convnets_tpu_torch import bridge, nn, ops
from convnets_tpu_torch.core.precision import DEFAULT_POLICY, MIXED_POLICY
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.models import base
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.nn import layers
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.ops.kernels import conv as kconv
from convnets_tpu_torch.ops.kernels import depthwise as kdw
from convnets_tpu_torch.ops.kernels import library
from convnets_tpu_torch.train import build_train_step, create_train_state
from test_torch_conv_envelope import _jax_train_fn, recording_lib  # noqa: F401
from test_torch_resnet import _randomize_bn
from test_torch_train import _check_variables, _flat, _t

TOL = 1e-5
BF16_TOL = 1e-2
_OPS = getattr(torch.ops, library.NAMESPACE)
# (N, H, W, Cin, Cout, k, stride, pad, dilation, groups, what)
KINDS = [
    (2, 10, 10, 16, 16, 3, 1, 2, 2, 16, "D1 depthwise 3x3, dilation 2"),
    (2, 11, 11, 16, 16, 3, 2, 2, 2, 16, "D1 depthwise 3x3, dilation 2, stride 2"),
    (2, 12, 12, 16, 16, 3, 1, 4, 4, 16, "depthwise 3x3, dilation 4"),
    (2, 12, 12, 8, 16, 3, 1, 1, 1, 8, "D2 depthwise 3x3, multiplier 2"),
    (2, 12, 12, 8, 16, 3, 2, 1, 1, 8, "D2 depthwise 3x3, multiplier 2, stride 2"),
    (2, 10, 10, 8, 16, 3, 1, 2, 2, 8, "D3 depthwise 3x3, dilation 2, multiplier 2"),
    (2, 9, 11, 4, 12, 3, (1, 2), (2, 1), (2, 1), 4,
     "depthwise multiplier 3, per-axis stride and dilation"),
    (2, 8, 8, 320, 320, 3, 1, 1, 1, 80, "G1 grouped 3x3, 80 groups, Cin/G 4"),
    (2, 8, 8, 320, 320, 3, 2, 1, 1, 80, "G1 grouped 3x3, 80 groups, stride 2"),
    (2, 8, 8, 160, 160, 3, 1, 1, 1, 80, "G2 grouped 3x3, 80 groups, Cin/G 2"),
    (2, 8, 8, 320, 640, 1, 1, 0, 1, 80, "G3 grouped 1x1, 80 groups, Cin/G 4, Cout/G 8"),
    (2, 12, 12, 32, 32, 3, 3, 1, 1, 8, "G4 grouped 3x3, stride 3"),
    (2, 12, 12, 16, 16, 3, (2, 1), 1, 1, 4, "G4 grouped 3x3, stride (2, 1)"),
]
IDS = [k[-1] for k in KINDS]


def _depthwise(cin, groups):
    return groups == cin


def _inputs(n, h, w, cin, cout, k, groups, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(k, k, cin // groups, cout) / np.sqrt(k * k * cin / groups)).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("n,h,w,cin,cout,k,s,p,d,groups,what", KINDS, ids=IDS)
def test_plain_conv_wrappers_and_ops_match_jax(n, h, w, cin, cout, k, s, p, d, groups, what):
    """ops.conv2d, the wrappers' CPU path (the plain version each kernel is
    held to on the card) and the custom op the eval-mode layers call,
    against JAX's lax conv."""
    x, wt = _inputs(n, h, w, cin, cout, k, groups)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(wt), stride=s, padding=p,
                                 dilation=d, groups=groups))
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    got = {"ops.conv2d": ops.conv2d(xt, wtt, stride=s, padding=p, dilation=d, groups=groups)}
    geo = (list(to_pair(s)), list(to_pair(p)))
    if _depthwise(cin, groups):
        got["ops.conv2d_depthwise"] = ops.conv2d_depthwise(xt, wtt, stride=s, padding=p,
                                                           dilation=d)
        got["depthwise_conv2d"] = kernels.depthwise_conv2d(xt, wtt, stride=s, padding=p,
                                                           dilation=d)
        got["op depthwise_conv2d"] = _OPS.depthwise_conv2d(xt, wtt, *geo, list(to_pair(d)))
        got["depthwise_train"] = kernels.depthwise_train(xt, wtt, s, p, d)
    else:
        kw = dict(stride=s, padding=p, dilation=d)
        got["grouped_conv2d_fused"] = kernels.grouped_conv2d_fused(xt, wtt, groups, **kw)
        got["grouped_conv2d_stats y"], sums = kernels.grouped_conv2d_stats(xt, wtt, groups, **kw)
        got["op grouped_conv2d_fused"] = _OPS.grouped_conv2d_fused(
            xt, wtt, groups, None, None, *geo, False, list(to_pair(d)))
        got["grouped_conv2d_train"] = kernels.grouped_conv2d_train(xt, wtt, groups, s, p, d)
        np.testing.assert_allclose(sums.numpy(), np.stack([want.sum((0, 1, 2)),
                                                           (want * want).sum((0, 1, 2))]),
                                   rtol=1e-4, atol=1e-3)
        rng = np.random.RandomState(1)
        scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        shift = (0.1 * rng.randn(cout)).astype(np.float32)
        epi = np.maximum(want * scale + shift, 0.0)
        np.testing.assert_allclose(
            kernels.grouped_conv2d_fused(xt, wtt, groups, torch.from_numpy(scale),
                                         torch.from_numpy(shift), relu=True, **kw).numpy(),
            epi, atol=TOL, rtol=TOL)
    for name, y in got.items():
        assert tuple(y.shape) == want.shape, name
        np.testing.assert_allclose(y.detach().numpy(), want, atol=TOL, rtol=TOL, err_msg=name)


# where the shape ints start in each entry point's arguments: after (dtype,
# x, w, y) for depthwise_launch, (dtype, x, w, scale, shift, y) for the
# fused entry, (dtype, x, w, y, partial) for the statistics entry
GEO_AT = {"depthwise_launch": 4, "grouped_fused_launch": 6, "grouped_stats_launch": 5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,cout,k,s,p,d,groups,what", KINDS, ids=IDS)
def test_wrappers_pass_the_shape_and_route(recording_lib, n, h, w, cin, cout, k, s, p, d,
                                           groups, what, dtype):
    """As for a CUDA tensor, each wrapper's launch hands its entry point n,
    h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw (OH and OW of
    the dilated window), then the route its plan gives (depthwise_plan with
    the multiplier and the dilation: the vector route for the 3x3 at
    multiplier 1, stride 1 or 2 and dilation 1 or 2, the loop for dilation
    4; grouped_plan at any number of groups and stride), and
    counts the launch on that route."""
    (sh, sw), (ph, pw), (dh, dw) = (to_pair(v) for v in (s, p, d))
    oh, ow = conv_out_size(h, k, sh, ph, dh), conv_out_size(w, k, sw, pw, dw)
    want = (n, h, w, cin, oh, ow, cout, k, k, sh, sw, ph, pw, dh, dw)
    x = torch.zeros(n, h, w, cin, dtype=dtype)
    wt = torch.zeros(k, k, cin // groups, cout, dtype=dtype)
    kernels.reset_launches()
    if _depthwise(cin, groups):
        y = kdw._launch(x, wt, s, p, d)
        ((name, args),) = recording_lib.calls
        at = GEO_AT[name]
        assert name == "depthwise_launch" and tuple(y.shape) == (n, oh, ow, cout)
        # the depthwise entry takes (..., oh, ow, cout, ...): the same ints
        assert args[at:at + 15] == want
        plan = kernels.depthwise_plan(n, h, w, cin, k, k, (sh, sw), (ph, pw), dtype,
                                      dilation=(dh, dw), multiplier=cout // cin)
        assert args[at + 15:at + 21] == plan.args()
        vector = (cout == cin and cin % 8 == 0 and k == 3 and sh == sw and sh in (1, 2)
                  and dh == dw and dh in (1, 2))
        assert plan.route == ("vector" if vector else "loop")
        assert kernels.ROUTE_LAUNCHES["depthwise_conv2d"] == {
            r: int(r == plan.route) for r in ("vector", "loop")}
        assert kernels._SIGNATURES[name][at:at + 21] == [kernels._I] * 21
    else:
        kconv._launch_fused("grouped_conv2d_fused", x, wt, None, None, s, p, False, groups,
                            dilation=d)
        kconv._launch_stats("grouped_conv2d_stats", x, wt, s, p, groups, dilation=d)
        (fname, fargs), (sname, sargs), (rname, _) = recording_lib.calls
        assert (fname, sname, rname) == ("grouped_fused_launch", "grouped_stats_launch",
                                         "stats_reduce_launch")
        cg = cin // groups
        wgmma = cin == cout and cin % 64 == 0 and cg in kconv.GROUPED_WGMMA_CG
        route = ("simt" if dtype == torch.float32 or cg == 2 else
                 "wgmma" if wgmma else "wgmma_wide")
        assert kernels.grouped_plan(dtype, cin, cout, groups).route == route
        for name, args in ((fname, fargs), (sname, sargs)):
            at = GEO_AT[name]
            assert args[at:at + 17] == (*want, groups, kconv._ROUTES[route]), name
        for name in ("grouped_conv2d_fused", "grouped_conv2d_stats"):
            assert kernels.ROUTE_LAUNCHES[name] == {
                r: int(r == route) for r in ("wgmma", "wgmma_wide", "simt")}, name


TRAINABLE = [(kind, shape) for shape in KINDS
             for kind in (("depthwise_train",) if _depthwise(shape[3], shape[9]) else
                          ("grouped_conv2d_train", "conv_bn_relu_train"))]


@pytest.mark.parametrize("kind,shape", TRAINABLE,
                         ids=[f"{kind}-{shape[-1]}" for kind, shape in TRAINABLE])
def test_trainable_functions_match_jax_vjp(kind, shape):
    """Forward and every gradient, fp32, against jax.vjp of the lax conv
    (conv_bn_relu_train: then batch-stat BN and ReLU); the backward takes
    the conv's own stride, dilation and groups (aten.convolution_backward,
    groups = Cin for a depthwise conv of any multiplier)."""
    n, h, w, cin, cout, k, s, p, d, groups, _ = shape
    x, wt = _inputs(n, h, w, cin, cout, k, groups, seed=1)
    rng = np.random.RandomState(2)
    args = [x, wt]
    if kind == "conv_bn_relu_train":
        args += [rng.uniform(0.5, 1.5, cout).astype(np.float32),
                 (0.1 * rng.randn(cout)).astype(np.float32)]
    want, vjp = jax.vjp(jax.jit(_jax_train_fn(kind, s, p, d, groups)),
                        *map(jnp.asarray, args))
    cot = rng.randn(*want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    if kind == "conv_bn_relu_train":
        got = kernels.conv_bn_relu_train(*ins, s, p, groups=groups, dilation=d)[0]
    elif kind == "grouped_conv2d_train":
        got = kernels.grouped_conv2d_train(*ins, groups, s, p, d)
    else:
        got = kernels.depthwise_train(*ins, s, p, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    tgrads = torch.autograd.grad(got, ins, torch.from_numpy(cot))
    for t, j in zip(tgrads, jgrads):
        j = np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=1e-4)


def _blocks(shape, mixed):
    """The port's and JAX's conv_block of `shape` (BN and ReLU on) under
    the fp32 or the bf16 policy, with the same weights: the port's init
    with BN randomized by numpy, in the JAX layout through the bridge."""
    n, h, w, cin, cout, k, s, p, d, groups, _ = shape
    kw = dict(stride=s, padding=p, dilation=d, groups=groups)
    with jnn.use_policy(JAX_MIXED if mixed else JAX_DEFAULT):
        jblock = jnn.conv_block(cout, k, **kw)
    with nn.use_policy(MIXED_POLICY if mixed else DEFAULT_POLICY):
        block = nn.conv_block(cout, k, **kw)
    block.init(torch.Generator().manual_seed(0), (1, h, w, cin))
    variables = bridge.export_jax_variables(block)
    rng = np.random.RandomState(4)
    variables = {c: _randomize_bn(variables[c], rng) for c in ("params", "state")}
    bridge.load_jax_variables(block, variables)
    return block, jblock, variables


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", KINDS, ids=IDS)
def test_conv_block_matches_jax(shape, train, dname):
    """conv_block (ConvBNReLU: a depthwise one unfused, a grouped one
    fused) against JAX's, which runs these convs unfused on lax: fp32 to
    1e-5, and the running statistics a train step writes; bf16 to 1e-2 of
    the output's largest value (the fused grouped site rounds y once, JAX
    the conv output and then the BN output)."""
    block, jblock, variables = _blocks(shape, dname == "bfloat16")
    n, h, w, cin = shape[:4]
    x = np.random.RandomState(5).randn(n, h, w, cin).astype(np.float32)
    want, updates = jax.jit(lambda v, a: jblock.apply(v, a, train=train))(variables,
                                                                          jnp.asarray(x))
    with torch.no_grad():
        got = block.train(train)(torch.from_numpy(x))
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == (torch.bfloat16 if dname == "bfloat16" else torch.float32)
    assert tuple(got.shape) == want.shape
    if dname == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
        if train:
            bn = block._modules["1"]
            for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
                np.testing.assert_allclose(getattr(bn, name).numpy(),
                                           np.asarray(updates["1"][leaf]), atol=TOL, rtol=TOL)
    else:
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= BF16_TOL * float(np.abs(want).max()), err


def test_every_conv_whose_groups_divide_has_a_family():
    """_check_conv_envelope names the family in the JAX package's order
    (dense, depthwise, grouped; nn/layers.py:91-105) for every conv whose
    groups divide both channel counts, at any stride and dilation per
    axis; any other conv is no conv and raises ValueError."""
    seen = set()
    for cin in (1, 2, 3, 4, 8, 12, 130, 256):
        for cout in (1, 2, 4, 6, 8, 16, 24, 130, 256, 260, 512):
            for groups in (1, 2, 3, 4, 8, 65, 128, 130, 256):
                for stride, dilation in ((1, 1), (3, 1), ((2, 1), 1), (1, 2), ((2, 1), (1, 3))):
                    conv = nn.Conv2d(cout, 3, stride=stride, dilation=dilation, groups=groups)
                    if cin % groups or cout % groups:
                        with pytest.raises(ValueError, match="groups must divide"):
                            layers._check_conv_envelope(conv, cin)
                        continue
                    want = (layers.DENSE if groups == 1 else
                            layers.DEPTHWISE if groups == cin else layers.GROUPED)
                    assert layers._check_conv_envelope(conv, cin) == want
                    seen.add((want, groups > 64, max(to_pair(stride)) > 2 or
                              len(set(to_pair(stride))) > 1, cout > cin, max(to_pair(dilation)) > 1))
    # each of the four kinds among them
    assert (layers.GROUPED, True, False, False, False) in seen
    assert (layers.GROUPED, False, True, False, False) in seen
    assert (layers.DEPTHWISE, False, False, True, False) in seen
    assert (layers.DEPTHWISE, False, True, False, True) in seen


ENVELOPE_NET = "envelope_net"


def _envelope_net(nn_, builder, model_cls):
    """The network a user who copies template_net.py would write with these
    convs: Builder.conv_block layers, a BN site on each, one of each kind
    the widened kernels take (chip_smoke.py's phase 17 net, its widths cut
    for the CPU: 80 groups where that one has 128 and 512)."""
    def build(setting):
        b = builder(setting)
        layers_ = [
            b.conv_block(8, kernel=3, padding=1),                             # dense stem
            b.conv_block(16, kernel=3, padding=1, groups=8),                  # D2: multiplier 2
            b.conv_block(16, kernel=3, padding=2, dilation=2, groups=16),     # D1: dilated
            b.conv_block(32, kernel=3, padding=2, dilation=2, groups=16),     # D3: both
            b.conv_block(32, kernel=3, stride=(2, 1), padding=1, groups=8),   # G4: per-axis stride
            b.conv_block(32, kernel=3, stride=3, padding=1, groups=8),        # G4: stride 3
            b.conv_block(160, kernel=1),                                      # dense 1x1
            b.conv_block(160, kernel=3, stride=2, padding=1, groups=80),      # G1: 80 groups
            b.conv_block(160, kernel=3, padding=1, groups=80),                # G2: Cin/G 2
            b.conv_block(320, kernel=1, groups=80),                           # G3: 1x1
            nn_.GlobalAvgPool2d(),
            b.linear(setting.num_classes)]
        return model_cls("EnvelopeNet", setting, nn_.Sequential(layers_))
    return build


@pytest.fixture
def envelope_net(monkeypatch):
    """The network registered in both packages for this test only."""
    monkeypatch.setitem(base._REGISTRY, ENVELOPE_NET,
                        _envelope_net(nn, base.Builder, base.Model))
    monkeypatch.setitem(jax_base._REGISTRY, ENVELOPE_NET,
                        _envelope_net(jnn, jax_base.Builder, jax_base.Model))


def _setting(**kw):
    fields = dict(kind="0", input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                  dropout_rate=0.0, batch_norm=True, data_augment=False, data_norm=True)
    fields.update(kw)
    return Settings(**fields)


def test_builder_network_eval_logits_match_jax(envelope_net):
    """fp32 eval logits against the JAX twin's (lax) to 1e-5 of the
    largest, the port's init with BN randomized, carried to JAX by the
    bridge; every conv of it runs on a kernel wrapper's CPU path."""
    setting = _setting()
    jm = jax_build_model(ENVELOPE_NET, setting)
    model = build_model(ENVELOPE_NET, setting, device="cpu")
    variables = bridge.export_jax_variables(model)
    rng = np.random.RandomState(6)
    variables = {c: _randomize_bn(variables[c], rng) for c in ("params", "state")}
    bridge.load_jax_variables(model, variables)
    families = [layers._check_conv_envelope(m._modules["0"], shape[-1])
                for m, shape in _conv_blocks(model)]
    assert families.count(layers.DEPTHWISE) == 3 and families.count(layers.GROUPED) == 5
    x = np.random.RandomState(7).rand(2, 32, 32, 3).astype(np.float32)
    want, _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = np.asarray(want)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * np.abs(want).max(), rtol=TOL)


def _conv_blocks(model):
    """(ConvBNReLU, its input shape) of the network, in order."""
    out, shape = [], model.batch_shape(1)
    for child in model.module._modules.values():
        if isinstance(child, nn.ConvBNReLU):
            out.append((child, shape))
        shape = child.out_shape(shape)
    return out


def test_builder_network_sgd_step_matches_jax(envelope_net):
    """One SGD step of the network against the JAX engine's own step
    (lax), with the bars of tests/test_torch_zoo.py: loss to 1e-4, params
    and BN state to 1e-4; the velocity (the step's gradient) per leaf to
    1e-3 in ‖Δ‖ / ‖v‖, where tests/test_torch_zoo.py takes max |Δ| / max
    |v|: in fp32 one ReLU mask element can flip between the two summation
    orders, and here one did (one element of the 1x1 block's BN bias
    velocity moved 1.8e-5 against a largest element of 1.8e-2, every other
    element within 2e-8). One kind of leaf is held to 1e-3 of the step's
    largest velocity element instead (as ShuffleNet's depthwise BN biases
    in tests/test_torch_zoo_shuffle.py): the BN scale of each block that
    feeds a depthwise conv. At init (BN bias 0) that block's output is
    s·ReLU(x̂), the depthwise conv carries each channel's s to its own
    output channels, and their BN removes it (up to eps), so the true
    gradient is about 0 and both steps hold rounding noise there (~1e-7,
    against velocities up to ~1)."""
    setting = _setting(optimizer="sgd", learning_rate=5e-5, weight_decay=1e-4, nesterov=True)
    trainer = JaxTrainer(jax_build_model(ENVELOPE_NET, setting), use_mesh=False)
    trainer.init_state()
    step = trainer._get_train_step(augment=False, norm=True)
    start = {"params": jax.tree.map(np.asarray, trainer.state.params),
             "state": jax.tree.map(np.asarray, trainer.state.model_state)}
    model = build_model(ENVELOPE_NET, setting, device="cpu")
    bridge.load_jax_variables(model, start)
    state = create_train_state(model)
    port_step = build_train_step(state, norm=True)
    rng = np.random.RandomState(8)
    x = rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 8).astype(np.int32)
    w = np.ones(8, np.float32)
    js, jloss, jcorrect = step(trainer.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                               jax.random.key(0))
    loss, correct = port_step(state, _t(x, torch.uint8), _t(y, torch.int64), _t(w))
    np.testing.assert_allclose((float(loss), float(correct)), (float(jloss), float(jcorrect)),
                               rtol=1e-4)
    _check_variables(model, js, 1e-4)
    mine = _flat(bridge.export_jax_opt_state(model, state.opt_state)["momentum"])
    want = _flat(jax.tree.map(np.asarray, js.opt_state.momentum))
    assert set(mine) == set(want)
    largest = max(float(np.abs(v).max()) for v in want.values())
    cancelled = ("0/1/scale", "1/1/scale", "2/1/scale")  # before D2, D1 and D3
    for k in want:
        if k in cancelled:
            assert float(np.abs(mine[k] - want[k]).max()) <= 1e-3 * largest, k
        else:
            assert np.linalg.norm(mine[k] - want[k]) <= 1e-3 * np.linalg.norm(want[k]), k
