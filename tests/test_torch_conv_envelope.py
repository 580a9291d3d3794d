"""The widened conv envelopes on the CPU: dilation (SKConv's second path, a
dilated dense conv), wide groups (ShuffleNet's grouped 1x1s, Cin/G up to
400) and any dense stride (AlexNet's 11x11/4 stem).

- The plain `ops.conv2d`, every kernel's oracle, against the JAX package's
  `convnets_tpu/ops/conv.py:conv2d` (lax) at those shapes, and the CPU
  path of each kernel wrapper (its plain version) against the same.
- The trainable functions (conv2d_train, grouped_conv2d_train,
  conv_bn_relu_train) with dilation: forward and gradients against JAX's
  VJP of the lax conv (and batch-stat BN and ReLU).
- The 15 shape ints (`geo`: n, h, w, cin, oh, ow, cout, kh, kw, sh, sw,
  ph, pw, dh, dw) that each wrapper passes to its C entry point, through a
  recording stand-in for the kernel library.
- The route `grouped_plan` gives every grouped conv of SKNet-26,
  SK-ResNet-26 and ShuffleNet-v1 g2, g3, g4, g8.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu import ops as jops
from convnets_tpu.ops.conv import conv2d as jax_conv2d
from convnets_tpu_torch import nn, ops
from convnets_tpu_torch.core.shapes import to_pair
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.ops.kernels import conv as kconv
from convnets_tpu_torch.settings import Settings

TOL = 1e-5
# (N, H, W, Cin, Cout, k, stride, pad, dilation, groups, what)
SHAPES = [
    (2, 9, 9, 64, 64, 3, 1, 2, 2, 32, "SK path 1: grouped 3x3, dilation 2, Cin/G 2"),
    (2, 10, 10, 128, 128, 3, 2, 2, 2, 32, "SK path 1, stride 2, Cin/G 4"),
    (2, 8, 8, 272, 68, 1, 1, 0, 1, 4, "ShuffleNet g4 compress: Cin/G 68, Cout/G 17"),
    (2, 4, 4, 800, 200, 1, 1, 0, 1, 2, "ShuffleNet g2 compress: Cin/G 400"),
    (2, 8, 8, 68, 248, 1, 1, 0, 1, 4, "ShuffleNet g4 expand: Cin/G 17, Cout/G 62"),
    (1, 35, 35, 3, 16, 11, 4, 2, 1, 1, "AlexNet's 11x11/4 stem (K = 363)"),
    (2, 12, 12, 8, 16, 3, 1, 3, 3, 1, "dilated dense 3x3, dilation 3"),
    (2, 11, 11, 6, 8, 3, (2, 1), (1, 2), (2, 1), 1, "dense, per-axis stride and dilation"),
    (2, 11, 11, 6, 8, 3, 2, (1, 2), (2, 1), 2, "grouped, per-axis dilation"),
]
IDS = [s[-1] for s in SHAPES]


def _inputs(n, h, w, cin, cout, k, groups, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(k, k, cin // groups, cout) / np.sqrt(k * k * cin / groups)).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("n,h,w,cin,cout,k,s,p,d,groups,what", SHAPES, ids=IDS)
def test_plain_conv_matches_jax(n, h, w, cin, cout, k, s, p, d, groups, what):
    """ops.conv2d, and the wrappers' CPU path (the plain version each
    kernel is held to on the card), against JAX's lax conv."""
    x, wt = _inputs(n, h, w, cin, cout, k, groups)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(wt), stride=s, padding=p,
                                 dilation=d, groups=groups))
    tx, tw = torch.from_numpy(x), torch.from_numpy(wt)
    got = ops.conv2d(tx, tw, stride=s, padding=p, dilation=d, groups=groups)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if groups == 1:
        y = kernels.conv2d_fused(tx, tw, stride=s, padding=p, dilation=d)
        ys = kernels.conv2d_stats(tx, tw, stride=s, padding=p, dilation=d)
    else:
        y = kernels.grouped_conv2d_fused(tx, tw, groups, stride=s, padding=p, dilation=d)
        ys = kernels.grouped_conv2d_stats(tx, tw, groups, stride=s, padding=p, dilation=d)
    np.testing.assert_allclose(y.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ys[0].numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ys[1][0].numpy(), want.sum((0, 1, 2)), atol=1e-4, rtol=1e-4)


def _jax_train_fn(kind, s, p, d, groups):
    def fn(x, w, scale=None, bias=None):
        y = jax_conv2d(x, w, stride=s, padding=p, dilation=d, groups=groups)
        if kind != "conv_bn_relu_train":
            return y
        z, _, _ = jops.batch_norm_train(y, jnp.zeros(y.shape[-1]), jnp.ones(y.shape[-1]),
                                        scale, bias)
        return jops.relu(z)
    return fn


@pytest.mark.parametrize("kind,shape", [
    ("conv_bn_relu_train", SHAPES[1]), ("grouped_conv2d_train", SHAPES[3]),
    ("conv2d_train", SHAPES[5]), ("conv2d_train", SHAPES[6]),
    ("grouped_conv2d_train", SHAPES[0])], ids=lambda v: v if isinstance(v, str) else v[-1])
def test_trainable_functions_match_jax_vjp(kind, shape):
    """Forward and every gradient, fp32, against jax.vjp of the lax conv
    (conv_bn_relu_train: then batch-stat BN and ReLU): the backward takes
    the conv's own stride and dilation (aten.convolution_backward)."""
    n, h, w, cin, cout, k, s, p, d, groups, _ = shape
    x, wt = _inputs(n, h, w, cin, cout, k, groups, seed=1)
    rng = np.random.RandomState(2)
    args = [x, wt]
    if kind == "conv_bn_relu_train":
        args += [rng.uniform(0.5, 1.5, cout).astype(np.float32),
                 (0.1 * rng.randn(cout)).astype(np.float32)]
    want, vjp = jax.vjp(_jax_train_fn(kind, s, p, d, groups), *map(jnp.asarray, args))
    cot = rng.randn(*want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    if kind == "conv_bn_relu_train":
        got = kernels.conv_bn_relu_train(*ins, s, p, groups=groups, dilation=d)[0]
    elif kind == "grouped_conv2d_train":
        got = kernels.grouped_conv2d_train(*ins, groups, s, p, d)
    else:
        got = kernels.conv2d_train(*ins, s, p, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    tgrads = torch.autograd.grad(got, ins, torch.from_numpy(cot))
    for t, j in zip(tgrads, jgrads):
        j = np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=1e-4)


class _RecordingLib:
    """Stands in for the kernel library: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recording_lib(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(kernels, "lib", lambda: lib)
    monkeypatch.setattr(kernels, "check_cuda_operand", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    saved = dict(kernels.LAUNCHES)
    yield lib
    kernels.LAUNCHES.update(saved)


# where the 15 shape ints start in each entry point's arguments: after
# (dtype, x, w, scale, shift, y) for the fused entries, (dtype, x, w, y,
# partial) for the statistics entries
GEO_AT = {"conv_fused_launch": 6, "grouped_fused_launch": 6, "conv_stats_launch": 5,
          "grouped_stats_launch": 5}


@pytest.mark.parametrize("n,h,w,cin,cout,k,s,p,d,groups,what", SHAPES, ids=IDS)
def test_wrappers_pass_the_15_shape_ints(recording_lib, n, h, w, cin, cout, k, s, p, d, groups,
                                         what):
    """The fused and statistics wrappers (through _launch_fused /
    _launch_stats, as a CUDA tensor would) pass n, h, w, cin, oh, ow, cout,
    kh, kw, sh, sw, ph, pw, dh, dw, with OH and OW of the dilated window;
    the signatures declare 15 ints there."""
    x = torch.zeros(n, h, w, cin, dtype=torch.bfloat16)
    wt = torch.zeros(k, k, cin // groups, cout, dtype=torch.bfloat16)
    (sh, sw), (ph, pw), (dh, dw) = (to_pair(v) for v in (s, p, d))
    oh = (h + 2 * ph - dh * (k - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (k - 1) - 1) // sw + 1
    prefix = "grouped_" if groups > 1 else ""
    kconv._launch_fused(f"{prefix}conv2d_fused", x, wt, None, None, s, p, True, groups,
                        dilation=d)
    kconv._launch_stats(f"{prefix}conv2d_stats", x, wt, s, p, groups, dilation=d)
    (fname, fargs), (sname, sargs), (rname, _) = recording_lib.calls
    want = (n, h, w, cin, oh, ow, cout, k, k, sh, sw, ph, pw, dh, dw)
    assert rname == "stats_reduce_launch"
    for name, args in ((fname, fargs), (sname, sargs)):
        assert name == ("grouped" if groups > 1 else "conv") + name[name.index("_"):]
        at = GEO_AT[name]
        assert args[at:at + 15] == want, name
        assert kernels._SIGNATURES[name][at:at + 15] == [kernels._I] * 15
    y = torch.zeros(n, oh, ow, cout)
    assert y.shape == ops.conv2d(x.float(), wt.float(), stride=s, padding=p, dilation=d,
                                 groups=groups).shape


@pytest.mark.parametrize("train,batch_norm,groups,wrapper", [
    (True, False, 1, "conv2d_fused"), (True, False, 2, "grouped_conv2d_fused"),
    (True, True, 1, "conv2d_stats"), (True, True, 2, "grouped_conv2d_stats"),
    (False, True, 1, "conv2d_fused"), (False, True, 2, "grouped_conv2d_fused")])
def test_layers_pass_the_dilation_to_the_kernels(monkeypatch, train, batch_norm, groups,
                                                 wrapper):
    """Conv2d in train mode (conv2d_train / grouped_conv2d_train, forward
    and backward), ConvBNReLU in train mode (conv_bn_relu_train) and in
    eval mode (the custom op) hand the layer's dilation to the kernel
    wrapper, and the result is the dilated conv's."""
    seen = []
    fn = getattr(kernels, wrapper)

    def recording(*args, **kwargs):
        seen.append(tuple(kwargs["dilation"]))
        return fn(*args, **kwargs)

    monkeypatch.setattr(kernels, wrapper, recording)
    block = nn.conv_block(8, 3, padding=2, dilation=2, groups=groups, batch_norm=batch_norm)
    block.init(torch.Generator().manual_seed(0), (1, 9, 9, 4))
    block.train(train)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 9, 9, 4).astype(np.float32))
    x.requires_grad_(train)
    out = block(x)
    if train:
        out.sum().backward()
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert seen == [(2, 2)] and out.shape == (2, 9, 9, 8)


def _grouped_convs(arch, kind):
    """{(Cin, Cout, groups, dilation, stride)} of the model's grouped convs
    (not depthwise)."""
    model = build_model(arch, Settings(kind=kind, input_size=(3, 32, 32), num_classes=10),
                        device="cpu")
    out = set()
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and m.groups > 1:
            cin = m.weight.shape[2] * m.groups
            if not (m.groups == cin and m.out_channels == cin):
                out.add((cin, m.out_channels, m.groups, m.dilation[0], m.stride[0]))
    return out


# per family: (distinct grouped convs, of them dilated, those the bf16 plan
# puts on the grouped mode of the tensor-core loop, those it puts on the
# tensor-core loop of csrc/grouped_wgmma.cu)
ROUTES = {("sknet", "26"): (14, 7, 14, 0), ("sk_resnet", "26"): (14, 7, 12, 0),
          ("shufflenet_v1", "g2"): (11, 0, 0, 11), ("shufflenet_v1", "g3"): (11, 0, 0, 11),
          ("shufflenet_v1", "g4"): (11, 0, 0, 11), ("shufflenet_v1", "g8"): (11, 0, 0, 11)}


@pytest.mark.parametrize("arch,kind", list(ROUTES))
def test_grouped_plan_routes_the_new_shapes(arch, kind):
    """bf16: the grouped mode of the tensor cores where it takes the shape
    (Cin/G = Cout/G in {4, 8, 16, 32}, Cin a multiple of 64), dilated or
    not; the CUDA-core loop for SK-ResNet's Cin/G 2 paths; the tensor-core
    loop of csrc/grouped_wgmma.cu for every other shape, every ShuffleNet
    grouped 1x1 among them (Cin ≠ Cout; Cin/G up to 400). fp32: the
    CUDA-core loop. Every shape is inside fits_grouped."""
    convs = _grouped_convs(arch, kind)
    wgmma = wide = 0
    for cin, cout, groups, dilation, stride in convs:
        assert kernels.fits_grouped(cin, cout, stride, dilation, groups)
        cg = cin // groups
        tensor_cores = cin == cout and cin % 64 == 0 and cg in kconv.GROUPED_WGMMA_CG
        plan = kernels.grouped_plan(torch.bfloat16, cin, cout, groups)
        want = "wgmma" if tensor_cores else "simt" if cg == 2 else "wgmma_wide"
        assert plan.route == want, (cin, cout, groups)
        assert kernels.grouped_plan(torch.float32, cin, cout, groups).route == "simt"
        wgmma += plan.route == "wgmma"
        wide += plan.route == "wgmma_wide"
    assert (len(convs), sum(c[3] > 1 for c in convs), wgmma, wide) == ROUTES[(arch, kind)]
    if arch == "shufflenet_v1":
        assert max(cin // groups for cin, _, groups, _, _ in convs) > 32
