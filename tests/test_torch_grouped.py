"""The port's grouped conv kernels and the whole-bottleneck-block kernel
(convnets_tpu_torch/ops/kernels/{conv,fused,block}.py) against the JAX
package on the CPU, and the card default of build_model.

The JAX package runs a grouped conv through its dense Pallas kernels on a
block-diagonal weight (ops/pallas/conv.py:block_diag_weight); the port's
kernel sums each group's own products only, so the two agree up to the
order of fp32 sums. Pallas runs in interpret mode, as tests/test_pallas.py
and tests/test_block_kernel.py run it. On the CPU each wrapper answers with
its plain PyTorch version; chip_smoke.py holds the CUDA kernels against the
same plain versions on the card. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu.ops.pallas import conv2d_fused as jax_conv2d_fused
from convnets_tpu.ops.pallas import conv2d_stats as jax_conv2d_stats
from convnets_tpu.ops.pallas import conv_bn_relu_train as jax_conv_bn_relu_train
from convnets_tpu.ops.pallas import grouped_conv2d_train as jax_grouped_conv2d_train
from convnets_tpu.ops.pallas.block import bottleneck_block as jax_bottleneck_block
from convnets_tpu.ops.pallas.block import bottleneck_block_reference
from convnets_tpu.ops.pallas.conv import block_diag_weight
from convnets_tpu.settings import Settings
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.nn import layers
from convnets_tpu_torch.ops import kernels

EPS = 1e-5
GROUPED_CASES = [(g, s) for g in (4, 8, 32) for s in (1, 2)]


def _rand(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).requires_grad_(grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _grouped_inputs(groups, cg=4, cout_per_group=4, hw=8, n=2):
    cin, cout = groups * cg, groups * cout_per_group
    x = _rand(0, (n, hw, hw, cin))
    w = _rand(1, (3, 3, cg, cout), 0.2)
    scale = 1.0 + _rand(2, (cout,), 0.2)
    shift = _rand(3, (cout,), 0.1)
    return x, w, scale, shift


@pytest.mark.parametrize("epilogue", ["none", "bn_relu"])
@pytest.mark.parametrize("groups,stride", GROUPED_CASES)
def test_grouped_conv2d_fused_matches_jax_block_diagonal(groups, stride, epilogue):
    """fp32: the port's per-group sums against the JAX dense kernel on the
    block-diagonal weight; 1e-5 for the conv alone, 1e-4 with the fp32
    multiply-add epilogue (the bars of test_torch_kernels.py)."""
    x, w, scale, shift = _grouped_inputs(groups)
    epi = epilogue == "bn_relu"
    want = jax_conv2d_fused(jnp.asarray(x), block_diag_weight(jnp.asarray(w), groups),
                            jnp.asarray(scale) if epi else None,
                            jnp.asarray(shift) if epi else None,
                            stride=stride, padding=1, relu=epi, interpret=True)
    got = kernels.grouped_conv2d_fused(_t(x), _t(w), groups, _t(scale) if epi else None,
                                       _t(shift) if epi else None, stride=stride, padding=1,
                                       relu=epi)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == tuple(want.shape)
    tol = 1e-4 if epi else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("groups,stride", GROUPED_CASES)
def test_grouped_conv2d_stats_matches_jax_block_diagonal(groups, stride):
    """y to 1e-5 and Σy, Σy² to 1e-4, the bars of test_torch_train_kernels.py."""
    x, w, _, _ = _grouped_inputs(groups, cout_per_group=8)
    want = jax_conv2d_stats(jnp.asarray(x), block_diag_weight(jnp.asarray(w), groups),
                            stride=stride, padding=1, interpret=True)
    got = kernels.grouped_conv2d_stats(_t(x), _t(w), groups, stride=stride, padding=1)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5, atol=1e-5)
    for g, j in zip(got[1], want[1:]):
        assert g.dtype == torch.float32 and g.shape == (groups * 8,)
        np.testing.assert_allclose(_np(g), _np(j), rtol=1e-4, atol=1e-4)


def test_grouped_conv2d_fused_bf16_rounds_once():
    """bf16 in, bf16 out: the fp32 grouped conv and epilogue rounded once,
    within one bf16 ulp (2^-8 relative) of the JAX kernel's rounding."""
    x, w, scale, shift = _grouped_inputs(8)
    want = jax_conv2d_fused(jnp.asarray(x, jnp.bfloat16),
                            block_diag_weight(jnp.asarray(w, jnp.bfloat16), 8),
                            jnp.asarray(scale), jnp.asarray(shift), stride=1, padding=1,
                            relu=True, interpret=True)
    got = kernels.grouped_conv2d_fused(_t(x, torch.bfloat16), _t(w, torch.bfloat16), 8,
                                       _t(scale), _t(shift), stride=1, padding=1, relu=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("groups,stride", [(4, 1), (8, 2), (32, 1)])
def test_grouped_conv2d_train_matches_jax(groups, stride):
    """Forward, dx and dw against JAX grouped_conv2d_train in interpret mode,
    at the bars of tests/test_pallas.py:103-126 (forward 1e-4, gradients
    1e-3); dw comes back (kh, kw, Cin/G, Cout)."""
    cin, cout = groups * 4, groups * 8
    x = _rand(0, (2, 8, 8, cin))
    w = _rand(1, (3, 3, 4, cout), 0.1)
    probe = _rand(2, (2, 8 // stride, 8 // stride, cout))

    want, vjp = jax.vjp(lambda a, b: jax_grouped_conv2d_train(a, b, groups, stride, 1, True),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(probe))
    ins = [_t(x, grad=True), _t(w, grad=True)]
    got = kernels.grouped_conv2d_train(*ins, groups, stride, 1)
    dx, dw = torch.autograd.grad(got, ins, _t(probe))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert tuple(dw.shape) == (3, 3, 4, cout)
    np.testing.assert_allclose(_np(dx), _np(jdx), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(dw), _np(jdw), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("stride,relu", [(1, True), (2, True), (1, False)])
def test_grouped_conv_bn_relu_train_matches_jax(stride, relu):
    """conv_bn_relu_train with groups 4 against JAX's (block-diagonal
    forward, grouped VJP) in interpret mode: out, mean, var and dx, dw,
    dγ, dβ at 1e-4, the bar of test_torch_train_kernels.py."""
    groups, cin, cout = 4, 32, 64
    x = _rand(0, (4, 8, 8, cin))
    w = _rand(1, (3, 3, cin // groups, cout), 0.2)
    gamma = _rand(2, (cout,), 0.3) + 1.0
    beta = _rand(3, (cout,), 0.2)
    probe = _rand(4, (4, 8 // stride, 8 // stride, cout))

    def fn(x_, w_, g_, b_):
        return jax_conv_bn_relu_train(x_, w_, g_, b_, stride, 1, groups, EPS, relu, True)

    want, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma),
                        jnp.asarray(beta))
    jgrads = vjp((jnp.asarray(probe), jnp.zeros(cout), jnp.zeros(cout)))
    ins = [_t(x, grad=True), _t(w, grad=True), _t(gamma, grad=True), _t(beta, grad=True)]
    got = kernels.conv_bn_relu_train(*ins, stride, 1, EPS, relu, groups=groups)
    tgrads = torch.autograd.grad(got[0], ins, _t(probe))
    for g, j, name in zip(got, want, ("out", "mean", "var")):
        np.testing.assert_allclose(_np(g), _np(j), rtol=1e-4, atol=1e-4, err_msg=name)
    for g, j, name in zip(tgrads, jgrads, ("dx", "dw", "dscale", "dbias")):
        assert tuple(g.shape) == tuple(j.shape)
        np.testing.assert_allclose(_np(g), _np(j), rtol=1e-4, atol=1e-4, err_msg=name)


def test_fits_grouped_is_the_jax_envelope():
    """The port's grouped envelope is the JAX package's Pallas one
    (ops/pallas/__init__.py:fits_grouped) widened to every grouped conv
    its Conv2d takes off the depthwise kernel: by dilation (SKConv's second
    path), by Cin/G above 32 (ShuffleNet's grouped 1x1s, Cin/G up to 400),
    by more than 64 groups and by any stride per axis (3, (2, 1)). It
    contains JAX's, and takes exactly what JAX's takes once those four
    limits are lifted."""
    from convnets_tpu.ops.pallas import fits_grouped as jax_fits_grouped

    cases = [(128, 128, 1, 1, 32), (64, 64, 2, 1, 32), (32, 64, 1, 1, 32), (256, 256, 1, 1, 4),
             (128, 128, 1, 2, 32), (128, 128, 3, 1, 32), (4, 4, 1, 1, 4), (96, 96, 1, 1, 3),
             (4096, 4096, 1, 1, 128), (128, 130, 1, 1, 32), (16, 16, 1, 1, 1),
             (272, 68, 1, 1, 4), (800, 200, 1, 1, 2), (68, 248, 1, 1, 4), (256, 256, 2, 2, 32),
             (128, 128, 3, 2, 32), (6, 8, 1, 1, 2), (512, 512, 1, 1, 256),
             (256, 256, (2, 1), 1, 32), (64, 64, (1, 3), (2, 1), 8), (128, 256, 1, 1, 128)]
    for cin, cout, stride, dilation, groups in cases:
        port = kernels.fits_grouped(cin, cout, stride, dilation, groups)
        if jax_fits_grouped(cin, cout, stride, dilation, groups):
            assert port, (cin, cout, stride, dilation, groups)
        # JAX's test with the dilation, the Cin/G <= 32 cap, the 64-group
        # cap and the stride set lifted
        widened = (jax_fits_grouped(2 * min(groups, 64), 2 * min(groups, 64), 1, 1,
                                    min(groups, 64))
                   and cin % groups == 0 and cout % groups == 0 and cin // groups >= 2)
        assert port == widened, (cin, cout, stride, dilation, groups)


@pytest.mark.parametrize("cin,cout,groups,family", [
    (16, 32, 1, layers.DENSE), (16, 16, 16, layers.DEPTHWISE), (128, 128, 32, layers.GROUPED),
    (8, 16, 4, layers.GROUPED)])
def test_conv_family_in_the_jax_order(cin, cout, groups, family):
    """Dense first, then depthwise (Cin/G = 1), then grouped (Cin/G >= 2),
    as the JAX Conv2d tests them (nn/layers.py:91-105)."""
    conv = layers.Conv2d(cout, 3, padding=1, groups=groups)
    assert layers._check_conv_envelope(conv, cin) == family


# --- the whole-bottleneck-block kernel ------------------------------------

def _block_inputs(seed, n, h, w, cin, cmid):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, h, w, cin).astype(np.float32),
            (rng.randn(cin, cmid) / np.sqrt(cin)).astype(np.float32),
            rng.uniform(0.5, 1.5, cmid).astype(np.float32),
            (0.1 * rng.randn(cmid)).astype(np.float32),
            (rng.randn(3, 3, cmid, cmid) / np.sqrt(9 * cmid)).astype(np.float32),
            rng.uniform(0.5, 1.5, cmid).astype(np.float32),
            (0.1 * rng.randn(cmid)).astype(np.float32),
            (rng.randn(cmid, cin) / np.sqrt(cmid)).astype(np.float32),
            rng.uniform(0.5, 1.5, cin).astype(np.float32),
            (0.1 * rng.randn(cin)).astype(np.float32)]


def _block_both(args, dtype=torch.float32, relu_out=True):
    """(JAX interpret-mode kernel, JAX lax oracle, port) as float32 numpy."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    weights = (1, 4, 7)  # w1, w2, w3 in the compute dtype; x too
    jargs = [jnp.asarray(a).astype(jd) if i == 0 or i in weights else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [_t(a, dtype) if i == 0 or i in weights else _t(a) for i, a in enumerate(args)]
    kernel = jax_bottleneck_block(*jargs, relu_out=relu_out, interpret=True)
    oracle = bottleneck_block_reference(*jargs, relu_out=relu_out)
    got = kernels.bottleneck_block(*targs, relu_out=relu_out)
    assert got.dtype == dtype and got.shape == targs[0].shape
    return _np(kernel), _np(oracle), _np(got)


@pytest.mark.parametrize("shape", [(2, 14, 14, 128, 32), (2, 7, 7, 256, 64), (1, 8, 8, 64, 16)])
def test_bottleneck_block_matches_jax_f32(shape):
    """The shapes and fp32 bar (2e-5) of tests/test_block_kernel.py."""
    kernel, oracle, got = _block_both(_block_inputs(0, *shape))
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)


def test_bottleneck_block_matches_jax_bf16():
    """bf16, at tests/test_block_kernel.py's 5e-2: h1 and h2 round to bf16
    at the same points, and the accumulation orders differ by bf16 ulps."""
    kernel, oracle, got = _block_both(_block_inputs(1, 2, 14, 14, 128, 32), torch.bfloat16)
    np.testing.assert_allclose(got, oracle, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got, kernel, rtol=0.05, atol=0.05)


def test_bottleneck_block_without_final_relu_and_4d_weights():
    args = _block_inputs(2, 1, 8, 8, 64, 16)
    args[1] = args[1].reshape(1, 1, 64, 16)
    args[7] = args[7].reshape(1, 1, 16, 64)
    kernel, oracle, got = _block_both(args, relu_out=False)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    assert got.min() < 0.0  # no final ReLU


def test_bottleneck_block_halo_is_zero_not_relu_b1():
    """With W1 = 0, h1 = ReLU(b1) > 0 inside the image, and the 3×3 conv
    must still see zeros outside it (block.py:68): a border pixel differs
    from an interior one."""
    args = _block_inputs(3, 1, 6, 6, 32, 8)
    args[1] = np.zeros_like(args[1])
    args[3] = np.abs(args[3]) + 0.5
    args[0] = np.zeros_like(args[0])
    kernel, oracle, got = _block_both(args, relu_out=False)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    assert not np.allclose(got[0, 0, 0], got[0, 3, 3])


def test_fits_block_envelope():
    assert kernels.fits_block(14, 14, 1024, 256)
    assert kernels.fits_block(28, 28, 512, 128)
    assert not kernels.fits_block(56, 56, 4096, 1024)
    assert not kernels.fits_block(8, 8, 16, 32)  # Cmid > Cin


# --- the entry point defaults to the card ----------------------------------

def test_build_model_defaults_to_cuda_and_raises_without_it():
    setting = Settings(kind="18", input_size=(3, 32, 32), num_classes=10)
    if torch.cuda.is_available():
        assert build_model("resnet", setting).module._modules["0"]._modules["0"] \
            .weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model("resnet", setting)
    assert next(build_model("resnet", setting, device="cpu").parameters()).device.type == "cpu"
