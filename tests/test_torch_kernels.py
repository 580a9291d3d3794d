"""The port's kernel modules (convnets_tpu_torch/ops/kernels) against the
JAX Pallas kernels run in interpret mode on the CPU.

On the CPU each wrapper answers with its plain PyTorch version; the CUDA
kernels themselves are compared with the same plain versions on the card
by chip_smoke.py. Inputs are made with numpy from a seed and handed to
both frameworks.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from convnets_tpu.ops.pallas import avg_pool2d as jax_avg_pool2d
from convnets_tpu.ops.pallas import conv2d_fused as jax_conv2d_fused
from convnets_tpu.ops.pallas import depthwise_conv2d as jax_depthwise_conv2d
from convnets_tpu.ops.pallas import max_pool2d as jax_max_pool2d
from convnets_tpu_torch.ops import kernels

# the (stride, padding, k) cases of tests/test_pallas.py, plus the ResNet
# stem (7x7/2 p3 on Cin=3)
CONV_CASES = [(1, 1, 3, 8), (2, 1, 3, 8), (1, 0, 1, 8), (2, 3, 7, 8), (2, 0, 1, 8),
              (2, 1, 1, 8), (2, 3, 7, 3)]


def _conv_inputs(seed, cin, k, cout=16, n=2, hw=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    scale = (1.0 + 0.2 * rng.randn(cout)).astype(np.float32)
    shift = (0.1 * rng.randn(cout)).astype(np.float32)
    return x, w, scale, shift


def _both(x, w, scale, shift, stride, padding, relu, dtype=np.float32):
    """(JAX interpret-mode result, port result) as float32 numpy."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_conv2d_fused(
        jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
        None if scale is None else jnp.asarray(scale),
        None if shift is None else jnp.asarray(shift),
        stride=stride, padding=padding, relu=relu, interpret=True)
    got = kernels.conv2d_fused(
        torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
        None if scale is None else torch.from_numpy(scale),
        None if shift is None else torch.from_numpy(shift),
        stride=stride, padding=padding, relu=relu)
    assert got.dtype == td and got.is_contiguous()
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("epilogue", ["none", "bn_relu"])
@pytest.mark.parametrize("stride,padding,k,cin", CONV_CASES)
def test_conv2d_fused_matches_jax(stride, padding, k, cin, epilogue):
    x, w, scale, shift = _conv_inputs(0, cin, k)
    if epilogue == "none":
        want, got = _both(x, w, None, None, stride, padding, False)
        tol = 1e-5
    else:
        want, got = _both(x, w, scale, shift, stride, padding, True)
        tol = 1e-4  # the epilogue's fp32 multiply-add, as tests/test_pallas.py:49
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("scale_on,relu", [(True, False), (False, True)])
def test_conv2d_fused_epilogue_parts(scale_on, relu):
    x, w, scale, shift = _conv_inputs(1, 8, 3)
    want, got = _both(x, w, scale if scale_on else None, shift if scale_on else None,
                      1, 1, relu)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv2d_fused_shift_only_means_unit_scale():
    x, w, _, shift = _conv_inputs(2, 8, 3)
    want, got = _both(x, w, None, shift, 2, 1, False)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv2d_fused_bf16():
    """Both round once from an fp32 accumulator; only the summation order
    differs, so an element may differ by one bf16 ulp (2^-7 relative), and
    by a little more in absolute terms where the shift cancels the sum."""
    x, w, scale, shift = _conv_inputs(3, 8, 3)
    want, got = _both(x, w, scale, shift, 2, 1, True, dtype="bfloat16")
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-3)


POOL_CASES = [(3, 2, 1), (2, 2, 0), (3, 1, 1)]


@pytest.mark.parametrize("k,stride,padding", POOL_CASES)
def test_max_pool2d_matches_jax(k, stride, padding):
    x = np.random.RandomState(4).randn(2, 16, 16, 8).astype(np.float32)
    want = np.asarray(jax_max_pool2d(jnp.asarray(x), k, stride, padding, interpret=True))
    got = kernels.max_pool2d(torch.from_numpy(x), k, stride, padding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool2d_all_negative_uses_neg_inf_padding(dtype):
    """With every input below 0, a zero-padded pool would return 0 at the
    border; -inf padding returns the window's own max."""
    x = -np.abs(np.random.RandomState(5).randn(2, 15, 15, 4)).astype(np.float32) - 1.0
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = np.asarray(jax_max_pool2d(jnp.asarray(x).astype(jd), 3, 2, 1,
                                     interpret=True).astype(jnp.float32))
    got = kernels.max_pool2d(torch.from_numpy(x).to(td), 3, 2, 1)
    assert got.dtype == td
    assert (got.float().numpy() < 0).all()
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,padding", [(2, 2, 0), (3, 1, 1), (3, 2, 1)])
def test_avg_pool2d_matches_jax(k, stride, padding, dtype):
    """fp32 window sum × fp32 1/(k·k), one rounding; padding taps count as
    zeros. fp32: only the summation order may differ; bf16: both round the
    same fp32 value, one ulp (2^-8 relative) where the orders round apart."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    x = np.random.RandomState(7).randn(2, 16, 16, 8).astype(np.float32)
    want = np.asarray(jax_avg_pool2d(jnp.asarray(x).astype(jd), k, stride, padding,
                                     interpret=True).astype(jnp.float32))
    got = kernels.avg_pool2d(torch.from_numpy(x).to(td), k, stride, padding)
    assert got.dtype == td and got.is_contiguous() and got.shape == want.shape
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,hw,c", [
    pytest.param(1, 15, 24, id="1"), pytest.param(2, 15, 24, id="2"),
    # MobileNet-like: C not a multiple of 8 (the kernel's loop route), odd
    # maps at stride 2 (7² -> 4², 13² -> 7²), a 7² stride-1 map
    pytest.param(2, 13, 12, id="2-13x13x12"), pytest.param(2, 7, 20, id="2-7x7x20"),
    pytest.param(1, 7, 32, id="1-7x7x32"), pytest.param(1, 9, 27, id="1-9x9x27")])
def test_depthwise_conv2d_matches_jax(stride, hw, c, dtype):
    """fp32 products accumulated in (i, j) order, one rounding to x.dtype:
    fp32 to the accumulation order, bf16 to one ulp (2^-8 relative)."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    rng = np.random.RandomState(8)
    x = rng.randn(2, hw, hw, c).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, 1, c)).astype(np.float32)
    want = np.asarray(jax_depthwise_conv2d(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                                           stride=stride, padding=1,
                                           interpret=True).astype(jnp.float32))
    got = kernels.depthwise_conv2d(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                                   stride=stride, padding=1)
    assert got.dtype == td and got.is_contiguous() and got.shape == want.shape
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kernels.reset_launches()
    x, w, scale, shift = _conv_inputs(6, 8, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    st, sh = torch.from_numpy(scale), torch.from_numpy(shift)
    got = kernels.conv2d_fused(xt, wt, st, sh, stride=2, padding=1, relu=True)
    ref = kernels.conv2d_fused_plain(xt, wt, st, sh, stride=2, padding=1, relu=True)
    assert torch.equal(got, ref)
    assert torch.equal(kernels.max_pool2d(xt, 3, 2, 1), kernels.max_pool2d_plain(xt, 3, 2, 1))
    assert torch.equal(kernels.avg_pool2d(xt, 2, 2), kernels.avg_pool2d_plain(xt, 2, 2))
    wd = torch.from_numpy(np.random.RandomState(9).randn(3, 3, 1, 8).astype(np.float32))
    assert torch.equal(kernels.depthwise_conv2d(xt, wd, stride=2, padding=1),
                       kernels.depthwise_conv2d_plain(xt, wd, stride=2, padding=1))
    for a, b in zip(kernels.conv2d_stats(xt, wt, stride=2, padding=1),
                    kernels.conv2d_stats_plain(xt, wt, stride=2, padding=1)):
        assert torch.equal(a, b)
    wg = torch.from_numpy(np.random.RandomState(10).randn(3, 3, 2, 16).astype(np.float32))
    assert torch.equal(kernels.grouped_conv2d_fused(xt, wg, 4, st, sh, stride=2, padding=1),
                       kernels.grouped_conv2d_fused_plain(xt, wg, 4, st, sh, stride=2, padding=1))
    for a, b in zip(kernels.grouped_conv2d_stats(xt, wg, 4, padding=1),
                    kernels.grouped_conv2d_stats_plain(xt, wg, 4, padding=1)):
        assert torch.equal(a, b)
    rng = np.random.RandomState(11)
    block = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
             for shape in ((1, 4, 4, 8), (8, 2), (2,), (2,), (3, 3, 2, 2), (2,), (2,), (2, 8),
                           (8,), (8,))]
    assert torch.equal(kernels.bottleneck_block(*block), kernels.bottleneck_block_plain(*block))
    y, taps = kernels.max_pool2d(xt, 3, 2, 1, taps=True)
    assert torch.equal(y, kernels.max_pool2d_plain(xt, 3, 2, 1)) and taps.dtype == torch.uint8
    assert torch.equal(kernels.pool2d_backward("max", y, taps, (16, 16), torch.float32, 3, 2, 1),
                       kernels.pool2d_backward_plain("max", y, taps, (16, 16), torch.float32,
                                                     3, 2, 1))
    for m in (2, 4):
        assert torch.equal(kernels.winograd_conv2d(xt, wt, None, st, sh, padding=1, m=m, relu=True),
                           kernels.winograd_conv2d_plain(xt, wt, None, st, sh, padding=1, m=m,
                                                         relu=True))
        for a, b in zip(kernels.winograd_conv2d_stats(xt, wt, padding=1, m=m),
                        kernels.winograd_conv2d_stats_plain(xt, wt, padding=1, m=m)):
            assert torch.equal(a, b)
    assert kernels.LAUNCHES == {"conv2d_fused": 0, "conv2d_stats": 0, "conv2d_stats_reduce": 0,
                                "max_pool2d": 0, "avg_pool2d": 0, "depthwise_conv2d": 0,
                                "grouped_conv2d_fused": 0, "grouped_conv2d_stats": 0,
                                "bottleneck_block": 0, "pool2d_backward": 0,
                                "bn_act_forward": 0, "bn_act_backward_sums": 0,
                                "bn_act_backward_reduce": 0, "bn_act_backward_apply": 0,
                                "winograd_input": 0, "winograd_output": 0}
    assert {k: set(v) for k, v in kernels.ROUTE_LAUNCHES.items()} == {
        "depthwise_conv2d": {"vector", "loop"}, "max_pool2d": {"vector", "loop"},
        "avg_pool2d": {"vector", "loop"}, "pool2d_backward": {"vector", "loop"},
        "bn_act_forward": {"vector", "loop"}, "bn_act_backward_sums": {"vector", "loop"},
        "bn_act_backward_apply": {"vector", "loop"}, "bottleneck_block": {"wgmma", "simt"},
        "grouped_conv2d_fused": {"wgmma", "wgmma_wide", "simt"},
        "grouped_conv2d_stats": {"wgmma", "wgmma_wide", "simt"}}
    assert all(n == 0 for routes in kernels.ROUTE_LAUNCHES.values() for n in routes.values())


def test_non_cpu_non_cuda_tensor_is_refused():
    """Off the CPU a wrapper launches its kernel or raises: no fallback."""
    x = torch.empty(1, 8, 8, 4, device="meta")
    w = torch.empty(3, 3, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv2d_fused(x, w, stride=1, padding=1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool2d(x, 3, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.avg_pool2d(x, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.depthwise_conv2d(x, torch.empty(3, 3, 1, 4, device="meta"), padding=1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv2d_stats(x, w, stride=1, padding=1)
    wg = torch.empty(3, 3, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.grouped_conv2d_fused(x, wg, 2, stride=1, padding=1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.grouped_conv2d_stats(x, wg, 2, stride=1, padding=1)
    block = [torch.empty(shape, device="meta")
             for shape in ((1, 8, 8, 4), (4, 2), (2,), (2,), (3, 3, 2, 2), (2,), (2,), (2, 4),
                           (4,), (4,))]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bottleneck_block(*block)


@pytest.mark.parametrize("stride,dilation,groups,fits", [
    (1, 1, 1, True), (2, 1, 1, True), ((1, 2), 1, 1, True), (3, 1, 1, True),
    (1, 2, 1, True), (1, 1, 4, False)])
def test_fits_conv(stride, dilation, groups, fits):
    """The dense kernels take any stride and dilation (AlexNet's 11x11/4
    stem, a dilated dense conv); a grouped conv is not theirs."""
    assert kernels.fits_conv(stride, dilation, groups) is fits


@pytest.mark.parametrize("cin,cout,dilation,groups,fits", [
    (32, 32, 1, 32, True), (1024, 1024, (1, 1), 1024, True), (32, 64, 1, 32, False),
    (32, 32, 2, 32, False), (32, 32, 1, 16, False), (8, 8, 1, 1, False)])
def test_fits_depthwise(cin, cout, dilation, groups, fits):
    """The envelope of convnets_tpu/ops/pallas/__init__.py:fits_depthwise
    (`fits`: its answer) widened by the channel multiplier and the dilation
    that JAX leaves to lax: it contains JAX's, and takes exactly JAX's test
    with both limits lifted (groups == Cin, Cout a multiple of Cin)."""
    from convnets_tpu.ops.pallas import fits_depthwise as jax_fits_depthwise

    assert jax_fits_depthwise(cin, cout, dilation, groups) is fits
    port = kernels.fits_depthwise(cin, cout, dilation, groups)
    assert port or not fits
    widened = cout % cin == 0 and jax_fits_depthwise(cin, cin, 1, groups)
    assert port is widened


def test_nothing_is_built_on_import_or_cpu_use():
    """The CPU path never reaches nvcc: the library stays unloaded."""
    assert kernels._lib is None
