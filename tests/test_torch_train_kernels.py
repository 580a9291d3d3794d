"""The port's trainable kernel functions (conv2d_stats, conv_bn_relu_train,
pool2d_train, conv2d_train, depthwise_train) against the JAX Pallas
functions run in interpret mode on the CPU, forward and VJP.

On the CPU the wrappers answer with their plain PyTorch versions; the CUDA
kernels are compared with the same plain versions on the card by
chip_smoke.py. Inputs and cotangents are made with numpy from a seed and
handed to both frameworks.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu.ops.pallas import conv2d_stats as jax_conv2d_stats
from convnets_tpu.ops.pallas import conv2d_train as jax_conv2d_train
from convnets_tpu.ops.pallas import conv_bn_relu_train as jax_conv_bn_relu_train
from convnets_tpu.ops.pallas import depthwise_train as jax_depthwise_train
from convnets_tpu.ops.pallas import pool2d_train as jax_pool2d_train
from convnets_tpu_torch.ops import kernels

# the (stride, padding, k) cases of tests/test_pallas.py, plus the ResNet
# stem (7x7/2 p3 on Cin=3)
CONV_CASES = [(1, 1, 3, 8), (2, 1, 3, 8), (1, 0, 1, 8), (2, 3, 7, 8), (2, 0, 1, 8),
              (2, 1, 1, 8), (2, 3, 7, 3)]
EPS = 1e-5


def _rand(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("stride,padding,k,cin", CONV_CASES)
def test_conv2d_stats_matches_jax(stride, padding, k, cin):
    x = _rand(0, (2, 16, 16, cin))
    w = _rand(1, (k, k, cin, 16), 0.1)
    want = jax_conv2d_stats(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding,
                            interpret=True)
    got = kernels.conv2d_stats(_t(x), _t(w), stride=stride, padding=padding)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5, atol=1e-5)
    for g, j in zip(got[1], want[1:]):
        assert g.dtype == torch.float32 and g.shape == (16,)
        np.testing.assert_allclose(_np(g), _np(j), rtol=1e-4, atol=1e-4)


def test_conv2d_stats_sums_the_rounded_bf16_output():
    """bf16: Σ and Σ² are of the stored (rounded) y, conv.py:534-538."""
    x = _rand(2, (2, 16, 16, 8))
    w = _rand(3, (3, 3, 8, 16), 0.1)
    y, (s1, s2) = kernels.conv2d_stats(_t(x, torch.bfloat16), _t(w, torch.bfloat16),
                                     stride=1, padding=1)
    assert y.dtype == torch.bfloat16
    yf = y.float()
    torch.testing.assert_close(s1, yf.sum((0, 1, 2)), rtol=0, atol=0)
    torch.testing.assert_close(s2, (yf * yf).sum((0, 1, 2)), rtol=0, atol=0)
    want = jax_conv2d_stats(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                            stride=1, padding=1, interpret=True)
    # one bf16 ulp (2^-8 relative) where the two accumulation orders round apart
    np.testing.assert_allclose(_np(y), _np(want[0]), rtol=2 ** -7, atol=1e-2)
    for g, j in zip((s1, s2), want[1:]):
        np.testing.assert_allclose(_np(g), _np(j), rtol=1e-3, atol=1e-2)


def _fused_case(stride, relu, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = _rand(0, (4, 8, 8, 8))
    w = _rand(1, (3, 3, 8, 16), 0.2)
    gamma = _rand(2, (16,), 0.3) + 1.0
    beta = _rand(3, (16,), 0.2)
    probe = _rand(4, (4, 8 // stride, 8 // stride, 16))

    def fn(x_, w_, g_, b_):
        return jax_conv_bn_relu_train(x_, w_, g_, b_, stride, 1, 1, EPS, relu, True)

    want, vjp = jax.vjp(fn, jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(gamma),
                        jnp.asarray(beta))
    jgrads = vjp((jnp.asarray(probe, jd), jnp.zeros(16), jnp.zeros(16)))

    ins = [_t(x, dtype, True), _t(w, dtype, True), _t(gamma, grad=True), _t(beta, grad=True)]
    got = kernels.conv_bn_relu_train(*ins, stride, 1, EPS, relu)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    assert not got[1].requires_grad and not got[2].requires_grad
    tgrads = torch.autograd.grad(got[0], ins, _t(probe, dtype))
    return want, got, jgrads, tgrads


@pytest.mark.parametrize("stride,relu", [(1, True), (2, True), (1, False), (2, False)])
def test_conv_bn_relu_train_matches_jax(stride, relu):
    want, got, jgrads, tgrads = _fused_case(stride, relu, torch.float32)
    for g, j, name in zip(got, want, ("out", "mean", "var")):
        np.testing.assert_allclose(_np(g), _np(j), rtol=1e-4, atol=1e-4, err_msg=name)
    for g, j, name in zip(tgrads, jgrads, ("dx", "dw", "dscale", "dbias")):
        assert tuple(g.shape) == tuple(j.shape)
        np.testing.assert_allclose(_np(g), _np(j), rtol=1e-4, atol=1e-4, err_msg=name)


def test_conv_bn_relu_train_bf16_matches_jax():
    """bf16 compute. Both frameworks round the elementwise bf16 chain at the
    same points (they agree bit for bit on this CPU); the bar allows one
    bf16 ulp (2^-8 relative) where a conv accumulation order rounds y apart:
    out to 2^-7 relative, the fp32 statistics to 1e-4, gradients to 1e-2
    of their largest element."""
    want, got, jgrads, tgrads = _fused_case(1, True, torch.bfloat16)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-4, atol=1e-4)
    for g, j, name in zip(tgrads, jgrads, ("dx", "dw", "dscale", "dbias")):
        assert g.dtype == (torch.bfloat16 if name in ("dx", "dw") else torch.float32)
        scale = float(np.abs(_np(j)).max())
        np.testing.assert_allclose(_np(g), _np(j), rtol=0, atol=1e-2 * scale, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool2d_train_max_routes_ties_like_jax(dtype):
    """The stem pool follows a ReLU, so its windows hold tied zeros: each
    window's gradient must reach the same element in both frameworks."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = np.maximum(_rand(5, (2, 12, 12, 8)), 0.0)  # about half exact zeros
    x[:, :4, :4, :] = 0.0  # whole windows of ties
    x[0, 6:9, 6:9, 0] = 0.5  # a tie of positive values
    g = _rand(6, (2, 6, 6, 8))
    want, vjp = jax.vjp(lambda a: jax_pool2d_train(a, "max", 3, 2, 1, True), jnp.asarray(x, jd))
    (jdx,) = vjp(jnp.asarray(g, jd))
    xt = _t(x, dtype, True)
    got = kernels.pool2d_train(xt, "max", 3, 2, 1)
    (tdx,) = torch.autograd.grad(got, xt, _t(g, dtype))
    np.testing.assert_array_equal(_np(got), _np(want))
    # fp32: the ≤ 4 contributions an element gets may be added in another
    # order; bf16: and rounded per addition
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(_np(tdx), _np(jdx), rtol=tol, atol=tol)
    assert ((_np(tdx) != 0) == (_np(jdx) != 0)).all()


@pytest.mark.parametrize("stride,padding,k,cin", [(1, 1, 3, 8), (2, 1, 3, 8), (2, 0, 1, 8),
                                                  (2, 3, 7, 3)])
def test_conv2d_train_matches_jax(stride, padding, k, cin):
    x = _rand(0, (2, 16, 16, cin))
    w = _rand(1, (k, k, cin, 16), 0.1)
    y0 = jax_conv2d_train(jnp.asarray(x), jnp.asarray(w), stride, padding, True)
    g = _rand(2, y0.shape)
    want, vjp = jax.vjp(lambda a, b: jax_conv2d_train(a, b, stride, padding, True),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    xt, wt = _t(x, grad=True), _t(w, grad=True)
    got = kernels.conv2d_train(xt, wt, stride, padding)
    tdx, tdw = torch.autograd.grad(got, (xt, wt), _t(g))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tdx), _np(jdx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tdw), _np(jdw), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,padding", [(2, 2, 0), (3, 2, 1)])
def test_pool2d_train_avg_matches_jax(k, stride, padding, dtype):
    """Avg mode: forward through the avg_pool2d wrapper, dx the plain avg
    pool's VJP with the cotangent cast to x.dtype (pool.py:111-116): g·1/k²
    spread over each window, padding taps included in the divisor."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = _rand(7, (2, 12, 12, 8))
    want, vjp = jax.vjp(lambda a: jax_pool2d_train(a, "avg", k, stride, padding, True),
                        jnp.asarray(x, jd))
    g = _rand(8, want.shape)
    (jdx,) = vjp(jnp.asarray(g, jd))
    xt = _t(x, dtype, True)
    got = kernels.pool2d_train(xt, "avg", k, stride, padding)
    (tdx,) = torch.autograd.grad(got, xt, _t(g, dtype))
    assert got.dtype == tdx.dtype == dtype
    # fp32: summation order only; bf16: one ulp (2^-8 relative) of a rounding
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tdx), _np(jdx), rtol=tol, atol=tol)


def test_pool2d_train_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        kernels.pool2d_train(torch.zeros(1, 4, 4, 2), "sum", 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_train_matches_jax(stride, dtype):
    """Forward through the depthwise kernel's wrapper, dx/dw the grouped
    conv's VJP with the cotangent cast to x.dtype (conv.py:712-719)."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = _rand(0, (2, 13, 13, 16))
    w = _rand(1, (3, 3, 1, 16), 0.3)
    want, vjp = jax.vjp(lambda a, b: jax_depthwise_train(a, b, stride, 1, True),
                        jnp.asarray(x, jd), jnp.asarray(w, jd))
    g = _rand(2, want.shape)
    jdx, jdw = vjp(jnp.asarray(g, jd))
    xt, wt = _t(x, dtype, True), _t(w, dtype, True)
    got = kernels.depthwise_train(xt, wt, stride, 1)
    tdx, tdw = torch.autograd.grad(got, (xt, wt), _t(g, dtype))
    assert got.dtype == tdx.dtype == tdw.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(tdx), _np(jdx), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(tdw), _np(jdw), rtol=1e-4, atol=1e-4)
        return
    # bf16: one ulp (2^-8 relative) where the accumulation orders round y
    # apart; the gradients (bf16 convs in both) to 1e-2 of their largest element
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -7)
    for a, b, name in ((tdx, jdx, "dx"), (tdw, jdw, "dw")):
        scale = float(np.abs(_np(b)).max())
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-2 * scale, err_msg=name)
