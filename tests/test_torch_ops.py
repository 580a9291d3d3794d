"""The port's plain ops (convnets_tpu_torch/ops) against convnets_tpu.ops on
the CPU, from the same numpy inputs. fp32 at 1e-5 unless stated."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from convnets_tpu import ops as jops
from convnets_tpu.core.precision import policy_from_setting as jax_policy_from_setting
from convnets_tpu_torch import ops
from convnets_tpu_torch.core.precision import policy_from_setting
from convnets_tpu_torch.ops import initializers

RNG = np.random.RandomState(0)
X = RNG.randn(2, 9, 9, 16).astype(np.float32)
MEAN = (0.1 * RNG.randn(16)).astype(np.float32)
VAR = RNG.uniform(0.5, 1.5, 16).astype(np.float32)
SCALE = RNG.uniform(0.5, 1.5, 16).astype(np.float32)
BIAS = (0.1 * RNG.randn(16)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_inference_both_dtype_branches(dtype):
    """fp32: the subtract-first form; bf16: per-channel constants folded in
    fp32 and one bf16 multiply-add — identical roundings in both frameworks."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = jops.batch_norm_inference(jnp.asarray(X).astype(jd), jnp.asarray(MEAN),
                                     jnp.asarray(VAR), jnp.asarray(SCALE), jnp.asarray(BIAS))
    got = ops.batch_norm_inference(_t(X, td), _t(MEAN), _t(VAR), _t(SCALE), _t(BIAS))
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_avg_pool2d_means_in_fp32(dtype):
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = jops.global_avg_pool2d(jnp.asarray(X).astype(jd))
    got = ops.global_avg_pool2d(_t(X, td))
    assert got.dtype == td and got.shape == (2, 16)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8  # one rounding of an fp32 mean
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 3, 7), (2, 0, 1)])
def test_conv2d_matches_lax(stride, padding, k):
    w = (RNG.randn(k, k, 16, 8) * 0.1).astype(np.float32)
    want = jops.conv2d(jnp.asarray(X), jnp.asarray(w), stride=stride, padding=padding)
    got = ops.conv2d(_t(X), _t(w), stride=stride, padding=padding)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_linear_matches_jax():
    x = RNG.randn(4, 32).astype(np.float32)
    w = (0.1 * RNG.randn(32, 10)).astype(np.float32)
    b = RNG.randn(10).astype(np.float32)
    want = jops.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(_np(ops.linear(_t(x), _t(w), _t(b))), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_max_pool2d_and_relu_match_jax():
    want = jops.max_pool2d(jnp.asarray(X), 3, 2, 1)
    np.testing.assert_array_equal(_np(ops.max_pool2d(_t(X), 3, 2, 1)), np.asarray(want))
    np.testing.assert_array_equal(_np(ops.relu(_t(X))), np.asarray(jops.relu(jnp.asarray(X))))
    np.testing.assert_allclose(_np(ops.softmax(_t(X))), np.asarray(jops.softmax(jnp.asarray(X))),
                               rtol=1e-6, atol=1e-6)


def test_eval_dropout_is_identity_and_train_dropout_raises():
    """Eval mode and rate 0 are the identity; train mode without a generator
    raises, as the JAX Dropout does without an rng key."""
    x = _t(X)
    assert ops.dropout(x, 0.5, train=False) is x
    assert ops.dropout(x, 0.0, train=True) is x
    with pytest.raises(ValueError, match="Generator"):
        ops.dropout(x, 0.5, train=True)


@pytest.mark.parametrize("mixed", [False, True])
def test_policy_from_setting(mixed):
    class S:
        mixed_precision = mixed

    want = jax_policy_from_setting(S())
    got = policy_from_setting(S())
    for field in ("param_dtype", "compute_dtype", "accum_dtype", "norm_dtype", "output_dtype"):
        assert str(getattr(got, field)).split(".")[-1] == jnp.dtype(getattr(want, field)).name


def test_initializer_statistics():
    """Same distributions as convnets_tpu/ops/initializers.py, from an
    explicit generator (the values differ from JAX's)."""
    g = torch.Generator().manual_seed(0)
    w = initializers.he_normal_conv((3, 3, 64, 128), g)
    assert abs(float(w.std()) - (2.0 / (128 * 9)) ** 0.5) < 2e-3
    lin = initializers.normal_linear((512, 100), g)
    assert abs(float(lin.std()) - 0.01) < 5e-4
    u = initializers.he_uniform_conv_default((3, 3, 16, 8), g)
    assert float(u.abs().max()) <= (1.0 / (16 * 9)) ** 0.5
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(initializers.he_normal_conv((3, 3, 64, 128), g2), w)
