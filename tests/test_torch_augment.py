"""The port's data/augment.py against the JAX package's, on the CPU.

The two packages' generators differ, so each random transform is compared
through its apply function: the parameters are drawn with jax.random as
the JAX function draws them (for augment_batch, by JAX's own
_affine_matrices) and handed to the port, whose result is held against the
JAX function run on the same key. fp32, within TOL = 1e-5 abs (the
bilinear weights are computed in another order: measured ≤ 3e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnets_tpu import ops as jops
from convnets_tpu.data import augment as J
from convnets_tpu_torch import ops
from convnets_tpu_torch.data import augment as P

TOL = 1e-5
KEY = jax.random.key(3)


def _x(n=4, h=32, w=32, seed=0):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _affine_args(do_affine):
    return (15.0, 15.0, (0.75, 1.25)) if do_affine else (0.0, 0.0, (1.0, 1.0))


@pytest.mark.parametrize("do_affine", [True, False])
def test_augment_apply_matches_jax_augment_batch(do_affine):
    """The gather path (affine) and the separable path (crop + flip)."""
    x = _x()
    want = np.asarray(J.augment_batch(KEY, jnp.asarray(x), do_affine=do_affine))
    deg, shear, scale = _affine_args(do_affine)
    a, b, c, d, tx, ty, _, _ = J._affine_matrices(KEY, 4, degrees=deg, shear_deg=shear,
                                                  scale_range=scale, crop_pad=4, hflip_p=0.5,
                                                  h=32, w=32)
    m = P.AffineMatrices(*(_t(v) for v in (a, b, c, d, tx, ty)))
    got = P.augment_apply(torch.from_numpy(x), m, do_affine).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("do_affine", [True, False])
def test_affine_matrices_match_jax(do_affine):
    """The draws (made here with JAX's calls of _affine_matrices) give
    JAX's matrices."""
    deg, shear, scale = _affine_args(do_affine)
    k1, k2, k3, k4, k5, k6 = jax.random.split(KEY, 6)
    draws = P.AffineDraws(
        _t(jax.random.uniform(k1, (6,), minval=-deg, maxval=deg)),
        _t(jax.random.uniform(k2, (6,), minval=-shear, maxval=shear)),
        _t(jax.random.uniform(k3, (6,), minval=scale[0], maxval=scale[1])),
        _t(jax.random.randint(k4, (6,), -4, 5).astype(jnp.float32)),
        _t(jax.random.randint(k5, (6,), -4, 5).astype(jnp.float32)),
        _t(jax.random.bernoulli(k6, 0.5, (6,))))
    want = J._affine_matrices(KEY, 6, degrees=deg, shear_deg=shear, scale_range=scale,
                              crop_pad=4, hflip_p=0.5, h=32, w=32)[:6]
    for got, ref in zip(P.affine_matrices(draws), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hw,out_hw", [((48, 40), (32, 32)), ((40, 40), (24, 28))])
def test_resized_crop_apply_matches_jax(hw, out_hw):
    x = _x(3, *hw, seed=1)
    want = np.asarray(J.random_resized_crop_batch(KEY, jnp.asarray(x), out_hw))
    k1, k2, k3, k4, k5 = jax.random.split(KEY, 5)
    draws = P.ResizedCropDraws(
        _t(jax.random.uniform(k1, (3,))),
        _t(jax.random.uniform(k2, (3,), minval=math.log(3 / 4), maxval=math.log(4 / 3))),
        _t(jax.random.uniform(k3, (3,))), _t(jax.random.uniform(k4, (3,))),
        _t(jax.random.bernoulli(k5, 0.5, (3,))))
    got = P.resized_crop_apply(torch.from_numpy(x), out_hw, draws).numpy()
    assert got.shape == (3, *out_hw, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("hw,out_hw", [((48, 40), (32, 32)), ((32, 32), (32, 32)),
                                       ((64, 80), (56, 48))])
def test_center_crop_resize_matches_jax(hw, out_hw):
    x = _x(2, *hw, seed=2)
    want = np.asarray(J.center_crop_resize(jnp.asarray(x), out_hw))
    got = P.center_crop_resize(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("size", [8, 5])
def test_cutout_apply_matches_jax(size):
    x = _x()
    ky, kx = jax.random.split(KEY)
    draws = P.CutoutDraws(_t(jax.random.randint(ky, (4,), 0, 32).astype(jnp.float32)),
                          _t(jax.random.randint(kx, (4,), 0, 32).astype(jnp.float32)))
    want = np.asarray(J.cutout(KEY, jnp.asarray(x), size))
    np.testing.assert_array_equal(P.cutout_apply(torch.from_numpy(x), draws, size).numpy(), want)


def test_normalize_matches_jax():
    x = _x()
    mean, std = np.array([0.5, 0.4, 0.3], np.float32), np.array([0.2, 0.25, 0.3], np.float32)
    np.testing.assert_array_equal(P.normalize(torch.from_numpy(x), mean, std).numpy(),
                                  np.asarray(J.normalize(jnp.asarray(x), mean, std)))
    np.testing.assert_array_equal(P.normalize(torch.from_numpy(x)).numpy(),
                                  np.asarray(J.normalize(jnp.asarray(x))))


def test_draws_are_fixed_by_the_generator_and_in_range():
    """The same seed gives the same draws; each lies in its range."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (P.affine_draws(g, 64), P.resized_crop_draws(g, 64), P.cutout_draws(g, 64, 32, 24),
                P.mixup_draws(g, torch.Generator().manual_seed(seed), 64, 0.2))
    a, b = draw(5), draw(5)
    for u, v in zip(a[:3], b[:3]):
        assert all(torch.equal(p, q) for p, q in zip(u, v))
    assert a[3].lam == b[3].lam and torch.equal(a[3].perm, b[3].perm)
    aff, rrc, cut, mix = a
    assert aff.angle.abs().max() <= 15 and aff.shear.abs().max() <= 15
    assert 0.75 <= aff.scale.min() and aff.scale.max() <= 1.25
    assert set(aff.tx.tolist()) <= set(range(-4, 5)) and aff.flip.dtype == torch.bool
    assert rrc.log_ratio.abs().max() <= math.log(4 / 3) + 1e-6
    assert cut.cy.max() < 32 and cut.cx.max() < 24 and cut.cy.min() >= 0
    assert 0.0 <= mix.lam <= 1.0 and sorted(mix.perm.tolist()) == list(range(64))
    assert not torch.equal(draw(6)[0].angle, aff.angle)


def test_augment_batch_runs_each_path():
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_x())
    for do_affine in (True, False):
        y = P.augment_batch(g, x, do_affine=do_affine)
        assert y.shape == x.shape and y.dtype == x.dtype and torch.isfinite(y).all()
    y = P.random_resized_crop_batch(g, torch.from_numpy(_x(2, 40, 48)), (32, 32))
    assert y.shape == (2, 32, 32, 3)
    # crop + flip only: every output pixel is a source pixel or the zero border
    y = P.augment_batch(g, x, do_affine=False)
    assert set(np.unique(y.numpy())) <= set(np.unique(x.numpy())) | {0.0}


def test_mixup_loss_matches_jax_cross_entropy_sums():
    """λ·CE(y) + (1−λ)·CE(y[perm]) with the JAX package's
    ops.cross_entropy_sum, weights and label smoothing included."""
    rng = np.random.RandomState(7)
    logits = rng.randn(8, 10).astype(np.float32)
    y = rng.randint(0, 10, 8)
    w = (np.arange(8) < 6).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    draws = P.mixup_draws(g, torch.Generator().manual_seed(2), 8, 0.2)
    perm = draws.perm.numpy()
    lam = np.float32(draws.lam)
    for eps in (0.0, 0.1):
        want = (lam * jops.cross_entropy_sum(jnp.asarray(logits), y, w, label_smoothing=eps)
                + (1 - lam) * jops.cross_entropy_sum(jnp.asarray(logits), y[perm], w,
                                                     label_smoothing=eps))
        got = ops.mixup_cross_entropy_sum(torch.from_numpy(logits), torch.from_numpy(y),
                                          torch.from_numpy(y[perm]), draws.lam,
                                          torch.from_numpy(w), label_smoothing=eps)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixup_apply_matches_the_jax_formula(dtype):
    """x·λ + x[perm]·(1−λ) with λ and 1−λ rounded to x.dtype
    (convnets_tpu/train/engine.py:220-222)."""
    x = _x(6)
    perm = np.array([3, 0, 5, 1, 2, 4])
    lam = np.float32(0.3)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = lam.astype(xj.dtype) * xj + (1.0 - jnp.float32(lam)).astype(xj.dtype) * xj[perm]
    y = torch.arange(6)
    got, y_mix = P.mixup_apply(torch.from_numpy(x).to(dtype),
                               P.MixupDraws(float(lam), torch.from_numpy(perm)), y)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert y_mix.tolist() == perm.tolist()
