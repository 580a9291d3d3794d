"""The port's plain ops with the JAX package's signatures, the public
Winograd entry, and the names the port's packages re-export as the JAX
package's do, on the CPU.

- ops.conv2d / conv2d_depthwise with a bias and ops.linear with a bias and
  accum_dtype against convnets_tpu.ops, fp32 at tests/test_torch_ops.py's
  1e-5 and bf16 at its one rounding (2^-8); accum_dtype honoured where it
  equals x.dtype (fp64), fp32 accumulation otherwise; ops.softmax(axis=).
- ops.winograd.conv2d_winograd on a CPU tensor against JAX's, under
  tests/test_torch_winograd.py's FP32_TOL and CONV_TOL_BF16; its errors
  for a shape outside Winograd's envelope; a non-CPU tensor goes to the
  kernels' winograd_conv2d (recorded on meta tensors), not to the plain
  composition.
- The re-exports: each name resolves from the package that exports it in
  the JAX package, to the port's own object; viz.PlotMngr only on access.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnets_tpu import ops as jops
from convnets_tpu.ops import winograd as jwin
from convnets_tpu_torch import ops
from convnets_tpu_torch.ops import kernels, winograd
from torch_one_thread import one_intra_op_thread  # noqa: F401

FP32 = 1e-5  # tests/test_torch_ops.py's fp32 bar
BF16 = 2.0 ** -8  # its bf16 bar: one rounding
WINOGRAD_FP32_TOL = {2: 1e-5, 4: 5e-5}  # tests/test_torch_winograd.py:FP32_TOL
CONV_TOL_BF16 = 1e-2  # tests/test_torch_winograd.py:CONV_TOL_BF16
RNG = np.random.RandomState(21)
X = RNG.randn(2, 9, 9, 16).astype(np.float32)
# (stride, padding, dilation, groups, k, cout)
CONVS = [(1, 1, 1, 1, 3, 8), (2, 3, 1, 1, 7, 8), (1, 2, 2, 4, 3, 8), (2, 0, 1, 16, 1, 32)]
DTYPES = {"float32": (torch.float32, jnp.float32, FP32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


def _np(t):
    return t.detach().float().numpy()


def _j(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _jax_winograd(x, w, b=None, **kw):
    return np.asarray(jax.jit(lambda x, w, b: jwin.conv2d_winograd(x, w, b, **kw))(x, w, b))


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("conv", CONVS, ids=str)
def test_conv2d_with_bias_matches_jax(conv, dname):
    td, jd, tol = DTYPES[dname]
    s, p, d, g, k, o = conv
    w = (RNG.randn(k, k, 16 // g, o) * 0.2).astype(np.float32)
    b = RNG.randn(o).astype(np.float32)
    want = jops.conv2d(_j(X, jd), _j(w, jd), _j(b, jd), stride=s, padding=p, dilation=d,
                       groups=g)
    got = ops.conv2d(torch.from_numpy(X).to(td), torch.from_numpy(w).to(td),
                     torch.from_numpy(b).to(td), stride=s, padding=p, dilation=d, groups=g)
    assert got.dtype == td and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_conv2d_depthwise_with_bias_matches_jax(dname):
    td, jd, tol = DTYPES[dname]
    w = (RNG.randn(3, 3, 1, 32) * 0.3).astype(np.float32)  # multiplier 2
    b = RNG.randn(32).astype(np.float32)
    want = jops.conv2d_depthwise(_j(X, jd), _j(w, jd), _j(b, jd), stride=2, padding=1)
    got = ops.conv2d_depthwise(torch.from_numpy(X).to(td), torch.from_numpy(w).to(td),
                               torch.from_numpy(b).to(td), stride=2, padding=1)
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_linear_with_bias_and_accum_dtype_matches_jax(dname):
    td, jd, tol = DTYPES[dname]
    x = RNG.randn(4, 3, 24).astype(np.float32)
    w, b = (RNG.randn(24, 10) * 0.2).astype(np.float32), RNG.randn(10).astype(np.float32)
    want = jops.linear(_j(x, jd), _j(w, jd), _j(b, jd), accum_dtype=jnp.float32)
    got = ops.linear(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                     torch.from_numpy(b).to(td), accum_dtype=torch.float32)
    assert got.dtype == td and tuple(got.shape) == (4, 3, 10)
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


def test_conv2d_honours_accum_dtype_where_it_is_the_input_dtype():
    x = torch.from_numpy(X).double()
    w = torch.from_numpy((RNG.randn(3, 3, 16, 8) * 0.2)).double()
    exact = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                       padding=1).permute(0, 2, 3, 1)
    got = ops.conv2d(x, w, padding=1, accum_dtype=torch.float64)
    assert got.dtype == torch.float64 and torch.allclose(got, exact, rtol=1e-12, atol=1e-12)
    # the default accumulates in fp32, then casts to x.dtype
    fp32 = ops.conv2d(x, w, padding=1)
    assert fp32.dtype == torch.float64
    assert torch.equal(fp32, ops.conv2d(x.float(), w.float(), padding=1).double())
    assert not torch.equal(fp32, got)


def test_softmax_axis_matches_jax():
    x = RNG.randn(2, 1, 1, 3, 8).astype(np.float32)
    for axis in (-1, -2, 0):
        want = jops.softmax(jnp.asarray(x), axis=axis)
        np.testing.assert_allclose(ops.softmax(torch.from_numpy(x), axis=axis).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 8, 1), (1, 9, 7, 4, 12, (1, 0))], ids=str)
def test_conv2d_winograd_matches_jax_fp32(shape, m):
    n, h, w, c, o, pad = shape
    rng = np.random.default_rng(m)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (0.1 * rng.standard_normal((3, 3, c, o))).astype(np.float32)
    b = rng.standard_normal(o).astype(np.float32)
    want = _jax_winograd(x, wt, b, padding=pad, m=m)
    got = winograd.conv2d_winograd(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
                                   padding=pad, m=m)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=WINOGRAD_FP32_TOL[m],
                               atol=WINOGRAD_FP32_TOL[m])
    # without a bias, and the default padding 0, as JAX's
    want = _jax_winograd(x, wt, m=m)
    got = winograd.conv2d_winograd(torch.from_numpy(x), torch.from_numpy(wt), m=m)
    np.testing.assert_allclose(got.numpy(), want, rtol=WINOGRAD_FP32_TOL[m],
                               atol=WINOGRAD_FP32_TOL[m])


@pytest.mark.parametrize("m", [2, 4])
def test_conv2d_winograd_matches_jax_bf16(m):
    """bf16 with a bias: elementwise within CONV_TOL_BF16 at m = 2; at m = 4
    by the mean, as tests/test_torch_winograd.py holds it (F(4,3)'s fp32
    weight transform rounds ~0.3% of U to the neighbouring bf16 value)."""
    rng = np.random.default_rng(30 + m)
    x = rng.standard_normal((2, 10, 10, 16)).astype(np.float32)
    wt = (0.1 * rng.standard_normal((3, 3, 16, 16))).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    want = _jax_winograd(_j(x, jnp.bfloat16), _j(wt, jnp.bfloat16), _j(b, jnp.bfloat16),
                         padding=1, m=m).astype(np.float32)
    got = winograd.conv2d_winograd(torch.from_numpy(x).bfloat16(), torch.from_numpy(wt).bfloat16(),
                                   torch.from_numpy(b).bfloat16(), padding=1, m=m)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    if m == 2:
        np.testing.assert_allclose(got, want, rtol=CONV_TOL_BF16, atol=CONV_TOL_BF16)
    else:
        assert np.abs(got - want).mean() <= CONV_TOL_BF16 * np.abs(want).mean()


@pytest.mark.parametrize("wshape,m", [((5, 5, 4, 8), 4), ((3, 3, 5, 8), 4), ((3, 3, 4, 8), 3)])
def test_conv2d_winograd_rejects_what_jax_rejects(wshape, m):
    x, wt = np.ones((1, 8, 8, 4), np.float32), np.ones(wshape, np.float32)
    with pytest.raises((ValueError, KeyError)):  # JAX: ValueError of its einsum, KeyError for m
        jwin.conv2d_winograd(x, wt, padding=1, m=m)
    with pytest.raises(ValueError):
        winograd.conv2d_winograd(torch.from_numpy(x), torch.from_numpy(wt), padding=1, m=m)


def test_conv2d_winograd_off_the_cpu_runs_the_kernels(monkeypatch):
    calls = []

    def recorded(x, w, bias=None, scale=None, shift=None, *, padding=1, m=4, relu=False):
        calls.append((tuple(x.shape), tuple(w.shape), bias is not None, padding, m))
        return torch.empty(x.shape[0], 8, 8, w.shape[-1], device=x.device, dtype=x.dtype)

    def forbidden(*args, **kw):
        raise AssertionError("the plain composition ran for a tensor off the CPU")

    monkeypatch.setattr(kernels, "winograd_conv2d", recorded)
    monkeypatch.setattr(winograd, "conv2d_winograd_plain", forbidden)
    x = torch.empty(2, 8, 8, 16, device="meta", dtype=torch.bfloat16)
    w = torch.empty(3, 3, 16, 32, device="meta", dtype=torch.bfloat16)
    y = winograd.conv2d_winograd(x, w, torch.empty(32, device="meta"), padding=1, m=2)
    assert calls == [((2, 8, 8, 16), (3, 3, 16, 32), True, 1, 2)] and y.device.type == "meta"


def test_re_exports_resolve_to_the_ports_objects():
    import convnets_tpu_torch as port
    from convnets_tpu_torch import core, data, models, settings, train, utils
    from convnets_tpu_torch.data import augment
    from convnets_tpu_torch.models import blocks
    from convnets_tpu_torch.train import scheduler

    assert (port.Settings, port.HyperParams, port.HyperParamsDistrib) == (
        settings.Settings, settings.HyperParams, settings.HyperParamsDistrib)
    assert (data.augment_batch, data.normalize) == (augment.augment_batch, augment.normalize)
    assert (models.SEUnit, models.SKConv) == (blocks.SEUnit, blocks.SKConv)
    assert (train.ReduceLROnPlateau, train.StepDecay) == (scheduler.ReduceLROnPlateau,
                                                          scheduler.StepDecay)
    assert {train.optim.__name__, train.metrics.__name__, train.checkpoint.__name__} == {
        f"convnets_tpu_torch.train.{m}" for m in ("optim", "metrics", "checkpoint")}
    assert ops.initializers.zeros((2, 3)).eq(0).all() and ops.initializers.ones((4,)).eq(1).all()
    # core.set_reproducible_mode seeds what utils.set_reproducible_mode seeds
    draws = []
    for seed_fn in (core.set_reproducible_mode, utils.set_reproducible_mode):
        seed_fn(7)
        draws.append((np.random.rand(), torch.rand(1).item(), __import__("random").random()))
    assert draws[0] == draws[1]


def test_viz_plotmngr_is_imported_on_access():
    code = ("import sys; import convnets_tpu_torch.viz as v; "
            "assert 'matplotlib' not in sys.modules; "
            "from convnets_tpu_torch.viz.plots import PlotMngr; assert v.PlotMngr is PlotMngr; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    import convnets_tpu_torch.viz as viz

    with pytest.raises(AttributeError):
        viz.NoSuchName  # noqa: B018
