"""The port's activation trace (nn/trace.py, Trainer.debug_trace, fit with
debug) against the JAX package's, and the last small pieces: Lambda,
adaptive_avg_pool2d and device_prefetch's CPU path. On the CPU.

The JAX trace runs with its kernel path on (CONVNETS_TPU_PALLAS=1, Pallas
in interpret mode, `enabled` as on one device), where its ConvBNReLU
computes without calling its children, as the port's always does, so both print the same modules. Each
line's path, shape and dtype must be the same and in the same order; the
mean and std are read where both packages compute them (each `_emit`
recorded; JAX's reduced in blocks, `_BlockedStats`) and held within 1e-5
of (|mean| + std) and of std, fp32, or within 10 × the gap between JAX's
kernel path and its lax path where that is wider: in train mode RN18@32's
last stage normalizes over 2 values at b2, and there JAX's two paths part
by 1.1e-4 (8e-4 at the logits).
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu import nn as jnn
from convnets_tpu import ops as jops
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.models import densenet as jdensenet
from convnets_tpu.nn import trace as jtrace
from convnets_tpu.ops import pallas as jpallas
from convnets_tpu.settings import Settings as JSettings
from convnets_tpu_torch import bridge, nn, ops
from convnets_tpu_torch.data import loader as tloader
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.models import densenet
from convnets_tpu_torch.nn import trace
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer
from test_torch_zoo_attention import numpy_variables
from torch_one_thread import one_intra_op_thread  # noqa: F401

STAT_TOL = 1e-5
WITNESS_FACTOR = 10.0
TINY_DENSENET = (8, [2, 2], 16)


def _blocked_mean(a):
    """The mean of a's values as block means of 128, then their mean."""
    flat = a.reshape(-1)
    if flat.shape[0] % 128:
        return jnp.mean(flat)
    return jnp.mean(jnp.mean(flat.reshape(-1, 128), axis=1))


class _BlockedStats:
    """jax.numpy for JAX's trace module with its mean and std reduced in
    blocks (two levels, as torch's reductions go): jnp.std's fp32 sum over
    the 32,768 values of RN18@32's stem output lies 2.9e-5 from the fp64 std
    of the same values, which the port's reduction meets within 1e-7."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def mean(a):
        return _blocked_mean(a)

    @staticmethod
    def std(a):
        return jnp.sqrt(_blocked_mean(jnp.square(a - _blocked_mean(a))))


def _recorded(module, monkeypatch):
    """Run `module`'s trace context with its _emit recording (path, shape,
    dtype, mean, std) beside the printed lines."""
    rows, lines = [], []
    emit = module._emit

    def record(printer, path, shape, dtype, mean, std):
        rows.append((path, tuple(shape), str(dtype), float(mean), float(std)))
        emit(printer, path, shape, dtype, mean, std)

    monkeypatch.setattr(module, "_emit", record)
    return rows, lines


CASES = {"resnet18": ("resnet", "18"), "densenet-remat": ("densenet", "121")}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_lines_match_jax(case, train, monkeypatch):
    arch, kind = CASES[case]
    monkeypatch.setitem(densenet.CONFIG, "121", TINY_DENSENET)
    monkeypatch.setitem(jdensenet.CONFIG, "121", TINY_DENSENET)
    fields = dict(kind=kind, input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                  dropout_rate=0.0, remat=arch == "densenet")
    jm = jax_build_model(arch, JSettings(**fields))
    variables = numpy_variables(jax.eval_shape(jm.init, jax.random.key(0)), 3)
    model = build_model(arch, Settings(**fields), device="cpu")
    bridge.load_jax_variables(model, variables)
    x = np.random.RandomState(6).rand(2, 32, 32, 3).astype(np.float32)

    monkeypatch.setattr(jtrace, "jnp", _BlockedStats())
    monkeypatch.setenv("CONVNETS_TPU_PALLAS_INTERPRET", "1")
    # the test process has several CPU devices and no mesh, where enabled()
    # would keep the kernels off; one device is what the trace runs on
    monkeypatch.setattr(jpallas, "enabled", lambda: jpallas.mode() == "1")
    runs = {}
    for mode in ("0", "1"):  # JAX's lax path (the witness), then its kernel path
        monkeypatch.setenv("CONVNETS_TPU_PALLAS", mode)
        runs[mode] = _recorded(jtrace, monkeypatch)
        with jtrace.activation_trace(jm.module, printer=runs[mode][1].append):
            jm.module.apply(variables, jnp.asarray(x), train=train, rng=jax.random.key(1))
    (jrows, jlines), witness = runs["1"], {r[0]: r for r in reversed(runs["0"][0])}
    rows, lines = _recorded(trace, monkeypatch)
    model.train(train)
    with torch.no_grad(), trace.activation_trace(model.module, printer=lines.append):
        model.module(torch.from_numpy(x))

    assert len(lines) == len(rows) == len(jlines) == len(jrows) > 0
    if arch == "densenet":
        assert any(r[0].endswith("/child") for r in rows)  # Remat's child, on the trace path
    assert [line.split(" mean=")[0] for line in lines] == \
        [line.split(" mean=")[0] for line in jlines]
    for (path, shape, dtype, mean, std), (jpath, jshape, jdtype, jmean, jstd) in zip(rows, jrows):
        assert (path, shape, dtype) == (jpath, jshape, jdtype)
        assert dtype == "float32" and len(shape) in (2, 4)
        _, _, _, wmean, wstd = witness[path]
        scale = abs(jmean) + jstd
        mean_bar = max(STAT_TOL, WITNESS_FACTOR * abs(wmean - jmean) / scale)
        std_bar = max(STAT_TOL, WITNESS_FACTOR * abs(wstd - jstd) / jstd)
        assert abs(mean - jmean) <= mean_bar * scale, (path, mean, jmean, mean_bar)
        assert abs(std - jstd) <= std_bar * jstd, (path, std, jstd, std_bar)
    assert all(not m._forward_hooks for m in model.modules())  # none left behind


def _modules_that_run(model, x):
    """The modules whose forward runs on x (counted with hooks of our own,
    on a copy of the model)."""
    model = copy.deepcopy(model)
    ran = set()
    hooks = [m.register_forward_hook(lambda m, i, o: ran.add(id(m))) for m in model.modules()]
    with torch.no_grad(), nn.use_generator(torch.Generator()):
        model.module(x)
    for h in hooks:
        h.remove()
    return len(ran)


def test_debug_trace_prints_one_line_per_module_that_runs(tmp_path, capsys):
    """Trainer.debug_trace: one line per module whose forward runs, every
    value finite, the BN running statistics unchanged in train mode, no
    hook left."""
    setting = Settings(kind="18", input_size=(3, 32, 32), num_classes=10,
                       mixed_precision=False, output_dir=str(tmp_path), seed=2)
    trainer = Trainer(build_model("resnet", setting, device="cpu"))
    with pytest.raises(RuntimeError, match="load_checkpoint"):
        trainer.debug_trace()
    trainer.init_state()
    model = trainer.model
    before = {k: b.clone() for k, b in model.named_buffers()}
    for train in (False, True):
        model.train(train)
        want = _modules_that_run(model, torch.rand(2, 32, 32, 3))
        model.eval()
        trainer.debug_trace(train=train)
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[trace]")]
        assert len(lines) == want
        assert lines[-1].startswith("[trace] Sequential ") and "out=(2, 10)" in lines[-1]
        for line in lines:
            mean = float(line.split("mean=")[1].split()[0])
            std = float(line.split("std=")[1])
            assert np.isfinite(mean) and np.isfinite(std)
    assert not model.training
    for k, b in model.named_buffers():
        assert torch.equal(b, before[k]), k
    assert all(not m._forward_hooks for m in model.modules())
    trainer.close()


ADAPTIVE_CASES = [((8, 8), (2, 4)), ((7, 10), (3, 4)), ((6, 6), (6, 6))]
ADAPTIVE_IDS = ["even", "uneven", "identity"]


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,out", ADAPTIVE_CASES, ids=ADAPTIVE_IDS)
def test_adaptive_avg_pool2d_matches_jax(hw, out, dname):
    """The plain op (even bins: the plain avg pool; uneven bins in fp32)
    against JAX: fp32 within 1e-6, bf16 within one bf16 ulp (2^-8
    relative)."""
    x = np.random.RandomState(4).randn(2, *hw, 5).astype(np.float32)
    jd = jnp.float32 if dname == "float32" else jnp.bfloat16
    want = np.asarray(jops.adaptive_avg_pool2d(jnp.asarray(x).astype(jd), out), np.float32)
    got = ops.adaptive_avg_pool2d(torch.from_numpy(x).to(getattr(torch, dname)), out)
    assert got.dtype == getattr(torch, dname) and tuple(got.shape) == (2, *out, 5)
    tol = 1e-6 if dname == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def _recording_pool_kernels(monkeypatch):
    """Record the avg-pool wrapper (the custom op's body) and pool2d_train
    as they are called; returns the list of names called."""
    from convnets_tpu_torch.ops import kernels

    calls = []
    for name in ("avg_pool2d", "pool2d_train"):
        def recording(*a, _fn=getattr(kernels, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, recording)
    return calls


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,out", ADAPTIVE_CASES, ids=ADAPTIVE_IDS)
def test_adaptive_avg_pool2d_layer_matches_jax(hw, out, dname, train, monkeypatch):
    """nn.AdaptiveAvgPool2d: even bins on the pool kernels (the avg-pool
    custom op in eval; in train pool2d_train, whose forward is the same
    avg-pool wrapper: one launch of the kernel on the card either way),
    uneven bins and the identity on no kernel; against JAX at the plain
    op's tolerances."""
    calls = _recording_pool_kernels(monkeypatch)
    x = np.random.RandomState(4).randn(2, *hw, 5).astype(np.float32)
    jd = jnp.float32 if dname == "float32" else jnp.bfloat16
    want = np.asarray(jops.adaptive_avg_pool2d(jnp.asarray(x).astype(jd), out), np.float32)
    layer = nn.AdaptiveAvgPool2d(out).train(train)
    got = layer(torch.from_numpy(x).to(getattr(torch, dname)))
    assert got.dtype == getattr(torch, dname) and tuple(got.shape) == (2, *out, 5)
    assert layer.out_shape((2, *hw, 5)) == (2, *out, 5)
    even = hw != out and hw[0] % out[0] == 0 and hw[1] % out[1] == 0
    assert calls == ((["pool2d_train"] if train else []) + ["avg_pool2d"] if even else [])
    tol = 1e-6 if dname == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_adaptive_avg_pool2d_even_bins_are_trainable(monkeypatch):
    """The plain op's dx and nn.AdaptiveAvgPool2d's in train mode (through
    pool2d_train: the avg-pool kernel and pool2d_backward on the card) are
    JAX's within 1e-6."""
    calls = _recording_pool_kernels(monkeypatch)
    x = np.random.RandomState(5).randn(2, 8, 8, 3).astype(np.float32)
    g = np.random.RandomState(6).randn(2, 2, 4, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jops.adaptive_avg_pool2d(a, (2, 4)), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    layer = nn.AdaptiveAvgPool2d((2, 4)).train()
    for pool in (lambda a: ops.adaptive_avg_pool2d(a, (2, 4)), layer):
        tx = torch.from_numpy(x).requires_grad_()
        (dx,) = torch.autograd.grad(pool(tx), tx, torch.from_numpy(g))
        np.testing.assert_allclose(dx.numpy(), want, atol=1e-6, rtol=1e-6)
    assert calls == ["pool2d_train", "avg_pool2d"]


def test_lambda_matches_jax():
    """A Lambda applies its function and reports its shape function's shape."""
    x = np.random.RandomState(7).randn(2, 4, 4, 6).astype(np.float32)
    jl = jnn.Lambda(lambda a: jnp.maximum(a, 0.0)[..., ::2], lambda s: (*s[:-1], s[-1] // 2),
                    name="half")
    tl = nn.Lambda(lambda a: torch.clamp_min(a, 0.0)[..., ::2], lambda s: (*s[:-1], s[-1] // 2),
                   name="half")
    want, state = jl.apply({"params": {}, "state": {}}, jnp.asarray(x))
    assert state == {} and not list(tl.parameters())
    np.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(), np.asarray(want))
    assert tl.out_shape((2, 4, 4, 6)) == jl.out_shape((2, 4, 4, 6)) == (2, 4, 4, 3)
    assert nn.Lambda(torch.neg).out_shape((1, 2)) == (1, 2) and "half" in repr(tl)


def test_device_prefetch_on_the_cpu_keeps_its_batches():
    """On the CPU no stream is involved: numpy batches come back as tensors
    over the same values, in order, and a batch already on the device
    passes through as the same objects."""
    arrays = [(np.full((2, 3), i, np.uint8), np.arange(2), np.ones(2, np.float32))
              for i in range(4)]
    on_device = tuple(torch.from_numpy(a) for a in arrays[0])
    got = list(tloader.device_prefetch([*arrays, on_device], size=2, device="cpu"))
    assert len(got) == 5 and all(t is u for t, u in zip(got[-1], on_device))
    for batch, want in zip(got, arrays):
        for t, a in zip(batch, want):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)
