"""The BN passes of the fused conv sites (ops/kernels/bn_act.py): the plain
versions against the JAX package's conv_bn_relu_train and its VJP, the
plan, and the launch path's arguments through a recording library.

The JAX function runs in Pallas interpret mode on the CPU through a 1x1
conv whose weight is the identity (Cin = Cout), so its conv output y is its
input exactly in both dtypes: its out, mean and var are then the forward's
reference, and its dx, dscale and dbias the backward's (dy, Σdz·x̂, Σdz).
Inputs and cotangents are made with numpy from a seed. The CUDA kernels
are held to these plain versions on the card by chip_smoke.py (phase 4).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from convnets_tpu.ops.pallas import conv_bn_relu_train as jax_conv_bn_relu_train
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.ops.kernels import bn_act
from convnets_tpu_torch.parallel import init_distributed, make_mesh, mesh_scope

EPS = 1e-5
SHAPE = (4, 8, 8)  # N, H, W: M = 256 rows
BN_ACT = ("bn_act_forward", "bn_act_backward_sums", "bn_act_backward_reduce",
          "bn_act_backward_apply")


def _inputs(c, seed):
    rng = np.random.RandomState(seed)
    return {"y": (rng.randn(*SHAPE, c) * 1.5 + 0.4).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": (0.2 * rng.randn(c)).astype(np.float32),
            "g": rng.randn(*SHAPE, c).astype(np.float32)}


def _f32(t):
    return np.asarray(t.astype(jnp.float32)) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


def _jax_reference(a, dtype, relu):
    """(out, mean, var, dy, Σdz·x̂, Σdz) of JAX's conv_bn_relu_train on an
    identity 1x1 conv, in interpret mode; the forward and its VJP jitted as
    one program (compiling it whole is several times quicker than running
    it op by op)."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    c = a["y"].shape[-1]
    eye = jnp.asarray(np.eye(c, dtype=np.float32).reshape(1, 1, c, c), jd)

    @jax.jit
    def forward_and_vjp(x, scale, bias, cot):
        def fn(x_, g_, b_):
            return jax_conv_bn_relu_train(x_, eye, g_, b_, 1, 0, 1, EPS, relu, True)

        out, vjp = jax.vjp(fn, x, scale, bias)
        return out + vjp((cot, jnp.zeros(c), jnp.zeros(c)))

    return forward_and_vjp(jnp.asarray(a["y"], jd), jnp.asarray(a["scale"]),
                           jnp.asarray(a["bias"]), jnp.asarray(a["g"], jd))


def _plain(a, dtype, relu):
    y = torch.from_numpy(a["y"]).to(dtype)
    scale, bias = torch.from_numpy(a["scale"]), torch.from_numpy(a["bias"])
    yf = y.float()
    sums = torch.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    m = y.numel() // y.shape[-1]
    out, mean, var, inv = bn_act.bn_act_forward_plain(y, sums, m, scale, bias, EPS, relu)
    g = torch.from_numpy(a["g"]).to(dtype)
    dy, dscale, dbias = bn_act.bn_act_backward_plain(g, y, mean, inv, scale, bias, relu, m)
    return out, mean, var, dy, dscale, dbias


@pytest.mark.parametrize("c", [6, 27, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_plain_versions_match_jax_fused(c, dtype, relu):
    """fp32: everything to 1e-5 of each tensor's largest element (the sums
    only reassociate). bf16: out to one bf16 ulp (2^-7 relative: the fp32
    statistics may part in their last bit), the statistics to 1e-5, and
    the gradients dy, Σdz·x̂, Σdz to 1e-2 of their largest element, the bar
    of test_torch_train_kernels.py's bf16 case: the jitted JAX backward
    keeps its bf16 chain x̂, dz − a, x̂·b in fp32 between ops (XLA's excess
    precision) where the port rounds each op to bf16, which moves Σdz·x̂
    by up to ~4e-3 of its largest element here."""
    a = _inputs(c, seed=c + (dtype == torch.bfloat16) + 2 * relu)
    want = _jax_reference(a, dtype, relu)
    got = _plain(a, dtype, relu)
    assert got[0].dtype == got[3].dtype == dtype
    assert all(t.dtype == torch.float32 for t in (got[1], got[2], got[4], got[5]))
    bf16 = dtype == torch.bfloat16
    bars = {"out": 2 ** -7 if bf16 else 1e-5, "mean": 1e-5, "var": 1e-5,
            "dy": 1e-2 if bf16 else 1e-5, "dscale": 1e-2 if bf16 else 1e-5,
            "dbias": 1e-2 if bf16 else 1e-5}
    for (name, bar), g, w in zip(bars.items(), got, want):
        w = _f32(w)
        assert tuple(g.shape) == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        if name == "out" and bf16:
            np.testing.assert_allclose(_f32(g), w, rtol=bar, atol=bar, err_msg=name)
        else:
            np.testing.assert_allclose(_f32(g), w, rtol=0, atol=bar * scale, err_msg=name)


def test_cpu_calls_take_the_plain_versions_and_count_no_launch():
    kernels.reset_launches()
    a = _inputs(27, seed=3)
    y = torch.from_numpy(a["y"])
    scale, bias, g = (torch.from_numpy(a[k]) for k in ("scale", "bias", "g"))
    sums = torch.stack([y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
    got = kernels.bn_act_forward(y, sums, 256, scale, bias, EPS, True)
    want = kernels.bn_act_forward_plain(y, sums, 256, scale, bias, EPS, True)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    _, mean, _, inv = got
    got = kernels.bn_act_backward(g, y, mean, inv, scale, bias, True, 256)
    want = kernels.bn_act_backward_plain(g, y, mean, inv, scale, bias, True, 256)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    assert all(kernels.LAUNCHES[k] == 0 for k in BN_ACT)
    assert all(n == 0 for k in BN_ACT[:1] + BN_ACT[1:4:2]
               for n in kernels.ROUTE_LAUNCHES[k].values())


@pytest.mark.parametrize("m,c,aligned,route,tx", [
    (256 * 56 * 56, 64, True, "vector", 8), (256 * 7 * 7, 2048, True, "vector", 32),
    (8 * 28 * 28, 128, True, "vector", 16), (8 * 14 * 14, 6, True, "loop", 6),
    (64, 27, True, "loop", 27), (64, 60, True, "loop", 32), (8, 32, True, "vector", 4),
    (4096, 64, False, "loop", 32)])
def test_plan_route_and_tiles(m, c, aligned, route, tx):
    """The vector route iff C % 8 == 0 and the operands align; tx units
    across (8 channels on the vector route), tiles covering C; the row
    blocks no more than the rows fill and about 8 blocks per SM in all."""
    plan = kernels.bn_act_plan(m, c, aligned)
    assert (plan.route, plan.tx) == (route, tx)
    v = 8 if route == "vector" else 1
    tiles = -(-c // (v * tx))
    assert tiles * plan.tx * v >= c > (tiles - 1) * plan.tx * v
    rows = bn_act.THREADS // tx
    assert 1 <= plan.rowblocks <= -(-m // rows)
    assert plan.rowblocks * tiles <= bn_act._BLOCKS + tiles
    assert plan.rowblocks == -(-m // rows) or plan.rowblocks * tiles >= bn_act._BLOCKS


class _RecordingLib:
    """Stands in for the kernel library: records each call's arguments."""

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
    saved = {k: dict(v) for k, v in kernels.ROUTE_LAUNCHES.items()}, dict(kernels.LAUNCHES)
    yield lib
    kernels.LAUNCHES.update(saved[1])
    for k, v in saved[0].items():
        kernels.ROUTE_LAUNCHES[k].update(v)


@pytest.mark.parametrize("c,route", [(64, "vector"), (6, "loop")])
def test_launch_path_arguments_and_counts(recording_lib, c, route):
    """What a CUDA tensor's call passes (through _launch_forward /
    _launch_backward): the forward's pointers and (m, c, n, eps, relu) and
    plan; the backward's three launches on one plan, the reduction writing
    the row that the apply pass reads, and one count per launch on the
    route."""
    kernels.reset_launches()
    y = torch.zeros(*SHAPE, c, dtype=torch.bfloat16)
    sums = torch.zeros(2, c)
    scale, bias = torch.ones(c), torch.zeros(c)
    out, mean, var, inv = bn_act._launch_forward(y, sums, 512, scale, bias, EPS, True)
    plan = kernels.bn_act_plan(256, c)
    (name, args), = recording_lib.calls
    assert name == "bn_act_forward_launch" and plan.route == route
    assert args[:9] == (1, y.data_ptr(), sums.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), mean.data_ptr(), var.data_ptr(), inv.data_ptr())
    assert args[9:] == (256, c, 512, EPS, 1, *plan.args(), 0)
    assert out.shape == y.shape and out.dtype == y.dtype
    assert all(t.shape == (c,) and t.dtype == torch.float32 for t in (mean, var, inv))

    recording_lib.calls.clear()
    g = torch.zeros(*SHAPE, c, dtype=torch.float32)  # cast to y's dtype by the wrapper
    dy, dscale, dbias = bn_act._launch_backward(g, y, mean, inv, scale, bias, False, 256)
    (sname, sargs), (rname, rargs), (aname, aargs) = recording_lib.calls
    assert (sname, rname, aname) == ("bn_act_sums_launch", "stats_reduce_launch",
                                     "bn_act_apply_launch")
    assert sargs[2] == aargs[2] == y.data_ptr() and sargs[1] == aargs[1] != g.data_ptr()
    assert sargs[3:7] == aargs[3:7] == (mean.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                                        bias.data_ptr())
    assert sargs[8:] == (256, c, 0, *plan.args(), 0)
    # the reduction adds the rowblocks partial rows into a (2, C) row of its
    # own, which the apply pass reads and which the gradients are views of
    assert rargs[0] == sargs[7] and rargs[2:4] == (plan.rowblocks, c)
    assert rargs[1] == aargs[7] != sargs[7]
    assert dbias.data_ptr() == rargs[1] and dscale.data_ptr() == rargs[1] + 4 * c
    assert dbias.untyped_storage().nbytes() == 4 * 2 * c
    assert aargs[8] == dy.data_ptr() and aargs[9:] == (256, c, 256, 0, *plan.args(), 0)
    assert {k: kernels.LAUNCHES[k] for k in BN_ACT} == dict.fromkeys(BN_ACT, 1)
    for k in BN_ACT[:1] + BN_ACT[1:4:2]:
        assert kernels.ROUTE_LAUNCHES[k][route] == 1


_SEEN = []  # the data pointers of the sums rows bn_act_forward is handed


def _record_sums(fn):
    def wrapper(y, sums, *args, **kwargs):
        _SEEN.append(sums.data_ptr())
        return fn(y, sums, *args, **kwargs)
    return wrapper


def test_mesh_all_reduces_the_rows_in_place(recording_lib, monkeypatch):
    """Under a mesh (a world of one here): the backward all-reduces the
    reduction's own (2, C) row before the apply pass reads it, with the
    global count, and returns a copy of this rank's row taken before; the
    fused site's forward all-reduces the sums row it hands to
    bn_act_forward, the same tensor, and its backward one (2, C) row."""
    reduced = []
    real = torch.distributed.all_reduce
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, *a, **k: (reduced.append(t.data_ptr()), real(t, *a, **k))[1])
    c = 16
    y = torch.zeros(*SHAPE, c, dtype=torch.bfloat16)
    mean, inv, scale, bias = torch.zeros(c), torch.ones(c), torch.ones(c), torch.zeros(c)
    assert init_distributed(device="cpu") == (0, 1, 1)
    try:
        with mesh_scope(make_mesh()):
            _, dscale, dbias = bn_act._launch_backward(y, y, mean, inv, scale, bias, True, 256)
            (_, sargs), (_, rargs), (_, aargs) = recording_lib.calls
            assert reduced == [rargs[1]] and aargs[7] == rargs[1] and aargs[11] == 256
            assert dbias.data_ptr() not in (rargs[1], rargs[1] + 4 * c)
            assert dscale.data_ptr() == dbias.data_ptr() + 4 * c

            # the fused site on the CPU: the plain conv's (2, C) row is the
            # one all-reduced and the one bn_act_forward reads
            monkeypatch.setattr(kernels, "bn_act_forward", _record_sums(kernels.bn_act_forward))
            reduced.clear()
            rng = np.random.RandomState(0)
            x = torch.from_numpy(rng.randn(2, 6, 6, 4).astype(np.float32)).requires_grad_()
            w = torch.from_numpy(rng.randn(3, 3, 4, c).astype(np.float32)).requires_grad_()
            out, _, _ = kernels.conv_bn_relu_train(x, w, scale, bias, 1, 1)
            assert reduced == [_SEEN[-1]]
            out.sum().backward()
            assert len(reduced) == 2  # the backward's (2, C) row, once
    finally:
        torch.distributed.destroy_process_group()

