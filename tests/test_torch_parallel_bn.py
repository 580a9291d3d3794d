"""Sync-BN and the per-rank data blocks of the port's data parallel
(convnets_tpu_torch/parallel/mesh.py) on the CPU.

The BN functions on 2 gloo ranks, each holding its contiguous block of a
global batch of 8, against the port's own functions in one process at the
whole batch: row 6's conv → batch-stat BN → ReLU Function
(ops/kernels/fused.py), `batch_norm_train` (`_BNCore` and the running
update with the global count), and `batch_stats` + `bn_apply_stats`. The
outputs and dx, concatenated in rank order, equal the whole batch's; the
statistics are the same on every rank; dw and dscale/dbias are this
rank's partial sums, which summed once over the ranks give the whole
batch's (the train step's gradient all-reduce sums them once: a global sum
returned here would come out x2). Then the per-host blocks of the port's
DeviceCacheLoader and ShardRotationLoader against the JAX loaders'
(numpy only, no process group).

The ranks run in subprocesses (tests/torch_parallel_ranks.py) that import
torch and the port, never jax, rendezvous through a file in tmp_path, and
are stopped at RANK_TIMEOUT seconds.
"""

import os

import numpy as np
import pytest
import torch

from convnets_tpu.data import ArrayDataset as JArrayDataset
from convnets_tpu.data.loader import DeviceCacheLoader as JDeviceCacheLoader
from convnets_tpu.data.stream import ShardRotationLoader as JShardRotationLoader
from convnets_tpu_torch.data import ArrayDataset, DeviceCacheLoader, ShardRotationLoader
from convnets_tpu_torch.ops.kernels import conv_bn_relu_train
from convnets_tpu_torch.ops.norm import batch_norm_train, batch_stats, bn_apply_stats
from convnets_tpu_torch.parallel.dryrun import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT = 120
WORLD = 2
TOL = 1e-5  # fp32: the rank split only reassociates the per-channel sums


def _inputs():
    rng = np.random.RandomState(5)
    c = 8
    return {"x": rng.randn(8, 6, 6, 4).astype(np.float32),
            "w": (rng.randn(3, 3, 4, c) * 0.3).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": (0.1 * rng.randn(c)).astype(np.float32),
            "gy": rng.randn(8, 6, 6, c).astype(np.float32),
            "h": (rng.randn(8, 3, 3, c) * 2 + 0.5).astype(np.float32),
            "gh": rng.randn(8, 3, 3, c).astype(np.float32),
            "rm": (0.1 * rng.randn(c)).astype(np.float32),
            "rv": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _whole(g):
    """The same functions in this process, at the whole batch, no mesh."""
    def leaf(a):
        return torch.from_numpy(a).requires_grad_(True)

    x, w, scale, bias = leaf(g["x"]), leaf(g["w"]), leaf(g["scale"]), leaf(g["bias"])
    y, mean, var = conv_bn_relu_train(x, w, scale, bias, 1, 1)
    dx, dw, ds, db = torch.autograd.grad(y, (x, w, scale, bias), torch.from_numpy(g["gy"]))
    out = dict(fused_y=y, fused_mean=mean, fused_var=var, fused_dx=dx, fused_dw=dw,
               fused_dscale=ds, fused_dbias=db)
    h, gh = leaf(g["h"]), torch.from_numpy(g["gh"])
    z, rm, rv = batch_norm_train(h, torch.from_numpy(g["rm"]), torch.from_numpy(g["rv"]),
                                 scale, bias)
    dh, ds, db = torch.autograd.grad(z, (h, scale, bias), gh)
    out.update(core_y=z, core_rm=rm, core_rv=rv, core_dx=dh, core_dscale=ds, core_dbias=db)
    m, v = batch_stats(h.detach())
    z = bn_apply_stats(h, m, v, scale, bias)
    dh, ds, db = torch.autograd.grad(z, (h, scale, bias), gh)
    out.update(stats_mean=m, stats_var=v, apply_y=z, apply_dx=dh, apply_dscale=ds,
               apply_dbias=db)
    return {k: t.detach().numpy() for k, t in out.items()}


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn")
    g = _inputs()
    np.savez(tmp / "inputs.npz", **g)
    run_ranks("torch_parallel_ranks:bn_functions", WORLD,
              {"inputs": str(tmp / "inputs.npz"), "workdir": str(tmp)}, workdir=str(tmp),
              timeout=RANK_TIMEOUT, paths=[HERE])
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, _whole(g)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


BATCH_KEYS = ("fused_y", "fused_dx", "core_y", "core_dx", "apply_y", "apply_dx")
SHARED_KEYS = ("fused_mean", "fused_var", "core_rm", "core_rv", "stats_mean", "stats_var")
PARAM_GRAD_KEYS = ("fused_dw", "fused_dscale", "fused_dbias", "core_dscale", "core_dbias",
                   "apply_dscale", "apply_dbias")


@pytest.mark.parametrize("key", BATCH_KEYS)
def test_rank_blocks_equal_the_whole_batch(bn_runs, key):
    """Outputs and dx on each rank's rows: the whole batch's, in rank order."""
    ranks, whole = bn_runs
    _close(np.concatenate([r[key] for r in ranks]), whole[key], key)


@pytest.mark.parametrize("key", SHARED_KEYS)
def test_statistics_are_the_global_batchs(bn_runs, key):
    """The batch statistics, and the running update made with the global
    count (its unbiased correction n/(n-1) at n = 8·3·3, not 4·3·3), equal
    the whole batch's on every rank."""
    ranks, whole = bn_runs
    for r in ranks:
        _close(r[key], whole[key], key)


@pytest.mark.parametrize("key", PARAM_GRAD_KEYS)
def test_parameter_gradients_are_summed_once(bn_runs, key):
    """The ×world trap: dw and dscale/dbias come back as each rank's own
    sums. Summed once over the ranks they are the whole batch's, and no
    rank's alone is."""
    ranks, whole = bn_runs
    _close(sum(r[key] for r in ranks), whole[key], key)
    scale = max(float(np.abs(whole[key]).max()), 1.0)
    for r in ranks:
        assert float(np.abs(r[key] - whole[key]).max()) > 100 * TOL * scale, key
    assert float(np.abs(WORLD * sum(r[key] for r in ranks) - whole[key]).max()) \
        > 100 * TOL * scale


def _tracer(n, hw=4):
    images = np.random.RandomState(0).randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    return images, np.arange(n, dtype=np.int32)  # label == index


@pytest.mark.parametrize("n,batch,drop_last", [(44, 4, False), (64, 8, True)])
def test_device_cache_blocks_match_jax(n, batch, drop_last):
    """DeviceCacheLoader.epoch_matrices per host: the JAX loader's blocks,
    index and weight, over two shuffled epochs."""
    images, labels = _tracer(n)
    for host in range(WORLD):
        kw = dict(shuffle=True, seed=4, drop_last=drop_last, host_id=host, num_hosts=WORLD)
        mine = DeviceCacheLoader(ArrayDataset(images, labels), batch, device="cpu", **kw)
        theirs = JDeviceCacheLoader(JArrayDataset(images, labels), batch, **kw)
        for _ in range(2):
            (mi, mw), (ti, tw) = mine.epoch_matrices(), theirs.epoch_matrices()
            np.testing.assert_array_equal(mi, np.asarray(ti))
            np.testing.assert_array_equal(mw, np.asarray(tw))


def test_shard_rotation_blocks_match_jax():
    """ShardRotationLoader per host: each chunk's real rows (the label
    tracer) are the JAX chunk's, and the hosts' rows are disjoint and cover
    the split."""
    n, batch = 60, 4
    images, labels = _tracer(n)
    chunk_bytes = 2 * batch * images[0].nbytes  # 2 batches a chunk
    seen = []
    for host in range(WORLD):
        kw = dict(shuffle=True, seed=2, host_id=host, num_hosts=WORLD, chunk_bytes=chunk_bytes)
        mine = ShardRotationLoader(ArrayDataset(images, labels), batch, device="cpu", **kw)
        theirs = JShardRotationLoader(JArrayDataset(images, labels), batch, **kw)
        rows_mine = [c.host_labels[c.w_mat.reshape(-1) > 0] for c in mine.epoch_chunks()]
        rows_theirs = [np.asarray(c.host_labels)[np.asarray(c.w_mat).reshape(-1) > 0]
                       for c in theirs.epoch_chunks()]
        rows_theirs = [r for r in rows_theirs if len(r)]
        assert len(rows_mine) == len(rows_theirs) == mine.num_chunks
        for a, b in zip(rows_mine, rows_theirs):
            np.testing.assert_array_equal(a, b)
        seen.extend(np.concatenate(rows_mine).tolist())
    assert sorted(seen) == list(range(n))
