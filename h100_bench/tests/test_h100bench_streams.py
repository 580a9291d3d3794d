"""The generators repeat from the seed, and the streams follow the
program's stated rules."""

import numpy as np
import pytest
import torch

import streams
import weights
from reference import resnet as ref

CFG = {"input_size": [3, 8, 8], "num_classes": 10, "stem": {"out": 4, "kernel": 3, "stride": 1,
       "padding": 1, "pool": {"kernel": 3, "stride": 2, "padding": 1}},
       "stages": [[2, 1, 1]], "expansion": 2, "groups": 1, "head": "global_avg_pool"}
BIG_SEED = 2 ** 31 + 987654321


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_weights_and_split_repeat(seed):
    a, b = weights.make_tensors(CFG, seed, "cpu"), weights.make_tensors(CFG, seed, "cpu")
    assert a.keys() == b.keys() == ref.leaf_shapes(CFG).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = weights.make_tensors(CFG, seed + 1, "cpu")
    assert not torch.equal(a["stem.weight"], c["stem.weight"])
    x1, y1 = weights.make_split(16, CFG, seed, "cpu")
    x2, y2 = weights.make_split(16, CFG, seed, "cpu")
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert x1.dtype == torch.uint8 and x1.shape == (16, 8, 8, 3)
    assert int(y1.max()) < 10


def test_weight_ranges():
    t = weights.make_tensors(CFG, 3, "cpu")
    assert float(t["stem.bn.weight"].min()) >= 0.5 and float(t["stem.bn.weight"].max()) <= 1.5
    assert float(t["stem.bn.running_var"].min()) >= 0.5
    assert float(t["stem.bn.bias"].abs().max()) <= 0.1
    assert torch.count_nonzero(t["fc.bias"]) == 0


def test_epoch_order_is_the_loaders():
    from convnets_tpu_torch.data.datasets import ArrayDataset
    from convnets_tpu_torch.data.loader import DeviceCacheLoader
    n, seed = 50, BIG_SEED % (2 ** 31)
    ds = ArrayDataset(np.zeros((n, 2, 2, 3), np.uint8), np.arange(n) % 10)
    loader = DeviceCacheLoader(ds, 10, shuffle=True, seed=seed, device="cpu")
    for epoch in range(3):
        idx, _ = loader.epoch_matrices()
        assert np.array_equal(idx.reshape(-1), streams.epoch_order(n, seed, epoch))


def test_dropout_keep_is_the_programs():
    from convnets_tpu_torch.core.rng import generator_for
    for seed, epoch, step in ((5, 0, 0), (BIG_SEED, 3, 17)):
        g = generator_for(seed, "dropout", epoch, step, 0)
        want = torch.rand((4, 6), generator=g) < 0.5
        assert torch.equal(streams.dropout_keep((4, 6), 0.5, seed, epoch, step, "cpu"), want)
