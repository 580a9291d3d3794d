"""The port's ShardRotationLoader (data/stream.py) and the Trainer's chunked
epoch on the CPU, mirroring tests/test_stream.py: epoch coverage and the
chunks' one shape, the seeded reshuffle, drop_last, training and eval
through the chunk rotation against the resident DeviceCacheLoader,
DataMngr's route for a split above DEVICE_CACHE_AUTO_BYTES (against the
JAX DataMngr's), and the memmap-build decode cache.

Step s of chunk c is step c·batches_per_chunk + s of the epoch and draws
generator_for(seed, stream, e, c·bpc + s), so a chunked epoch equals the
resident one bit for bit, augmentation and dropout included (the JAX
package re-keys its RNG per chunk). Its last chunk's free rows replay index
0 of the split, as the resident last batch does, and its batches without
an example are not run (the JAX package runs them at weight 0).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from convnets_tpu.data.manager import DataMngr as JDataMngr
from convnets_tpu_torch.data import (
    ArrayDataset, DataLoader, DataMngr, DeviceCacheLoader, ImageFolderDataset,
    ShardRotationLoader, synthetic_dataset,
)
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer


def _dataset(n, seed=0, hw=8):
    ds = synthetic_dataset(n, (hw, hw, 3), 4, seed=seed)
    return ArrayDataset((ds.images * 255).round().astype(np.uint8), ds.labels)


def tiny_chunks_loader(ds, bs, **kw):
    """chunk_bytes of two batches, so the tiny splits rotate several chunks."""
    img_bytes = int(np.prod(ds.image_shape))
    return ShardRotationLoader(ds, bs, chunk_bytes=2 * bs * img_bytes, device="cpu", **kw)


def test_epoch_chunks_cover_every_example_once():
    ds = _dataset(50)
    loader = tiny_chunks_loader(ds, 8, shuffle=True, seed=3)
    assert loader.num_chunks == 4  # ceil(ceil(50/8) = 7 batches / 2 per chunk)
    served, shapes, steps = [], set(), []
    for ch in loader.epoch_chunks():
        shapes.add((tuple(ch.data.shape), ch.idx_mat.shape, ch.w_mat.shape))
        steps.append((ch.first_step, ch.num_steps))
        labels = ch.labels.numpy()
        np.testing.assert_array_equal(labels, ch.host_labels)
        for i, w in zip(ch.idx_mat.reshape(-1), ch.w_mat.reshape(-1)):
            if w > 0:
                served.append(int(labels[i]))
    assert len(shapes) == 1  # the padded last chunk too
    assert steps == [(0, 2), (2, 2), (4, 2), (6, 1)]
    assert sorted(served) == sorted(int(v) for v in ds.all_labels())
    assert loader.epoch == 1


def test_epoch_chunks_shuffle_is_seeded_and_reshuffles():
    ds = _dataset(40)

    def first_chunk(loader):
        return next(iter(loader.epoch_chunks())).labels.clone()

    a = tiny_chunks_loader(ds, 8, shuffle=True, seed=7)
    b = tiny_chunks_loader(ds, 8, shuffle=True, seed=7)
    e0_a, e0_b = first_chunk(a), first_chunk(b)
    assert torch.equal(e0_a, e0_b)  # same seed and epoch: same permutation
    assert not torch.equal(first_chunk(a), e0_a)  # epoch 1 reshuffles
    # the chunks' rows are the resident loader's batches in order
    idx, _ = DeviceCacheLoader(ds, 8, shuffle=True, seed=7, device="cpu").epoch_matrices()
    np.testing.assert_array_equal(e0_a.numpy(), ds.labels[idx[:2].reshape(-1)])


def test_drop_last_serves_full_batches_only():
    ds = _dataset(50)
    loader = tiny_chunks_loader(ds, 8, drop_last=True)
    chunks = [(int(ch.w_mat.sum()), ch.num_steps) for ch in loader.epoch_chunks()]
    assert chunks == [(16, 2), (16, 2), (16, 2)]  # 6 full batches
    batches = list(iter(tiny_chunks_loader(ds, 8, drop_last=True)))
    assert len(batches) == 6 and all(w.sum() == 8 for _, _, w in batches)


def _setting(tmp, **kw):
    base = dict(kind=0, input_size=(3, 16, 16), num_classes=4, batch_size=8, epochs=2,
                learning_rate=2e-3, mixed_precision=False, data_augment=False, data_norm=False,
                early_stop=False, dropout_rate=0.0, output_dir=str(tmp))
    base.update(kw)
    return Settings(**base)


@pytest.mark.parametrize("n,extra", [(48, {}), (44, {"data_augment": True, "dropout_rate": 0.3})],
                         ids=["exact-chunks", "padded-last-chunk-augmented"])
def test_chunked_training_matches_resident(tmp_path, n, extra):
    """A 2-epoch fit through the chunk rotation equals one through the
    resident DeviceCacheLoader bit for bit: epoch results and weights
    (48 images: 3 chunks of 2 batches; 44: the last chunk's second batch
    holds 4 images and its free rows replay index 0)."""
    ds, vds = _dataset(n, 0, 16), _dataset(16, 1, 16)

    def run(chunked, out):
        trainer = Trainer(build_model("lenet", _setting(tmp_path / out, **extra), device="cpu"),
                          optimizer="sgd")
        if chunked:
            train, valid = tiny_chunks_loader(ds, 8, shuffle=True, seed=0), \
                tiny_chunks_loader(vds, 8)
        else:
            train, valid = (DeviceCacheLoader(ds, 8, shuffle=True, seed=0, device="cpu"),
                            DeviceCacheLoader(vds, 8, device="cpu"))
        trainer.fit(train, valid)
        trainer.close()
        return trainer

    resident, chunked = run(False, "resident"), run(True, "chunked")
    for k in ("train_loss", "train_score", "valid_loss", "valid_score"):
        assert resident.epoch_results[k] == chunked.epoch_results[k], k
    for (k, a), (_, b) in zip(resident.model.state_dict().items(),
                              chunked.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_chunked_evaluate_collects_predictions(tmp_path):
    ds = _dataset(44, 0, 16)
    trainer = Trainer(build_model("lenet", _setting(tmp_path, epochs=1), device="cpu"),
                      optimizer="sgd")
    train, valid = tiny_chunks_loader(ds, 8, shuffle=True, seed=0), tiny_chunks_loader(ds, 8)
    trainer.fit(train, valid)
    score = trainer.evaluate(valid, info=True)  # builds the confusion matrix
    trainer.close()
    assert 0.0 <= score <= 1.0
    assert trainer.confusion_matrix.sum() == 44  # every real example judged once
    resident = trainer._run_eval_epoch(DeviceCacheLoader(ds, 8, device="cpu"), True)
    chunked = trainer._run_eval_epoch(tiny_chunks_loader(ds, 8), True)
    assert resident[:2] == chunked[:2]
    np.testing.assert_array_equal(resident[2], chunked[2])
    np.testing.assert_array_equal(resident[3], chunked[3])


def test_manager_picks_shard_rotation_for_big_splits(tmp_path, monkeypatch):
    from PIL import Image

    root = tmp_path / "set"
    rng = np.random.RandomState(0)
    for split in ("train", "valid", "test"):
        for c in ("a", "b"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(3):
                Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(d / f"{i}.png")
    monkeypatch.chdir(tmp_path)  # the port's decode caches go under ./data/cache
    monkeypatch.setattr(JDataMngr, "CACHE_DIR", str(tmp_path / "jcache"))
    monkeypatch.setattr(DataMngr, "DEVICE_CACHE_AUTO_BYTES", 1)
    monkeypatch.setattr(JDataMngr, "DEVICE_CACHE_AUTO_BYTES", 1)
    setting = _setting(tmp_path, batch_size=4)
    mine = DataMngr(setting, root=str(root), device="cpu")
    loader = mine.load_train()
    theirs = JDataMngr(SimpleNamespace(**vars(setting)), root=str(root)).load_train()
    assert type(loader) is ShardRotationLoader
    assert type(theirs).__name__ == "ShardRotationLoader"
    assert (loader.chunk_bytes, loader.batch_size, loader.shuffle, loader.augment) == \
        (theirs.chunk_bytes, theirs.batch_size, theirs.shuffle, theirs.augment)
    x, y, w = next(iter(loader))
    assert x.shape == (4, 8, 8, 3) and x.dtype == np.uint8
    monkeypatch.setenv("CONVNETS_TPU_STREAM", "0")
    assert type(DataMngr(setting, root=str(root), device="cpu").load_train()) is DataLoader


def test_memmap_build_decode_cache(tmp_path, monkeypatch):
    """A split over the RAM cache budget decodes straight into a disk
    memmap (.building.npy, then published), and a fresh dataset serves
    from the published cache without decoding again."""
    from PIL import Image

    root = tmp_path / "set"
    rng = np.random.RandomState(0)
    for c in ("a", "b"):
        d = root / c
        d.mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(d / f"{i}.png")
    cache = str(tmp_path / "cache" / "set.npy")
    monkeypatch.setattr(ImageFolderDataset, "CACHE_BUDGET_BYTES", 1)
    ds1 = ImageFolderDataset(str(root), disk_cache=cache)
    assert ds1._memmap_build
    x1, y1 = ds1.load_raw(np.arange(len(ds1)))
    assert os.path.exists(cache) and not os.path.exists(cache + ".building.npy")
    assert not ds1._memmap_build  # published and reopened read-only
    ds2 = ImageFolderDataset(str(root), disk_cache=cache)
    assert ds2._cached.all()
    x2, y2 = ds2.load_raw(np.arange(len(ds2)))
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    # the rotation serves the memmap's rows
    loader = ShardRotationLoader(ds2, 4, chunk_bytes=4 * 8 * 8 * 3, device="cpu")
    got = torch.cat([ch.data.clone() for ch in loader.epoch_chunks()]).numpy()
    np.testing.assert_array_equal(got, x1)
