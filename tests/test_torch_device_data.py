"""The port's device data path on the CPU: DeviceCacheLoader against the
port's DataLoader, DataMngr's routes against the JAX package's rule, the
train step's preprocessing against the JAX engine's where it draws
nothing, and the Trainer's augmented fit (augmentation, cutout, mixup)
with BN re-estimation over augmented batches.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnets_tpu.data import ArrayDataset as JArrayDataset
from convnets_tpu.data.loader import DeviceCacheLoader as JDeviceCacheLoader
from convnets_tpu.data.manager import DataMngr as JDataMngr
from convnets_tpu.train.engine import Trainer as JTrainer
from convnets_tpu_torch.data import (
    ArrayDataset, DataLoader, DataMngr, DeviceCacheLoader, ShardRotationLoader, synthetic_dataset,
)
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer
from convnets_tpu_torch.train.engine import _make_preprocess
from torch_one_thread import one_intra_op_thread  # noqa: F401

STATS = ((0.49, 0.48, 0.45), (0.25, 0.24, 0.26))


def _uint8(n, seed, hw=(32, 32)):
    ds = synthetic_dataset(n, (*hw, 3), seed=seed)
    return ArrayDataset((ds.images * 255).round().astype(np.uint8), ds.labels)


def _settings(tmp_path, **kw):
    base = dict(kind="18", input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                batch_size=8, epochs=1, optimizer="sgd", learning_rate=1e-3,
                data_augment=True, data_norm=True, dropout_rate=0.0, early_stop=False,
                output_dir=str(tmp_path))
    base.update(kw)
    return Settings(**base)


@pytest.mark.parametrize("shuffle,drop_last,host", [(True, False, (0, 1)), (False, False, (0, 1)),
                                                    (True, True, (1, 2)), (True, False, (0, 3))])
def test_device_cache_batches_equal_the_dataloaders(shuffle, drop_last, host):
    """Same indices in the same order and the same weights, over two
    epochs; only the index batch is made on the host. The last partial
    batch is padded as the JAX DeviceCacheLoader pads it: index 0 (image 0,
    label y[0]) at weight 0, where DataLoader has zero images, label 0; its
    epoch_matrices are the JAX loader's, and it offers the scanned epoch."""
    ds = _uint8(21, 0)
    kw = dict(shuffle=shuffle, seed=4, drop_last=drop_last, host_id=host[0], num_hosts=host[1])
    host_loader, cached = DataLoader(ds, 4, **kw), DeviceCacheLoader(ds, 4, device="cpu", **kw)
    theirs = JDeviceCacheLoader(JArrayDataset(ds.images, ds.labels), 4, **kw)
    matrices = DeviceCacheLoader(ds, 4, device="cpu", **kw)
    assert len(host_loader) == len(cached) and cached._host_count() == host_loader._host_count()
    assert cached.scan_epochs and theirs.scan_epochs
    for _ in range(2):
        batches = list(cached)
        want = list(host_loader)
        assert len(batches) == len(want)
        for (x, y, w), (xw, yw, ww) in zip(batches, want):
            assert x.dtype == torch.uint8 and y.dtype == torch.int32
            np.testing.assert_array_equal(w.numpy(), ww)
            real = ww > 0
            np.testing.assert_array_equal(x.numpy()[real], xw[real])
            np.testing.assert_array_equal(y.numpy()[real], yw[real])
            np.testing.assert_array_equal(x.numpy()[~real], np.broadcast_to(
                ds.images[0], xw[~real].shape))
            np.testing.assert_array_equal(y.numpy()[~real], ds.labels[0])
        for mine, want in zip(matrices.epoch_matrices(), theirs.epoch_matrices()):
            assert mine.dtype == want.dtype
            np.testing.assert_array_equal(mine, want)
    assert cached.epoch == matrices.epoch == theirs.epoch == host_loader.epoch == 2


def _write_image_folder(root, n_per_class=3, classes=("cat", "dog")):
    from PIL import Image

    rng = np.random.RandomState(0)
    for split in ("train", "valid", "test"):
        for c in classes:
            os.makedirs(os.path.join(root, split, c))
            for i in range(n_per_class):
                Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(
                    os.path.join(root, split, c, f"{i}.png"))


def test_datamngr_routes_follow_the_jax_rule(tmp_path, monkeypatch):
    """device_cache wins where set; else a split within
    DEVICE_CACHE_AUTO_BYTES goes to DeviceCacheLoader; a larger one (or
    device_cache=False) rotates through the device in chunks
    (ShardRotationLoader) in both packages, and with CONVNETS_TPU_STREAM=0
    both take the host DataLoader."""
    root = str(tmp_path / "folder")
    _write_image_folder(root)
    monkeypatch.chdir(tmp_path)  # the decode caches go under ./data/cache

    def routes(**kw):
        s = _settings(tmp_path, batch_size=4, **kw)
        mine = DataMngr(s, root, device="cpu")
        theirs = JDataMngr(SimpleNamespace(**vars(s)), root)
        return mine, theirs

    mine, theirs = routes()
    assert type(mine.load_train()).__name__ == type(theirs.load_train()).__name__ \
        == "DeviceCacheLoader"
    train, valid, test = mine.load_train(), mine.load_valid(), mine.load_test()
    assert (train.augment, train.normalize, train.shuffle) == (True, True, True)
    assert (valid.augment, valid.shuffle, test.augment, test.shuffle) == (False, False, False, True)
    assert mine.info("valid") == theirs.info("valid")
    x = np.random.RandomState(1).rand(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(mine.inv_normalized(x), theirs.inv_normalized(x))
    x, y, w = next(iter(train))
    assert x.shape == (4, 8, 8, 3) and x.dtype == torch.uint8 and w.tolist() == [1.0] * 4

    mine, theirs = routes(device_cache=False)
    assert type(theirs.load_train()).__name__ == "ShardRotationLoader"
    assert type(mine.load_train()) is ShardRotationLoader
    monkeypatch.setattr(DataMngr, "DEVICE_CACHE_AUTO_BYTES", 64)
    valid = routes()[0].load_valid()
    assert type(valid) is ShardRotationLoader and valid.device.type == "cpu"
    assert (valid.augment, valid.normalize, valid.shuffle) == (False, True, False)
    monkeypatch.setenv("CONVNETS_TPU_STREAM", "0")
    mine, theirs = routes(device_cache=False)
    assert type(mine.load_train()) is DataLoader
    assert type(theirs.load_train()).__name__ == "DataLoader"
    mine, _ = routes(device_cache=True)
    assert type(mine.load_valid()) is DeviceCacheLoader


@pytest.mark.parametrize("raw_hw", [(32, 32), (40, 48)])
def test_eval_preprocessing_matches_jax(raw_hw):
    """Where nothing is drawn (eval): uint8 → /255, the center crop when the
    raw size differs from the model's, normalize, cast."""
    x = np.random.RandomState(2).randint(0, 256, (3, *raw_hw, 3)).astype(np.uint8)
    jmodel = SimpleNamespace(input_shape_nhwc=(32, 32, 3),
                             policy=SimpleNamespace(compute_dtype=jnp.float32))
    jpre = JTrainer._make_preprocess(SimpleNamespace(model=jmodel,
                                                     setting=SimpleNamespace(cutout=0)),
                                     False, True, STATS, False)
    model = SimpleNamespace(input_shape_nhwc=(32, 32, 3),
                            policy=SimpleNamespace(compute_dtype=torch.float32),
                            parameters=lambda: iter([torch.zeros(1)]))
    got = _make_preprocess(model, True, STATS)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpre(jnp.asarray(x), None)), atol=1e-5, rtol=0)


def test_augmented_fit_with_cutout_and_mixup_runs_and_reestimates_bn(tmp_path):
    """The JAX defaults (data_augment, affine, data_norm) plus cutout and
    mixup, fed by DataMngr's route to DeviceCacheLoader: the fit runs, its
    losses are finite, and reestimate_bn over augmented batches moves every
    running statistic and no parameter."""
    s = _settings(tmp_path, cutout=8, mixup=0.2)
    mngr = DataMngr(s, device="cpu", datasets={"train": _uint8(16, 0), "valid": _uint8(8, 1)})
    trainer = Trainer(build_model("resnet", s, device="cpu"))
    train = mngr.load_train()
    assert isinstance(train, DeviceCacheLoader) and train.augment
    trainer.fit(train, mngr.load_valid())
    trainer.close()
    r = trainer.epoch_results
    assert np.isfinite(r["train_loss"]).all() and np.isfinite(r["valid_loss"]).all()
    params = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    running = {k: b.clone() for k, b in trainer.model.named_buffers() if b.is_floating_point()}
    trainer.reestimate_bn(train, passes=1, info=False)
    assert all(torch.equal(p, params[k]) for k, p in trainer.model.named_parameters())
    assert all(not torch.equal(b, running[k]) for k, b in trainer.model.named_buffers()
               if k in running)


def test_augmented_step_crops_a_larger_batch_to_the_model(tmp_path):
    """A raw batch larger than the model's input takes RandomResizedCrop in
    the train step and the center crop in eval (the 224-class path)."""
    s = _settings(tmp_path, data_augment=True)
    trainer = Trainer(build_model("resnet", s, device="cpu"))
    big = _uint8(8, 3, hw=(40, 40))
    trainer.fit(DataLoader(big, 8, shuffle=True), DataLoader(big, 8))
    trainer.close()
    assert np.isfinite(trainer.epoch_results["train_loss"]).all()
    assert trainer.evaluate(DataLoader(big, 8), info=False) >= 0.0


PAD_TRAIN, PAD_BATCH = 72, 32  # two full batches and one of 8 real rows and 24 padded
LOSS_RTOL, PARAM_RTOL = 1e-3, 1e-3  # tests/test_torch_trainer.py:143-154's bars
WITNESS, WITNESS_FACTOR = 1e-7, 10.0


def _flat(tree):
    from convnets_tpu_torch import bridge

    return {"/".join(k): np.asarray(v) for k, v in bridge._flatten(tree).items()}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_bn_fit_over_a_padded_split_matches_the_jax_device_cache_fit(tmp_path):
    """One epoch of RN18@32 at b32 over 72 images from DeviceCacheLoaders in
    both packages (their per-step routes), from the same bridged weights,
    SGD, dropout 0, no augmentation: the last batch's 24 free rows replay
    index 0 at weight 0 in both, and train-mode BN normalizes over them, so
    the running statistics, the parameters and the epoch loss agree, each
    leaf within the bar of tests/test_torch_trainer.py (PARAM_RTOL, or 10x
    a JAX witness refitted with its conv weights x(1 + 1e-7·N(0,1))). With
    zero images in those rows (the port's loader before) the running
    statistics part far outside it."""
    import jax

    from convnets_tpu.models import build_model as jax_build_model
    from convnets_tpu.settings import Settings as JSettings
    from convnets_tpu_torch import bridge

    kw = dict(kind="18", input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
              batch_size=PAD_BATCH, epochs=1, optimizer="sgd", learning_rate=1e-3,
              loss_reduction="mean", lr_scheduler="none", data_augment=False, data_norm=True,
              dropout_rate=0.0, early_stop=False)
    train, valid = _uint8(PAD_TRAIN, 0), _uint8(PAD_BATCH, 1)

    def loaders(pkg):
        if pkg == "jax":
            pair = (JDeviceCacheLoader(JArrayDataset(train.images, train.labels), PAD_BATCH,
                                       shuffle=True, seed=0),
                    JDeviceCacheLoader(JArrayDataset(valid.images, valid.labels), PAD_BATCH))
        else:
            pair = (DeviceCacheLoader(train, PAD_BATCH, shuffle=True, seed=0, device="cpu"),
                    DeviceCacheLoader(valid, PAD_BATCH, device="cpu"))
        for loader in pair:
            loader.scan_epochs = False
        return pair

    jt = JTrainer(jax_build_model("resnet", JSettings(**kw, output_dir=str(tmp_path / "j"))),
                  use_mesh=False)
    jt.init_state()
    start = {"params": jax.tree.map(np.asarray, jt.state.params),
             "state": jax.tree.map(np.asarray, jt.state.model_state)}
    model = build_model("resnet", Settings(**kw, output_dir=str(tmp_path / "t")), device="cpu")
    bridge.load_jax_variables(model, start)
    tt = Trainer(model)
    tt.fit(*loaders("port"))
    tt.close()
    jt.fit(*loaders("jax"))
    jt.close()
    want = {"params": _flat(jt.state.params), "state": _flat(jt.state.model_state)}
    results = dict(jt.epoch_results)
    rng = np.random.default_rng(1)
    jt.state = jt.state._replace(model_state=start["state"], params=jax.tree.map(
        lambda a: (a * (1 + WITNESS * rng.standard_normal(a.shape))).astype(a.dtype)
        if a.ndim == 4 else a, start["params"]))
    jt.fit(*loaders("jax"))
    jt.close()
    witness = {"params": _flat(jt.state.params), "state": _flat(jt.state.model_state)}
    got = bridge.export_jax_variables(tt.model)
    got = {"params": _flat(got["params"]), "state": _flat(got["state"])}
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(tt.epoch_results[k], results[k], rtol=LOSS_RTOL, err_msg=k)
    for coll in ("params", "state"):
        assert set(got[coll]) == set(want[coll]) and want[coll]
        for k in want[coll]:
            bar = max(PARAM_RTOL, WITNESS_FACTOR * _rel(witness[coll][k], want[coll][k]))
            assert _rel(got[coll][k], want[coll][k]) <= bar, (coll, k)
