"""The port's replayed-graph epoch (train/graph.py StepGraph, the counterpart
of the JAX engine's whole-epoch lax.scan) on the CPU, mirroring
tests/test_epoch_scan.py.

On the CPU the graph's step runs eagerly over the same static buffers as
on the card: the epoch's index and weight matrices, the device step
counter and the per-step output rows, with the generators reseeded and
the per-step scalars filled before each step. So the scanned epochs must
equal the per-step loop's bit for bit (the JAX test holds its two paths
to 1e-5, as XLA compiles them apart): same seeded permutation, same
index-0 padding, same draws of generator_for(seed, stream, e, s), same
np.sum of the per-step losses. The scanned BN fit is held against the
JAX package's scanned fit from the same bridged weights.
"""

import jax
import numpy as np
import pytest
import torch

from convnets_tpu.data import ArrayDataset as JArrayDataset
from convnets_tpu.data.loader import DeviceCacheLoader as JDeviceCacheLoader
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.settings import Settings as JSettings
from convnets_tpu.train import Trainer as JTrainer
from convnets_tpu_torch import bridge
from convnets_tpu_torch.data import ArrayDataset, DataLoader, DeviceCacheLoader, synthetic_dataset
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer
from convnets_tpu_torch.train.graph import StepGraph
from torch_one_thread import one_intra_op_thread  # noqa: F401

LOSS_RTOL = 1e-3  # the scanned BN fit's epoch losses against JAX (tests/test_torch_trainer.py)
N, BATCH = 64, 16  # 4 full batches; BATCH 24 leaves a last batch of 16 real rows


def _setting(tmp, **kw):
    base = dict(kind=0, input_size=(3, 16, 16), num_classes=4, batch_size=BATCH, epochs=1,
                mixed_precision=False, data_augment=True, data_norm=True, sanity_check=False,
                early_stop=False, lr_scheduler="none", learning_rate=0.01,
                output_dir=str(tmp))
    base.update(kw)
    return base


def _arrays(n, seed, hw=16):
    ds = synthetic_dataset(n, (hw, hw, 3), num_classes=4, seed=seed)
    return (ds.images * 255).round().astype(np.uint8), ds.labels


def _dataset(n=N, seed=3, hw=16):
    return ArrayDataset(*_arrays(n, seed, hw))


def _twins(tmp, arch="lenet", **kw):
    """Two port Trainers on the CPU holding the same weights."""
    a = Trainer(build_model(arch, Settings(**_setting(tmp, **kw)), device="cpu"))
    b = Trainer(build_model(arch, Settings(**_setting(tmp, **kw)), device="cpu"))
    b.model.load_state_dict(a.model.state_dict())
    a._new_state()
    b._new_state()
    return a, b


def _loaders(ds, batch, **kw):
    per_step = DeviceCacheLoader(ds, batch, device="cpu", **kw)
    per_step.scan_epochs = False
    return per_step, DeviceCacheLoader(ds, batch, device="cpu", **kw)


def _assert_same_weights(a, b):
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k


def _graphs(trainer):
    return [g for g in trainer._epoch_fns.values() if isinstance(g, StepGraph)]


@pytest.mark.parametrize("extra", [{}, {"cutout": 4, "mixup": 0.2, "dropout_rate": 0.3}],
                         ids=["augment", "augment-cutout-mixup-dropout"])
def test_train_epoch_scan_matches_per_step(tmp_path, extra):
    """LeNet with augmentation (and cutout, mixup, dropout): two epochs of
    each route, bit for bit: losses, scores, weights, Adam's count."""
    per_step, scanned = _twins(tmp_path, **extra)
    loader_it, loader_sc = _loaders(_dataset(), BATCH, shuffle=True, seed=5)
    assert loader_sc.scan_epochs and scanned._use_epoch_scan(loader_sc)
    for epoch in range(2):
        assert per_step._run_train_epoch(loader_it, epoch) == \
            scanned._run_train_epoch(loader_sc, epoch)
    assert per_step._epoch_fns == {} and len(_graphs(scanned)) == 1
    _assert_same_weights(per_step, scanned)
    assert per_step.state.opt_state.count == scanned.state.opt_state.count == 2 * N // BATCH


def test_train_epoch_scan_matches_per_step_batchnorm(tmp_path):
    """RN18 (BN running statistics updated inside the replayed step) with
    SGD, bit for bit, every parameter and buffer."""
    per_step, scanned = _twins(tmp_path, "resnet", kind="18", optimizer="sgd", momentum=0.9,
                               learning_rate=1e-3)
    loader_it, loader_sc = _loaders(_dataset(32), BATCH, shuffle=True, seed=5)
    for epoch in range(2):
        assert per_step._run_train_epoch(loader_it, epoch) == \
            scanned._run_train_epoch(loader_sc, epoch)
    _assert_same_weights(per_step, scanned)


def test_train_epoch_scan_with_padding(tmp_path):
    """A partial last batch (64 = 2·24 + 16): both routes replay index 0 at
    weight 0 there, so BN's batch statistics agree too."""
    per_step, scanned = _twins(tmp_path, "resnet", kind="18", batch_size=24)
    loader_it, loader_sc = _loaders(_dataset(), 24, shuffle=True, seed=7)
    idx, w = DeviceCacheLoader(_dataset(), 24, device="cpu", shuffle=True, seed=7).epoch_matrices()
    assert idx.shape == w.shape == (3, 24) and w.sum() == N
    assert (idx[2, 16:] == 0).all() and (w[2, 16:] == 0).all()
    assert per_step._run_train_epoch(loader_it, 0) == scanned._run_train_epoch(loader_sc, 0)
    _assert_same_weights(per_step, scanned)


def test_eval_epoch_scan_matches_per_step(tmp_path):
    t, _ = _twins(tmp_path)
    loader_it, loader_sc = _loaders(_dataset(), 24)  # padded last batch
    l_it, s_it, tg_it, pr_it = t._run_eval_epoch(loader_it, collect_preds=True)
    l_sc, s_sc, tg_sc, pr_sc = t._run_eval_epoch(loader_sc, collect_preds=True)
    assert (l_it, s_it) == (l_sc, s_sc)
    np.testing.assert_array_equal(tg_it, tg_sc)
    np.testing.assert_array_equal(pr_it, pr_sc)
    assert len(pr_sc) == N
    assert t._run_eval_epoch(loader_sc) == (l_sc, s_sc)
    assert len(_graphs(t)) == 2  # with and without the predictions


def test_scanned_bn_fit_matches_the_jax_scanned_fit(tmp_path, monkeypatch):
    """RN18@32 at b16 over 40 images (the last batch padded by index-0
    replay in both packages), one epoch from the same bridged weights, SGD,
    dropout 0, no augmentation: both Trainers fit over their
    DeviceCacheLoaders' scanned routes."""
    kw = _setting(tmp_path, kind="18", input_size=(3, 32, 32), num_classes=10,
                  data_augment=False, optimizer="sgd", momentum=0.9, learning_rate=1e-3,
                  loss_reduction="mean", dropout_rate=0.0)
    train, valid = _arrays(40, 0, 32), _arrays(24, 1, 32)
    jt = JTrainer(jax_build_model("resnet", JSettings(**{**kw, "output_dir": str(tmp_path / "j")})),
                  use_mesh=False)
    jt.init_state()
    model = build_model("resnet", Settings(**{**kw, "output_dir": str(tmp_path / "t")}),
                        device="cpu")
    bridge.load_jax_variables(model, {"params": jax.tree.map(np.asarray, jt.state.params),
                                      "state": jax.tree.map(np.asarray, jt.state.model_state)})
    tt = Trainer(model)
    jloaders = (JDeviceCacheLoader(JArrayDataset(*train), BATCH, shuffle=True, seed=0),
                JDeviceCacheLoader(JArrayDataset(*valid), BATCH))
    tloaders = (DeviceCacheLoader(ArrayDataset(*train), BATCH, shuffle=True, seed=0,
                                  device="cpu"),
                DeviceCacheLoader(ArrayDataset(*valid), BATCH, device="cpu"))
    assert jt._use_epoch_scan(jloaders[0]) and tt._use_epoch_scan(tloaders[0])
    jt.fit(*jloaders)
    jt.close()
    runs = []
    replay = StepGraph.run
    monkeypatch.setattr(StepGraph, "run",
                        lambda g, *a, **k: runs.append(g.kind) or replay(g, *a, **k))
    tt.fit(*tloaders)
    tt.close()
    assert runs == ["train", "eval"]
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(tt.epoch_results[k], jt.epoch_results[k], rtol=LOSS_RTOL,
                                   err_msg=k)


def test_sanity_check_and_debug_run_per_step(tmp_path, capsys):
    loader = DeviceCacheLoader(_dataset(), BATCH, shuffle=True, device="cpu")
    t, _ = _twins(tmp_path, sanity_check=True)
    assert not t._use_epoch_scan(loader)
    loss, _ = t._run_train_epoch(loader, 0)  # runs exactly one step
    assert np.isfinite(loss) and t.state.opt_state.count == 1 and t._epoch_fns == {}
    t, _ = _twins(tmp_path, debug=True)
    assert not t._use_epoch_scan(loader, debug=True)
    t._run_train_epoch(loader, 0)
    assert capsys.readouterr().out.count("grad_norm=") == N // BATCH and t._epoch_fns == {}


def test_plain_dataloader_never_scans(tmp_path):
    t, _ = _twins(tmp_path)
    loader = DataLoader(_dataset(), BATCH, shuffle=True)
    assert not t._use_epoch_scan(loader)
    t._run_train_epoch(loader, 0)
    assert t._epoch_fns == {}


def test_scan_single_process_metric_accounting(tmp_path):
    """Each host's scanned eval divides by its own example count (one
    process: `_scan_denominator` is the loader's host count), so the mean
    of two equal shards' means is the whole split's."""
    t, _ = _twins(tmp_path)
    single = DeviceCacheLoader(_dataset(), BATCH, device="cpu")
    l_all, s_all = t._run_eval_epoch(single)
    per_host = []
    for hid in (0, 1):
        shard = DeviceCacheLoader(_dataset(), BATCH, host_id=hid, num_hosts=2, device="cpu")
        assert t._scan_denominator(shard) == shard._host_count() == N // 2
        per_host.append(t._run_eval_epoch(shard))
    assert np.isclose(sum(l for l, _ in per_host) / 2, l_all, rtol=1e-6)
    assert np.isclose(sum(s for _, s in per_host) / 2, s_all, rtol=1e-6)
