"""Train-mode Remat (nn/layers.py:Remat, torch.utils.checkpoint) on the CPU.

Remat changes what autograd keeps, never what a step computes: with one
generator, a step with remat equals the step without, bit for bit (loss,
every parameter, every BN buffer), which also shows that the recompute in
the backward writes no running statistic (a second update would move the
buffers again) and reuses the forward's dropout masks (a recompute that
redraws them moves the gradients: the control). Against the JAX package: a
step of RN18@32 with remat on both sides. Through the replayed route: the
graphed epochs (train/graph.py StepGraph, eager on the CPU) with remat and
dropout equal the per-step loop's.
"""

import numpy as np
import pytest
import torch

from convnets_tpu.models import densenet as jdensenet
from convnets_tpu.settings import Settings as JSettings
from convnets_tpu_torch import bridge, nn
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.models import densenet
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import build_train_step, create_train_state
from test_torch_epoch_scan import _assert_same_weights, _dataset, _loaders, _twins
from test_torch_train import _check_variables, _run_both
from torch_one_thread import one_intra_op_thread  # noqa: F401

TINY_DENSENET = (8, [2, 2], 16)  # growth 8, two blocks of two layers, 16 stem channels


@pytest.fixture
def tiny_densenet(monkeypatch):
    """CONFIG["121"] of both packages cut to TINY_DENSENET: dense blocks with
    their dropouts, at a few ms per step."""
    monkeypatch.setitem(densenet.CONFIG, "121", TINY_DENSENET)
    monkeypatch.setitem(jdensenet.CONFIG, "121", TINY_DENSENET)


def _model(arch, remat, fused=False, monkeypatch=None, **kw):
    fields = dict(kind="18" if arch == "resnet" else "121", input_size=(3, 32, 32),
                  num_classes=10, mixed_precision=False, optimizer="sgd", learning_rate=0.1,
                  momentum=0.9, weight_decay=1e-4, remat=remat, seed=4)
    fields.update(kw)
    with monkeypatch.context() as m:
        m.setenv("CONVNETS_TPU_DENSENET_FUSED", "1" if fused else "0")
        return build_model(arch, Settings(**fields), device="cpu")


def _values(model):
    """{JAX path: a copy of the parameter or buffer} (the export shares the
    CPU tensors' memory)."""
    return {k: v.copy() for k, v in bridge._flatten(bridge.export_jax_variables(model)).items()}


def _step(model, seed=11):
    """One SGD step at b4 with the dropout masks from one generator: (loss,
    {JAX path: parameter or buffer after the step}, {parameter: gradient})."""
    state = create_train_state(model)
    step = build_train_step(state)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8))
    y = torch.from_numpy(rng.randint(0, 10, 4))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    loss, _ = step(state, x, y, generator=torch.Generator().manual_seed(seed))
    paths = bridge.param_paths(model)
    moved = {paths[k]: before[k] - p.detach() for k, p in model.named_parameters()}
    return float(loss), _values(model), moved


CASES = {"resnet18": ("resnet", False, {}),
         "densenet-dropout": ("densenet", False, {"dropout_rate": 0.5}),
         "densenet-fused-dropout": ("densenet", True, {"dropout_rate": 0.5})}


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_is_bit_for_bit_the_plain_step(case, monkeypatch, tiny_densenet):
    arch, fused, kw = CASES[case]
    runs = {}
    for remat in (False, True):
        model = _model(arch, remat, fused, monkeypatch, **kw)
        wrapped = [m for m in model.modules() if isinstance(m, nn.Remat)]
        assert len(wrapped) == (8 if arch == "resnet" else 2) if remat else not wrapped
        start = _values(model)
        runs[remat] = _step(model)
    (l0, v0, g0), (l1, v1, g1) = runs[False], runs[True]
    assert l0 == l1
    assert set(v0) == set(v1)
    for k in v0:
        assert np.array_equal(v0[k], v1[k]), "/".join(k)
    buffers = [k for k in v0 if k[0] == "state"]
    assert buffers and all(not np.array_equal(v1[k], start[k]) for k in buffers
                           if k[-1] == "mean")  # the step moved every running mean
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_a_recompute_that_redraws_its_masks_moves_the_gradients(monkeypatch, tiny_densenet):
    """The control of the mask replay: the same remat step, but each
    recomputed dropout draws a fresh mask, gives other gradients."""
    kw = {"dropout_rate": 0.5}
    _, _, want = _step(_model("densenet", True, False, monkeypatch, **kw))
    fresh = torch.Generator().manual_seed(99)
    monkeypatch.setattr(nn.MaskTape, "next_mask", lambda self, shape: (
        setattr(self, "cursor", self.cursor + 1) or torch.rand(shape, generator=fresh) < 0.5))
    _, _, redrawn = _step(_model("densenet", True, False, monkeypatch, **kw))
    gaps = {k: float((redrawn[k] - want[k]).norm() / want[k].norm().clamp_min(1e-30))
            for k in want}
    assert max(gaps.values()) > 0.1, gaps


def test_remat_step_matches_the_jax_remat_step():
    """RN18@32, one SGD step with remat on both sides (bridged weights, the
    bar of test_torch_train's one-step check)."""
    setting = JSettings(kind="18", input_size=(3, 32, 32), num_classes=10,
                        mixed_precision=False, dropout_rate=0.0, optimizer="sgd",
                        learning_rate=1e-3, weight_decay=1e-4, batch_norm=True,
                        data_augment=False, data_norm=True, nesterov=True, remat=True)
    js, jout, model, _, tout = _run_both(setting, 1)
    assert sum(isinstance(m, nn.Remat) for m in model.modules()) == 8
    np.testing.assert_allclose(tout, jout, rtol=1e-4)
    _check_variables(model, js, 1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_graphed_remat_epochs_equal_the_per_step_loop(tmp_path, fused, monkeypatch,
                                                      tiny_densenet):
    """The tiny DenseNet with remat and dropout 0.5 in its dense layers, two
    epochs through the captured step (eager on the CPU) and through the
    per-step loop: losses, scores and every weight bit for bit."""
    monkeypatch.setenv("CONVNETS_TPU_DENSENET_FUSED", "1" if fused else "0")
    per_step, scanned = _twins(tmp_path, "densenet", kind="121", remat=True, dropout_rate=0.5,
                               data_augment=False)
    assert any(isinstance(m, nn.Remat) for m in scanned.model.modules())
    loader_it, loader_sc = _loaders(_dataset(32), 16, shuffle=True, seed=5)
    assert scanned._use_epoch_scan(loader_sc)
    for epoch in range(2):
        assert per_step._run_train_epoch(loader_it, epoch) == \
            scanned._run_train_epoch(loader_sc, epoch)
    _assert_same_weights(per_step, scanned)
