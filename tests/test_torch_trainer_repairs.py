"""Two Trainer behaviours of the JAX package that the port now has, on the CPU.

- `init_state()` draws fresh weights from the settings' seed, as the JAX
  Trainer's init_state draws them from key_for(seed, "init"): after a fit
  it gives back exactly what build_model gives. `fit` on a Trainer without
  a state goes on from the model's current weights (build_model's, or what
  the caller loaded through the bridge).
- `test(..., profile_dir=...)` runs under torch.profiler, as the JAX test
  runs under jax.profiler.trace, writes the trace there, and returns what
  `test` returns without it.
"""

import json
import os

import numpy as np
import pytest
import torch

from convnets_tpu_torch import bridge
from convnets_tpu_torch.data import ArrayDataset, DataLoader, synthetic_dataset
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer
from torch_one_thread import one_intra_op_thread  # noqa: F401

BATCH = 8


def _setting(tmp, arch, **kw):
    kind = {"resnet": "18", "lenet": "0", "mynetwork": "base"}[arch]
    base = dict(kind=kind, input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                batch_size=BATCH, epochs=1, optimizer="adam", learning_rate=1e-2,
                data_augment=False, data_norm=True, dropout_rate=0.0, early_stop=False,
                output_dir=str(tmp), test_sample_size=4, seed=3)
    base.update(kw)
    return Settings(**base)


def _loader(n, seed, shuffle=False):
    ds = synthetic_dataset(n, seed=seed)
    images = (ds.images * 255).round().astype(np.uint8)
    return DataLoader(ArrayDataset(images, ds.labels), BATCH, shuffle=shuffle, seed=seed)


def _tensors(model):
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


@pytest.mark.parametrize("arch", ["resnet", "lenet", "mynetwork"])
def test_init_state_after_a_fit_gives_back_build_models_weights(arch, tmp_path):
    trainer = Trainer(build_model(arch, _setting(tmp_path, arch), device="cpu"))
    trainer.fit(_loader(16, 0, shuffle=True), _loader(8, 1))
    fresh = _tensors(build_model(arch, _setting(tmp_path, arch), device="cpu"))
    fitted = {k: t.detach().clone() for k, t in _tensors(trainer.model).items()}
    assert any(not torch.equal(fitted[k], fresh[k]) for k in fresh)  # the fit moved them

    state = trainer.init_state()
    now = _tensors(trainer.model)
    assert set(now) == set(fresh)
    for k in fresh:
        assert now[k].dtype == fresh[k].dtype and torch.equal(now[k], fresh[k]), k
    # the state is over the new tensors, with a zero optimizer state
    assert all(p is q for p, q in zip(state.model.parameters(), trainer.model.parameters()))
    for field, value in state.opt_state._asdict().items():
        if isinstance(value, dict):
            assert all(not t.any() for t in value.values()), field
        else:
            assert value == 0, field
    # and a step over it trains the fresh weights
    trainer.fit(_loader(16, 0, shuffle=True), _loader(8, 1))
    assert any(not torch.equal(_tensors(trainer.model)[k], fresh[k]) for k in fresh)


def test_fit_without_a_state_goes_on_from_the_loaded_weights(tmp_path):
    """Weights loaded through the bridge before the first fit stay the
    start: at learning rate 0 the parameters come out of the fit as they
    went in, not as the seed draws them."""
    setting = _setting(tmp_path, "lenet", learning_rate=0.0, weight_decay=0.0)
    model = build_model("lenet", setting, device="cpu")
    variables = bridge.export_jax_variables(model)
    rng = np.random.RandomState(9)
    variables["params"] = _perturbed(variables["params"], rng)
    bridge.load_jax_variables(model, variables)
    loaded = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer = Trainer(model)
    trainer.fit(_loader(16, 0, shuffle=True), _loader(8, 1))
    for k, p in trainer.model.named_parameters():
        assert torch.equal(p, loaded[k]), k


def _perturbed(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng) for k, v in tree.items()}
    return (tree + 0.1 * rng.randn(*tree.shape)).astype(np.float32)


def test_test_with_profile_dir_writes_a_trace_and_returns_the_same(tmp_path):
    trainer = Trainer(build_model("lenet", _setting(tmp_path, "lenet"), device="cpu"))
    trainer.fit(_loader(16, 0, shuffle=True), _loader(8, 1))
    loader = _loader(20, 2, shuffle=True)
    scores, times, _ = trainer.test(loader, num_warmup=2)
    cm = trainer.confusion_matrix.copy()
    profile_dir = tmp_path / "profile"
    p_scores, p_times, p_fps = trainer.test(loader, num_warmup=2, profile_dir=str(profile_dir))
    assert p_scores == scores and len(p_times) == len(times) and p_fps > 0
    np.testing.assert_array_equal(trainer.confusion_matrix, cm)
    traces = os.listdir(profile_dir)
    assert traces == [f"test-{trainer.model.model_name}.json"]
    with open(profile_dir / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the eval forwards ran inside the trace: the convs' custom op is in it
    assert any("conv2d_fused" in e.get("name", "") for e in events)
