"""The port's tuner (counterpart of tests/test_tune.py) against the JAX
package's: the sampler draws the same samples, floats bit for bit; the
random search keeps the best checkpoint with its tuning results, in the
JAX package's checkpoint format; `_data_varies` decides as the JAX Tuner
does.
"""

import numpy as np
import pytest

from convnets_tpu import settings as jax_settings
from convnets_tpu.train import checkpoint as jax_ckpt
from convnets_tpu.tune import ParameterSampler as JaxParameterSampler
from convnets_tpu.tune import Tuner as JaxTuner
from convnets_tpu_torch.data import DataLoader, synthetic_dataset
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import checkpoint as ckpt
from convnets_tpu_torch.tune import ParameterSampler, Tuner
from convnets_tpu_torch.tune.tuner import DATA_FIELDS


def _distributions(pkg):
    return {
        "batch_size": [8, 16, 32],
        "learning_rate": pkg.LogUniform(1e-4, 1e-1),
        "weight_decay": pkg.Uniform(0.0, 1e-3),
        "batch_norm": [False, True],
        "lr_scheduler": ["plateau", "step", "cosine"],
    }


@pytest.mark.parametrize("seed", [0, 3, 21])
def test_sampler_draws_the_jax_samples_bit_for_bit(seed):
    import convnets_tpu_torch.settings as port_settings

    got = list(ParameterSampler(_distributions(port_settings), 6, seed=seed))
    want = list(JaxParameterSampler(_distributions(jax_settings), 6, seed=seed))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            assert type(g[k]) is type(w[k]), k
            if isinstance(w[k], float):
                assert np.float64(g[k]).tobytes() == np.float64(w[k]).tobytes(), k
            else:
                assert g[k] == w[k], k
    assert got != list(ParameterSampler(_distributions(port_settings), 6, seed=seed + 1))


def _distrib(pkg, **over):
    fields = dict(
        batch_size=[16], batch_norm=[True], epochs=[1],
        learning_rate=pkg.LogUniform(1e-4, 1e-2), lr_factor=[0.1], lr_patience=[5],
        weight_decay=[0.0], dropout_rate=[0.0], loss_optim=[False], data_augment=[False],
        data_norm=[False], early_stop=[False], es_patience=[10], grad_clip_norm=[False],
        gc_max_norm=[1.0], grad_clip_value=[False], gc_value=[1.0], init_params=[True])
    fields.update(over)
    return pkg.HyperParamsDistrib(**fields)


def test_tuner_process_keeps_best(tmp_path):
    """tests/test_tune.py's setting: LeNet at 16², 3 classes, two samples
    of one epoch; the best checkpoint carries the tuning results and reads
    in the JAX package's checkpoint reader."""
    import convnets_tpu_torch.settings as port_settings

    setting = Settings(
        kind=0, input_size=(3, 16, 16), num_classes=3, batch_size=16, epochs=1,
        mixed_precision=False, data_augment=False, data_norm=False,
        dropout_rate=0.0, early_stop=False, distrib=_distrib(port_settings),
        output_dir=str(tmp_path))

    def make_loaders(s):
        train = DataLoader(synthetic_dataset(32, (16, 16, 3), 3, seed=0),
                           s.batch_size, shuffle=True, seed=0)
        valid = DataLoader(synthetic_dataset(16, (16, 16, 3), 3, seed=1), s.batch_size)
        return train, valid

    tuner = Tuner("lenet", setting, make_loaders, device="cpu")
    assert not tuner._data_varies()
    best_trainer, results = tuner.process(num_iter=2)

    assert len(results["samples"]) == 2 and len(results["scores"]) == 2
    want = list(JaxParameterSampler(_distrib(jax_settings).to_dict(), 2, seed=setting.seed))
    assert results["samples"] == want
    assert 0 <= results["best_index"] < 2
    assert results["scores"][results["best_index"]] == max(results["scores"])
    assert best_trainer is not None and best_trainer.model.model_name == "LeNet0"
    assert tuner.best_path and tuner.best_path.endswith(ckpt.SUFFIX_TUNED + ckpt.EXT)
    _, meta = ckpt.load_checkpoint(tuner.best_path)
    assert meta["extra"]["tuning_results"]["scores"] == results["scores"]
    trees, jmeta = jax_ckpt.load_checkpoint(tuner.best_path)
    assert jmeta["extra"]["tuning_results"] == meta["extra"]["tuning_results"]
    assert set(trees["params"]) == set(ckpt.load_checkpoint(tuner.best_path)[0]["params"])
    # the reloaded winner scores what it scored when it was sampled
    assert best_trainer.evaluate(make_loaders(setting)[1], info=False) == max(results["scores"])


@pytest.mark.parametrize("over", [
    {},
    {"batch_size": [8, 16]},
    {"batch_size": [16, 16]},
    {"data_norm": [False, True]},
    {"data_augment": [True]},
    {"learning_rate": [1e-3, 1e-2]},
    {"batch_size": "uniform"},
], ids=lambda o: ",".join(o) or "none")
def test_data_varies_decides_as_the_jax_tuner(over, tmp_path):
    import convnets_tpu_torch.settings as port_settings

    def distrib(pkg):
        fields = {k: (pkg.Uniform(8, 8) if v == "uniform" else v) for k, v in over.items()}
        return _distrib(pkg, **fields)

    kw = dict(kind=0, input_size=(3, 16, 16), num_classes=3, output_dir=str(tmp_path))
    port = Tuner("lenet", Settings(distrib=distrib(port_settings), **kw),
                 lambda s: (None, None), device="cpu")
    jax = JaxTuner("lenet", jax_settings.Settings(distrib=distrib(jax_settings), **kw),
                   lambda s: (None, None))
    assert port._data_varies() == jax._data_varies()
    assert port._data_varies() == bool(set(over) & set(DATA_FIELDS)
                                       and over not in ({"batch_size": [16, 16]},
                                                        {"data_augment": [True]}))


def test_tuned_path_and_process_cv(tmp_path):
    setting = Settings(kind=0, input_size=(3, 16, 16), num_classes=3, output_dir=str(tmp_path))
    tuner = Tuner("lenet", setting, lambda s: (None, None), device="cpu")
    assert tuner.tuned_path() == ckpt.checkpoint_path(str(tmp_path), "lenet0", tuner.version,
                                                      ckpt.SUFFIX_TUNED)
    with pytest.raises(NotImplementedError):
        tuner.process_cv()
