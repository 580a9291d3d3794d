"""Random-search hyper-parameter tuner (counterpart of
convnets_tpu/tune/tuner.py; the reference Tuner, mngrtune.py:15-136).

Sample the Distrib space, train a fresh model per sample on `device`,
score it on the validation set, keep the best checkpoint as
`<name>-<version>-tuned`, and at the end reload the best state and write
the full tuning results into its checkpoint (the JAX package's .ckpt.npz
format). Data loaders are rebuilt per sample only when a data-affecting
hyper-parameter (batch_size / data_augment / data_norm) varies
(mngrtune.py:53-86). With a data-parallel `mesh`, every sample's Trainer
shards over it, as the JAX Tuner passes its mesh; data rank 0 alone writes
the tuned checkpoint.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from convnets_tpu_torch.models.base import build_model
from convnets_tpu_torch.parallel.mesh import broadcast_object, data_rank
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import checkpoint as ckpt
from convnets_tpu_torch.train.engine import Trainer
from convnets_tpu_torch.tune.sampler import ParameterSampler

DATA_FIELDS = ("batch_size", "data_augment", "data_norm")


class Tuner:
    def __init__(self, arch: str, setting: Settings,
                 make_loaders: Callable[[Settings], tuple],
                 optimizer: Optional[str] = None, device="cuda", mesh=None):
        """make_loaders(setting) -> (train_loader, valid_loader); called
        once up front and again per sample iff data hyper-parameters vary.
        Each sample's model is built on `device`; `mesh` is passed to every
        sample's Trainer (built once, not per sample)."""
        self.arch = arch
        self.setting = setting
        self.make_loaders = make_loaders
        self.optimizer = optimizer or getattr(setting, "optimizer", "adam")
        self.device = device
        self.mesh = mesh
        self.axis = getattr(setting, "data_axis", None) or "data"
        self.version = int(time.time())
        if mesh is not None:
            # the tuned file is named by rank 0's version on every rank
            self.version = broadcast_object(self.version, mesh, self.axis)
        self.best_score = -float("inf")
        self.best_path: Optional[str] = None
        self.results = {"samples": [], "scores": [], "best_index": -1}

    def _data_varies(self) -> bool:
        d = self.setting.distrib.to_dict()
        return any(
            (hasattr(d[f], "rvs") or len(set(map(str, d[f]))) > 1)
            for f in DATA_FIELDS if f in d and d[f] is not None
        )

    def tuned_path(self) -> str:
        name = self.arch + str(self.setting.kind)
        return ckpt.checkpoint_path(
            self.setting.output_dir, name, self.version, ckpt.SUFFIX_TUNED
        )

    def process(self, num_iter: int):
        sampler = ParameterSampler(
            self.setting.distrib.to_dict(), num_iter, seed=self.setting.seed
        )
        data_varies = self._data_varies()
        trainset, validset = self.make_loaders(self.setting)
        best_trainer = None

        for i, sample in enumerate(sampler):
            print(f"\n=== TUNING SAMPLE {i + 1}/{num_iter} ===\n{sample}")
            self.setting.load_values(sample)
            if data_varies:
                trainset, validset = self.make_loaders(self.setting)

            model = build_model(self.arch, self.setting, device=self.device)
            trainer = Trainer(model, optimizer=self.optimizer, mesh=self.mesh)
            trainer.fit(trainset, validset)
            score = trainer.evaluate(validset, info=False)

            self.results["samples"].append(dict(sample))
            self.results["scores"].append(float(score))
            if score > self.best_score:
                self.best_score = float(score)
                self.results["best_index"] = i
                best_trainer = trainer
                self.best_path = trainer.save_checkpoint(self.tuned_path())
                print(f"New best score {score:.4f} → {self.best_path}")

        if best_trainer is not None:
            # reload the best and attach the tuning results (mngrtune.py:113-122)
            meta = best_trainer.load_checkpoint(self.best_path)
            best_trainer.epoch_results = meta["epoch_results"]
            state = best_trainer.state
            if self.mesh is None or data_rank(self.mesh, self.axis) == 0:
                ckpt.save_checkpoint(
                    self.best_path,
                    **ckpt.state_arrays(best_trainer.model,
                                        ckpt.state_tensors(state, clone=False)),
                    epoch_results=best_trainer.epoch_results,
                    settings_dict=self.setting.to_dict(),
                    scheduler_state=best_trainer.scheduler.to_state()
                    if best_trainer.scheduler else {},
                    optimizer_name=self.optimizer,
                    extra={"tuning_results": self.results},
                )
        return best_trainer, self.results

    def process_cv(self, *a, **kw):
        raise NotImplementedError("cross-validation tuning (parity: mngrtune.py:130-136)")
