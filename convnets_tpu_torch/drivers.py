"""Experiment drivers (counterpart of convnets_tpu/drivers.py; the
reference's process_fit / process_tune / process_load / process_eval
quartet, template_net.py:69-261) over the port, exposed through the CLI
(``python -m convnets_tpu_torch``).

Every driver takes a `device` (default the card) and builds its model and
its DataMngr there; without a card the default raises (build_model), it
never falls back to the CPU. The plots need matplotlib, which is imported
only when a driver plots: where it is missing, process_eval says so once
and computes every score just the same.

Under torchrun (WORLD_SIZE in the environment) process_fit, process_tune
and process_load call parallel.init_distributed() and train over a
data-parallel mesh of every rank (`torchrun --nproc-per-node N -m
convnets_tpu_torch fit ...`: one card per rank, each rank its host slice
of every split); data rank 0 alone writes checkpoints and plots, and
process_export runs on rank 0 alone. There is no flag for it: the JAX CLI
has none either, and takes every local device by default.
"""

from __future__ import annotations

import os
from typing import Optional

from convnets_tpu_torch.data.manager import DataMngr
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.parallel.mesh import init_distributed, make_mesh
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train.engine import Trainer
from convnets_tpu_torch.tune.tuner import Tuner


def _torchrun_mesh(setting: Settings, device):
    """Under torchrun, the process group (init_distributed) and a mesh over
    every rank; otherwise None."""
    if "WORLD_SIZE" not in os.environ:
        return None
    init_distributed(device=device)
    return make_mesh(axis_name=getattr(setting, "data_axis", None) or "data",
                     mesh_shape=getattr(setting, "mesh_shape", None))


def _plot_manager(plot_dir: str):
    """A PlotMngr over `plot_dir`, or None where matplotlib is missing."""
    try:
        from convnets_tpu_torch.viz.plots import PlotMngr
    except ModuleNotFoundError as e:
        if not (e.name or "").startswith("matplotlib"):
            raise
        print(f"plots skipped: matplotlib is not installed ({plot_dir} not written)")
        return None
    return PlotMngr(plot_dir)


def process_eval(trainer: Trainer, trainset, validset, testset,
                 tuning: bool = False, results: Optional[dict] = None,
                 plot_dir: Optional[str] = None):
    """Evaluate on train/valid, timed test on test, render the plots
    (reference template_net.py:69-93). Returns test's (subset scores,
    per-batch seconds, img/s)."""
    if plot_dir is None:
        plot_dir = os.path.join(trainer.setting.output_dir, "plots")
    plot = _plot_manager(plot_dir) if trainer.rank == 0 else None

    def confusion(name):
        if plot is not None:
            plot.confusion_matrix(trainer.confusion_matrix, trainer.class_names, name=name)

    if plot is not None and trainer.epoch_results and trainer.epoch_results.get("train_loss"):
        plot.performance(trainer.epoch_results)
    trainer.evaluate(trainset)
    confusion("confusion_train.png")
    trainer.evaluate(validset)
    confusion("confusion_valid.png")
    scores, times, fps = trainer.test(testset)
    confusion("confusion_test.png")

    if tuning and results:
        if "tuning_results" in results:
            results = results["tuning_results"]
        if plot is not None and results.get("samples"):
            plot.hyperparameters(results, trainer.setting.get_hparams_names())
    return scores, times, fps


def process_fit(arch: str, setting: Settings, data_root: Optional[str] = None,
                optimizer: Optional[str] = None, device="cuda") -> Trainer:
    """Train a fresh model end-to-end, then evaluate
    (reference template_net.py:96-156)."""
    mesh = _torchrun_mesh(setting, device)
    model = build_model(arch, setting, device=device)
    data = DataMngr(setting, root=data_root, device=device, mesh=mesh)
    trainset, validset = data.load_train(), data.load_valid()
    trainer = Trainer(model, optimizer=optimizer, mesh=mesh)
    trainer.print_summary()
    trainer.fit(trainset, validset)
    process_eval(trainer, trainset, validset, data.load_test())
    return trainer


def process_tune(arch: str, setting: Settings, num_iter: int,
                 data_root: Optional[str] = None, optimizer: Optional[str] = None,
                 device="cuda"):
    """Random search over setting.distrib, then evaluate the winner
    (reference template_net.py:158-219). Returns (best Trainer, results)."""
    mesh = _torchrun_mesh(setting, device)

    def make_loaders(s):
        data = DataMngr(s, root=data_root, device=device, mesh=mesh)
        return data.load_train(), data.load_valid()

    tuner = Tuner(arch, setting, make_loaders, optimizer=optimizer, device=device, mesh=mesh)
    trainer, results = tuner.process(num_iter=num_iter)
    if trainer is not None:
        data = DataMngr(trainer.setting, root=data_root, device=device, mesh=mesh)
        process_eval(trainer, data.load_train(), data.load_valid(), data.load_test(),
                     tuning=True, results={"tuning_results": results})
    return trainer, results


def process_load(arch: str, setting: Settings, path: Optional[str] = None,
                 resume_training: bool = False, epochs: Optional[int] = None,
                 data_root: Optional[str] = None, testing: bool = False,
                 optimizer: Optional[str] = None, device="cuda"):
    """Load a checkpoint (of either package); optionally resume training;
    evaluate (reference template_net.py:221-261). With testing=True returns
    (model_name, subset_scores) for cross-model comparison
    (mngrutility.py:61-114), else (trainer, checkpoint meta)."""
    mesh = _torchrun_mesh(setting, device)
    model = build_model(arch, setting, device=device)
    trainer = Trainer(model, optimizer=optimizer, mesh=mesh)
    meta = trainer.load_checkpoint(path)
    trainer.setting.show()

    data = DataMngr(trainer.setting, root=data_root, device=device, mesh=mesh)
    if resume_training:
        if epochs is not None:
            trainer.setting.epochs = epochs
        trainer.fit(data.load_train(), data.load_valid(), resume=True)

    if testing:
        scores, _, _ = trainer.test(data.load_test())
        return trainer.model.model_name, scores

    process_eval(trainer, data.load_train(), data.load_valid(), data.load_test(),
                 tuning=True, results=meta.get("extra", {}))
    return trainer, meta


def process_export(arch: str, setting: Settings, out_path: str,
                   ckpt_path: Optional[str] = None,
                   serve_batch: Optional[int] = None,
                   output: str = "logits",
                   bake_norm: bool = False,
                   data_root: Optional[str] = None,
                   device="cuda") -> dict:
    """Load a checkpoint and write the single-file serving artifact
    (serve/export.py). With bake_norm=True the train split's per-channel
    normalization is part of the served program and requests send raw
    [0, 1] pixels. The JAX driver's `platforms` (its StableHLO lowering
    targets) has no counterpart: the artifact runs where it is loaded.
    Under torchrun only rank 0 exports (the others return None)."""
    from convnets_tpu_torch.serve import export_trainer

    if int(os.environ.get("RANK", "0")) != 0:
        return None

    model = build_model(arch, setting, device=device)
    trainer = Trainer(model)
    trainer.load_checkpoint(ckpt_path)

    stats = None
    class_names = None
    if bake_norm or data_root is not None:
        data = DataMngr(trainer.setting, root=data_root, device=device)
        ds = data.load_train().dataset
        if bake_norm:
            stats = (ds.mean, ds.std)
        class_names = getattr(ds, "class_names", None)

    meta = export_trainer(trainer, out_path, batch_size=serve_batch, output=output,
                          stats=stats, class_names=class_names)
    print(f"exported {meta['model_name']} -> {out_path} "
          f"(batch={meta['batch']}, output={meta['output']}, "
          f"platforms={','.join(meta['platforms'])})")
    return meta
