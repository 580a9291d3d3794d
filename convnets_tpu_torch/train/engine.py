"""The train and eval steps and the Trainer (counterpart of
convnets_tpu/train/engine.py: Trainer._build_train_step :190-278,
_build_eval_step :308-326, and Trainer).

Train step: preprocess (uint8 → /255, optional normalize, cast to the
compute dtype) → train-mode forward, fp32 logits → sum-CE (label
smoothing, example weights) and the sum or per-example-mean objective →
× loss scale → gradients → ÷ loss scale → clipping → Adam or SGD →
correct count. The step updates the TrainState in place: parameters and
optimizer state are overwritten after the update, and the BN running
statistics during the forward (the port mutates where the JAX package
returns a new state).

Trainer: fit (best-checkpoint gating on valid loss or score, the async
checkpoint, plateau rollback, early stop, resume with the data-order
clock), evaluate, test, reestimate_bn and checkpoints, on one device: the
model's. Each epoch is a host loop over `data.device_prefetch` batches;
the per-step loss and correct count stay on the device until the epoch
ends. Augmentation, cutout, mixup and a device-resident loader (the JAX
package's whole-epoch scan) are ROADMAP.md modules item 3 (data path);
data parallel is item 7.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from convnets_tpu_torch import bridge, ops
from convnets_tpu_torch.core.precision import LossScale
from convnets_tpu_torch.core.rng import generator_for
from convnets_tpu_torch.data.datasets import CINIC_MEAN, CINIC_STD
from convnets_tpu_torch.data.loader import DataLoader, device_prefetch
from convnets_tpu_torch.nn import use_generator
from convnets_tpu_torch.train import checkpoint as ckpt
from convnets_tpu_torch.train import metrics as M
from convnets_tpu_torch.train import optim
from convnets_tpu_torch.train.scheduler import (
    ConstantLR, CosineDecay, ReduceLROnPlateau, StepDecay, scheduler_from_state,
)
from convnets_tpu_torch.train.state import TrainState, create_train_state

def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md modules item 3, data path)")


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_device(device, x, y, w):
    """The batch on the model's device (the batch follows the model, never
    the other way); w all ones when None."""
    x, y = torch.as_tensor(x).to(device), torch.as_tensor(y).to(device)
    if w is None:
        return x, y, torch.ones(x.shape[0], dtype=torch.float32, device=device)
    return x, y, torch.as_tensor(w).to(device)


def _make_preprocess(model, norm: bool, stats):
    """uint8 → /255 on the device, optional normalize, cast to the compute
    dtype: the input side of the train, eval and BN re-estimation steps."""
    compute_dtype = model.policy.compute_dtype
    target_hw = tuple(model.input_shape_nhwc[:2])
    # CINIC-10's statistics are the default of the JAX package's
    # data/augment.py:normalize
    mean, std = (CINIC_MEAN, CINIC_STD) if stats is None else stats

    def preprocess(x):
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        if tuple(x.shape[1:3]) != target_hw:
            raise _not_ported(f"resizing a {tuple(x.shape[1:3])} batch to {target_hw}")
        if norm:
            m, s = (torch.as_tensor(np.asarray(v, np.float32), device=x.device).to(x.dtype)
                    for v in (mean, std))
            x = (x - m) / s
        return x.to(compute_dtype)

    return preprocess


def build_train_step(state: TrainState, *, augment: bool = False, norm: bool = False,
                     stats=None, debug: bool = False):
    """Return train_step(state, x, y, w=None, generator=None) -> (loss, correct),
    or (loss, correct, gradient global norm) when `debug`.

    x: (N, H, W, C) uint8 or float batch at the model's input size; y (N,)
    int labels; w (N,) 0/1 example weights (all ones when None), each moved
    to the model's device if it lies elsewhere; generator:
    the torch.Generator of the dropout masks, on x's device. loss is the
    batch's CE sum, correct its count of right argmaxes, both fp32 scalars
    on the device. Settings read: weight_decay, grad_clip_norm/gc_max_norm,
    grad_clip_value/gc_value, momentum, nesterov, loss_reduction,
    label_smoothing, mixup, cutout."""
    model = state.model
    setting = model.setting
    if augment:
        raise _not_ported("train-time augmentation (and cutout)")
    if float(getattr(setting, "mixup", 0.0) or 0.0) > 0.0:
        raise _not_ported("mixup")
    wd = float(getattr(setting, "weight_decay", 0.0))
    clip_norm = float(setting.gc_max_norm) if getattr(setting, "grad_clip_norm", False) else None
    clip_value = float(setting.gc_value) if getattr(setting, "grad_clip_value", False) else None
    mean_grad = getattr(setting, "loss_reduction", "sum") == "mean"
    smoothing = float(getattr(setting, "label_smoothing", 0.0) or 0.0)
    momentum = float(getattr(setting, "momentum", 0.9))
    nesterov = bool(getattr(setting, "nesterov", False))
    preprocess = _make_preprocess(model, norm, stats)

    def train_step(state: TrainState, x, y, w=None, generator: Optional[torch.Generator] = None):
        x, y, w = _on_device(_device_of(state.model), x, y, w)
        state.model.train()
        x = preprocess(x)
        params = state.params()
        with use_generator(generator):
            logits = state.model(x).float()
        loss_sum = ops.cross_entropy_sum(logits, y, w, label_smoothing=smoothing)
        objective = loss_sum
        if mean_grad:
            objective = loss_sum / torch.clamp_min(torch.sum(w), 1.0)
        values = torch.autograd.grad(state.loss_scale.scale_loss(objective),
                                     list(params.values()))
        grads = state.loss_scale.unscale_grads(dict(zip(params, values)))
        if clip_norm is not None:
            grads = optim.clip_by_global_norm(grads, clip_norm)
        if clip_value is not None:
            grads = optim.clip_by_value(grads, clip_value)
        current = {k: p.detach() for k, p in params.items()}
        if state.optimizer == "adam":
            new_params, state.opt_state = optim.adam_update(
                grads, state.opt_state, current, lr=state.lr, weight_decay=wd)
        else:
            new_params, state.opt_state = optim.sgd_update(
                grads, state.opt_state, current, lr=state.lr, weight_decay=wd,
                momentum=momentum, nesterov=nesterov)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        correct = ops.correct_count(logits.detach(), y, w)
        if debug:
            return loss_sum.detach(), correct, optim.global_norm(grads)
        return loss_sum.detach(), correct

    return train_step


def build_eval_step(model, norm: bool = False, stats=None):
    """Return eval_step(x, y, w=None) -> (loss, correct, preds): the eval-mode
    forward under no_grad, with the train step's preprocessing; loss the
    batch's fp32 CE sum, correct its fp32 count of right argmaxes, preds
    the argmax per row, all on the device."""
    preprocess = _make_preprocess(model, norm, stats)

    def eval_step(x, y, w=None):
        x, y, w = _on_device(_device_of(model), x, y, w)
        model.eval()
        with torch.no_grad():
            logits = model(preprocess(x)).float()
            return (ops.cross_entropy_sum(logits, y, w), ops.correct_count(logits, y, w),
                    logits.argmax(dim=-1))

    return eval_step


def _fresh_epoch_results() -> dict:
    return {
        "train_loss": [], "train_score": [], "valid_loss": [], "valid_score": [],
        "learning_rate": [], "train_epochs": 0, "total_epochs": 0, "train_time": 0.0,
    }


def _host_sum(values) -> float:
    """The sum of per-step device scalars, read back once."""
    if not values:
        return 0.0
    return float(np.sum(torch.stack(values).cpu().numpy()))


class Trainer:
    """fit / evaluate / test / checkpoint for one Model, on the model's
    device (build_model puts it on the card); the Trainer never moves it."""

    def __init__(self, model, optimizer: Optional[str] = None, mesh=None,
                 use_mesh: bool = False):
        if mesh is not None or use_mesh:
            raise NotImplementedError("data parallel is not ported yet "
                                      "(ROADMAP.md modules item 7)")
        self.model = model
        self.setting = model.setting
        self.device = _device_of(model)
        self.optimizer_name = optimizer or getattr(self.setting, "optimizer", "adam")
        self.state: Optional[TrainState] = None
        self.scheduler = None
        self.epoch_results: Optional[dict] = None
        self.class_names = None
        self.confusion_matrix = None
        self.classification_report = None
        self.model_path = self._checkpoint_path()
        self._train_step_fns = {}
        self._eval_step_fns = {}
        # optional hook called as epoch_hook(trainer, epoch_index) after
        # every epoch's bookkeeping (tail snapshots for weight averaging,
        # custom logging, ...)
        self.epoch_hook = None
        # async checkpoint writer (single thread: writes are serialized)
        self._ckpt_pool = None
        self._ckpt_future = None
        # data-order clock: the loaders fit() is feeding, whose epoch
        # counters travel with every checkpoint so resume replays the
        # uninterrupted run's permutations bit for bit
        self._fit_loaders = None
        self._resume_loader_epochs = None

    # ------------------------------------------------------------------
    # construction / state

    def _checkpoint_path(self) -> str:
        suffix = ckpt.SUFFIX_BEST_LOSS if self.setting.loss_optim else ckpt.SUFFIX_BEST_SCORE
        return ckpt.checkpoint_path(
            self.setting.output_dir, self.model.model_name, self.model.version, suffix
        )

    def init_state(self) -> TrainState:
        """A fresh TrainState over the model's current weights (build_model
        initialized them from the settings' seed) and a zero optimizer state."""
        self.state = create_train_state(self.model, self.setting, self.optimizer_name)
        return self.state

    def init_optimizer(self):
        """Fresh scheduler per Settings.lr_scheduler (reference
        init_optimizer, basemodel.py:58-83, hardwires plateau; step/cosine
        cover the ImageNet step-decay and from-scratch cosine recipes)."""
        kind = getattr(self.setting, "lr_scheduler", "plateau")
        lr = self.setting.learning_rate
        if kind == "plateau":
            mode = "min" if self.setting.loss_optim else "max"
            self.scheduler = ReduceLROnPlateau(
                lr=lr, mode=mode,
                factor=self.setting.lr_factor, patience=self.setting.lr_patience,
            )
        elif kind == "step":
            self.scheduler = StepDecay(
                lr=lr, step_size=int(self.setting.lr_step_size),
                gamma=float(self.setting.lr_factor),
            )
        elif kind == "cosine":
            self.scheduler = CosineDecay(
                lr=lr, total_epochs=int(self.setting.epochs),
                min_lr=float(self.setting.lr_min),
                warmup_epochs=int(self.setting.lr_warmup_epochs),
            )
        elif kind == "none":
            self.scheduler = ConstantLR(lr)
        else:
            raise ValueError(f"unknown lr_scheduler {kind!r}")

    # ------------------------------------------------------------------
    # steps

    def _get_train_step(self, augment: bool, norm: bool, debug: bool = False, stats=None):
        key = (augment, norm, debug, stats)
        if key not in self._train_step_fns:
            self._train_step_fns[key] = build_train_step(
                self.state, augment=augment, norm=norm, stats=stats, debug=debug)
        return self._train_step_fns[key]

    def _get_eval_step(self, norm: bool, stats=None):
        key = (norm, stats)
        if key not in self._eval_step_fns:
            self._eval_step_fns[key] = build_eval_step(self.model, norm, stats)
        return self._eval_step_fns[key]

    def reestimate_bn(self, loader: DataLoader, passes: int = 2,
                      augment: Optional[bool] = None, info: bool = True):
        """Re-estimate BN running statistics at fixed parameters
        (precise-BN style): train-mode forwards under no_grad over `loader`,
        FULL batches only (the zero-padded last batch would get the largest
        EMA weight of the pass), updating only the BN running mean/var
        (momentum-0.1 EMA over fresh batch statistics). The dropout masks
        come from the "bn_reestimate" stream. The model's mode is restored
        afterwards; if the loop is interrupted, the running statistics are
        restored too."""
        if self.state is None:
            raise RuntimeError(
                "reestimate_bn() requires trained parameters — call fit() or "
                "load_checkpoint() first"
            )
        aug, norm = self._resolve_flags(loader, train=True)
        if augment is not None:
            aug = bool(augment)
        if aug:
            raise _not_ported("BN re-estimation over augmented batches")
        preprocess = _make_preprocess(self.model, norm, self._resolve_stats(loader))
        host_n = loader._host_count() if hasattr(loader, "_host_count") else loader.num_examples
        n_full = max(host_n // loader.batch_size, 1)

        buffers = {k: b.clone() for k, b in self.model.named_buffers()}
        was_training = self.model.training
        steps = 0
        self.model.train()
        try:
            with torch.no_grad():
                for _ in range(int(passes)):
                    for i, (x, _, _) in enumerate(device_prefetch(loader, 2, self.device)):
                        if i >= n_full:
                            break
                        gen = generator_for(self.setting.seed, "bn_reestimate", steps,
                                            device=self.device)
                        with use_generator(gen):
                            self.model(preprocess(x))
                        steps += 1
                        if self.setting.sanity_check:
                            break
            _sync(self.device)
        except BaseException:
            with torch.no_grad():
                for k, b in self.model.named_buffers():
                    b.copy_(buffers[k])
            raise
        finally:
            self.model.train(was_training)
        if info:
            print(f"BN running stats re-estimated over {steps} train-mode batches")
        return self

    # ------------------------------------------------------------------
    # epoch phases

    def _resolve_flags(self, loader, train: bool):
        """Loader-attached flags win; otherwise fall back to Settings
        (data_augment applies to training only, as in mngrdata.py:139-190)."""
        augment = getattr(loader, "augment", None)
        if augment is None:
            augment = self.setting.data_augment and train
        norm = getattr(loader, "normalize", None)
        if norm is None:
            norm = self.setting.data_norm
        return bool(augment), bool(norm)

    def _resolve_stats(self, loader):
        """Per-channel normalization stats from the dataset (hashable, so
        they key the step caches; MNIST/CIFAR/CINIC each carry their own
        published constants, data/datasets.py)."""
        ds = getattr(loader, "dataset", None)
        mean = getattr(ds, "mean", None)
        std = getattr(ds, "std", None)
        if mean is None or std is None:
            mean, std = CINIC_MEAN, CINIC_STD
        return tuple(float(v) for v in mean), tuple(float(v) for v in std)

    @staticmethod
    def _refuse_scan(loader):
        if getattr(loader, "scan_epochs", False):
            raise _not_ported("a device-resident loader (the whole-epoch scan)")

    @staticmethod
    def _loader_host_count(loader) -> int:
        """Denominator for per-example epoch metrics: the number of examples
        THIS host iterated (padded rows carry weight 0)."""
        hc = getattr(loader, "_host_count", None)
        return hc() if callable(hc) else loader.num_examples

    def _run_train_epoch(self, loader: DataLoader, epoch_index: int):
        augment, norm = self._resolve_flags(loader, train=True)
        self._refuse_scan(loader)
        debug = bool(self.setting.debug)
        step_fn = self._get_train_step(augment, norm, debug, stats=self._resolve_stats(loader))

        # per-step metrics stay on the device until the epoch ends: a
        # float() per step would wait for the device every step and empty
        # the launch queue
        losses, corrects = [], []
        for step, (x, y, w) in enumerate(device_prefetch(loader, size=2, device=self.device)):
            gen = generator_for(self.setting.seed, "dropout", epoch_index, step,
                                device=self.device)
            if debug:
                loss, correct, gnorm = step_fn(self.state, x, y, w, gen)
                print(f"[debug] step {step}: x{tuple(x.shape)}/{x.dtype} "
                      f"loss={float(loss):.6f} correct={float(correct):.0f} "
                      f"grad_norm={float(gnorm):.4e}")
            else:
                loss, correct = step_fn(self.state, x, y, w, gen)
            losses.append(loss)
            corrects.append(correct)
            if self.setting.sanity_check:
                break
        n = self._loader_host_count(loader)
        return _host_sum(losses) / n, _host_sum(corrects) / n

    def _run_eval_epoch(self, loader: DataLoader, collect_preds: bool = False):
        _, norm = self._resolve_flags(loader, train=False)
        self._refuse_scan(loader)
        step_fn = self._get_eval_step(norm, stats=self._resolve_stats(loader))

        losses, corrects, preds, targets, weights = [], [], [], [], []
        for x, y, w in device_prefetch(loader, size=2, device=self.device):
            loss, correct, p = step_fn(x, y, w)
            losses.append(loss)
            corrects.append(correct)
            if collect_preds:
                preds.append(p)
                targets.append(y)
                weights.append(w)
            if self.setting.sanity_check:
                break
        n = self._loader_host_count(loader)
        out = (_host_sum(losses) / n, _host_sum(corrects) / n)
        if collect_preds:
            if not preds:
                return (*out, np.zeros(0, np.int64), np.zeros(0, np.int64))
            real = torch.cat(weights) > 0
            return (*out, torch.cat(targets)[real].cpu().numpy(),
                    torch.cat(preds)[real].cpu().numpy())
        return out

    # ------------------------------------------------------------------
    # fit (reference basemodel.py:395-495)

    def update_epoch_results(self):
        """Truncate history to the best epoch; prorate train time
        (reference basemodel.py:374-393)."""
        r = self.epoch_results
        best = r["train_epochs"]
        for k in ("train_loss", "valid_loss", "train_score", "valid_score",
                  "learning_rate"):
            r[k] = r[k][:best]
        epoch_time = float(r["train_time"]) / max(int(r["total_epochs"]), 1)
        r["train_time"] = epoch_time * int(best)
        r["total_epochs"] = best

    def _snapshot(self) -> dict:
        """Clones of every parameter and buffer: the step overwrites the live
        tensors in place, so a snapshot sharing their storage would follow
        them."""
        return {k: t.detach().clone() for k, t in self.model.state_dict().items()}

    def fit(self, trainset: DataLoader, validset: DataLoader, resume: bool = False):
        self._fit_loaders = {"train": trainset, "valid": validset}
        if resume:
            if self.state is None or self.epoch_results is None:
                raise RuntimeError("resume=True requires load_checkpoint() first")
            self.update_epoch_results()
            # restore the data-order clock: each loader's epoch counter is
            # rewound to its value when the resumed checkpoint was written,
            # so the next epoch draws the same seeded permutation the
            # uninterrupted run would have
            if self._resume_loader_epochs:
                for name, loader in self._fit_loaders.items():
                    if name in self._resume_loader_epochs and hasattr(loader, "epoch"):
                        loader.epoch = int(self._resume_loader_epochs[name])
                # replay the scheduler step the uninterrupted run applied
                # right AFTER the checkpointed epoch: improving-epoch saves
                # happen before scheduler.step(metric) (reference ordering,
                # basemodel.py:441-467), so the restored scheduler is one
                # step behind the run it came from. The plateau-drop case
                # needs no param rollback here — the checkpoint already
                # holds the best params the original run rolled back to.
                if self.epoch_results["valid_loss"]:
                    metric = (self.epoch_results["valid_loss"][-1]
                              if self.setting.loss_optim
                              else self.epoch_results["valid_score"][-1])
                    self.scheduler.step(metric)
            best_valid_score = self.epoch_results["valid_score"][-1] if self.epoch_results["valid_score"] else -1
            best_valid_loss = self.epoch_results["valid_loss"][-1] if self.epoch_results["valid_loss"] else float("inf")
        else:
            if self.state is None:
                self.init_state()
            self.init_optimizer()
            self.epoch_results = _fresh_epoch_results()
            best_valid_score = -1
            best_valid_loss = float("inf")

        # the step reads the learning rate from the state
        self.state.lr = float(self.scheduler.lr)
        best_snapshot = self._snapshot()
        epochs_no_improve = 0

        _sync(self.device)
        start_time = time.perf_counter()
        print("\n=== RESUME TRAINING ===\n" if resume else "\n=== START TRAINING ===\n")
        if self.setting.debug:
            self.print_summary()
            print("[debug] the per-layer activation trace is not ported yet "
                  "(ROADMAP.md modules item 8); per-step gradient norms follow")

        # global epoch index: continues the dropout RNG stream across resume
        # so a resumed run draws the same per-epoch masks the uninterrupted
        # run would (0 on a fresh fit; the completed-epoch count after
        # resume truncation)
        epoch_offset = int(self.epoch_results["total_epochs"])
        epoch = 0
        try:
            for epoch in range(self.setting.epochs):
                curr_lr = self.scheduler.lr

                train_loss, train_score = self._run_train_epoch(
                    trainset, epoch_offset + epoch)
                valid_loss, valid_score = self._run_eval_epoch(validset)

                self._end_epoch(train_loss, train_score, valid_loss, valid_score,
                                curr_lr, epoch + 1)

                if self.setting.loss_optim:
                    improved = valid_loss < best_valid_loss
                    if improved:
                        best_valid_loss = valid_loss
                else:
                    improved = valid_score > best_valid_score
                    if improved:
                        best_valid_score = valid_score
                if improved:
                    best_snapshot = self._snapshot()
                    # async write: serializing and writing the npz overlap
                    # the next epoch
                    self.save_checkpoint(block=False, loader_epochs={
                        name: int(ldr.epoch)
                        for name, ldr in self._fit_loaders.items()
                        if hasattr(ldr, "epoch")})
                    print("Best validation metric achieved; parameters snapshotted")
                    epochs_no_improve = 0
                else:
                    epochs_no_improve += 1

                metric = valid_loss if self.setting.loss_optim else valid_score
                new_lr = self.scheduler.step(metric)
                if curr_lr != new_lr:
                    if isinstance(self.scheduler, ReduceLROnPlateau):
                        # rollback to best params when plateau drops the LR
                        # (basemodel.py:465-467; the reference restores model
                        # weights only, optimizer moments stay). The snapshot
                        # is copied in, so it survives later steps.
                        self.model.load_state_dict(best_snapshot)
                        print(f"No improvement after {self.setting.lr_patience + 1} epochs: "
                              f"lr -> {new_lr:.2e}, continuing from best parameters")
                    self.state.lr = float(new_lr)

                if self.epoch_hook is not None:
                    self.epoch_hook(self, epoch)

                if self.setting.early_stop and self.setting.es_patience + 1 == epochs_no_improve:
                    print(f"Early stopped after {epoch + 1} epochs "
                          f"({epochs_no_improve} non-improving)")
                    break
        except BaseException:
            # a mid-run failure must not swallow an async checkpoint-write
            # error silently: the best checkpoint may be missing. Surface it
            # as a warning — never mask the original exception with the
            # writer's.
            if self._ckpt_future is not None:
                fut, self._ckpt_future = self._ckpt_future, None
                err = fut.exception()
                if err is not None:
                    print(f"WARNING: async checkpoint write failed: {err!r}")
            raise

        _sync(self.device)
        train_time = time.perf_counter() - start_time
        self.epoch_results["train_time"] = float(self.epoch_results["train_time"]) + train_time
        print(f"Training time: {train_time:.3f}s")

        # merge full history into the best checkpoint (basemodel.py:482-491)
        self.epoch_results["total_epochs"] += epoch + 1
        total_results = {k: (list(v) if isinstance(v, list) else v)
                         for k, v in self.epoch_results.items()}
        try:
            best_meta = self.load_checkpoint(path=self.model_path)
            total_results["train_epochs"] = best_meta["epoch_results"]["train_epochs"]
            self.epoch_results = total_results
            # the merged checkpoint keeps the BEST epoch's data-order clock
            # (not the final counters) — resume must replay from there
            self.save_checkpoint(
                path=self.model_path,
                loader_epochs=best_meta.get("extra", {}).get("loader_epochs"))
        except FileNotFoundError:
            self.epoch_results = total_results

        print("\n=== TRAINING IS FINISHED ===\n")
        return self

    def _end_epoch(self, train_loss, train_score, valid_loss, valid_score, lr, epoch):
        r = self.epoch_results
        already = r["total_epochs"]
        r["train_loss"].append(train_loss)
        r["valid_loss"].append(valid_loss)
        r["train_score"].append(train_score)
        r["valid_score"].append(valid_score)
        r["learning_rate"].append(lr)
        r["train_epochs"] = already + epoch
        print(f"EPOCH {already + epoch}/{already + self.setting.epochs}")
        print(f"Train Loss: {train_loss:.6f}  Valid Loss: {valid_loss:.6f}")
        print(f"Train Acc:  {train_score * 100:.3f}%  Valid Acc: {valid_score * 100:.3f}%")
        print(f"LR: {lr}")
        self._log_metrics({
            "epoch": already + epoch, "train_loss": train_loss,
            "valid_loss": valid_loss, "train_score": train_score,
            "valid_score": valid_score, "learning_rate": lr,
        })

    def _log_metrics(self, record: dict):
        """Structured per-epoch metrics (jsonl) alongside the checkpoints —
        the machine-readable twin of the epoch_results dict."""
        try:
            os.makedirs(self.setting.output_dir, exist_ok=True)
            path = os.path.join(self.setting.output_dir,
                                f"{self.model.model_name}-metrics.jsonl")
            with open(path, "a") as f:
                f.write(json.dumps({"model": self.model.model_name,
                                    "version": self.model.version, **record}) + "\n")
        except OSError:
            pass  # metrics logging must never take down training

    # ------------------------------------------------------------------
    # evaluate / test (reference basemodel.py:498-722)

    def eval_score(self, y_targets, y_preds, info=True) -> float:
        acc = M.accuracy_score(y_targets, y_preds)
        if info:
            print(f"Accuracy: {acc * 100:.2f}%")
        return acc

    def _require_state(self, what: str):
        """Scoring an uninitialized net would silently benchmark random
        weights; the reference hard-exits on a missing checkpoint
        (basemodel.py:927-932)."""
        if self.state is None:
            raise RuntimeError(
                f"{what}() called before any parameters exist — call fit() or "
                "load_checkpoint() first (or init_state() explicitly to "
                "really score random weights)"
            )

    def evaluate(self, loader: DataLoader, info: bool = True) -> float:
        self._require_state("evaluate")
        loss, score, targets, preds = self._run_eval_epoch(loader, collect_preds=True)
        num_classes = self.setting.num_classes
        self.class_names = getattr(loader.dataset, "class_names", None)
        self.confusion_matrix = M.confusion_matrix(targets, preds, num_classes)
        report, report_str = M.classification_report(
            targets, preds, num_classes, self.class_names
        )
        self.classification_report = report
        if info:
            print(report_str)
        return self.eval_score(targets, preds, info=info)

    def inference_time(self, times: np.ndarray, num_images: int, info=True,
                       full_batches: Optional[np.ndarray] = None):
        """Latency/throughput stats (reference basemodel.py:579-599).

        total/throughput cover every batch; the per-image mean±std follow
        the reference formula (per-batch latency / batch_size) but are
        computed over FULL batches only — the zero-padded final batch has
        the same latency at fewer real images, so including it would skew
        the per-image statistic."""
        total_s = float(np.sum(times))
        fps = num_images / total_s if total_s > 0 else 0.0
        bs = max(self.setting.batch_size, 1)
        sample = times if full_batches is None else times[np.asarray(full_batches, bool)]
        if len(sample) == 0:
            sample = times
        per_image_mean = float(np.mean(sample / bs)) if len(sample) else 0.0
        per_image_std = float(np.std(sample / bs)) if len(sample) else 0.0
        if info:
            print(f"Inference time: total {total_s:.3f}s, "
                  f"per-image {per_image_mean * 1e3:.3f}ms ± {per_image_std * 1e3:.3f}ms, "
                  f"throughput {fps:.1f} img/s")
        return total_s, per_image_mean, per_image_std, fps

    def test(self, loader: DataLoader, num_warmup: int = 50):
        """Timed benchmark testing: warmup forwards on a random batch of the
        loader's dtype, then per-batch timed eval fenced by the predictions'
        device-to-host copy, classification report, and the
        test_sample_size-subset accuracy sampling used for cross-model
        statistical comparison (basemodel.py:601-722). Returns (subset
        scores, per-batch seconds, img/s)."""
        self._require_state("test")
        # re-pin reproducible order before the timed loop (the reference
        # calls set_reproducible_mode(seed) here, basemodel.py:650-651):
        # the loader's epoch counter is our only order state, so resetting
        # it makes the benchmark's batch order — and hence the subset
        # accuracy samples — a function of the seed alone
        if hasattr(loader, "epoch"):
            loader.epoch = 0
        _, norm = self._resolve_flags(loader, train=False)
        self._refuse_scan(loader)
        step_fn = self._get_eval_step(norm, stats=self._resolve_stats(loader))

        bs = loader.batch_size
        shape = (bs, *self.model.input_shape_nhwc)
        gen = generator_for(self.setting.seed, "bench", device=self.device)
        # the warmup batch has the loader's transfer dtype (uint8 raw path
        # or float32), so it warms the path the timed loop takes
        raw = getattr(loader.dataset, "load_raw", None)
        feeds_uint8 = False
        if raw is not None and len(loader.dataset):
            feeds_uint8 = raw(np.array([0]))[0].dtype == np.uint8
        if feeds_uint8:
            x_w = torch.randint(0, 256, shape, dtype=torch.uint8, device=self.device,
                                generator=gen)
        else:
            x_w = torch.rand(shape, device=self.device, generator=gen)
        y_w = torch.zeros((bs,), dtype=torch.int32, device=self.device)
        w_w = torch.ones((bs,), dtype=torch.float32, device=self.device)
        for _ in range(num_warmup):
            step_fn(x_w, y_w, w_w)
        _sync(self.device)

        times = []
        full_batches = []
        all_preds, all_targets = [], []
        num_images = 0
        for x, y, w in device_prefetch(loader, size=2, device=self.device):
            # the device-to-host copy of the predictions is the timing
            # fence, and retrieving them is part of the measured protocol
            # (reference basemodel.py:637-668)
            t0 = time.perf_counter()
            _, _, preds = step_fn(x, y, w)
            preds_host = preds.cpu().numpy()
            times.append(time.perf_counter() - t0)
            k = int((w > 0).sum())
            num_images += k
            full_batches.append(k == loader.batch_size)
            all_preds.append(preds_host[:k])
            all_targets.append(y[:k].cpu().numpy())
            if self.setting.sanity_check:
                break

        targets = np.concatenate(all_targets)
        preds = np.concatenate(all_preds)
        num_classes = self.setting.num_classes
        self.class_names = getattr(loader.dataset, "class_names", None)
        self.confusion_matrix = M.confusion_matrix(targets, preds, num_classes)
        self.classification_report, report_str = M.classification_report(
            targets, preds, num_classes, self.class_names
        )
        print(report_str)

        # subset accuracy samples for statistical model comparison
        part = max(len(targets) // max(self.setting.test_sample_size, 1), 1)
        scores = [
            M.accuracy_score(targets[i: i + part], preds[i: i + part])
            for i in range(0, len(targets), part)
            if len(targets[i: i + part])
        ]
        times_arr = np.asarray(times)
        _, _, _, fps = self.inference_time(times_arr, num_images,
                                           full_batches=np.asarray(full_batches))
        return scores, times_arr, fps

    # ------------------------------------------------------------------
    # checkpointing (reference basemodel.py:834-948)

    def _ckpt_barrier(self):
        """Wait for an in-flight async checkpoint write (and surface its
        error, if any) before anything reads or replaces the file."""
        if self._ckpt_future is not None:
            fut, self._ckpt_future = self._ckpt_future, None
            fut.result()

    def close(self):
        """Flush the async checkpoint writer and release its thread.
        Raises if the last in-flight write failed."""
        try:
            self._ckpt_barrier()
        finally:
            if self._ckpt_pool is not None:
                self._ckpt_pool.shutdown(wait=True)
                self._ckpt_pool = None

    def __del__(self):
        pool = getattr(self, "_ckpt_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    def save_checkpoint(self, path: Optional[str] = None,
                        block: bool = True,
                        loader_epochs: Optional[dict] = None) -> str:
        """Write the full-state checkpoint.

        block=False (fit()'s improving-epoch saves) clones every tensor on
        the device, on the step's stream, before it returns; a background
        writer thread then copies the clones to the host, serializes and
        publishes the file. The clones are what the file holds: the next
        step overwrites the live tensors in place. A snapshot of
        epoch_results travels with the payload so later epochs can't
        mutate what gets written."""
        path = path or self.model_path
        self._ckpt_barrier()  # one outstanding write at a time
        meta = dict(
            epoch_results=copy.deepcopy(self.epoch_results
                                        or _fresh_epoch_results()),
            settings_dict=self.setting.to_dict(),
            scheduler_state=self.scheduler.to_state() if self.scheduler else {},
            optimizer_name=self.optimizer_name,
            extra={"arch": getattr(self.model, "registry_name", self.model.arch),
                   "model_name": self.model.model_name,
                   # data-order clock: loader epoch counters at save time
                   # (fit passes them; None for manual saves)
                   **({"loader_epochs": dict(loader_epochs)}
                      if loader_epochs else {})},
        )
        model = self.model
        if block:
            return ckpt.save_checkpoint(
                path, **ckpt.state_arrays(model, ckpt.state_tensors(self.state, clone=False)),
                **meta)
        tensors = ckpt.state_tensors(self.state, clone=True)

        def gather_and_write():
            return ckpt.save_checkpoint(path, **ckpt.state_arrays(model, tensors), **meta)

        if self._ckpt_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._ckpt_pool = ThreadPoolExecutor(
                1, thread_name_prefix="ckpt-writer")
        self._ckpt_future = self._ckpt_pool.submit(gather_and_write)
        return path

    def load_checkpoint(self, path: Optional[str] = None) -> dict:
        """Restore params/BN state/opt/scheduler/history from a checkpoint of
        either package; returns the checkpoint meta."""
        self._ckpt_barrier()  # never read under an in-flight async write
        if path is None:
            path = ckpt.get_last_checkpoint(self.setting.output_dir, self.model.model_name)
            if path is None:
                raise FileNotFoundError(
                    f"no checkpoint for {self.model.model_name} in {self.setting.output_dir}"
                )
        trees, meta = ckpt.load_checkpoint(path)
        bridge.load_jax_variables(self.model, {"params": trees["params"],
                                               "state": trees["model_state"]})
        # the optimizer kind travels with the checkpoint (reference
        # load_checkpoint restores the optimizer object wholesale,
        # basemodel.py:935-943) — the restored state must drive the
        # matching update rule, whatever this Trainer was constructed with
        self.optimizer_name = meta.get("optimizer", self.optimizer_name)
        self.state = TrainState(
            model=self.model, optimizer=self.optimizer_name,
            opt_state=ckpt.rebuild_opt_state(self.model, trees["opt_state"],
                                             self.optimizer_name),
            lr=float(trees["lr"]), loss_scale=LossScale(float(trees["loss_scale"])))
        self.epoch_results = meta["epoch_results"]
        if meta.get("scheduler"):
            self.scheduler = scheduler_from_state(meta["scheduler"])
        else:
            self.init_optimizer()
        # re-apply saved hyper-parameters onto the live Settings, and build
        # the steps anew from them
        hp = {k: v for k, v in meta["settings"].items()
              if k in self.setting.get_hparams_names()}
        self.setting.load_values(hp)
        self._train_step_fns.clear()
        self._eval_step_fns.clear()
        # data-order clock for fit(resume=True): rewind the loaders to the
        # permutation epoch this checkpoint was written at
        self._resume_loader_epochs = meta.get("extra", {}).get("loader_epochs")
        return meta

    def update_checkpoint(self, path: Optional[str] = None):
        self.save_checkpoint(path)

    def print_summary(self):
        print(self.model.summary())

    def debug_trace(self, *args, **kwargs):
        """The JAX package's per-layer activation trace (nn/trace.py)."""
        raise NotImplementedError("debug_trace needs nn/trace.py, which is not ported yet "
                                  "(ROADMAP.md modules item 8)")
