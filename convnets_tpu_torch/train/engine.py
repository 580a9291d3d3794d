"""The train and eval steps and the Trainer (counterpart of
convnets_tpu/train/engine.py: Trainer._build_train_step :190-278,
_build_eval_step :308-326, and Trainer).

Train step: preprocess in the JAX package's order (engine.py:147-188:
uint8 → /255; RandomResizedCrop where the batch's size differs from the
model's, else crop + flip (+ affine); or, without augmentation, the center
crop where the sizes differ; normalize; cutout; cast to the compute
dtype) → mixup (one λ ~ Beta(α, α) and one permutation per batch) →
train-mode forward, fp32 logits → sum-CE (label smoothing, example
weights; with mixup λ·CE(y) + (1 − λ)·CE(y[perm])) and the sum or
per-example-mean objective →
× loss scale → gradients → ÷ loss scale → clipping → Adam or SGD →
correct count. The step updates the TrainState in place: parameters and
optimizer state are overwritten after the update, and the BN running
statistics during the forward (the port mutates where the JAX package
returns a new state).

Trainer: fit (best-checkpoint gating on valid loss or score, the async
checkpoint, plateau rollback, early stop, resume with the data-order
clock), evaluate, test, reestimate_bn and checkpoints, on one device: the
model's. An epoch takes one of three routes, chosen as the JAX engine
chooses (engine.py:568-573, :667-682, :738-756):
  * a loader whose split lives on the device (`scan_epochs`: a
    DeviceCacheLoader) runs the epoch as replays of one captured step
    (train/graph.py StepGraph, the counterpart of the whole-epoch
    `lax.scan`): the epoch's index and weight matrices cross once, and
    the per-step losses are read back once;
  * a ShardRotationLoader (`chunked`) runs it chunk by chunk through the
    same graph over its rotating chunk buffer;
  * any other loader, or `debug` or `sanity_check`, runs the per-step
    loop over `data.device_prefetch` batches, the per-step loss and
    correct count kept on the device until the epoch ends.
The random draws of step s of global epoch e come from the seeds of
generator_for(seed, stream, e, s): "dropout" for the masks, "augment",
"cutout" and "mixup" for the data side (`DataRng`); the replayed route
reseeds long-lived generators to those seeds before each step.

Data parallel (`Trainer(model, mesh=make_mesh())`, parallel/mesh.py):
one process per card, each rank feeding its loader's host slice
(host_id = its data rank, num_hosts = the data group's size) as its block
of the global batch. The parameters and BN buffers start from rank 0's
(broadcast), every BN site reduces its statistics over the data group
while the mesh's steps run (`mesh_scope`), and the step sums the gradients
over the group as one flat fp32 buffer before clipping: the global
batch's gradient, a sum as in the JAX step. The dropout, augmentation,
cutout and mixup-permutation draws of step (e, s) on data rank r come from
the streams at (e, s, r), which at r = 0 are those at (e, s), so rank 0
draws what one process draws; mixup's λ is one host draw at (e, s),
the same on every rank. Only data rank 0 writes checkpoints and metrics;
the others wait at a barrier before they read one.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from convnets_tpu_torch import bridge, ops
from convnets_tpu_torch.core.precision import LossScale
from convnets_tpu_torch.core.rng import StepGenerators, generator_for
from convnets_tpu_torch.data.augment import (
    MixupDraws, augment_batch, center_crop_resize, cutout, mixup_apply, mixup_lambda, mixup_perm,
    normalize, random_resized_crop_batch,
)
from convnets_tpu_torch.data.datasets import CINIC_MEAN, CINIC_STD
from convnets_tpu_torch.data.loader import DataLoader, device_prefetch
from convnets_tpu_torch.nn import use_generator
from convnets_tpu_torch.parallel.mesh import (
    broadcast_object, broadcast_tensors, data_group, data_rank, data_size, data_sum_,
    make_mesh, mesh_backend, mesh_scope,
)
from convnets_tpu_torch.train import checkpoint as ckpt
from convnets_tpu_torch.train import metrics as M
from convnets_tpu_torch.train import optim
from convnets_tpu_torch.train.graph import StepGraph
from convnets_tpu_torch.train.scheduler import (
    ConstantLR, CosineDecay, ReduceLROnPlateau, StepDecay, scheduler_from_state,
)
from convnets_tpu_torch.train.state import TrainState, create_train_state


class DataRng(NamedTuple):
    """The generators of one step's data side: on the batch's device the
    augmentation's, the cutout's and the mixup permutation's; on the host
    the mixup λ's."""

    augment: torch.Generator
    cutout: torch.Generator
    mixup: torch.Generator
    mixup_host: torch.Generator


def data_rng(seed: int, device, *index: int, rank: int = 0) -> DataRng:
    """Step `index` = (e, s)'s DataRng on data rank `rank`: the "augment",
    "cutout" and "mixup" streams at (e, s, rank) on the device (at (e, s)
    for rank 0), and the host's λ generator at (e, s) on every rank."""
    return DataRng(*(generator_for(seed, stream, *index, rank, device=device)
                     for stream in ("augment", "cutout", "mixup")),
                   generator_for(seed, "mixup", *index))


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


def _make_preprocess(model, norm: bool, stats, augment: bool = False, do_affine: bool = True,
                     cut: int = 0):
    """The input side of the train, eval and BN re-estimation steps, in the
    JAX package's order (engine.py:147-188): uint8 → /255 on the device;
    with `augment`, RandomResizedCrop where the batch's size differs from
    the model's, else crop + flip (+ affine with `do_affine`); without, the
    center crop where the sizes differ; normalize; with `augment`, cutout
    of side `cut` (after normalize: a zero is the dataset mean); cast to
    the compute dtype. preprocess(x, rng) draws from rng, a DataRng, which
    an augmenting step must pass."""
    compute_dtype = model.policy.compute_dtype
    target_hw = tuple(model.input_shape_nhwc[:2])
    # CINIC-10's statistics are the default of the JAX package's
    # data/augment.py:normalize; placed on the device once, so that a step
    # copies nothing for them
    mean, std = (torch.as_tensor(np.asarray(v, np.float32), device=_device_of(model))
                 for v in ((CINIC_MEAN, CINIC_STD) if stats is None else stats))

    def preprocess(x, rng: Optional[DataRng] = None):
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        if augment and rng is None:
            raise ValueError("an augmenting step needs its DataRng")
        if augment and tuple(x.shape[1:3]) != target_hw:
            x = random_resized_crop_batch(rng.augment, x, target_hw)
        elif augment:
            x = augment_batch(rng.augment, x, do_affine=do_affine)
        elif tuple(x.shape[1:3]) != target_hw:
            x = center_crop_resize(x, target_hw)
        if norm:
            x = normalize(x, mean, std)
        if augment and cut > 0:
            x = cutout(rng.cutout, x, cut)
        return x.to(compute_dtype)

    return preprocess


def _sum_over_ranks(grads: dict) -> dict:
    """The gradients summed over the active mesh's data group as one flat
    fp32 buffer (one all-reduce), each back in its shape and dtype."""
    flat = torch.cat([g.float().reshape(-1) for g in grads.values()])
    data_sum_(flat, 1)
    out, at = {}, 0
    for k, g in grads.items():
        out[k] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
        at += g.numel()
    return out


def _data_flags(setting):
    """(do_affine, cutout side, mixup α) of the settings."""
    return (bool(getattr(setting, "augment_affine", True)),
            int(getattr(setting, "cutout", 0) or 0),
            float(getattr(setting, "mixup", 0.0) or 0.0))


class TrainStep:
    """One train step, in two parts: `prepare(state, rng)`, the host's part
    (advance Adam's step count; fill the state's StepScalars: the learning
    rate, Adam's bias corrections for that count, mixup's λ drawn from
    rng.mixup_host), and `run(state, x, y, w, generator, rng)`, the
    device's, which reads only tensors and generators and changes nothing
    on the host, so it can be captured once and replayed (train/graph.py).
    Calling the step does both. With a `mesh`, `run` makes it the active
    mesh (the BN sites reduce over its data group) and sums the gradients
    over that group before clipping; loss_reduction "mean" then divides by
    the global Σw. Without one, it makes no mesh active."""

    def __init__(self, state: TrainState, *, augment: bool = False, norm: bool = False,
                 stats=None, debug: bool = False, mesh=None, axis: str = "data"):
        model = state.model
        setting = model.setting
        self.mesh, self.axis = mesh, axis
        do_affine, cut, self.mix_a = _data_flags(setting)
        self.debug = debug
        self.wd = float(getattr(setting, "weight_decay", 0.0))
        self.clip_norm = (float(setting.gc_max_norm) if getattr(setting, "grad_clip_norm", False)
                          else None)
        self.clip_value = (float(setting.gc_value) if getattr(setting, "grad_clip_value", False)
                           else None)
        self.mean_grad = getattr(setting, "loss_reduction", "sum") == "mean"
        self.smoothing = float(getattr(setting, "label_smoothing", 0.0) or 0.0)
        self.momentum = float(getattr(setting, "momentum", 0.9))
        self.nesterov = bool(getattr(setting, "nesterov", False))
        self.preprocess = _make_preprocess(model, norm, stats, augment, do_affine, cut)

    def prepare(self, state: TrainState, rng: Optional[DataRng] = None) -> None:
        values = {"lr": state.lr}
        if state.optimizer == "adam":
            state.opt_state = state.opt_state._replace(count=state.opt_state.count + 1)
            values["bc1"], values["bc2"] = optim.adam_bias_corrections(state.opt_state.count)
        if self.mix_a > 0.0:
            if rng is None:
                raise ValueError("a mixup step needs its DataRng")
            values["lam"] = mixup_lambda(rng.mixup_host, self.mix_a)
        state.scalars.fill(**values)

    def run(self, state: TrainState, x, y, w, generator: Optional[torch.Generator] = None,
            rng: Optional[DataRng] = None):
        with mesh_scope(self.mesh, self.axis):
            return self._run(state, x, y, w, generator, rng)

    def _run(self, state: TrainState, x, y, w, generator, rng):
        sc = state.scalars
        state.model.train()
        x = self.preprocess(x, rng)
        if self.mix_a > 0.0:
            if rng is None:
                raise ValueError("a mixup step needs its DataRng")
            draws = MixupDraws(sc.lam, mixup_perm(rng.mixup, x.shape[0]))
            x, y_mix = mixup_apply(x, draws, y)
        params = state.params()
        with use_generator(generator):
            logits = state.model(x).float()
        if self.mix_a > 0.0:
            loss_sum = ops.mixup_cross_entropy_sum(logits, y, y_mix, sc.lam, w,
                                                   label_smoothing=self.smoothing)
        else:
            loss_sum = ops.cross_entropy_sum(logits, y, w, label_smoothing=self.smoothing)
        objective = loss_sum
        if self.mean_grad:
            total = torch.sum(w)
            if self.mesh is not None:
                total = total.reshape(1)
                data_sum_(total, 1)
                total = total[0]
            objective = loss_sum / torch.clamp_min(total, 1.0)
        values = torch.autograd.grad(state.loss_scale.scale_loss(objective),
                                     list(params.values()))
        grads = state.loss_scale.unscale_grads(dict(zip(params, values)))
        if self.mesh is not None:
            grads = _sum_over_ranks(grads)
        if self.clip_norm is not None:
            grads = optim.clip_by_global_norm(grads, self.clip_norm)
        if self.clip_value is not None:
            grads = optim.clip_by_value(grads, self.clip_value)
        current = {k: p.detach() for k, p in params.items()}
        # the moments update in place; the count moved in prepare
        if state.optimizer == "adam":
            new_params, _ = optim.adam_update(grads, state.opt_state, current, lr=sc.lr,
                                              weight_decay=self.wd, bias=(sc.bc1, sc.bc2))
        else:
            new_params, _ = optim.sgd_update(grads, state.opt_state, current, lr=sc.lr,
                                             weight_decay=self.wd, momentum=self.momentum,
                                             nesterov=self.nesterov)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        correct = ops.correct_count(logits.detach(), y, w)
        if self.debug:
            return loss_sum.detach(), correct, optim.global_norm(grads)
        return loss_sum.detach(), correct

    def __call__(self, state: TrainState, x, y, w=None,
                 generator: Optional[torch.Generator] = None, rng: Optional[DataRng] = None):
        x, y, w = _on_device(_device_of(state.model), x, y, w)
        self.prepare(state, rng)
        return self.run(state, x, y, w, generator, rng)


def build_train_step(state: TrainState, *, augment: bool = False, norm: bool = False,
                     stats=None, debug: bool = False, mesh=None, axis: str = "data") -> TrainStep:
    """Return train_step(state, x, y, w=None, generator=None, rng=None) ->
    (loss, correct), or (loss, correct, gradient global norm) when `debug`
    (a TrainStep).

    x: (N, H, W, C) uint8 or float batch (at another size than the model's
    only with `augment`, which then crops it to size); y (N,) int labels; w
    (N,) 0/1 example weights (all ones when None), each moved to the
    model's device if it lies elsewhere; generator: the torch.Generator of
    the dropout masks, on x's device; rng: the step's DataRng, needed with
    `augment` or mixup. loss is the batch's CE sum (mixed with mixup),
    correct its count of right argmaxes against y, both fp32 scalars on
    the device. Settings read: weight_decay, grad_clip_norm/gc_max_norm,
    grad_clip_value/gc_value, momentum, nesterov, loss_reduction,
    label_smoothing, augment_affine, cutout, mixup. mesh: a data-parallel
    mesh whose data dimension is `axis` (TrainStep)."""
    return TrainStep(state, augment=augment, norm=norm, stats=stats, debug=debug, mesh=mesh,
                     axis=axis)


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
    """The sum of per-step device scalars (a list of 0-d tensors, or one
    1-d tensor), read back once and summed by numpy."""
    if not isinstance(values, torch.Tensor):
        if not values:
            return 0.0
        values = torch.stack(values)
    return float(np.sum(values.cpu().numpy()))


class Trainer:
    """fit / evaluate / test / checkpoint for one Model, on the model's
    device (build_model puts it on the card); the Trainer never moves it.

    mesh: a data-parallel DeviceMesh (parallel/mesh.py make_mesh) whose
    data dimension is Settings.data_axis; use_mesh=True builds
    make_mesh(axis_name=data_axis, mesh_shape=Settings.mesh_shape) over the
    initialized default group. Either needs init_distributed() first. The
    JAX Trainer's use_mesh defaults to True (a mesh over the local
    devices); the port's to False, since its mesh spans processes."""

    def __init__(self, model, optimizer: Optional[str] = None, mesh=None,
                 use_mesh: bool = False):
        self.model = model
        self.setting = model.setting
        self.axis = getattr(self.setting, "data_axis", None) or "data"
        if mesh is not None or use_mesh:
            if not dist.is_initialized():
                raise RuntimeError("Trainer(mesh=...) needs an initialized process group: call "
                                   "convnets_tpu_torch.parallel.init_distributed() first")
            if mesh is None:
                mesh = make_mesh(axis_name=self.axis,
                                 mesh_shape=getattr(self.setting, "mesh_shape", None))
        self.mesh = mesh
        self.rank = 0 if mesh is None else data_rank(mesh, self.axis)
        self.world = 1 if mesh is None else data_size(mesh, self.axis)
        if self.world > 1:
            # the checkpoint files are named by the model's version (its
            # build time): every rank names rank 0's file
            model.version = broadcast_object(model.version, mesh, self.axis)
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
        # the replayed-graph epochs' steps (train/graph.py StepGraph), keyed
        # as the JAX engine keys its epoch functions, plus the split's address
        self._epoch_fns = {}
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
        """Fresh weights and a fresh TrainState: the parameters and BN
        buffers are drawn anew from the settings' seed (Model.init, what
        build_model gives), as the JAX package's init_state draws them from
        key_for(seed, "init"), and the optimizer state starts at zero."""
        self.model.init()
        return self._new_state()

    def _new_state(self) -> TrainState:
        """A TrainState over the model's current weights with a zero
        optimizer state; the steps built over the old state are dropped."""
        self._train_step_fns.clear()
        self._eval_step_fns.clear()
        self._epoch_fns.clear()
        self._replicate()
        self.state = create_train_state(self.model, self.setting, self.optimizer_name)
        return self.state

    def _replicate(self) -> None:
        """With a mesh, every parameter and buffer becomes data rank 0's."""
        if self.mesh is not None:
            with torch.no_grad():
                broadcast_tensors([t.detach() for t in self.model.state_dict().values()],
                                  self.mesh, self.axis)

    def _over_ranks(self, *values: float) -> list:
        """The host numbers summed over the data group when it has more than
        one rank (one all-reduce in fp64 on the model's device), else as
        they are."""
        if self.world == 1:
            return [float(v) for v in values]
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=data_group(self.mesh, self.axis))
        return t.tolist()

    def _check_shard(self, loader) -> None:
        """Under more than one rank, a train loader must be this rank's host
        slice, and every rank's slice must give the same number of steps
        (each step runs collectives that every rank joins)."""
        if self.world == 1:
            return
        hosts, host = getattr(loader, "num_hosts", 1), getattr(loader, "host_id", 0)
        if (hosts, host) != (self.world, self.rank):
            raise ValueError(f"data rank {self.rank} of {self.world} needs its loader's host "
                             f"slice (host_id={self.rank}, num_hosts={self.world}), got "
                             f"host_id={host}, num_hosts={hosts}")
        n, bs = loader.num_examples, loader.batch_size
        counts = [n // hosts + (1 if h < n % hosts else 0) for h in range(hosts)]
        drop_last = getattr(loader, "drop_last", False)
        steps = {c // bs if drop_last else -(-c // bs) for c in counts}
        if len(steps) > 1:
            raise ValueError(f"{n} examples over {hosts} ranks at batch {bs} give the ranks "
                             f"{sorted(steps)} steps: every rank must take the same number "
                             f"(drop_last=True, or a split size that divides evenly)")

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
        key = (augment, norm, debug, stats, _data_flags(self.setting))
        if key not in self._train_step_fns:
            self._train_step_fns[key] = build_train_step(
                self.state, augment=augment, norm=norm, stats=stats, debug=debug,
                mesh=self.mesh, axis=self.axis)
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
        (momentum-0.1 EMA over fresh batch statistics), through the train
        step's preprocessing (augmented where the loader is). The dropout
        masks come from the "bn_reestimate" stream at (step,), the
        augmentation and cutout from it at (step, 1) and (step, 2). The
        model's mode is restored afterwards; if the loop is interrupted,
        the running statistics are restored too."""
        if self.state is None:
            raise RuntimeError(
                "reestimate_bn() requires trained parameters — call fit() or "
                "load_checkpoint() first"
            )
        aug, norm = self._resolve_flags(loader, train=True)
        if augment is not None:
            aug = bool(augment)
        do_affine, cut, _ = _data_flags(self.setting)
        preprocess = _make_preprocess(self.model, norm, self._resolve_stats(loader), aug,
                                      do_affine, cut)
        host_n = loader._host_count() if hasattr(loader, "_host_count") else loader.num_examples
        if self.world > 1:
            # the smallest rank's share: every rank runs the same forwards
            host_n = loader.num_examples // self.world
        n_full = max(host_n // loader.batch_size, 1)

        buffers = {k: b.clone() for k, b in self.model.named_buffers()}
        was_training = self.model.training
        steps = 0
        self.model.train()
        try:
            with torch.no_grad(), mesh_scope(self.mesh, self.axis):
                for _ in range(int(passes)):
                    for i, (x, _, _) in enumerate(device_prefetch(loader, 2, self.device)):
                        if i >= n_full:
                            break
                        gen = generator_for(self.setting.seed, "bn_reestimate", steps, 0,
                                            self.rank, device=self.device)
                        rng = None
                        if aug:
                            aug_gen, cut_gen = (generator_for(
                                self.setting.seed, "bn_reestimate", steps, k, self.rank,
                                device=self.device) for k in (1, 2))
                            rng = DataRng(aug_gen, cut_gen, None, None)
                        with use_generator(gen):
                            self.model(preprocess(x, rng))
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
    def _loader_host_count(loader) -> int:
        """Denominator for per-example epoch metrics: the number of examples
        THIS host iterated (padded rows carry weight 0)."""
        hc = getattr(loader, "_host_count", None)
        return hc() if callable(hc) else loader.num_examples

    def _scan_denominator(self, loader) -> int:
        """Denominator of the replayed epochs' per-example means: with more
        than one rank the global count (their loss and correct sums are
        summed over the ranks, as the JAX package's replicated sums are),
        else the examples this host's loader serves, as in the per-step
        loop."""
        if self.world > 1:
            return loader.num_examples
        return self._loader_host_count(loader)

    def _scan_means(self, loader, *sums: float) -> tuple:
        """A replayed epoch's per-example means (`_scan_denominator`)."""
        n = self._scan_denominator(loader)
        return tuple(v / n for v in self._over_ranks(*sums))

    def _step_means(self, loader, *sums: float) -> tuple:
        """A per-step epoch's per-example means over this rank's count
        (`_loader_host_count`); with more than one rank the sums and the
        counts are summed over the ranks first, so every rank reads the
        same means and takes the same checkpoint, plateau and early-stop
        decisions."""
        *totals, n = self._over_ranks(*sums, self._loader_host_count(loader))
        return tuple(v / n for v in totals)

    # ------------------------------------------------------------------
    # the replayed-graph epoch over a split on the device (the JAX
    # engine's whole-epoch scan and chunked epochs, engine.py:350-451,
    # :568-682): one captured step, replayed once per batch

    def _use_epoch_scan(self, loader, debug: bool = False) -> bool:
        """The replayed epoch applies when the loader keeps its split on the
        device (`scan_epochs`), no per-step host work is asked for (debug
        prints per-step scalars; sanity_check runs one step), and the mesh,
        if any, reduces over NCCL: a CUDA graph captures NCCL's
        collectives, and no other backend's (gloo's run on the host), so a
        gloo mesh takes the per-step route."""
        return (bool(getattr(loader, "scan_epochs", False)) and not debug
                and not self.setting.sanity_check
                and (self.mesh is None or mesh_backend(self.mesh, self.axis) == "nccl"))

    def _epoch_inputs(self, loader):
        """The resident split and this epoch's (num_batches, bs) index and
        weight matrices (on the host: the graph copies each once)."""
        data, labels = loader.resident()
        if data.device != self.device:
            raise ValueError(f"the loader's split lies on {data.device}, the model on "
                             f"{self.device}: a replayed epoch gathers on the model's device")
        return (data, labels, *loader.epoch_matrices())

    def _get_train_epoch_fn(self, augment: bool, norm: bool, stats, shape, data,
                            labels) -> StepGraph:
        """The train StepGraph for (num_steps, bs) = `shape` over `data` /
        `labels`: the TrainStep's `run` as its body; before each step the
        host reseeds the "dropout", "augment", "cutout" and "mixup"
        generators to step (e, s)'s seeds and runs the TrainStep's
        `prepare`."""
        key = ("train", augment, norm, stats, _data_flags(self.setting),
               getattr(self.setting, "loss_reduction", "sum"),
               float(getattr(self.setting, "label_smoothing", 0.0) or 0.0),
               self.optimizer_name, tuple(shape), data.data_ptr(), labels.data_ptr())
        if key in self._epoch_fns:
            return self._epoch_fns[key]
        step = self._get_train_step(augment, norm, False, stats)
        state, seed = self.state, self.setting.seed
        draws = augment or _data_flags(self.setting)[2] > 0.0
        gens = StepGenerators(seed, ("dropout", "augment", "cutout", "mixup") if draws
                              else ("dropout",), self.device)
        rng = DataRng(gens["augment"], gens["cutout"], gens["mixup"], None) if draws else None

        def prologue(epoch, index):
            gens.reseed(epoch, index, self.rank)
            host = generator_for(seed, "mixup", epoch, index) if step.mix_a > 0.0 else None
            step.prepare(state, rng._replace(mixup_host=host) if draws else None)

        def body(x, y, w):
            return step.run(state, x, y, w, gens["dropout"], rng)

        # the process group's watchdog thread queries events while a step
        # with NCCL collectives is captured: a capture that only checks
        # this thread's calls
        graph = StepGraph("train", body, data, labels, *shape, prologue=prologue,
                          generators=gens, on_capture=self._ckpt_barrier,
                          capture_error_mode="global" if self.mesh is None else "thread_local")
        self._epoch_fns[key] = graph
        return graph

    def _get_eval_epoch_fn(self, norm: bool, stats, shape, data, labels,
                           collect_preds: bool = False) -> StepGraph:
        key = ("eval", norm, stats, tuple(shape), collect_preds, data.data_ptr(),
               labels.data_ptr())
        if key not in self._epoch_fns:
            self._epoch_fns[key] = StepGraph(
                "eval", self._get_eval_step(norm, stats), data, labels, *shape,
                preds=collect_preds, on_capture=self._ckpt_barrier)
        return self._epoch_fns[key]

    def _run_chunked_train_epoch(self, loader, epoch_index: int, augment: bool, norm: bool):
        """Shard-rotation epoch (ShardRotationLoader, data/stream.py): the
        chunks rotate through one static buffer on the device, which one
        train graph reads; step s of chunk c is the epoch's step c·bpc + s,
        so the epoch equals the resident one. The loader sends chunk c + 1
        while chunk c's replays run."""
        stats = self._resolve_stats(loader)
        losses, corrects, graph = [], [], None
        for ch in loader.epoch_chunks():
            if graph is None:
                graph = self._get_train_epoch_fn(augment, norm, stats, ch.idx_mat.shape,
                                                 ch.data, ch.labels)
            loss, correct = graph.run(ch.idx_mat, ch.w_mat, epoch_index, ch.first_step,
                                      ch.num_steps)
            losses.append(loss.clone())
            corrects.append(correct.clone())
        return self._scan_means(loader, _host_sum(torch.cat(losses)),
                                _host_sum(torch.cat(corrects)))

    def _run_chunked_eval_epoch(self, loader, norm: bool, collect_preds: bool = False):
        stats = self._resolve_stats(loader)
        outs, masks, targets, graph = [], [], [], None
        for ch in loader.epoch_chunks():
            if graph is None:
                graph = self._get_eval_epoch_fn(norm, stats, ch.idx_mat.shape, ch.data,
                                                ch.labels, collect_preds)
            outs.append([o.clone() for o in graph.run(ch.idx_mat, ch.w_mat, 0,
                                                       steps=ch.num_steps)])
            real = ch.w_mat[:ch.num_steps].reshape(-1) > 0
            masks.append(real)
            targets.append(ch.host_labels[ch.idx_mat[:ch.num_steps].reshape(-1)[real]])
        result = self._scan_means(loader, *(_host_sum(torch.cat([o[j] for o in outs]))
                                            for j in (0, 1)))
        if collect_preds:
            preds = torch.cat([o[2].reshape(-1) for o in outs]).cpu().numpy()
            return (*result, np.concatenate(targets), preds[np.concatenate(masks)])
        return result

    def _run_train_epoch(self, loader: DataLoader, epoch_index: int):
        augment, norm = self._resolve_flags(loader, train=True)
        debug = bool(self.setting.debug)
        stats = self._resolve_stats(loader)
        self._check_shard(loader)
        if self._use_epoch_scan(loader, debug):
            if getattr(loader, "chunked", False):
                return self._run_chunked_train_epoch(loader, epoch_index, augment, norm)
            data, labels, idx_mat, w_mat = self._epoch_inputs(loader)
            graph = self._get_train_epoch_fn(augment, norm, stats, idx_mat.shape, data, labels)
            loss, correct = graph.run(idx_mat, w_mat, epoch_index)
            return self._scan_means(loader, _host_sum(loss), _host_sum(correct))
        step_fn = self._get_train_step(augment, norm, debug, stats=stats)
        draws = augment or _data_flags(self.setting)[2] > 0.0

        # per-step metrics stay on the device until the epoch ends: a
        # float() per step would wait for the device every step and empty
        # the launch queue
        losses, corrects = [], []
        for step, (x, y, w) in enumerate(device_prefetch(loader, size=2, device=self.device)):
            gen = generator_for(self.setting.seed, "dropout", epoch_index, step, self.rank,
                                device=self.device)
            rng = (data_rng(self.setting.seed, self.device, epoch_index, step, rank=self.rank)
                   if draws else None)
            if debug:
                loss, correct, gnorm = step_fn(self.state, x, y, w, gen, rng)
                print(f"[debug] step {step}: x{tuple(x.shape)}/{x.dtype} "
                      f"loss={float(loss):.6f} correct={float(correct):.0f} "
                      f"grad_norm={float(gnorm):.4e}")
            else:
                loss, correct = step_fn(self.state, x, y, w, gen, rng)
            losses.append(loss)
            corrects.append(correct)
            if self.setting.sanity_check:
                break
        return self._step_means(loader, _host_sum(losses), _host_sum(corrects))

    def _run_eval_epoch(self, loader: DataLoader, collect_preds: bool = False):
        _, norm = self._resolve_flags(loader, train=False)
        stats = self._resolve_stats(loader)
        if self._use_epoch_scan(loader):
            if getattr(loader, "chunked", False):
                return self._run_chunked_eval_epoch(loader, norm, collect_preds)
            data, labels, idx_mat, w_mat = self._epoch_inputs(loader)
            graph = self._get_eval_epoch_fn(norm, stats, idx_mat.shape, data, labels,
                                            collect_preds)
            out = graph.run(idx_mat, w_mat, 0)
            result = self._scan_means(loader, _host_sum(out[0]), _host_sum(out[1]))
            if collect_preds:
                real = w_mat.reshape(-1) > 0
                targets = np.asarray(loader.dataset.all_labels())[idx_mat.reshape(-1)[real]]
                return (*result, targets, out[2].cpu().numpy().reshape(-1)[real])
            return result
        step_fn = self._get_eval_step(norm, stats=stats)

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
        out = self._step_means(loader, _host_sum(losses), _host_sum(corrects))
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
                # the model's current weights: build_model's seeded init,
                # or what the caller loaded into it (the bridge)
                self._new_state()
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
            # the summary and one synthetic batch's per-module trace before
            # the first epoch; per-step gradient norms follow
            self.print_summary()
            self.debug_trace()

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
        the machine-readable twin of the epoch_results dict (data rank 0's
        alone)."""
        if self.rank != 0:
            return
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
        targets, preds = self._gather_preds(targets, preds)
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

    def _gather_preds(self, targets, preds):
        """With more than one rank, every rank's (targets, predictions) in
        rank order, so the scores and reports cover the whole split."""
        if self.world == 1:
            return targets, preds
        parts = [None] * self.world
        dist.all_gather_object(parts, (np.asarray(targets), np.asarray(preds)),
                               group=data_group(self.mesh, self.axis))
        return (np.concatenate([t for t, _ in parts]), np.concatenate([p for _, p in parts]))

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

    def test(self, loader: DataLoader, num_warmup: int = 50,
             profile_dir: Optional[str] = None):
        """Timed benchmark testing: warmup forwards on a random batch of the
        loader's dtype, then per-batch timed eval fenced by the predictions'
        device-to-host copy, classification report, and the
        test_sample_size-subset accuracy sampling used for cross-model
        statistical comparison (basemodel.py:601-722). Returns (subset
        scores, per-batch seconds, img/s). With `profile_dir`, the whole
        call runs under torch.profiler (CPU activity, and the card's where
        the model is on one), and its Chrome trace is written into that
        directory as test-<model name>.json."""
        if profile_dir is not None:
            return self._profiled_test(loader, num_warmup, profile_dir)
        self._require_state("test")
        # re-pin reproducible order before the timed loop (the reference
        # calls set_reproducible_mode(seed) here, basemodel.py:650-651):
        # the loader's epoch counter is our only order state, so resetting
        # it makes the benchmark's batch order — and hence the subset
        # accuracy samples — a function of the seed alone
        if hasattr(loader, "epoch"):
            loader.epoch = 0
        _, norm = self._resolve_flags(loader, train=False)
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

        targets, preds = self._gather_preds(np.concatenate(all_targets),
                                            np.concatenate(all_preds))
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

    def _profiled_test(self, loader, num_warmup: int, profile_dir: str):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            out = self.test(loader, num_warmup=num_warmup)
        path = os.path.join(profile_dir, f"test-{self.model.model_name}.json")
        prof.export_chrome_trace(path)
        return out

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
        mutate what gets written. With a mesh only data rank 0 writes (the
        others return the path); a rank that reads the file waits for it at
        load_checkpoint's barrier."""
        path = path or self.model_path
        if self.rank != 0:
            return path
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
        either package; returns the checkpoint meta. With more than one
        rank, every rank first waits until data rank 0's writes are done,
        and the weights read are then made rank 0's (broadcast)."""
        self._ckpt_barrier()  # never read under an in-flight async write
        if self.world > 1:
            dist.barrier(group=data_group(self.mesh, self.axis))
        if path is None:
            path = ckpt.get_last_checkpoint(self.setting.output_dir, self.model.model_name)
            if path is None:
                raise FileNotFoundError(
                    f"no checkpoint for {self.model.model_name} in {self.setting.output_dir}"
                )
        trees, meta = ckpt.load_checkpoint(path)
        bridge.load_jax_variables(self.model, {"params": trees["params"],
                                               "state": trees["model_state"]})
        self._replicate()
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
        self._epoch_fns.clear()
        # data-order clock for fit(resume=True): rewind the loaders to the
        # permutation epoch this checkpoint was written at
        self._resume_loader_epochs = meta.get("extra", {}).get("loader_epochs")
        return meta

    def update_checkpoint(self, path: Optional[str] = None):
        self.save_checkpoint(path)

    def print_summary(self):
        print(self.model.summary())

    def debug_trace(self, batch_size: int = 2, train: bool = False):
        """One uniform fp32 batch from generator_for(seed, "bench") through
        the model's root module under nn/trace.py's activation_trace: each
        module that runs prints its path, output shape, dtype and mean/std.
        train=True runs train mode (the dropout masks from the "dropout"
        stream) and puts the BN running statistics back afterwards, as the
        JAX package drops the state its trace returns. fit() calls it once
        before the first epoch when Settings.debug is set."""
        from convnets_tpu_torch.nn.trace import activation_trace

        self._require_state("debug_trace")
        model, seed = self.model, self.setting.seed
        device = _device_of(model)
        x = torch.rand((batch_size, *model.input_shape_nhwc),
                       generator=generator_for(seed, "bench", device=device), device=device)
        buffers = {k: b.clone() for k, b in model.named_buffers()}
        was_training = model.training
        model.train(train)
        try:
            with torch.no_grad(), use_generator(generator_for(seed, "dropout", device=device)), \
                    mesh_scope(self.mesh, self.axis), activation_trace(model.module):
                model.module(x)
        finally:
            model.train(was_training)
            with torch.no_grad():
                for k, b in model.named_buffers():
                    b.copy_(buffers[k])
