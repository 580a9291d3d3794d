"""The train step (counterpart of convnets_tpu/train/engine.py:
Trainer._build_train_step, :190-278).

preprocess (uint8 → /255, optional normalize, cast to the compute dtype)
→ train-mode forward, fp32 logits → sum-CE (label smoothing, example
weights) and the sum or per-example-mean objective → × loss scale →
gradients → ÷ loss scale → clipping → Adam or SGD → correct count.

The step updates the TrainState in place: parameters and optimizer state
are overwritten after the update, and the BN running statistics during
the forward (the port mutates where the JAX package returns a new state).
The Trainer (fit / evaluate / checkpoints) is ROADMAP.md modules item 6;
augmentation, cutout and mixup are item 7 (data path).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.nn import use_generator
from convnets_tpu_torch.train import optim
from convnets_tpu_torch.train.state import TrainState

# convnets_tpu/data/datasets.py CINIC_MEAN / CINIC_STD, the default of
# data/augment.py:normalize
CINIC_MEAN = (0.47889522, 0.47227842, 0.43047404)
CINIC_STD = (0.24205776, 0.23828046, 0.25874835)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md modules item 7, data path)")


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
    compute_dtype = model.policy.compute_dtype
    target_hw = tuple(model.input_shape_nhwc[:2])
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

    def train_step(state: TrainState, x, y, w=None, generator: Optional[torch.Generator] = None):
        # the batch follows the model to its device, never the other way
        device = next(state.model.parameters()).device
        x, y = torch.as_tensor(x).to(device), torch.as_tensor(y).to(device)
        if w is None:
            w = torch.ones(x.shape[0], dtype=torch.float32, device=device)
        w = torch.as_tensor(w).to(device)
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
