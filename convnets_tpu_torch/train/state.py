"""TrainState (counterpart of convnets_tpu/train/state.py).

The model (its parameters and BN running statistics), the optimizer state
keyed by parameter name, the learning rate and the loss scale. Unlike the
JAX package's immutable pytree, the port's step updates it in place.

The learning rate stays a host float (the scheduler sets it, checkpoints
carry it). The step reads it, and the other per-step scalars, from
`scalars`: fp32 0-d tensors on the model's device that the host fills
before each step, so a step captured once as a CUDA graph reads each
replay's values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from convnets_tpu_torch.core.precision import LossScale
from convnets_tpu_torch.train import optim


class StepScalars:
    """The learning rate, Adam's bias corrections (1 − b1^t, 1 − b2^t) and
    mixup's λ of the current step, as fp32 0-d tensors on `device`. `fill`
    writes each with `fill_`: a kernel that carries the value, rounded to
    fp32 once, as the host rounds it; no copy crosses from the host."""

    NAMES = ("lr", "bc1", "bc2", "lam")

    def __init__(self, device):
        for name in self.NAMES:
            setattr(self, name, torch.zeros((), dtype=torch.float32, device=device))

    def fill(self, **values: float) -> None:
        for name, v in values.items():
            getattr(self, name).fill_(float(v))


@dataclasses.dataclass
class TrainState:
    model: object  # models.base.Model
    optimizer: str  # "adam" | "sgd"
    opt_state: Union[optim.AdamState, optim.SGDState]
    lr: float
    loss_scale: LossScale = dataclasses.field(default_factory=LossScale)
    scalars: Optional[StepScalars] = None

    def __post_init__(self):
        if self.scalars is None:
            self.scalars = StepScalars(next(self.model.parameters()).device)

    def params(self):
        """name → parameter, in `named_parameters` order."""
        return dict(self.model.named_parameters())


def create_train_state(model, setting=None, optimizer=None) -> TrainState:
    """Fresh optimizer state for `model`; optimizer and learning rate from
    the settings (Settings.optimizer, default "adam")."""
    setting = model.setting if setting is None else setting
    name = optimizer or getattr(setting, "optimizer", "adam")
    params = {k: p.detach() for k, p in model.named_parameters()}
    if name == "adam":
        opt_state = optim.adam_init(params)
    elif name == "sgd":
        opt_state = optim.sgd_init(params)
    else:
        raise ValueError(f"unknown optimizer '{name}'")
    return TrainState(model=model, optimizer=name, opt_state=opt_state,
                      lr=float(setting.learning_rate))
