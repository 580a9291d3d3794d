"""TrainState (counterpart of convnets_tpu/train/state.py).

The model (its parameters and BN running statistics), the optimizer state
keyed by parameter name, the learning rate and the loss scale. Unlike the
JAX package's immutable pytree, the port's step updates it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Union

from convnets_tpu_torch.core.precision import LossScale
from convnets_tpu_torch.train import optim


@dataclasses.dataclass
class TrainState:
    model: object  # models.base.Model
    optimizer: str  # "adam" | "sgd"
    opt_state: Union[optim.AdamState, optim.SGDState]
    lr: float
    loss_scale: LossScale = dataclasses.field(default_factory=LossScale)

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
