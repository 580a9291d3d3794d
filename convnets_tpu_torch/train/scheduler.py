"""Learning-rate schedulers, host-side and per epoch (counterpart of
convnets_tpu/train/scheduler.py, copied).

ReduceLROnPlateau reproduces torch.optim.lr_scheduler.ReduceLROnPlateau
(the reference's scheduler, basemodel.py:72-79) including default
threshold=1e-4 (relative), cooldown=0, min_lr=0. StepDecay covers the
ImageNet baseline config (BASELINE.json: "step-decay LR schedule").

These are plain Python objects whose state round-trips through checkpoints
(to_state/from_state) — the schedule decision runs on host between epochs;
the chosen lr is written into the TrainState.
"""

from __future__ import annotations

import math


class ReduceLROnPlateau:
    def __init__(self, lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0, eps: float = 1e-8):
        if factor >= 1.0:
            raise ValueError("factor should be < 1.0")
        self.lr = float(lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return metric < self.best * (1.0 - self.threshold)
            return metric < self.best - self.threshold
        if self.threshold_mode == "rel":
            return metric > self.best * (1.0 + self.threshold)
        return metric > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def to_state(self) -> dict:
        return {
            "kind": "plateau", "lr": self.lr, "mode": self.mode,
            "factor": self.factor, "patience": self.patience,
            "threshold": self.threshold, "threshold_mode": self.threshold_mode,
            "cooldown": self.cooldown, "min_lr": self.min_lr, "eps": self.eps,
            "best": self.best, "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    @classmethod
    def from_state(cls, state: dict) -> "ReduceLROnPlateau":
        sched = cls(
            lr=state["lr"], mode=state["mode"], factor=state["factor"],
            patience=state["patience"], threshold=state["threshold"],
            threshold_mode=state["threshold_mode"], cooldown=state["cooldown"],
            min_lr=state["min_lr"], eps=state["eps"],
        )
        sched.best = state["best"]
        sched.num_bad_epochs = state["num_bad_epochs"]
        sched.cooldown_counter = state["cooldown_counter"]
        return sched


class StepDecay:
    """lr · gamma^(epoch // step_size) — torch StepLR semantics."""

    def __init__(self, lr: float, step_size: int, gamma: float = 0.1):
        self.base_lr = float(lr)
        self.lr = float(lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        self.epoch = 0

    def step(self, metric: float = 0.0) -> float:
        del metric
        self.epoch += 1
        self.lr = self.base_lr * (self.gamma ** (self.epoch // self.step_size))
        return self.lr

    def to_state(self) -> dict:
        return {"kind": "step", "base_lr": self.base_lr, "lr": self.lr,
                "step_size": self.step_size, "gamma": self.gamma, "epoch": self.epoch}

    @classmethod
    def from_state(cls, state: dict) -> "StepDecay":
        sched = cls(state["base_lr"], state["step_size"], state["gamma"])
        sched.lr = state["lr"]
        sched.epoch = state["epoch"]
        return sched


class CosineDecay:
    """Half-cosine decay from base_lr to min_lr over total_epochs, with an
    optional linear warmup — the standard from-scratch CNN recipe
    (torch CosineAnnealingLR semantics, stepped per epoch)."""

    def __init__(self, lr: float, total_epochs: int, min_lr: float = 0.0,
                 warmup_epochs: int = 0):
        self.base_lr = float(lr)
        self.total_epochs = int(total_epochs)
        self.min_lr = float(min_lr)
        self.warmup_epochs = int(warmup_epochs)
        self.epoch = 0
        self.lr = self._lr_at(0)

    def _lr_at(self, e: int) -> float:
        if self.warmup_epochs and e < self.warmup_epochs:
            return self.base_lr * (e + 1) / self.warmup_epochs
        span = max(self.total_epochs - self.warmup_epochs, 1)
        t = min(max(e - self.warmup_epochs, 0), span)
        return self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
            1.0 + math.cos(math.pi * t / span))

    def step(self, metric: float = 0.0) -> float:
        del metric
        self.epoch += 1
        self.lr = self._lr_at(self.epoch)
        return self.lr

    def to_state(self) -> dict:
        return {"kind": "cosine", "base_lr": self.base_lr, "lr": self.lr,
                "total_epochs": self.total_epochs, "min_lr": self.min_lr,
                "warmup_epochs": self.warmup_epochs, "epoch": self.epoch}

    @classmethod
    def from_state(cls, state: dict) -> "CosineDecay":
        sched = cls(state["base_lr"], state["total_epochs"],
                    state["min_lr"], state["warmup_epochs"])
        sched.lr = state["lr"]
        sched.epoch = state["epoch"]
        return sched


class ConstantLR:
    """No schedule — lr stays fixed (lr_scheduler='none')."""

    def __init__(self, lr: float):
        self.lr = float(lr)

    def step(self, metric: float = 0.0) -> float:
        del metric
        return self.lr

    def to_state(self) -> dict:
        return {"kind": "none", "lr": self.lr}

    @classmethod
    def from_state(cls, state: dict) -> "ConstantLR":
        return cls(state["lr"])


def scheduler_from_state(state: dict):
    kinds = {"plateau": ReduceLROnPlateau, "step": StepDecay,
             "cosine": CosineDecay, "none": ConstantLR}
    return kinds[state["kind"]].from_state(state)
