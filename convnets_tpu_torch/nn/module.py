"""Module base (counterpart of convnets_tpu/nn/module.py).

A port module is a `torch.nn.Module` that, like its JAX counterpart,
captures the dtype policy when it is constructed (`use_policy`) and
creates its parameters from the input shape: `init(generator, in_shape)`
mirrors the JAX `init(key, in_shape)`, and `out_shape` is analytic, so no
layer needs its input width at construction.

`JAX_LEAVES` maps each parameter or buffer name to the (collection, leaf)
the JAX variables hold it under; `bridge.py` reads it. A module whose
`JAX_TRANSPARENT` is true adds no level to its children's JAX paths.

Random numbers at train time come from an explicit `torch.Generator`
handed to the step with `use_generator`, the counterpart of the JAX
package's per-step `rng` key; there is no global RNG. A train-mode
`Remat` keeps the dropout masks its child draws (`MaskTape`), so the
recompute in the backward reuses them and draws nothing.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch

from convnets_tpu_torch.core.precision import DEFAULT_POLICY, Policy

_POLICY_STACK = [DEFAULT_POLICY]


@contextlib.contextmanager
def use_policy(policy: Policy):
    """Layers constructed inside this context compute in policy.compute_dtype."""
    _POLICY_STACK.append(policy)
    try:
        yield policy
    finally:
        _POLICY_STACK.pop()


def current_policy() -> Policy:
    return _POLICY_STACK[-1]


_GENERATOR_STACK: list = [None]


@contextlib.contextmanager
def use_generator(generator: Optional[torch.Generator]):
    """Forwards run inside this context draw their random numbers (the
    dropout masks) from `generator`."""
    _GENERATOR_STACK.append(generator)
    try:
        yield generator
    finally:
        _GENERATOR_STACK.pop()


def current_generator() -> Optional[torch.Generator]:
    return _GENERATOR_STACK[-1]


class MaskTape:
    """The dropout masks of one train-mode Remat forward, in the order the
    child drew them. `recording()` scopes the forward (each mask drawn is
    appended), `replaying()` the recompute in the backward (each dropout
    takes the next kept mask, and no module writes its running
    statistics)."""

    def __init__(self):
        self.masks: list = []
        self.cursor: Optional[int] = None

    @contextlib.contextmanager
    def recording(self):
        _TAPE_STACK.append(self)
        try:
            yield self
        finally:
            _TAPE_STACK.pop()

    @contextlib.contextmanager
    def replaying(self):
        self.cursor = 0
        _TAPE_STACK.append(self)
        try:
            yield self
        finally:
            _TAPE_STACK.pop()
        if self.cursor != len(self.masks):
            raise RuntimeError(f"Remat recompute used {self.cursor} of the {len(self.masks)} "
                               f"dropout masks its forward drew")
        self.cursor = None

    def next_mask(self, shape) -> torch.Tensor:
        if self.cursor >= len(self.masks) or tuple(self.masks[self.cursor].shape) != tuple(shape):
            raise RuntimeError(f"Remat recompute asked for dropout mask {self.cursor} of shape "
                               f"{tuple(shape)}, which its forward did not draw")
        self.cursor += 1
        return self.masks[self.cursor - 1]


_TAPE_STACK: list = []


def current_tape() -> Optional[MaskTape]:
    return _TAPE_STACK[-1] if _TAPE_STACK else None


def recomputing() -> bool:
    """True inside a Remat recompute: running statistics stay as the
    forward left them (one update per step, as JAX's functional state)."""
    tape = current_tape()
    return tape is not None and tape.cursor is not None


class Module(torch.nn.Module):
    JAX_LEAVES: Dict[str, Tuple[str, str]] = {}
    JAX_TRANSPARENT = False

    def __init__(self):
        super().__init__()
        self.policy = current_policy()

    def init(self, generator: torch.Generator, in_shape: Sequence[int]) -> None:
        """Create (or re-create) this module's parameters for `in_shape`."""
        del generator, in_shape

    def out_shape(self, in_shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(in_shape)
