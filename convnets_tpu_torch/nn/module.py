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

`summarize` is the JAX package's layer-by-layer summary, line for line:
each module's `summary_label()` is its JAX `__repr__` (torch's own
`repr`, which `print(model)` shows, is left as it is),
`summary_children()` its JAX `children()`, and a container with
`shape_flow` gives each child its input shape, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from convnets_tpu_torch import bridge
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

    def summary_children(self) -> Dict[str, torch.nn.Module]:
        """The children `summarize` walks, in the JAX module's order and
        under its names (its `children()`): by default every child."""
        return dict(self.named_children())

    def summary_label(self) -> str:
        """This module's line label in `summarize`: the JAX module's
        `__repr__` (by default the class name)."""
        return type(self).__name__


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _count(tree) -> int:
    return int(sum(int(np.prod(tuple(leaf.shape))) for leaf in _leaves(tree)))


def count_params(params) -> int:
    """The number of parameter values: of a module's parameters, or of the
    leaves of a tree of arrays (a JAX-layout params tree, whose leaves may
    be tensors, numpy arrays or anything else with a shape)."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    return _count(params)


def count_state(state) -> int:
    """The number of state values: of the buffers of a module that the JAX
    state holds (BN's running mean and var), or of the leaves of a tree of
    arrays (a JAX-layout state tree)."""
    if isinstance(state, torch.nn.Module):
        return _count(bridge.jax_tensors(state)["state"])
    return _count(state)


def summarize(module: torch.nn.Module, in_shape, variables=None) -> str:
    """Layer-by-layer summary: each module's label, output shape, and the
    parameters and state of each leaf, then the totals
    (convnets_tpu/nn/module.py:summarize, line for line).

    variables: a JAX-layout {"params", "state"} tree to count instead of
    the module's own tensors (the JAX package's variables, their
    `jax.eval_shape`, or `bridge.export_jax_variables` of a model); its
    leaves need only a shape. A child's counts are read at its JAX path,
    so the children of a Remat, whose variables sit at the child's own
    paths, count 0 as they do in the JAX package."""
    if variables is None:
        variables = bridge.jax_tensors(module)
    lines = []
    total = [0, 0]

    def walk(mod, params, state, shape, prefix):
        kids = mod.summary_children()
        out = mod.out_shape(shape)
        own_p = count_params(params) if not kids else 0
        own_s = count_state(state) if not kids else 0
        lines.append(
            f"{prefix}{mod.summary_label():<30} out={tuple(int(d) for d in out)!s:<22}"
            f" params={own_p:,}" + (f" state={own_s:,}" if own_s else "")
        )
        total[0] += own_p
        total[1] += own_s
        if kids:
            if hasattr(mod, "shape_flow"):
                flows = mod.shape_flow(shape)
            else:
                flows, s = {}, shape
                for name, kid in kids.items():
                    flows[name] = s
                    s = kid.out_shape(s)
            for name, kid in kids.items():
                walk(kid, params.get(name, {}), state.get(name, {}), flows[name], prefix + "  ")
        return out

    walk(module, variables.get("params", {}), variables.get("state", {}), tuple(in_shape), "")
    lines.append(f"total params: {total[0]:,}   total state: {total[1]:,}")
    return "\n".join(lines)
