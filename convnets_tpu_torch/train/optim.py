"""Optimizers and gradient clipping (counterpart of convnets_tpu/train/optim.py).

Functions on name → tensor dicts, in fp32, computing exactly what the JAX
package computes (not torch.optim): Adam with L2 weight decay folded into
the gradient before the moment updates, bias-corrected moments and eps
outside the sqrt (optim.py:48-55); SGD with momentum, nesterov and the
same decay (v = m·v + g; p -= lr·v); torch's clip_grad_norm_ and
clip_grad_value_ over all gradients as one vector. The learning rate is
an argument, not state.

The new moments are written into the state's own tensors (each sum's
kernel with an output), so a step captured once and replayed
(train/graph.py) keeps updating the state. Such a step reads what changes
per step from device tensors that the host fills before each replay: the
learning rate and Adam's bias corrections, which the host computes as
`adam_bias_corrections` does (`bias=`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    count: int
    mu: Tensors  # first moments, keyed like the params
    nu: Tensors  # second moments


class SGDState(NamedTuple):
    momentum: Tensors  # velocities


def _zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def adam_init(params: Tensors) -> AdamState:
    return AdamState(count=0, mu=_zeros(params), nu=_zeros(params))


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def adam_bias_corrections(count: int, b1=0.9, b2=0.999):
    """(1 − b1^count, 1 − b2^count) in fp32 (optim.py:48-49), as floats."""
    cf = _f32(float(count))
    return (float(1.0 - torch.pow(_f32(b1), cf)), float(1.0 - torch.pow(_f32(b2), cf)))


def adam_update(grads: Tensors, state: AdamState, params: Tensors, *, lr, weight_decay=0.0,
                b1=0.9, b2=0.999, eps=1e-8, bias=None):
    """One Adam step. Returns (new_params, new_state), new_state's moments
    being state's tensors, updated. lr: a float or an fp32 0-d tensor;
    bias: the step's (1 − b1^t, 1 − b2^t) as fp32 0-d tensors (computed
    from state.count + 1 when None)."""
    count = state.count + 1
    if bias is None:
        bias = tuple(_f32(v) for v in adam_bias_corrections(count, b1, b2))
    bc1, bc2 = bias
    new_p, new_m, new_v = {}, {}, {}
    for k, g in grads.items():
        p = params[k]
        g = g.float()
        if weight_decay:
            g = g + weight_decay * p.float()
        m = torch.add(b1 * state.mu[k], (1.0 - b1) * g, out=state.mu[k])
        v = torch.add(b2 * state.nu[k], (1.0 - b2) * torch.square(g), out=state.nu[k])
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[k], new_m[k], new_v[k] = p - step.to(p.dtype), m, v
    return new_p, AdamState(count=count, mu=new_m, nu=new_v)


def sgd_init(params: Tensors) -> SGDState:
    return SGDState(momentum=_zeros(params))


def sgd_update(grads: Tensors, state: SGDState, params: Tensors, *, lr, weight_decay=0.0,
               momentum=0.0, nesterov=False):
    """torch.optim.SGD semantics (v = m·v + g; p -= lr·v). Returns
    (new_params, new_state), new_state's velocities being state's tensors,
    updated; lr a float or an fp32 0-d tensor."""
    new_p, new_v = {}, {}
    for k, g in grads.items():
        p = params[k]
        g = g.float()
        if weight_decay:
            g = g + weight_decay * p.float()
        v = torch.add(momentum * state.momentum[k], g, out=state.momentum[k])
        d = g + momentum * v if nesterov else v
        new_p[k], new_v[k] = p - (lr * d).to(p.dtype), v
    return new_p, SGDState(momentum=new_v)


def global_norm(tree: Tensors) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tensors:
    """torch clip_grad_norm_: scale all grads by max_norm/total_norm if needed."""
    scale = torch.clamp_max(max_norm / (global_norm(grads) + 1e-6), 1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


def clip_by_value(grads: Tensors, clip_value: float) -> Tensors:
    return {k: torch.clamp(g, -clip_value, clip_value) for k, g in grads.items()}
