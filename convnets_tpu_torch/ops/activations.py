"""Elementwise activations (counterpart of convnets_tpu/ops/activations.py)."""

from __future__ import annotations

from typing import Optional

import torch


def relu(x):
    return torch.clamp_min(x, 0)


def sigmoid(x):
    return torch.sigmoid(x)


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def channel_shuffle(x, groups: int):
    """ShuffleNet's channel shuffle on the channel (last) axis of NHWC, the
    permutation of convnets_tpu/ops/activations.py:32: (…, g, C/g) → swap
    the last two axes → (…, C). Channel j·g + i of the result is channel
    i·(C/g) + j of x."""
    *lead, c = x.shape
    if c % groups:
        raise ValueError(f"channel_shuffle: channels {c} not divisible by groups {groups}")
    return x.reshape(*lead, groups, c // groups).transpose(-1, -2).reshape(*lead, c)


def flatten(x):
    """All non-batch dims into one, in memory order: (N, H, W, C) NHWC →
    (N, H·W·C), the order the JAX package's classifier weight expects
    (ops/activations.py:27-29). No permute to NCHW."""
    return x.reshape(x.shape[0], -1)


def dropout_mask(x, rate: float, generator: Optional[torch.Generator]):
    """The keep mask of dropout(x, rate, generator, train=True): each element
    kept with probability 1 - rate, drawn from `generator` (on x's device)."""
    if generator is None:
        raise ValueError("dropout needs a torch.Generator at train time")
    return torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate


def apply_dropout(x, mask, rate: float):
    """x scaled by 1/(1 - rate) where `mask` keeps it, 0 elsewhere."""
    # keep, rounded to x.dtype, as a CPU scalar: it enters the kernel as an
    # argument, with no host-to-device copy
    return torch.where(mask, x / torch.tensor(1.0 - rate, dtype=x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, rate: float, generator: Optional[torch.Generator] = None, *, train: bool):
    """Inverted dropout, torch semantics: at train time each element is
    kept with probability 1 - rate and scaled by 1/(1 - rate). The mask
    comes from `generator` (on x's device); eval mode and rate 0 are the
    identity. The masks cannot equal JAX's bits: the streams differ."""
    if not train or rate <= 0.0:
        return x
    return apply_dropout(x, dropout_mask(x, rate, generator), rate)
