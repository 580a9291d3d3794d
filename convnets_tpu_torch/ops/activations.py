"""Elementwise activations (counterpart of convnets_tpu/ops/activations.py)."""

from __future__ import annotations

import torch


def relu(x):
    return torch.clamp_min(x, 0)


def softmax(x, dim=-1):
    return torch.softmax(x, dim=dim)


def dropout(x, rate: float, *, train: bool):
    """Inverted dropout; eval mode (and rate 0) is the identity. The
    train-mode mask is ROADMAP modules item 4 (train step)."""
    if not train or rate <= 0.0:
        return x
    raise NotImplementedError(
        "train-mode dropout is not ported yet (ROADMAP.md modules item 4, train step)")
