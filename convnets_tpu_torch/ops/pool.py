"""Pooling, NHWC (counterpart of convnets_tpu/ops/pool.py)."""

from __future__ import annotations

import torch.nn.functional as F

from convnets_tpu_torch.core.shapes import to_pair


def max_pool2d(x, kernel, stride=None, padding=0):
    """torch MaxPool2d semantics: padding taps are -inf."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), to_pair(kernel),
                     to_pair(kernel if stride is None else stride), to_pair(padding))
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool2d(x):
    """Mean over H, W taken in fp32, then cast back to x.dtype."""
    return x.float().mean(dim=(-3, -2)).to(x.dtype)
