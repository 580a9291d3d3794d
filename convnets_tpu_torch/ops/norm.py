"""Inference batch norm, NHWC (counterpart of convnets_tpu/ops/norm.py:23-47).

Train-mode BN (batch statistics, running update, hand-written backward) is
ROADMAP modules item 2.
"""

from __future__ import annotations

import torch


def _apply_norm(x, mean, inv, scale, bias):
    """y = (x - mean)·inv·scale + bias with dtype-aware arithmetic.

    fp32 inputs use the subtract-first form; bf16 inputs fold the
    per-channel constants in fp32 and do one bf16 multiply-add.
    """
    w = inv if scale is None else scale.float() * inv
    if x.dtype == torch.float32:
        out = (x - mean) * w
        if bias is not None:
            out = out + bias.float()
        return out
    shift = -mean * w
    if bias is not None:
        shift = shift + bias.float()
    return x * w.to(x.dtype) + shift.to(x.dtype)


def batch_norm_inference(x, running_mean, running_var, scale, bias, *, eps=1e-5):
    """Normalize with running statistics (eval mode)."""
    inv = torch.rsqrt(running_var.float() + eps)
    return _apply_norm(x, running_mean.float(), inv, scale, bias).to(x.dtype)
