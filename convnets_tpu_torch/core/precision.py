"""Mixed-precision policy (counterpart of convnets_tpu/core/precision.py).

Explicit dtypes instead of autocast: parameters are stored in fp32, and
layers cast activations and weights to `compute_dtype` (bf16 under
`mixed_precision`), accumulate in fp32 and return fp32 logits.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32
    norm_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
MIXED_POLICY = Policy(compute_dtype=torch.bfloat16)


def policy_from_setting(setting) -> Policy:
    """The `mixed_precision` flag selects bf16 compute."""
    return MIXED_POLICY if getattr(setting, "mixed_precision", False) else DEFAULT_POLICY


@dataclasses.dataclass
class LossScale:
    """Loss-scale shim (counterpart of convnets_tpu/core/precision.py
    LossScale): bf16 has fp32's exponent range, so the scale stays 1.0 and
    is a no-op; it is kept so the train step and a checkpoint carry the
    same field as the JAX package's."""

    scale: float = 1.0

    def scale_loss(self, loss):
        return loss * self.scale

    def unscale_grads(self, grads):
        """grads: name → tensor dict."""
        if self.scale == 1.0:
            return grads
        inv = 1.0 / self.scale
        return {k: g * inv for k, g in grads.items()}

    def to_state(self):
        return {"scale": self.scale}

    @classmethod
    def from_state(cls, state):
        return cls(scale=float(state["scale"]))
