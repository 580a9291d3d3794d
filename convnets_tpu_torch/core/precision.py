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
