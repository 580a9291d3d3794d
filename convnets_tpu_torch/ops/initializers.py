"""Parameter initializers (counterpart of convnets_tpu/ops/initializers.py).

Same distributions as the JAX package, drawn from an explicit
`torch.Generator` (the two frameworks' streams differ, so the values do
not). Conv weights are HWIO, linear weights (in, out).
"""

from __future__ import annotations

import math

import torch


def he_normal_conv(shape, generator, dtype=torch.float32):
    """shape = (kh, kw, I, O); std = sqrt(2 / fan_out), fan_out = O·kh·kw."""
    kh, kw, _, o = shape
    std = math.sqrt(2.0 / (o * kh * kw))
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def _uniform(shape, bound, generator, dtype):
    return (torch.rand(shape, generator=generator, dtype=dtype) * 2.0 - 1.0) * bound


def he_uniform_conv_default(shape, generator, dtype=torch.float32):
    """torch Conv2d constructor default: U(-b, b), b = sqrt(1 / fan_in)."""
    kh, kw, i, _ = shape
    return _uniform(shape, math.sqrt(1.0 / (i * kh * kw)), generator, dtype)


def conv_bias_default(shape, fan_in, generator, dtype=torch.float32):
    """torch default conv/linear bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(shape, bound, generator, dtype)


def normal_linear(shape, generator, dtype=torch.float32, std=0.01):
    """shape = (in, out); N(0, 0.01)."""
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def linear_default(shape, generator, dtype=torch.float32):
    """torch Linear constructor default on (in, out): U(-b, b), b = sqrt(1 / in)."""
    return _uniform(shape, math.sqrt(1.0 / shape[0]), generator, dtype)


def zeros(shape, generator=None, dtype=torch.float32):
    """Zeros (the generator, the JAX initializers' key, is not used)."""
    del generator
    return torch.zeros(shape, dtype=dtype)


def ones(shape, generator=None, dtype=torch.float32):
    """Ones (the generator, the JAX initializers' key, is not used)."""
    del generator
    return torch.ones(shape, dtype=dtype)
