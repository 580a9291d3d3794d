"""Pooling, NHWC (counterpart of convnets_tpu/ops/pool.py)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from convnets_tpu_torch.core.shapes import to_pair


def max_pool2d(x, kernel, stride=None, padding=0):
    """torch MaxPool2d semantics: padding taps are -inf."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), to_pair(kernel),
                     to_pair(kernel if stride is None else stride), to_pair(padding))
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool2d(x, kernel, stride=None, padding=0):
    """torch AvgPool2d semantics (count_include_pad: the divisor is always
    kh·kw). The window sum is taken in fp32 and multiplied, not divided, by
    fp32 1/(kh·kw), then cast back once, as convnets_tpu/ops/pool.py:41-52."""
    kh, kw = to_pair(kernel)
    summed = F.avg_pool2d(x.float().permute(0, 3, 1, 2), (kh, kw),
                          to_pair(kernel if stride is None else stride), to_pair(padding),
                          divisor_override=1)
    y = summed * np.float32(1.0 / (kh * kw))
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def global_avg_pool2d(x, keepdims: bool = False):
    """Mean over H, W taken in fp32, then cast back to x.dtype; keepdims
    keeps them as 1 × 1 (SKConv's descriptor input)."""
    return x.float().mean(dim=(-3, -2), keepdim=keepdims).to(x.dtype)


def adaptive_avg_pool2d(x, output_size):
    """Adaptive average pooling, torch semantics (pool.py:
    adaptive_avg_pool2d). Where (H, W) divide into the output size it is
    avg_pool2d of window and stride (H/oh, W/ow) (nn.AdaptiveAvgPool2d runs
    the avg-pool kernel there); uneven bins, bin i covering [⌊iH/oh⌋,
    ⌈(i+1)H/oh⌉), are averaged in fp32."""
    oh, ow = to_pair(output_size)
    _, h, w, _ = x.shape
    if (h, w) == (oh, ow):
        return x
    if h % oh == 0 and w % ow == 0:
        k = (h // oh, w // ow)
        return avg_pool2d(x, k, k)
    xf = x.float()
    rows = [xf[:, (i * h) // oh:-(-(i + 1) * h // oh)].mean(1, keepdim=True) for i in range(oh)]
    xr = torch.cat(rows, 1)
    cols = [xr[:, :, (j * w) // ow:-(-(j + 1) * w // ow)].mean(2, keepdim=True)
            for j in range(ow)]
    return torch.cat(cols, 2).to(x.dtype)
