"""Plain 2-D convolution and dense layer, NHWC / HWIO
(counterpart of convnets_tpu/ops/conv.py).

`conv2d` is the oracle of the conv kernel: operands are upcast to fp32,
convolved, and the result is cast back to the input dtype once, so bf16
in gives bf16 out with fp32 accumulation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from convnets_tpu_torch.core.shapes import to_pair


def conv2d(x, w, *, stride=1, padding=0, dilation=1, groups=1):
    """x (N, H, W, C), w (kh, kw, C/groups, O). Returns (N, H', W', O) in x.dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 stride=to_pair(stride), padding=to_pair(padding), dilation=to_pair(dilation),
                 groups=groups)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv2d_depthwise(x, w, *, stride=1, padding=0, dilation=1):
    """One filter per input channel (groups = C): w (kh, kw, 1, C·multiplier)."""
    return conv2d(x, w, stride=stride, padding=padding, dilation=dilation, groups=x.shape[-1])


def linear(x, w, b=None):
    """x (..., in), w (in, out), b (out,): x·w (+ b) in x.dtype."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y
