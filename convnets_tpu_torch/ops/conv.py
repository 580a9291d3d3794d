"""Plain 2-D convolution and dense layer, NHWC / HWIO
(counterpart of convnets_tpu/ops/conv.py).

`conv2d` is the oracle of the conv kernel: operands are upcast to fp32,
convolved, and the result is cast back to the input dtype once, so bf16
in gives bf16 out with fp32 accumulation. The bias and `accum_dtype`
follow the JAX package's rounding points (conv.py:63-78): the conv's
result in the output dtype, the bias added in that dtype, the sum cast to
x.dtype; `accum_dtype` is honoured where it equals x.dtype (an fp64
input with accum_dtype=float64 accumulates in fp64), and otherwise the
accumulation is fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from convnets_tpu_torch.core.shapes import to_pair

# the JAX package's lax dimension numbers: activations NHWC, weights HWIO
DIMENSION_NUMBERS = ("NHWC", "HWIO", "NHWC")


def _accum(x, accum_dtype):
    return accum_dtype if x.dtype == accum_dtype else torch.float32


def conv2d(x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
           accum_dtype=torch.float32):
    """x (N, H, W, C), w (kh, kw, C/groups, O), b (O,) or None. Returns (N,
    H', W', O) in x.dtype."""
    acc = _accum(x, accum_dtype)
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2), w.to(acc).permute(3, 2, 0, 1),
                 stride=to_pair(stride), padding=to_pair(padding), dilation=to_pair(dilation),
                 groups=groups)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype).contiguous()


def conv2d_depthwise(x, w, b=None, *, stride=1, padding=0, dilation=1,
                     accum_dtype=torch.float32):
    """One filter per input channel (groups = C): w (kh, kw, 1, C·multiplier)."""
    return conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                  groups=x.shape[-1], accum_dtype=accum_dtype)


def linear(x, w, b=None, *, accum_dtype=torch.float32):
    """x (..., in), w (in, out), b (out,): x·w (+ b) in x.dtype. The product
    runs in x.dtype (accum_dtype, where it equals x.dtype, is that dtype
    already; otherwise, as in the JAX package, it does not change it)."""
    del accum_dtype
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y
