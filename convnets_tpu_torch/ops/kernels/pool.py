"""Max pool: the wrapper of csrc/pool.cu and its plain PyTorch version.

Replaces convnets_tpu/ops/pallas/pool.py:max_pool2d. The kernel runs one
thread per output element with the channel innermost; padding taps are
-inf. It is memory-bound on the H100 (one read of x, one write of y).
"""

from __future__ import annotations

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k


def max_pool2d_plain(x, kernel, stride=None, padding=0):
    return ops.max_pool2d(x, kernel, stride, padding)


def max_pool2d(x, kernel, stride=None, padding=0):
    """x (N, H, W, C) NHWC, float32 or bfloat16; torch MaxPool2d semantics."""
    if x.device.type == "cpu":
        return max_pool2d_plain(x, kernel, stride, padding)
    _k.check_cuda_operand("max_pool2d x", x)
    n, h, w, c = x.shape
    kh, kw = to_pair(kernel)
    sh, sw = to_pair(kernel if stride is None else stride)
    ph, pw = to_pair(padding)
    oh = conv_out_size(h, kh, sh, ph)
    ow = conv_out_size(w, kw, sw, pw)
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    rc = _k.lib().max_pool_launch(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow,
        kh, kw, sh, sw, ph, pw, _k.stream_ptr(x))
    _k.check_launch("max_pool2d", rc)
    _k.LAUNCHES["max_pool2d"] += 1
    return y
