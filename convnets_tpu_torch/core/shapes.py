"""Static NHWC shape math (counterpart of convnets_tpu/core/shapes.py).

Kept as a copy: importing `convnets_tpu.core.shapes` runs
`convnets_tpu/core/__init__.py`, which imports jax.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def to_pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected pair, got {v}")
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv_out_size(size: int, kernel: int, stride: int, padding: int, dilation: int = 1) -> int:
    """floor((H + 2p - d(k-1) - 1)/s) + 1; raises on a non-positive size."""
    out = (size + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
    if out < 1:
        raise ValueError(
            f"conv/pool output size {out} < 1 (input {size}, kernel {kernel}, "
            f"stride {stride}, padding {padding}): input too small for this "
            f"network's downsampling depth"
        )
    return out


def conv2d_out_shape(in_shape: Sequence[int], out_channels: int, kernel, stride=1,
                     padding=0, dilation=1) -> Tuple[int, ...]:
    kh, kw = to_pair(kernel)
    sh, sw = to_pair(stride)
    ph, pw = to_pair(padding)
    dh, dw = to_pair(dilation)
    *lead, h, w, _ = in_shape
    return (*lead, conv_out_size(h, kh, sh, ph, dh), conv_out_size(w, kw, sw, pw, dw),
            out_channels)


def pool2d_out_shape(in_shape, kernel, stride=None, padding=0) -> Tuple[int, ...]:
    kh, kw = to_pair(kernel)
    sh, sw = to_pair(kernel if stride is None else stride)
    ph, pw = to_pair(padding)
    *lead, h, w, c = in_shape
    return (*lead, conv_out_size(h, kh, sh, ph), conv_out_size(w, kw, sw, pw), c)


def num_flat_features(in_shape) -> int:
    """The fan-in of a classifier after a flatten: the product of the last
    three dimensions (H·W·C)."""
    n = 1
    for d in in_shape[-3:]:
        n *= int(d)
    return n
