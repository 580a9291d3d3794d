"""The whole-bottleneck-block kernel: the wrapper of csrc/block.cu and its
plain PyTorch version.

Replaces convnets_tpu/ops/pallas/block.py:bottleneck_block (:122): a
stride-1 identity bottleneck in inference form (BN folded into fp32
scale/shift),

    out = [ReLU](s3·(h2·W3) + b3 + x),
    h2 = round(ReLU(s2·conv3x3(h1, W2) + b2)), h1 = round(ReLU(s1·(x·W1) + b1)),

as one launch that keeps h1 and h2 in shared memory. No model calls it, in
either package; its user is the block A/B of chip_smoke.py (the
counterpart of scripts/tpu_block_ab.py). The JAX package's VMEM batch-tile
picker (`_pick_bt`) has no counterpart: the CUDA kernel tiles each image
spatially and needs no batch tile.
"""

from __future__ import annotations

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.ops import kernels as _k

MAX_CMID = 256  # csrc/block.cu: one thread per mid channel, 256 threads


def fits_block(h: int, w: int, cin: int, cmid: int) -> bool:
    """This kernel's envelope: an identity bottleneck (1×1 Cin → Cmid, 3×3
    pad 1, 1×1 Cmid → Cin, stride 1) with Cmid <= min(Cin, 256). RN50's
    14²×1024/256 and 28²×512/128 blocks fit; any H and W do."""
    return h >= 1 and w >= 1 and 1 <= cmid <= min(cin, MAX_CMID)


def _as_matrix(w):
    """(1, 1, a, b) or (a, b) → (a, b)."""
    return w.reshape(w.shape[-2], w.shape[-1])


def bottleneck_block_plain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, *, relu_out=True):
    """The kernel's contract in plain PyTorch (bottleneck_block_reference,
    block.py:186-206): fp32 convs, fp32 epilogues, h1 and h2 rounded to
    x.dtype, the residual added in fp32 and one rounding at the end."""
    cmid = _as_matrix(w1).shape[1]
    w1 = _as_matrix(w1).reshape(1, 1, -1, cmid)
    w3 = _as_matrix(w3).reshape(1, 1, cmid, -1)
    f = [v.float() for v in (s1, b1, s2, b2)]
    s1, b1, s2, b2 = (v[:cmid] for v in f)
    h1 = torch.clamp_min(ops.conv2d(x.float(), w1.float()) * s1 + b1, 0.0).to(x.dtype)
    h2 = torch.clamp_min(ops.conv2d(h1.float(), w2.float(), padding=1) * s2 + b2,
                         0.0).to(x.dtype)
    y = ops.conv2d(h2.float(), w3.float()) * s3.float() + b3.float() + x.float()
    if relu_out:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def bottleneck_block(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, *, relu_out=True):
    """x (N, H, W, Cin) NHWC; w1 (Cin, Cmid) or (1, 1, Cin, Cmid); w2 (3, 3,
    Cmid, Cmid); w3 (Cmid, Cin) or (1, 1, Cmid, Cin), all in x.dtype;
    s1/b1/s2/b2 fp32 with at least Cmid entries (the first Cmid are used),
    s3/b3 fp32 (Cin,). Returns (N, H, W, Cin) in x.dtype."""
    if x.device.type == "cpu":
        return bottleneck_block_plain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                                      relu_out=relu_out)
    n, h, w, cin = x.shape
    m1, m3 = _as_matrix(w1).contiguous(), _as_matrix(w3).contiguous()
    cmid = m1.shape[1]
    if m1.shape != (cin, cmid) or tuple(w2.shape) != (3, 3, cmid, cmid) \
            or m3.shape != (cmid, cin):
        raise ValueError(f"bottleneck_block: weights {tuple(w1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(w3.shape)} do not form a {cin} → {cmid} → {cin} bottleneck")
    if not fits_block(h, w, cin, cmid):
        raise NotImplementedError(f"bottleneck_block: Cmid={cmid} with Cin={cin} is outside "
                                  f"the kernel's envelope (Cmid <= min(Cin, {MAX_CMID}))")
    w2 = w2.contiguous()
    for name, t in (("x", x), ("w1", m1), ("w2", w2), ("w3", m3)):
        _k.check_cuda_operand(f"bottleneck_block {name}", t, x.dtype)
    # one (6, Cin) fp32 operand, mid-width rows padded with zeros (block.py:145-147)
    sb = torch.zeros((6, cin), dtype=torch.float32, device=x.device)
    for r, v in enumerate((s1, b1, s2, b2, s3, b3)):
        v = v.reshape(-1).float()
        sb[r, :min(v.numel(), cin)] = v[:cin]
    out = torch.empty_like(x)
    rc = _k.lib().bottleneck_launch(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), m1.data_ptr(), w2.data_ptr(), m3.data_ptr(),
        sb.data_ptr(), out.data_ptr(), n, h, w, cin, cmid, int(relu_out), _k.stream_ptr(x))
    _k.check_launch("bottleneck_block", rc)
    _k.LAUNCHES["bottleneck_block"] += 1
    return out
