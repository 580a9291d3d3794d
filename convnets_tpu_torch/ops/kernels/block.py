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

`block_plan` chooses the route. bf16 with Cmid in {64, 128, 256} and Cin %
64 == 0 (RN50's three identity shapes among them) runs on the tensor cores
(csrc/block_wgmma.cu): a CTA owns `th` whole output rows of one image, h1
is computed over those rows and the row above and below, and the three
products are chained wgmma MMAs with h1 and h2 in shared memory. fp32 and
every other bf16 shape of the envelope run the CUDA-core loop of
csrc/block.cu, 7×7 output tiles with a 9×9 h1 halo.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.ops import kernels as _k

# the envelope: the simt route's 256 threads, one per mid channel, and the
# wgmma route's conv2 accumulator (m64n256: 128 registers a thread)
MAX_CMID = 256
_ROUTES = {"simt": 0, "wgmma": 1}
WGMMA_CMID = (64, 128, 256)  # Cmid of the tensor-core route
# csrc/block_wgmma.cu: MMA rows of conv2/conv3 per CTA (two warpgroups of
# 64), the ring (three 48 KB slots) and the H100's shared memory per block
_M2 = 128
_RING_BYTES = 3 * 48 * 1024
_MAX_SMEM = 232448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BlockPlan(NamedTuple):
    """How a bottleneck_block call runs. route: "wgmma" (bf16, the tensor-core
    kernel of csrc/block_wgmma.cu) or "simt" (the CUDA-core loop of
    csrc/block.cu). wgmma only: each CTA computes `th` output rows of one
    image (its h1 covers th + 2 rows, clipped to zeros outside the image),
    `m1` MMA rows for conv1 ((th + 2)·W pixels in 64-row blocks), 128 for
    conv2 and conv3, with `smem` bytes of shared memory."""

    route: str
    th: int = 0
    m1: int = 0
    smem: int = 0

    def args(self):
        """The plan as bottleneck_launch takes it: route, th."""
        return _ROUTES[self.route], self.th

    def tiles(self, h: int):
        """(first output row, rows) of each CTA of one image: the image's
        rows, each exactly once."""
        if self.route != "wgmma":
            return ()
        return tuple((r, min(self.th, h - r)) for r in range(0, h, self.th))


def _wgmma_smem(th: int, w: int, cmid: int) -> int:
    """Shared memory of a wgmma CTA (block_wgmma.cu smem_bytes): 1 KB to
    align the ring, the ring, the bordered h1 ((th + 2) × (W + 2) × Cmid
    bf16; h2 overlays it)."""
    region = max((th + 2) * (w + 2) * cmid * 2, _M2 * cmid * 2)
    return 1024 + _RING_BYTES + _cdiv(region, 1024) * 1024


def wgmma_rows(h: int, w: int, cmid: int) -> int:
    """Output rows per CTA of the tensor-core route for an H × W image at
    mid width Cmid, 0 where no tile fits: the most rows th for which th·W ≤
    128 (the MMA rows of conv2 and conv3), the (th + 2)·W h1 pixels fill at
    most 2 m64 blocks at Cmid = 256 (its n256 accumulator is 128 registers
    a thread) or 4 below it, and the shared memory fits; then evened out
    over the image's rows."""
    h1_rows = 128 if cmid == 256 else 256
    th = min(h, _M2 // w, h1_rows // w - 2)
    while th >= 1 and _wgmma_smem(th, w, cmid) > _MAX_SMEM:
        th -= 1
    return _cdiv(h, _cdiv(h, th)) if th >= 1 else 0


def block_plan(dtype, n: int, h: int, w: int, cin: int, cmid: int,
               aligned: bool = True) -> BlockPlan:
    """The plan of a bottleneck block of N images H × W, Cin → Cmid → Cin,
    in `dtype` (inside `fits_block`). bf16 with Cmid in WGMMA_CMID, Cin % 64
    == 0 and every operand 16-byte aligned (`aligned`), where a tile fits
    (`wgmma_rows`): the tensor cores. fp32, the other bf16 shapes, and a
    width that leaves no tile (W > 128, or W > 42 at Cmid = 256): the
    CUDA-core loop. N does not change the plan: the grid is N × the image's
    tiles."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_plan: dtype {dtype} not supported (float32, bfloat16)")
    if not fits_block(h, w, cin, cmid):
        raise NotImplementedError(f"block_plan: Cmid={cmid} with Cin={cin} is outside the "
                                  f"kernel's envelope (Cmid <= min(Cin, {MAX_CMID}))")
    th = wgmma_rows(h, w, cmid)
    if dtype != torch.bfloat16 or cmid not in WGMMA_CMID or cin % 64 or not aligned or not th:
        return BlockPlan("simt")
    return BlockPlan("wgmma", th, 64 * _cdiv((th + 2) * w, 64), _wgmma_smem(th, w, cmid))


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
    return _launch_block(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, relu_out=relu_out)


def _launch_block(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, *, relu_out=True, route=None):
    """Check the operands, then launch bottleneck_launch with the plan of
    `block_plan` (route="simt" forces the CUDA-core loop: the on-card
    comparison of the two routes), and count it under its route."""
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, m1, w2, m3, out))
    plan = BlockPlan("simt") if route == "simt" else block_plan(x.dtype, n, h, w, cin, cmid,
                                                                   aligned)
    rc = _k.lib().bottleneck_launch(
        _k.DTYPE_CODES[x.dtype], x.data_ptr(), m1.data_ptr(), w2.data_ptr(), m3.data_ptr(),
        sb.data_ptr(), out.data_ptr(), n, h, w, cin, cmid, int(relu_out), *plan.args(),
        _k.stream_ptr(x))
    _k.check_launch("bottleneck_block", rc)
    _k.count_launch("bottleneck_block", plan.route)
    return out
