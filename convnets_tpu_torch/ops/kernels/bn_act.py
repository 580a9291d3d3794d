"""Batch-stat BN → [ReLU] of the fused conv sites: the wrappers of
csrc/bn_act.cu, their plain PyTorch versions, and the plan that picks
their route.

Replaces the part of convnets_tpu/ops/pallas/fused.py:conv_bn_relu_train
(:49-103) that XLA fuses around the conv2d_stats kernel there:
- `bn_act_forward` finishes the batch statistics from the conv kernel's
  (2, C) row of Σy, Σy² and writes relu(z) with z = _apply_norm(y, mean,
  inv, scale, bias) in y's dtype: one launch, one read of y and one write.
- `bn_act_backward` is the BN VJP with the ReLU mask recomputed from y
  through the forward's own rounding (dz = g where z > 0), then dy = γ·inv
  · (dz − Σdz/n − x̂·Σdz·x̂/n): three launches, the per-block partial sums
  of Σdz and Σdz·x̂, their fixed-order reduction (conv_fused.cu's
  stats_reduce_kernel) and the apply pass.

Under an active data-parallel mesh (parallel/mesh.py) the backward sums
its (2, C) row of Σdz, Σdz·x̂ over the data group in place between the
reduction and the apply pass, with the global count for n, and returns
this rank's sums (a copy taken before the all-reduce) as the scale and
bias gradients; the forward's caller all-reduces its Σy, Σy² row before
the call and passes the global count.

`bn_act_plan` picks the route by shape: "vector" (C % 8 == 0 and 16-byte
aligned operands: 8 channels per thread in 16-byte loads) or "loop" (one
channel per thread); LeNet's Cout 6, ShuffleNet's odd widths and SKConv's
1×1 descriptor take the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from convnets_tpu_torch.ops import kernels as _k
from convnets_tpu_torch.ops.kernels.pool import _aligned
from convnets_tpu_torch.ops.norm import _apply_norm, bn_input_grad
from convnets_tpu_torch.parallel.mesh import active_mesh, data_sum_

_ROUTES = {"loop": 0, "vector": 1}
THREADS = 256  # a block's threads: tx channel units × THREADS // tx rows
_BLOCKS = 8 * 132  # enough blocks of 256 threads to fill the H100's 132 SMs


class BNActPlan(NamedTuple):
    """How a bn_act kernel call runs. route: "vector" (a channel unit is 8
    channels, 16-byte loads) or "loop" (a unit is 1 channel). A block is
    `tx` units wide and THREADS // tx rows tall; `rowblocks` blocks share
    the rows of each tile of channels, each striding over them (the
    backward writes one partial row per row block)."""

    route: str
    tx: int
    rowblocks: int

    def args(self):
        """The plan as the C entry points take it: route, tx, rowblocks."""
        return _ROUTES[self.route], self.tx, self.rowblocks


def bn_act_plan(m: int, c: int, aligned: bool = True) -> BNActPlan:
    """The plan for M rows of C channels: the vector route iff C % 8 == 0
    and the operands are 16-byte aligned, else the loop; up to 32 units per
    block; enough row blocks that all tiles together make about _BLOCKS
    blocks, and no more than the rows fill."""
    vector = c % 8 == 0 and aligned
    units = c // 8 if vector else c
    tx = min(units, 32)
    tiles = -(-units // tx)
    rowblocks = max(1, min(-(-m // (THREADS // tx)), -(-_BLOCKS // tiles)))
    return BNActPlan("vector" if vector else "loop", tx, rowblocks)


def _check_channels(name, c, **vectors):
    for what, t in vectors.items():
        _k.check_cuda_operand(f"{name} {what}", t, torch.float32)
        if t.shape[-1] != c:
            raise ValueError(f"{name}: {what} has {t.shape[-1]} channels, y has {c}")


def bn_act_forward_plain(y, sums, n: int, scale, bias, eps: float = 1e-5, relu: bool = True):
    """The forward kernel's contract in plain PyTorch: mean = Σy/n, biased
    var = max(Σy²/n − mean², 0), inv = rsqrt(var + eps) in fp32, out =
    relu(_apply_norm(y, mean, inv, scale, bias)) in y's dtype. Returns
    (out, mean, var, inv)."""
    mean = sums[0] / n
    var = torch.clamp_min(sums[1] / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    z = _apply_norm(y, mean, inv, scale, bias).to(y.dtype)
    out = torch.clamp_min(z, 0.0) if relu else z
    return out, mean, var, inv


def bn_act_forward(y, sums, n: int, scale, bias, eps: float = 1e-5, relu: bool = True):
    """y (..., C) the conv output in the compute dtype; sums (2, C) fp32
    [Σy; Σy²] over the n values of each channel (the global batch's under
    a mesh); scale, bias (C,) fp32. Returns (out, mean, var, inv): out in
    y's dtype, mean, biased var and rsqrt(var + eps) fp32 (C,). One
    launch."""
    if y.device.type == "cpu":
        return bn_act_forward_plain(y, sums, n, scale, bias, eps, relu)
    return _launch_forward(y, sums, n, scale, bias, eps, relu)


def _launch_forward(y, sums, n, scale, bias, eps, relu):
    """Check the operands, then launch bn_act_forward_launch with its plan
    and count it; returns (out, mean, var, inv)."""
    name = "bn_act_forward"
    _k.check_cuda_operand(f"{name} y", y)
    c = y.shape[-1]
    m = y.numel() // c
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _check_channels(name, c, sums=sums, scale=scale, bias=bias)
    out = torch.empty_like(y)
    mean, var, inv = (torch.empty(c, dtype=torch.float32, device=y.device) for _ in range(3))
    plan = bn_act_plan(m, c, _aligned(y, out))
    rc = _k.lib().bn_act_forward_launch(
        _k.DTYPE_CODES[y.dtype], y.data_ptr(), sums.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), mean.data_ptr(), var.data_ptr(), inv.data_ptr(), m, c,
        int(n), float(eps), int(relu), *plan.args(), _k.stream_ptr(y))
    _k.check_launch(name, rc)
    _k.count_launch(name, plan.route)
    return out, mean, var, inv


def bn_act_backward_plain(g, y, mean, inv, scale, bias, relu: bool, n: int):
    """The backward kernels' contract in plain PyTorch (fused.py:_fused_bwd):
    x̂ and, with relu, the mask z > 0 recomputed from y in its dtype, then
    ops/norm.py:bn_input_grad. Returns (dy, Σdz·x̂, Σdz), the sums fp32."""
    cd = y.dtype
    xhat = (y - mean.to(cd)) * inv.to(cd)
    if relu:
        # the forward's own rounding of z: a mask flipped at z ≈ 0 would
        # route the gradient unlike the forward activation
        z = _apply_norm(y, mean, inv, scale, bias).to(cd)
        dz = torch.where(z > 0, g, torch.zeros((), dtype=g.dtype, device=g.device)).to(cd)
    else:
        dz = g.to(cd)
    return bn_input_grad(dz, xhat, scale, inv, n)


def bn_act_backward(g, y, mean, inv, scale, bias, relu: bool, n: int):
    """g, y (..., C) in the compute dtype (g is cast and made contiguous);
    mean, inv (C,) fp32 as bn_act_forward returned them; n this rank's
    count per channel. Returns (dy, Σdz·x̂, Σdz): dy in y's dtype, the
    scale and bias gradients fp32 (this rank's under a mesh). Three
    launches: the partial sums, their reduction, the apply pass."""
    if y.device.type == "cpu":
        return bn_act_backward_plain(g, y, mean, inv, scale, bias, relu, n)
    return _launch_backward(g, y, mean, inv, scale, bias, relu, n)


def _launch_backward(g, y, mean, inv, scale, bias, relu, n):
    """Check the operands, then launch the partial sums, their reduction
    and the apply pass with one plan, all-reduce the reduced (2, C) row in
    place under a mesh, and count the three; returns (dy, Σdz·x̂, Σdz)."""
    _k.check_cuda_operand("bn_act_backward y", y)
    g = g.to(y.dtype).contiguous()
    c = y.shape[-1]
    m = y.numel() // c
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _check_channels("bn_act_backward", c, mean=mean, inv=inv, scale=scale, bias=bias)
    if g.shape != y.shape:
        raise ValueError(f"bn_act_backward: g {tuple(g.shape)} and y {tuple(y.shape)} differ")
    dy = torch.empty_like(y)
    plan = bn_act_plan(m, c, _aligned(g, y, dy))
    lib, stream, dtype = _k.lib(), _k.stream_ptr(y), _k.DTYPE_CODES[y.dtype]
    # one (2, C) partial row per row block, and their reduction in a tensor
    # of its own: the gradients returned from it do not keep the partials
    partial = torch.empty((plan.rowblocks, 2, c), dtype=torch.float32, device=y.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=y.device)
    rc = lib.bn_act_sums_launch(dtype, g.data_ptr(), y.data_ptr(), mean.data_ptr(),
                                inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                partial.data_ptr(), m, c, int(relu), *plan.args(), stream)
    _k.check_launch("bn_act_backward_sums", rc)
    _k.count_launch("bn_act_backward_sums", plan.route)
    rc = lib.stats_reduce_launch(partial.data_ptr(), sums.data_ptr(), plan.rowblocks, c, stream)
    _k.check_launch("bn_act_backward_reduce", rc)
    _k.LAUNCHES["bn_act_backward_reduce"] += 1
    own = sums
    if active_mesh() is not None:
        own = sums.clone()  # this rank's Σdz, Σdz·x̂: the parameter gradients
        n = data_sum_(sums, n)
    rc = lib.bn_act_apply_launch(dtype, g.data_ptr(), y.data_ptr(), mean.data_ptr(),
                                 inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                 sums.data_ptr(), dy.data_ptr(), m, c, int(n), int(relu),
                                 *plan.args(), stream)
    _k.check_launch("bn_act_backward_apply", rc)
    _k.count_launch("bn_act_backward_apply", plan.route)
    return dy, own[1], own[0]
