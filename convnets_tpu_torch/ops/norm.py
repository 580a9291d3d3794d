"""Batch normalization, NHWC (counterpart of convnets_tpu/ops/norm.py).

torch.nn.BatchNorm2d semantics: eps 1e-5, momentum 0.1 with
new_running = (1 - momentum)·running + momentum·batch_stat, the biased
batch variance for normalizing and the unbiased one in running_var.
Statistics are always fp32, whatever the compute dtype.

Under a data-parallel mesh (parallel/mesh.py) the statistics are the
global batch's: the forward's per-channel mean and E[x²] and the
backward's Σdy and Σdy·x̂ are reduced over the data group, each pair in
one call, and the counts are global (`global_count`), so the unbiased
running variance corrects by the global count as GSPMD's does. The scale
and bias gradients stay this rank's sums: the train step's one gradient
all-reduce sums them with every other gradient, and a global sum here
would enter it world times.
"""

from __future__ import annotations

import torch

from convnets_tpu_torch.parallel.mesh import active_mesh, data_mean_, data_sum_, global_count


def _apply_norm(x, mean, inv, scale, bias):
    """y = (x - mean)·inv·scale + bias with dtype-aware arithmetic.

    fp32 inputs use the subtract-first form; bf16 inputs fold the
    per-channel constants in fp32 and do one bf16 multiply-add.
    """
    w = inv if scale is None else scale.float() * inv
    if x.dtype == torch.float32:
        out = (x - mean) * w
        if bias is not None:
            out = out + bias.float()
        return out
    shift = -mean * w
    if bias is not None:
        shift = shift + bias.float()
    return x * w.to(x.dtype) + shift.to(x.dtype)


def batch_norm_inference(x, running_mean, running_var, scale, bias, *, eps=1e-5):
    """Normalize with running statistics (eval mode)."""
    inv = torch.rsqrt(running_var.float() + eps)
    return _apply_norm(x, running_mean.float(), inv, scale, bias).to(x.dtype)


def bn_input_grad(dy, xhat, scale, inv, n: int):
    """The textbook batch-norm gradient of norm.py:_bn_core_bwd (:77-95):
        dx = γ·inv · (dy − mean(dy) − x̂·mean(dy·x̂))
    with the two per-channel reductions in fp32 and the elementwise work
    in dy's dtype; n is this rank's count per channel. Returns (dx, Σdy·x̂,
    Σdy); the last two are the scale and bias gradients in fp32. Under an
    active mesh dx takes the two sums over the data group (one all-reduce
    of a 2·C buffer) and the global count, while the returned sums stay
    this rank's: the step's gradient all-reduce adds them up once (a copy
    of the (2, C) row taken before the all-reduce)."""
    cd = dy.dtype
    axes = tuple(range(dy.ndim - 1))
    dyf = dy.float()
    sums = dyf.new_empty((2, dy.shape[-1]))  # [Σdy; Σdy·x̂], all-reduced in place
    torch.sum(dyf, axes, out=sums[0])
    torch.sum(dyf * xhat.float(), axes, out=sums[1])
    own = sums
    if active_mesh() is not None:
        own = sums.clone()
        n = data_sum_(sums, n)
    g = scale.float() * inv
    dx = (g.to(cd) * (dy
                      - (sums[0] / n).to(cd)
                      - xhat * (sums[1] / n).to(cd))).to(cd)
    return dx, own[1], own[0]


class _BNCore(torch.autograd.Function):
    """(y, mean, biased var) with batch statistics; the backward is the
    hand-written VJP of norm.py:_bn_core (the statistics outputs carry no
    gradient)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, var = batch_stats(x)
        inv = torch.rsqrt(var + eps)
        y = _apply_norm(x, mean, inv, scale, bias).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, scale = ctx.saved_tensors
        cd = x.dtype
        n = x.numel() // x.shape[-1]
        xhat = (x - mean.to(cd)) * inv.to(cd)
        dx, dscale, dbias = bn_input_grad(dy.to(cd), xhat, scale, inv, n)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


def running_update(running_mean, running_var, mean, var, n: int, momentum: float):
    """torch's running-statistics update in fp32, with the unbiased
    variance: (1 - m)·r + m·stat, written out (not lerp) as the JAX
    package writes it, so the last ulp agrees. n: the count per channel
    behind the statistics, the global one under a mesh."""
    unbiased = var * (n / max(n - 1, 1))
    new_mean = (1.0 - momentum) * running_mean.float() + momentum * mean
    new_var = (1.0 - momentum) * running_var.float() + momentum * unbiased
    return new_mean, new_var


def batch_norm_train(x, running_mean, running_var, scale, bias, *, eps=1e-5, momentum=0.1):
    """Normalize with batch statistics over (N, H, W); return (y,
    new_running_mean, new_running_var). Missing affine parameters are
    replaced by ones / zeros, as in the JAX package."""
    c = x.shape[-1]
    if scale is None:
        scale = torch.ones(c, dtype=torch.float32, device=x.device)
    if bias is None:
        bias = torch.zeros(c, dtype=torch.float32, device=x.device)
    out, mean, var = _BNCore.apply(x, scale, bias, eps)
    n = global_count(x.numel() // c)
    new_mean, new_var = running_update(running_mean, running_var, mean, var, n, momentum)
    return out, new_mean, new_var


def batch_stats(x):
    """Per-channel (mean, biased var) of x over (N, H, W) in fp32, the var
    as E[x²] − mean² clamped at 0 (norm.py:batch_stats): the shared
    statistics of DenseBlockFused, where every layer's BN would reduce the
    same concatenated blocks again. Under an active mesh the mean and
    E[x²] are the global batch's: this rank's pair, averaged over the data
    group in one all-reduce of the (2, C) row they are computed into. x
    carries no gradient (the callers pass a detached tensor)."""
    axes = tuple(range(x.ndim - 1))
    xf = x.float()
    both = xf.new_empty((2, x.shape[-1]))  # [mean; E[x²]], averaged in place
    torch.mean(xf, axes, out=both[0])
    torch.mean(xf * xf, axes, out=both[1])
    data_mean_(both)
    mean, ex2 = both[0], both[1]
    return mean, torch.clamp_min(ex2 - mean * mean, 0.0)


class _BNApplyStats(torch.autograd.Function):
    """y = _apply_norm(x, mean, rsqrt(var + eps), scale, bias) in x's dtype;
    the backward is the total-derivative BN gradient (norm.py:
    _bn_apply_stats_bwd), which already holds the path through the
    statistics, so mean and var get a cotangent of zero."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, eps):
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, inv, scale)
        return _apply_norm(x, mean, inv, scale, bias).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, inv, scale = ctx.saved_tensors
        cd = x.dtype
        xhat = (x - mean.to(cd)) * inv.to(cd)
        dx, dscale, dbias = bn_input_grad(dy.to(cd), xhat, scale, inv, x.numel() // x.shape[-1])
        return (dx, torch.zeros_like(mean), torch.zeros_like(inv), dscale.to(scale.dtype),
                dbias.to(scale.dtype), None)


def bn_apply_stats(x, mean, var, scale, bias, eps=1e-5):
    """Train-mode batch norm with given batch statistics (fp32 `mean`, biased
    `var`), which must be those of x itself (batch_stats over the same
    values): the gradient is exact for that case only."""
    return _BNApplyStats.apply(x, mean, var, scale, bias, eps)
