"""Train-mode conv → batch-stat BN → [ReLU] (counterpart of
convnets_tpu/ops/pallas/fused.py:conv_bn_relu_train).

Forward: the conv2d_stats kernel (grouped_conv2d_stats for groups > 1:
the per-group sums, not the JAX package's block-diagonal weight, fused.py:
51-53) gives y and the (2, Cout) row of Σy, Σy²; the bn_act_forward kernel
(csrc/bn_act.cu) finishes mean, biased variance and rsqrt from that row
and writes normalize + ReLU in the compute dtype, one read of y and one
write (_fused_fwd_impl, fused.py:49-60). Backward (_fused_bwd, :70-103):
the bn_act_backward kernels recompute the ReLU mask and x̂ from y through
the forward's own rounding, reduce the two per-channel sums in fp32 and
write dy; dx/dw come from transposed convs in plain PyTorch, as the JAX
package leaves them to XLA.

Under an active data-parallel mesh (parallel/mesh.py) the statistics are
the global batch's, as GSPMD reduces them over the sharded batch: the
kernel's (2, Cout) row of Σy, Σy² is summed over the data group in place,
in one all-reduce, and n is the global count; the backward's Σdz and
Σdz·x̂ are summed likewise for dy (bn_act_backward), and dscale/dbias
are returned as this rank's sums, which the train step's gradient
all-reduce adds up once with dw. The JAX package leaves the fused kernel
under a multi-device mesh, because its statistics would be per shard; the
port keeps the kernel and reduces its sums.

A site the Winograd gate takes (`winograd` = m) gets (y, sums) from
winograd_conv2d_stats (ops/kernels/winograd.py: the output transform's
statistics epilogue, then the same reduction kernel) instead of
conv2d_stats; the rest is unchanged, its backward included (the direct
conv's transposed convs).
"""

from __future__ import annotations

import torch

from convnets_tpu_torch.ops import kernels as _k
from convnets_tpu_torch.ops.kernels.conv import conv2d_backward
from convnets_tpu_torch.parallel.mesh import data_sum_


class _ConvBNReLUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias, stride, padding, eps, relu, groups, dilation, winograd):
        if winograd is not None:
            y, sums = _k.winograd_conv2d_stats(x, w, padding=padding, m=winograd)
        elif groups == 1:
            y, sums = _k.conv2d_stats(x, w, stride=stride, padding=padding, dilation=dilation)
        else:
            y, sums = _k.grouped_conv2d_stats(x, w, groups, stride=stride, padding=padding,
                                              dilation=dilation)
        n = data_sum_(sums, y.shape[0] * y.shape[1] * y.shape[2])
        out, mean, var, inv = _k.bn_act_forward(y, sums, n, scale, bias, eps, relu)
        # y (the conv output), not out: x̂ and the ReLU mask are recomputed
        ctx.save_for_backward(x, w, scale, bias, y, mean, inv)
        ctx.conf = (stride, padding, relu, groups, dilation)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        x, w, scale, bias, y, mean, inv = ctx.saved_tensors
        stride, padding, relu, groups, dilation = ctx.conf
        n = y.shape[0] * y.shape[1] * y.shape[2]
        dy, dscale, dbias = _k.bn_act_backward(g, y, mean, inv, scale, bias, relu, n)
        dx, dw = conv2d_backward(x, w, dy, stride, padding, need=ctx.needs_input_grad[:2],
                                 groups=groups, dilation=dilation)
        return (dx, dw, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None, None, None,
                None, None, None)


def conv_bn_relu_train(x, w, scale, bias, stride=1, padding=0, eps=1e-5, relu=True, groups=1,
                       dilation=1, winograd=None):
    """x (N, H, W, Cin) and w (kh, kw, Cin/groups, Cout) in the compute
    dtype, scale/bias (Cout,) fp32; groups > 1 within `fits_grouped`; any
    dilation (SKConv's second path). Returns (out, mean, var): out in
    x.dtype, mean and biased var fp32 (Cout,) for the caller's running
    update (they carry no gradient; the global batch's under an active
    mesh). At 1x1 spatial (SKConv's descriptor)
    the statistics are over the N values of each channel. winograd: m
    of F(m,3) for a dense 3x3 stride-1 conv the gate takes, else None."""
    return _ConvBNReLUTrain.apply(x, w, scale, bias, stride, padding, eps, relu, groups,
                                  dilation, winograd)
