"""Shared attention blocks: Squeeze-and-Excitation and Selective-Kernel
(counterpart of convnets_tpu/models/blocks.py), with the JAX child and
leaf names, so `bridge.py` maps them as it maps every other layer.

  SEUnit  global pool (fp32 mean, cast back) → linear C→C/r, no bias →
          ReLU → linear C/r→C → sigmoid → channel rescale of x, the
          excitation cast to x's dtype first (blocks.py:40-46)
  SKConv  kernel0 / kernel1: grouped 3x3 conv blocks, dilation and padding
          1 + i; the paths summed; the sum's global pool (keepdims) →
          descriptor (1x1 conv block at 1x1 spatial) → att0 / att1 (plain
          1x1 convs with bias, no BN) → softmax over the paths in fp32, cast
          back → the paths' weighted sum (blocks.py:118-136)

Every conv runs a kernel of `ops.kernels`: the paths the grouped kernels
(path 1 dilated), the descriptor the dense conv, the attention convs the
dense conv as plain Conv2d layers (conv2d_train in train mode). The
linear layers, the sum, sigmoid and softmax stay plain PyTorch, as the
JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from convnets_tpu_torch import nn, ops
from convnets_tpu_torch.nn.module import Module
from convnets_tpu_torch.ops import initializers as init


class SEUnit(Module):
    """Squeeze-and-Excitation; keeps the tensor's shape. `w1` (C, C/r) and
    `w2` (C/r, C) are the JAX leaves of the same names."""

    JAX_LEAVES = {"w1": ("params", "w1"), "w2": ("params", "w2")}

    def __init__(self, channels: int, reduction: int, linear_init="normal"):
        super().__init__()
        self.channels = int(channels)
        self.reduced = int(channels) // int(reduction)
        self.linear_init = linear_init
        self.w1 = self.w2 = None

    def init(self, generator, in_shape):
        dtype = self.policy.param_dtype
        draw = init.normal_linear if self.linear_init == "normal" else init.linear_default
        self.w1 = torch.nn.Parameter(draw((self.channels, self.reduced), generator, dtype))
        self.w2 = torch.nn.Parameter(draw((self.reduced, self.channels), generator, dtype))

    def forward(self, x):
        cd = self.policy.compute_dtype
        squeezed = ops.global_avg_pool2d(x)  # (N, C)
        e = ops.relu(ops.linear(squeezed, self.w1.to(cd)))
        e = ops.sigmoid(ops.linear(e, self.w2.to(cd)))
        return x * e[:, None, None, :].to(x.dtype)

    def extra_repr(self):
        return f"C={self.channels}, r→{self.reduced}"

    def summary_label(self):
        return f"SEUnit({self.extra_repr()})"


class SKConv(Module):
    """Selective-Kernel convolution over `num_paths` dilated grouped 3x3
    paths; shape-preserving except for the stride. Children: kernel0, …,
    descriptor, att0, … (the JAX names)."""

    def __init__(self, builder, num_paths=2, groups=32, reduction=16, min_descriptor=32,
                 stride=1):
        super().__init__()
        self.num_paths = num_paths
        self.channels = builder.in_channels
        self.stride = stride
        self.desc_size = max(self.channels // reduction, min_descriptor)
        for i in range(num_paths):
            self.add_module(f"kernel{i}", builder.conv_block(
                self.channels, set_output=False, kernel=3, padding=1 + i, dilation=1 + i,
                groups=groups, stride=stride))
        self.descriptor = builder.conv_block(self.desc_size, set_output=False, kernel=1)
        # raw torch nn.Conv2d in the reference: bias on, no BN
        for i in range(num_paths):
            self.add_module(f"att{i}", nn.Conv2d(self.channels, 1, bias=True,
                                                 init_mode=builder.conv_init))

    def _paths(self):
        return [self._modules[f"kernel{i}"] for i in range(self.num_paths)]

    def _attentions(self):
        return [self._modules[f"att{i}"] for i in range(self.num_paths)]

    def init(self, generator, in_shape):
        n = in_shape[0]
        for path in self._paths():
            path.init(generator, in_shape)
        self.descriptor.init(generator, (n, 1, 1, self.channels))
        for att in self._attentions():
            att.init(generator, (n, 1, 1, self.desc_size))

    def out_shape(self, in_shape):
        return self._paths()[0].out_shape(tuple(in_shape))

    def shape_flow(self, in_shape):
        """Each child's input shape: the paths take the block's input, the
        descriptor the paths' pooled sum (N, 1, 1, C), the attention convs
        the descriptor's output (N, 1, 1, d)."""
        n = self.out_shape(in_shape)[0]
        flows = {f"kernel{i}": tuple(in_shape) for i in range(self.num_paths)}
        flows["descriptor"] = (n, 1, 1, self.channels)
        flows.update({f"att{i}": (n, 1, 1, self.desc_size) for i in range(self.num_paths)})
        return flows

    def forward(self, x):
        stacked = torch.stack([path(x) for path in self._paths()], dim=-2)  # (N, H', W', P, C)
        fused = stacked.sum(dim=-2)
        desc = self.descriptor(ops.global_avg_pool2d(fused, keepdims=True))  # (N, 1, 1, d)
        att = torch.stack([a(desc) for a in self._attentions()], dim=-2)  # (N, 1, 1, P, C)
        att = ops.softmax(att.float(), axis=-2).to(stacked.dtype)
        return (stacked * att).sum(dim=-2)

    def extra_repr(self):
        return f"C={self.channels}, paths={self.num_paths}, s={self.stride}"

    def summary_label(self):
        return f"SKConv({self.extra_repr()})"
