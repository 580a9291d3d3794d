"""DenseNet-121/169/201/264/161 (counterpart of convnets_tpu/models/densenet.py,
built by the same Builder calls).

  stem        conv7x7 s2 p3 (+BN+ReLU) → maxpool 3x3 s2 p1
  dense layer BN → ReLU → dropout → 1x1 (4·growth) → BN → ReLU → dropout →
              3x3 (growth), concatenated after its input
  transition  BN → ReLU → 1x1 (C/2) → avgpool 2x2 s2
  head        BN → ReLU → global avgpool → dropout → linear

The pre-activation BNs are unconditional (as in the reference), while the
conv bias still follows `not batch_norm`. CONVNETS_TPU_DENSENET_FUSED=1,
read at build time as in the JAX package, builds each dense block as the
shared-statistics DenseBlockFused, in its own variable layout.
"""

from __future__ import annotations

import os

import torch

from convnets_tpu_torch import nn, ops
from convnets_tpu_torch.models.base import Builder, Model, register
from convnets_tpu_torch.ops.norm import running_update
from convnets_tpu_torch.parallel.mesh import global_count

# copied from convnets_tpu/models/densenet.py (importing it would pull in
# jax): (growth_rate, block_sizes, init_features)
CONFIG = {
    "121": (32, [6, 12, 24, 16], 64),
    "169": (32, [6, 12, 32, 32], 64),
    "201": (32, [6, 12, 48, 32], 64),
    "264": (32, [6, 12, 64, 48], 64),
    "161": (48, [6, 12, 36, 24], 96),
}


class _Affine(nn.Module):
    """A BN's scale and bias alone (DenseBlockFused's bn1_i): params/scale,
    params/bias."""

    JAX_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias")}

    def __init__(self):
        super().__init__()
        self.weight = self.bias = None

    def init(self, generator, in_shape):
        c = in_shape[-1]
        dtype = self.policy.param_dtype
        self.weight = torch.nn.Parameter(torch.ones(c, dtype=dtype))
        self.bias = torch.nn.Parameter(torch.zeros(c, dtype=dtype))


class _StatsBank(nn.Module):
    """One source block's running statistics (DenseBlockFused's bank_j):
    state/mean, state/var, fp32."""

    JAX_LEAVES = {"running_mean": ("state", "mean"), "running_var": ("state", "var")}

    def __init__(self):
        super().__init__()
        self.register_buffer("running_mean", None)
        self.register_buffer("running_var", None)

    def init(self, generator, in_shape):
        self.running_mean = torch.zeros(in_shape[-1], dtype=torch.float32)
        self.running_var = torch.ones(in_shape[-1], dtype=torch.float32)


class DenseBlockFused(nn.Module):
    """The shared-statistics dense block (models/densenet.py:DenseBlockFused).

    The buffer a dense layer's leading BN normalizes is the concatenation
    of blocks that never change once made, so the batch statistics layer i
    would take over block j are those every earlier consumer took: each
    block's statistics are computed once (ops.batch_stats) and banked, and
    each layer applies them to the concatenated buffer (ops.bn_apply_stats,
    whose backward is the total-derivative BN gradient): O(L) statistics
    reductions per block instead of O(L²). Equal to the standard block up
    to float reassociation.

    Variables, in the JAX layout: params bn1_i {scale, bias}, conv1_i {w},
    bn2_i {scale, bias}, conv2_i {w}; state bn2_i {mean, var} and bank_j
    {mean, var} for j < size (block 0 is the input; the last layer's
    output only joins the concat, and is not banked). Train mode updates
    each bank with the unbiased running update and bn2_i as BatchNorm2d
    does, none of them in a Remat recompute; eval mode normalizes with the
    banks' running statistics. The convs are the port's Conv2d, so they run
    conv2d_train in train mode and the conv2d_fused op in eval mode; only
    they run as modules (bn1_i, bn2_i and the banks hold tensors)."""

    def __init__(self, size, growth, in_channels, bottleneck_factor=4, drop_rate=0.0,
                 eps=1e-5, momentum=0.1, conv_init="he"):
        super().__init__()
        self.size, self.growth, self.c0 = int(size), int(growth), int(in_channels)
        self.drop, self.eps, self.momentum = float(drop_rate), float(eps), float(momentum)
        for i in range(self.size):
            self.add_module(f"bn1_{i}", _Affine())
            self.add_module(f"conv1_{i}", nn.Conv2d(bottleneck_factor * growth, kernel=1,
                                                    bias=False, init_mode=conv_init))
            self.add_module(f"bn2_{i}", nn.BatchNorm2d(eps=eps, momentum=momentum))
            self.add_module(f"conv2_{i}", nn.Conv2d(growth, kernel=3, padding=1, bias=False,
                                                    init_mode=conv_init))
        for j in range(self.size):
            self.add_module(f"bank_{j}", _StatsBank())

    def init(self, generator, in_shape):
        n, h, w, _ = in_shape
        for i in range(self.size):
            cin = (n, h, w, self.c0 + i * self.growth)
            mid = (n, h, w, self._modules[f"conv1_{i}"].out_channels)
            self._modules[f"bn1_{i}"].init(generator, cin)
            self._modules[f"conv1_{i}"].init(generator, cin)
            self._modules[f"bn2_{i}"].init(generator, mid)
            self._modules[f"conv2_{i}"].init(generator, mid)
        for j in range(self.size):
            self._modules[f"bank_{j}"].init(generator, (self.c0 if j == 0 else self.growth,))

    def out_shape(self, in_shape):
        n, h, w, c = in_shape
        return (n, h, w, c + self.size * self.growth)

    def _bank_stats(self, t, j):
        bank = self._modules[f"bank_{j}"]
        if not self.training:
            return bank.running_mean.float(), bank.running_var.float()
        mean, var = ops.batch_stats(t.detach())  # bn_apply_stats gives them no cotangent
        n = global_count(t.numel() // t.shape[-1])
        nn.write_running(bank, *running_update(bank.running_mean, bank.running_var, mean, var,
                                               n, self.momentum))
        return mean, var

    def forward(self, x):
        m = self._modules
        x = x.to(self.policy.compute_dtype)
        blocks = [x]
        mean, var = self._bank_stats(x, 0)
        means, variances = [mean], [var]
        for i in range(self.size):
            g1, bn2 = m[f"bn1_{i}"], m[f"bn2_{i}"]
            h = blocks[0] if len(blocks) == 1 else torch.cat(blocks, -1)
            mc = means[0] if len(means) == 1 else torch.cat(means)
            vc = variances[0] if len(variances) == 1 else torch.cat(variances)
            if self.training:
                h = ops.bn_apply_stats(h, mc, vc, g1.weight, g1.bias, self.eps)
            else:
                h = ops.batch_norm_inference(h, mc, vc, g1.weight, g1.bias, eps=self.eps)
            h = nn.dropout(ops.relu(h), self.drop, self.training)
            h = m[f"conv1_{i}"](h)
            if self.training:
                h, new_mean, new_var = ops.batch_norm_train(
                    h, bn2.running_mean, bn2.running_var, bn2.weight, bn2.bias, eps=self.eps,
                    momentum=self.momentum)
                nn.write_running(bn2, new_mean, new_var)
            else:
                h = ops.batch_norm_inference(h, bn2.running_mean, bn2.running_var, bn2.weight,
                                             bn2.bias, eps=self.eps)
            h = nn.dropout(ops.relu(h), self.drop, self.training)
            blocks.append(m[f"conv2_{i}"](h))
            if i < self.size - 1:
                mean, var = self._bank_stats(blocks[-1], i + 1)
                means.append(mean)
                variances.append(var)
        return torch.cat(blocks, -1)

    def extra_repr(self):
        return f"size={self.size}, growth={self.growth}"

    def summary_children(self):
        """The JAX block's children: its convs alone, conv1_i and conv2_i
        in layer order (bn1_i, bn2_i and the banks are tensors there)."""
        return {name: self._modules[name] for i in range(self.size)
                for name in (f"conv1_{i}", f"conv2_{i}")}

    def summary_label(self):
        return f"DenseBlockFused({self.extra_repr()})"


def _dense_layer(b: Builder, growth: int, bottleneck_factor: int) -> nn.Concat:
    body = nn.Sequential([
        nn.BatchNorm2d(),
        nn.ReLU(),
        b.dropout(),
        b.conv(bottleneck_factor * growth, kernel=1),
        nn.BatchNorm2d(),
        nn.ReLU(),
        b.dropout(),
        b.conv(growth, kernel=3, padding=1),
    ])
    return nn.Concat([nn.Identity(), body])  # the input first


def _dense_block(b: Builder, size: int, growth: int):
    if os.environ.get("CONVNETS_TPU_DENSENET_FUSED", "0") == "1":
        block = DenseBlockFused(size, growth, b.in_channels, bottleneck_factor=4,
                                drop_rate=b.setting.dropout_rate, conv_init=b.conv_init)
        b.in_channels += size * growth
        return nn.Remat(block) if getattr(b.setting, "remat", False) else block
    layers = []
    for _ in range(size):
        cin = b.in_channels
        layers.append(_dense_layer(b, growth, bottleneck_factor=4))
        b.in_channels = cin + growth
    block = nn.Sequential(layers)
    if getattr(b.setting, "remat", False):
        block = nn.Remat(block)
    return block


def _transition(b: Builder) -> nn.Sequential:
    return nn.Sequential([
        nn.BatchNorm2d(),
        nn.ReLU(),
        b.conv(b.in_channels // 2, kernel=1),
        nn.AvgPool2d(2, stride=2),
    ])


@register("densenet")
def build_densenet(setting) -> Model:
    growth, block_sizes, init_features = CONFIG[str(setting.kind)]
    b = Builder(setting)
    layers = [
        b.conv_block(init_features, kernel=7, stride=2, padding=3),
        nn.MaxPool2d(3, stride=2, padding=1),
    ]
    for i, size in enumerate(block_sizes):
        layers.append(_dense_block(b, size, growth))
        if i != len(block_sizes) - 1:
            layers.append(_transition(b))
    layers += [
        nn.BatchNorm2d(),
        nn.ReLU(),
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("DenseNet", setting, nn.Sequential(layers))
