"""DenseNet-121/169/201/264/161 (counterpart of convnets_tpu/models/densenet.py,
built by the same Builder calls).

  stem        conv7x7 s2 p3 (+BN+ReLU) → maxpool 3x3 s2 p1
  dense layer BN → ReLU → dropout → 1x1 (4·growth) → BN → ReLU → dropout →
              3x3 (growth), concatenated after its input
  transition  BN → ReLU → 1x1 (C/2) → avgpool 2x2 s2
  head        BN → ReLU → global avgpool → dropout → linear

The pre-activation BNs are unconditional (as in the reference), while the
conv bias still follows `not batch_norm`. The opt-in shared-statistics
block (CONVNETS_TPU_DENSENET_FUSED=1, DenseBlockFused) is not ported: it
would build another state layout, so that setting raises.
"""

from __future__ import annotations

import os

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register

# copied from convnets_tpu/models/densenet.py (importing it would pull in
# jax): (growth_rate, block_sizes, init_features)
CONFIG = {
    "121": (32, [6, 12, 24, 16], 64),
    "169": (32, [6, 12, 32, 32], 64),
    "201": (32, [6, 12, 48, 32], 64),
    "264": (32, [6, 12, 64, 48], 64),
    "161": (48, [6, 12, 36, 24], 96),
}


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
        raise NotImplementedError(
            "CONVNETS_TPU_DENSENET_FUSED=1: the shared-statistics DenseBlockFused "
            "(ops batch_stats / bn_apply_stats) is not ported yet (ROADMAP.md: modules "
            "item 5)")
    layers = []
    for _ in range(size):
        cin = b.in_channels
        layers.append(_dense_layer(b, growth, bottleneck_factor=4))
        b.in_channels = cin + growth
    block = nn.Sequential(layers)
    if getattr(b.setting, "remat", False):
        block = nn.Remat(block)  # eval only: train-mode Remat raises
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
