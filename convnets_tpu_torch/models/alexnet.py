"""AlexNet (counterpart of convnets_tpu/models/alexnet.py, built by the
same Builder calls), two kinds keyed by Settings.kind:
  "imagenet" (the default): the 224x224 geometry, an 11x11 stride-4 stem
             (the dense conv kernels take any stride), BN in place of LRN;
  "cifar":   a 3x3 stride-1 stem for 32x32 inputs, the same channels.
Head: global avgpool → dropout → linear 4096 → ReLU → dropout → linear
4096 → ReLU → linear.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register


@register("alexnet")
def build_alexnet(setting) -> Model:
    kind = str(setting.kind) or "imagenet"
    b = Builder(setting)
    if kind == "imagenet":
        layers = [
            b.conv_block(64, kernel=11, stride=4, padding=2),
            nn.MaxPool2d(3, stride=2),
            b.conv_block(192, kernel=5, padding=2),
            nn.MaxPool2d(3, stride=2),
            b.conv_block(384, kernel=3, padding=1),
            b.conv_block(256, kernel=3, padding=1),
            b.conv_block(256, kernel=3, padding=1),
            nn.MaxPool2d(3, stride=2),
        ]
    elif kind == "cifar":
        layers = [
            b.conv_block(64, kernel=3, stride=1, padding=1),
            nn.MaxPool2d(2, stride=2),
            b.conv_block(192, kernel=3, padding=1),
            nn.MaxPool2d(2, stride=2),
            b.conv_block(384, kernel=3, padding=1),
            b.conv_block(256, kernel=3, padding=1),
            b.conv_block(256, kernel=3, padding=1),
            nn.MaxPool2d(2, stride=2),
        ]
    else:
        raise KeyError(f"alexnet kind must be 'imagenet' or 'cifar', got {kind!r}")
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(4096),
        nn.ReLU(),
        b.dropout(),
        b.linear(4096),
        nn.ReLU(),
        b.linear(setting.num_classes),
    ]
    return Model("AlexNet", setting, nn.Sequential(layers))
