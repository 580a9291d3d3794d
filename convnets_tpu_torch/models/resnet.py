"""ResNet-18/34 (basic) and 26/50/101/152 (bottleneck)
(counterpart of convnets_tpu/models/resnet.py, built by the same Builder calls).

  stem   conv7x7 s2 p3 (+BN+ReLU) → maxpool 3x3 s2 p1
  stage  (filters, repeats, stride-of-first-block) per config
  basic  [3x3 s, 3x3] + shortcut; bottleneck [1x1, 3x3 s, 1x1·exp] + shortcut
  shortcut: 1x1 conv(+BN, no ReLU) when stride≠1 or channels change
  post-add ReLU; head = global avgpool → dropout → linear
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register

# copied from convnets_tpu/models/resnet.py (importing it would pull in jax)
CONFIG = {
    "18": ("basic", [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]),
    "34": ("basic", [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]),
    "26": ("bottleneck", [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]),
    "50": ("bottleneck", [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]),
    "101": ("bottleneck", [(64, 3, 1), (128, 4, 2), (256, 23, 2), (512, 3, 2)]),
    "152": ("bottleneck", [(64, 3, 1), (128, 8, 2), (256, 36, 2), (512, 3, 2)]),
}


def _residual_block(b: Builder, block_type: str, filters: int, expansion: int, stride: int = 1):
    out_ch = filters * expansion
    needs_synch = stride != 1 or b.in_channels != out_ch
    shortcut = (
        b.conv_block(out_ch, activation=False, set_output=False, kernel=1, stride=stride)
        if needs_synch else nn.Identity()
    )
    if block_type == "basic":
        body = nn.Sequential([
            b.conv_block(filters, kernel=3, padding=1, stride=stride),
            b.conv_block(out_ch, activation=False, kernel=3, padding=1),
        ])
    else:
        body = nn.Sequential([
            b.conv_block(filters, kernel=1),
            b.conv_block(filters, kernel=3, padding=1, stride=stride),
            b.conv_block(out_ch, activation=False, kernel=1),
        ])
    b.in_channels = out_ch
    block = nn.Add([body, shortcut], post_relu=True)
    if getattr(b.setting, "remat", False):
        block = nn.Remat(block)
    return block


def build_trunk(b: Builder, block_type: str, stages, expansion: int):
    layers = [
        b.conv_block(64, kernel=7, stride=2, padding=3),
        nn.MaxPool2d(3, stride=2, padding=1),
    ]
    for filters, repeats, stride in stages:
        layers.append(_residual_block(b, block_type, filters, expansion, stride))
        for _ in range(1, repeats):
            layers.append(_residual_block(b, block_type, filters, expansion))
    return layers


@register("resnet")
def build_resnet(setting) -> Model:
    block_type, stages = CONFIG[str(setting.kind)]
    expansion = 4 if block_type == "bottleneck" else 1
    b = Builder(setting)
    layers = build_trunk(b, block_type, stages, expansion)
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("ResNet", setting, nn.Sequential(layers))
