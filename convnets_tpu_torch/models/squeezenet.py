"""SqueezeNet 1.0 / 1.1 (counterpart of convnets_tpu/models/squeezenet.py,
built by the same Builder calls): an op list of conv / max pool / Fire;
Fire = a 1x1 squeeze, then a Concat of a 1x1 and a 3x3 expand; a fully
convolutional classifier (dropout → 1x1 ConvBNReLU with num_classes
filters → global average pool).

The max pools are 3x3/2 without padding. At 32² version 1.0 collapses:
its 7x7/2 stem and the first two pools leave 2x2, which the third pool
takes to 0x0. Version 1.1 (3x3/2 stem) is the one for 32² inputs; 1.0
needs a larger input (224² as published).
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register

# copied from convnets_tpu/models/squeezenet.py: ("conv", filters, kernel,
# stride), ("maxpool", kernel, stride), ("fire", squeeze, expand 1x1,
# expand 3x3)
CONFIG = {
    "1.0": [
        ("conv", 96, 7, 2),
        ("maxpool", 3, 2),
        ("fire", 16, 64, 64),
        ("fire", 16, 64, 64),
        ("fire", 32, 128, 128),
        ("maxpool", 3, 2),
        ("fire", 32, 128, 128),
        ("fire", 48, 192, 192),
        ("fire", 48, 192, 192),
        ("fire", 64, 256, 256),
        ("maxpool", 3, 2),
        ("fire", 64, 256, 256),
    ],
    "1.1": [
        ("conv", 64, 3, 2),
        ("maxpool", 3, 2),
        ("fire", 16, 64, 64),
        ("fire", 16, 64, 64),
        ("maxpool", 3, 2),
        ("fire", 32, 128, 128),
        ("fire", 32, 128, 128),
        ("maxpool", 3, 2),
        ("fire", 48, 192, 192),
        ("fire", 48, 192, 192),
        ("fire", 64, 256, 256),
        ("fire", 64, 256, 256),
    ],
}


def _fire(b: Builder, squeeze: int, expand_1x1: int, expand_3x3: int) -> nn.Sequential:
    block = nn.Sequential([
        b.conv_block(squeeze, kernel=1),
        nn.Concat([
            b.conv_block(expand_1x1, set_output=False, kernel=1),
            b.conv_block(expand_3x3, set_output=False, kernel=3, padding=1),
        ]),
    ])
    b.in_channels = expand_1x1 + expand_3x3
    return block


@register("squeezenet")
def build_squeezenet(setting) -> Model:
    b = Builder(setting)
    layers = []
    for cfg in CONFIG[str(setting.kind)]:
        op = cfg[0]
        if op == "fire":
            layers.append(_fire(b, *cfg[1:]))
        elif op == "maxpool":
            layers.append(nn.MaxPool2d(cfg[1], stride=cfg[2]))
        else:  # conv
            layers.append(b.conv_block(cfg[1], kernel=cfg[2], stride=cfg[3]))
    layers += [
        b.dropout(),
        b.conv_block(setting.num_classes, kernel=1),
        nn.GlobalAvgPool2d(),
    ]
    return Model("SqueezeNet", setting, nn.Sequential(layers))
