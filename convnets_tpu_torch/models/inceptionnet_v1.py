"""InceptionNet-v1 (GoogLeNet; counterpart of
convnets_tpu/models/inceptionnet_v1.py, built by the same Builder calls):
a 7x7/2 stem, then 9 inception blocks of four branches concatenated on
the channel axis (1x1; 1x1 → 3x3; 1x1 → 5x5; a 3x3 stride-1 max pool with
padding 1 → 1x1), no auxiliary classifiers, BN after every conv.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register

# copied from convnets_tpu/models/inceptionnet_v1.py: (ch_1x1, ch_3x3_red,
# ch_3x3, ch_5x5_red, ch_5x5, pool_proj) per block, "M" a 3x3/2 max pool
BLOCKS = [
    (64, 96, 128, 16, 32, 32),
    (128, 128, 192, 32, 96, 64),
    "M",
    (192, 96, 208, 16, 48, 64),
    (160, 112, 224, 24, 64, 64),
    (128, 128, 256, 24, 64, 64),
    (112, 144, 288, 32, 64, 64),
    (256, 160, 320, 32, 128, 128),
    "M",
    (256, 160, 320, 32, 128, 128),
    (384, 192, 384, 48, 128, 128),
]


def _inception_block(b: Builder, c1, c3r, c3, c5r, c5, pp) -> nn.Concat:
    block = nn.Concat([
        b.conv_block(c1, set_output=False, kernel=1),
        nn.Sequential([
            b.conv_block(c3r, set_output=False, kernel=1),
            b.conv_block(c3, set_output=False, kernel=3, padding=1),
        ]),
        nn.Sequential([
            b.conv_block(c5r, set_output=False, kernel=1),
            b.conv_block(c5, set_output=False, kernel=5, padding=2),
        ]),
        nn.Sequential([
            nn.MaxPool2d(3, stride=1, padding=1),
            b.conv_block(pp, set_output=False, kernel=1),
        ]),
    ])
    b.in_channels = c1 + c3 + c5 + pp
    return block


@register("inceptionnet_v1")
def build_inceptionnet_v1(setting) -> Model:
    b = Builder(setting)
    layers = [
        b.conv_block(64, kernel=7, stride=2, padding=3),
        nn.MaxPool2d(3, stride=2, padding=1),
        b.conv_block(64, kernel=1),
        b.conv_block(192, kernel=3, padding=1),
        nn.MaxPool2d(3, stride=2, padding=1),
    ]
    for cfg in BLOCKS:
        if cfg == "M":
            layers.append(nn.MaxPool2d(3, stride=2, padding=1))
        else:
            layers.append(_inception_block(b, *cfg))
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("InceptionNetV1", setting, nn.Sequential(layers))
