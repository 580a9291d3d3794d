"""SENet (counterpart of convnets_tpu/models/senet.py, built by the same
Builder calls): the ResNeXt-style trunk (widths 128-1024, expansion 2, a
grouped 3x3 of cardinality 32) with an SEUnit (reduction 16) closing each
bottleneck's body: 1x1 → 3x3 grouped, stride → 1x1·2 → SEUnit, plus the
shortcut, post-add ReLU.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register
from convnets_tpu_torch.models.blocks import SEUnit

# copied from convnets_tpu/models/senet.py (importing it would pull in jax)
CONFIG = {
    "26": [(128, 2, 1), (256, 2, 2), (512, 2, 2), (1024, 2, 2)],
    "50": [(128, 3, 1), (256, 4, 2), (512, 6, 2), (1024, 3, 2)],
    "101": [(128, 3, 1), (256, 4, 2), (512, 23, 2), (1024, 3, 2)],
    "152": [(128, 3, 1), (256, 8, 2), (512, 36, 2), (1024, 3, 2)],
}


def se_bottleneck(b: Builder, filters: int, expansion: int, reduction: int,
                  stride: int = 1, cardinality: int = 32):
    out_ch = filters * expansion
    needs_synch = stride != 1 or b.in_channels != out_ch
    shortcut = (
        b.conv_block(out_ch, activation=False, set_output=False, kernel=1, stride=stride)
        if needs_synch else nn.Identity()
    )
    body = nn.Sequential([
        b.conv_block(filters, kernel=1),
        b.conv_block(filters, kernel=3, padding=1, stride=stride, groups=cardinality),
        b.conv_block(out_ch, activation=False, kernel=1),
        SEUnit(out_ch, reduction, linear_init=b.linear_init),
    ])
    b.in_channels = out_ch
    return nn.Add([body, shortcut], post_relu=True)


@register("senet")
def build_senet(setting) -> Model:
    stages = CONFIG[str(setting.kind)]
    b = Builder(setting)
    layers = [
        b.conv_block(64, kernel=7, stride=2, padding=3),
        nn.MaxPool2d(3, stride=2, padding=1),
    ]
    for filters, repeats, stride in stages:
        layers.append(se_bottleneck(b, filters, 2, 16, stride))
        for _ in range(1, repeats):
            layers.append(se_bottleneck(b, filters, 2, 16))
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("SENet", setting, nn.Sequential(layers))
