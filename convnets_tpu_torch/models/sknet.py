"""SKNet (counterpart of convnets_tpu/models/sknet.py, built by the same
Builder calls): the ResNeXt-style trunk (widths 128-1024, expansion 2)
whose bottleneck is 1x1 → SKConv(stride, groups 32) → 1x1·exp, plus the
shortcut, post-add ReLU.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register
from convnets_tpu_torch.models.blocks import SKConv

# copied from convnets_tpu/models/sknet.py (importing it would pull in jax)
CONFIG = {
    "26": [(128, 2, 1), (256, 2, 2), (512, 2, 2), (1024, 2, 2)],
    "50": [(128, 3, 1), (256, 4, 2), (512, 6, 2), (1024, 3, 2)],
    "101": [(128, 3, 1), (256, 4, 2), (512, 23, 2), (1024, 3, 2)],
    "152": [(128, 3, 1), (256, 8, 2), (512, 36, 2), (1024, 3, 2)],
}


def sk_bottleneck(b: Builder, filters: int, expansion: int, stride: int = 1,
                  cardinality: int = 32):
    out_ch = filters * expansion
    needs_synch = stride != 1 or b.in_channels != out_ch
    shortcut = (
        b.conv_block(out_ch, activation=False, set_output=False, kernel=1, stride=stride)
        if needs_synch else nn.Identity()
    )
    body = nn.Sequential([
        b.conv_block(filters, kernel=1),
        SKConv(b, groups=cardinality, stride=stride),
        b.conv_block(out_ch, activation=False, kernel=1),
    ])
    b.in_channels = out_ch
    return nn.Add([body, shortcut], post_relu=True)


def build_sk_trunk(b: Builder, stages, expansion: int):
    layers = [
        b.conv_block(64, kernel=7, stride=2, padding=3),
        nn.MaxPool2d(3, stride=2, padding=1),
    ]
    for filters, repeats, stride in stages:
        layers.append(sk_bottleneck(b, filters, expansion, stride))
        for _ in range(1, repeats):
            layers.append(sk_bottleneck(b, filters, expansion))
    return layers


@register("sknet")
def build_sknet(setting) -> Model:
    b = Builder(setting)
    layers = build_sk_trunk(b, CONFIG[str(setting.kind)], 2)
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("SKNet", setting, nn.Sequential(layers))
