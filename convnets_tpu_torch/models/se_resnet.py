"""SE-ResNet (counterpart of convnets_tpu/models/se_resnet.py, built by the
same Builder calls): the plain ResNet trunk (basic expansion 1,
bottleneck 4, no cardinality) with an SEUnit (reduction 16) after the last
conv of each block's body, before the shortcut's add and its ReLU.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register
from convnets_tpu_torch.models.blocks import SEUnit

# copied from convnets_tpu/models/se_resnet.py (importing it would pull in jax)
CONFIG = {
    "18": ("basic", [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]),
    "34": ("basic", [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]),
    "26": ("bottleneck", [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]),
    "50": ("bottleneck", [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]),
    "101": ("bottleneck", [(64, 3, 1), (128, 4, 2), (256, 23, 2), (512, 3, 2)]),
    "152": ("bottleneck", [(64, 3, 1), (128, 8, 2), (256, 36, 2), (512, 3, 2)]),
}


def _se_res_block(b: Builder, block_type: str, filters: int, expansion: int,
                  reduction: int, stride: int = 1):
    out_ch = filters * expansion
    needs_synch = stride != 1 or b.in_channels != out_ch
    shortcut = (
        b.conv_block(out_ch, activation=False, set_output=False, kernel=1, stride=stride)
        if needs_synch else nn.Identity()
    )
    if block_type == "basic":
        convs = [
            b.conv_block(filters, kernel=3, padding=1, stride=stride),
            b.conv_block(out_ch, activation=False, kernel=3, padding=1),
        ]
    else:
        convs = [
            b.conv_block(filters, kernel=1),
            b.conv_block(filters, kernel=3, padding=1, stride=stride),
            b.conv_block(out_ch, activation=False, kernel=1),
        ]
    body = nn.Sequential(convs + [SEUnit(out_ch, reduction, linear_init=b.linear_init)])
    b.in_channels = out_ch
    return nn.Add([body, shortcut], post_relu=True)


@register("se_resnet")
def build_se_resnet(setting) -> Model:
    block_type, stages = CONFIG[str(setting.kind)]
    expansion = 4 if block_type == "bottleneck" else 1
    b = Builder(setting)
    layers = [
        b.conv_block(64, kernel=7, stride=2, padding=3),
        nn.MaxPool2d(3, stride=2, padding=1),
    ]
    for filters, repeats, stride in stages:
        layers.append(_se_res_block(b, block_type, filters, expansion, 16, stride))
        for _ in range(1, repeats):
            layers.append(_se_res_block(b, block_type, filters, expansion, 16))
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("SEResNet", setting, nn.Sequential(layers))
