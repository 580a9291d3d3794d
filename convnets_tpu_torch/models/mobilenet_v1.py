"""MobileNet-v1 (counterpart of convnets_tpu/models/mobilenet_v1.py, built by
the same Builder calls): a 3x3/2 stem conv, then 13 depthwise-separable
blocks — depthwise 3x3 (+BN+ReLU) on the depthwise_conv2d kernel, then
pointwise 1x1 (+BN+ReLU) on the conv kernels — then global avgpool →
dropout → linear.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register

# copied from convnets_tpu/models/mobilenet_v1.py (importing it would pull
# in jax): (num_filters, stride) of each depthwise-separable block
DW_STACK = [
    (64, 1),
    (128, 2), (128, 1),
    (256, 2), (256, 1),
    (512, 2), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
]


def _dw_separable(b: Builder, num_filters: int, stride: int) -> nn.Sequential:
    dw = b.conv_block_depthwise(kernel=3, stride=stride, padding=1)
    pw = b.conv_block(num_filters, kernel=1)
    return nn.Sequential([dw, pw])


@register("mobilenet_v1")
def build_mobilenet_v1(setting) -> Model:
    b = Builder(setting)
    layers = [b.conv_block(32, kernel=3, stride=2, padding=1)]
    for filters, stride in DW_STACK:
        layers.append(_dw_separable(b, filters, stride))
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("MobileNetV1", setting, nn.Sequential(layers))
