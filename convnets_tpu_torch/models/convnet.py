"""ConvNet and LeNet-5 (counterpart of convnets_tpu/models/convnet.py,
built by the same Builder calls).

Both end in Flatten → Linear. Flatten is NHWC, as in the JAX package, so
the classifier's (in, out) weight reads its rows in (H, W, C) order and a
JAX weight carried over by the bridge needs no permutation.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register


@register("convnet")
def build_convnet(setting) -> Model:
    """conv3x3(32)→pool → conv5x5(64,s2,p1)→pool → FC2048 → FC(classes)."""
    b = Builder(setting)
    module = nn.Sequential([
        b.conv_block(32, kernel=3),
        nn.MaxPool2d(2, stride=2),
        b.conv_block(64, kernel=5, stride=2, padding=1),
        nn.MaxPool2d(2, stride=2),
        nn.Flatten(),
        b.linear(2048),
        nn.ReLU(),
        b.dropout(),
        b.linear(setting.num_classes),
    ])
    return Model("ConvNet", setting, module)


@register("lenet")
def build_lenet(setting) -> Model:
    """LeNet-5 with ReLU and max pools: conv5(6)→pool→conv5(16)→pool→
    FC120→FC84→FC(classes). kind is unused (one variant)."""
    b = Builder(setting)
    module = nn.Sequential([
        b.conv_block(6, kernel=5, padding=2),
        nn.MaxPool2d(2, stride=2),
        b.conv_block(16, kernel=5),
        nn.MaxPool2d(2, stride=2),
        nn.Flatten(),
        b.linear(120),
        nn.ReLU(),
        b.linear(84),
        nn.ReLU(),
        b.dropout(),
        b.linear(setting.num_classes),
    ])
    return Model("LeNet", setting, module)
