"""ShuffleNet-v1, kinds g1/g2/g3/g4/g8 (counterpart of
convnets_tpu/models/shufflenet_v1.py, built by the same Builder calls).

ShuffleUnit: grouped 1x1 compress (ungrouped in the very first unit) →
channel shuffle → depthwise 3x3, stride (BN, no ReLU) → grouped 1x1
expand (BN, no ReLU). A stride-2 unit pools its identity (3x3/2 p1 avg
pool) and concatenates [identity, out]; a stride-1 unit adds them; ReLU
after either. The grouped 1x1s run the grouped kernels: the compress
convs of g2-g8 have Cin/G of 34-400 (the wide groups of the CUDA-core
loop), the expand convs 12-25. The identity's pool runs the avg-pool
kernel: the avg_pool2d custom op in eval mode, pool2d_train in avg mode
in train mode.
"""

from __future__ import annotations

import torch

from convnets_tpu_torch import nn, ops
from convnets_tpu_torch.models.base import Builder, Model, register
from convnets_tpu_torch.nn.layers import AvgPool2d
from convnets_tpu_torch.nn.module import Module

# copied from convnets_tpu/models/shufflenet_v1.py (importing it would pull
# in jax): (stride, repeats, out_channels) per stage
CONFIG = {
    "g1": [(2, 1, 144), (1, 3, 144), (2, 1, 288), (1, 7, 288), (2, 1, 576), (1, 3, 576)],
    "g2": [(2, 1, 200), (1, 3, 200), (2, 1, 400), (1, 7, 400), (2, 1, 800), (1, 3, 800)],
    "g3": [(2, 1, 240), (1, 3, 240), (2, 1, 480), (1, 7, 480), (2, 1, 960), (1, 3, 960)],
    "g4": [(2, 1, 272), (1, 3, 272), (2, 1, 544), (1, 7, 544), (2, 1, 1088), (1, 3, 1088)],
    "g8": [(2, 1, 384), (1, 3, 384), (2, 1, 768), (1, 7, 768), (2, 1, 1536), (1, 3, 1536)],
}


class ShuffleUnit(Module):
    """Children compress, depthwise, expand (the JAX names) and, in a
    stride-2 unit, `pool`: the identity's avg pool, functional in the JAX
    unit (ops.avg_pool2d, shufflenet_v1.py:80); it holds no variables, so
    the JAX layout is the same."""

    def __init__(self, b: Builder, out_channels: int, groups: int, stride: int,
                 downsample: bool, first_conv: bool):
        super().__init__()
        self.groups = groups
        self.downsample = downsample
        self.stride = stride
        bottleneck = out_channels // 4
        identity_ch = b.in_channels
        body_out = out_channels - identity_ch if downsample else out_channels
        self.compress = b.conv_block(bottleneck, kernel=1, groups=1 if first_conv else groups)
        self.depthwise = b.conv_block(bottleneck, activation=False, kernel=3, stride=stride,
                                      padding=1, groups=bottleneck)
        self.expand = b.conv_block(body_out, activation=False, kernel=1, groups=groups)
        b.in_channels = out_channels
        self.out_channels = out_channels
        self.pool = AvgPool2d(3, stride=2, padding=1) if downsample else None

    def init(self, generator, in_shape):
        shape = tuple(in_shape)
        for child in (self.compress, self.depthwise, self.expand):
            child.init(generator, shape)
            shape = child.out_shape(shape)

    def out_shape(self, in_shape):
        n, h, w, _ = in_shape
        if self.downsample:
            h, w = self.pool.out_shape(in_shape)[1:3]
        return (n, h, w, self.out_channels)

    def forward(self, x):
        out = ops.channel_shuffle(self.compress(x), self.groups)
        out = self.expand(self.depthwise(out))
        if self.downsample:
            return ops.relu(torch.cat([self.pool(x), out], dim=-1))
        return ops.relu(out + x)

    def extra_repr(self):
        return f"out={self.out_channels}, g={self.groups}, s={self.stride}"

    def summary_children(self):
        """The JAX unit's children: compress, depthwise, expand (its
        identity pool is a function there)."""
        return {"compress": self.compress, "depthwise": self.depthwise, "expand": self.expand}

    def summary_label(self):
        return f"ShuffleUnit({self.extra_repr()})"


@register("shufflenet_v1")
def build_shufflenet_v1(setting) -> Model:
    cfg = CONFIG[str(setting.kind)]
    groups = int(str(setting.kind)[1:])
    b = Builder(setting)
    layers = [
        b.conv_block(24, kernel=3, stride=2, padding=1),
        nn.MaxPool2d(3, stride=2, padding=1),
    ]
    for i, (stride, repeat, out_channels) in enumerate(cfg):
        for j in range(repeat):
            layers.append(ShuffleUnit(b, out_channels, groups, stride, downsample=(stride == 2),
                                      first_conv=(i == 0 and j == 0)))
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("ShuffleNetV1", setting, nn.Sequential(layers))
