"""SK-ResNet (counterpart of convnets_tpu/models/sk_resnet.py, built by the
same Builder calls): SKNet's bottleneck (1x1 → SKConv(stride, groups 32)
→ 1x1·4) on the plain ResNet widths 64-512, expansion 4.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register
from convnets_tpu_torch.models.sknet import build_sk_trunk

# copied from convnets_tpu/models/sk_resnet.py (importing it would pull in jax)
CONFIG = {
    "26": [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)],
    "50": [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)],
    "101": [(64, 3, 1), (128, 4, 2), (256, 23, 2), (512, 3, 2)],
    "152": [(64, 3, 1), (128, 8, 2), (256, 36, 2), (512, 3, 2)],
}


@register("sk_resnet")
def build_sk_resnet(setting) -> Model:
    b = Builder(setting)
    layers = build_sk_trunk(b, CONFIG[str(setting.kind)], 4)
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("SKResNet", setting, nn.Sequential(layers))
