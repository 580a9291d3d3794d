"""VGG-11/13/16/19 (counterpart of convnets_tpu/models/vggnet.py, built by
the same Builder calls): BN after every conv, global average pooling
before the classifier, and a dropout-heavy 4096-4096 head.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register

# copied from convnets_tpu/models/vggnet.py: filters of each 3x3 conv, "M"
# a 2x2/2 max pool
CONFIG = {
    "11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
           512, 512, 512, "M"],
    "19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
           "M", 512, 512, 512, 512, "M"],
}


@register("vggnet")
def build_vggnet(setting) -> Model:
    b = Builder(setting)
    layers = []
    for element in CONFIG[str(setting.kind)]:
        if element == "M":
            layers.append(nn.MaxPool2d(2, stride=2))
        else:
            layers.append(b.conv_block(element, kernel=3, padding=1))
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(4096),
        nn.ReLU(),
        b.dropout(),
        b.linear(4096),
        nn.ReLU(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("VGGNet", setting, nn.Sequential(layers))
