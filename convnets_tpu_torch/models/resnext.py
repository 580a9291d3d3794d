"""ResNeXt (counterpart of convnets_tpu/models/resnext.py, built by the same
Builder calls): the ResNet skeleton with doubled widths, expansion 2
(bottleneck) and a grouped 3x3 of cardinality 32.

  stem   conv7x7 s2 p3 (+BN+ReLU) → maxpool 3x3 s2 p1
  stage  (filters, repeats, stride-of-first-block) per config
  bottleneck [1x1, 3x3 s groups 32, 1x1·2] + shortcut, post-add ReLU
  head   NO global pool: flatten (N, H·W·C) → dropout → linear, as in the
         JAX package (resnext.py:66); at 224² the classifier is
         7·7·2048 = 100,352 → num_classes.

The basic kinds ('18'/'34') keep the reference's quirk of passing stride
and groups to both 3x3 convs, which makes their stride-2 blocks
shape-inconsistent with the shortcut in the JAX package too: only the
bottleneck kinds are usable.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.core.shapes import num_flat_features  # noqa: F401  (as the JAX module)
from convnets_tpu_torch.models.base import Builder, Model, register

# copied from convnets_tpu/models/resnext.py (importing it would pull in jax)
CONFIG = {
    "18": ("basic", [(128, 2, 1), (256, 2, 2), (512, 2, 2), (1024, 2, 2)]),
    "34": ("basic", [(128, 3, 1), (256, 4, 2), (512, 6, 2), (1024, 3, 2)]),
    "26": ("bottleneck", [(128, 2, 1), (256, 2, 2), (512, 2, 2), (1024, 2, 2)]),
    "50": ("bottleneck", [(128, 3, 1), (256, 4, 2), (512, 6, 2), (1024, 3, 2)]),
    "101": ("bottleneck", [(128, 3, 1), (256, 4, 2), (512, 23, 2), (1024, 3, 2)]),
    "152": ("bottleneck", [(128, 3, 1), (256, 8, 2), (512, 36, 2), (1024, 3, 2)]),
}

CARDINALITY = 32


def _block(b: Builder, block_type: str, filters: int, expansion: int, stride: int):
    out_ch = filters * expansion
    needs_synch = stride != 1 or b.in_channels != out_ch
    shortcut = (
        b.conv_block(out_ch, activation=False, set_output=False, kernel=1, stride=stride)
        if needs_synch else nn.Identity()
    )
    if block_type == "basic":
        body = nn.Sequential([
            b.conv_block(filters, kernel=3, padding=1, stride=stride, groups=CARDINALITY),
            b.conv_block(out_ch, activation=False, kernel=3, padding=1,
                         stride=stride, groups=CARDINALITY),
        ])
    else:
        body = nn.Sequential([
            b.conv_block(filters, kernel=1),
            b.conv_block(filters, kernel=3, padding=1, stride=stride, groups=CARDINALITY),
            b.conv_block(out_ch, activation=False, kernel=1),
        ])
    b.in_channels = out_ch
    return nn.Add([body, shortcut], post_relu=True)


@register("resnext")
def build_resnext(setting) -> Model:
    block_type, stages = CONFIG[str(setting.kind)]
    expansion = 2 if block_type == "bottleneck" else 1
    b = Builder(setting)
    layers = [
        b.conv_block(64, kernel=7, stride=2, padding=3),
        nn.MaxPool2d(3, stride=2, padding=1),
    ]
    for filters, repeats, stride in stages:
        layers.append(_block(b, block_type, filters, expansion, stride))
        for _ in range(1, repeats):
            layers.append(_block(b, block_type, filters, expansion, 1))
    layers += [
        nn.Flatten(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("ResNeXt", setting, nn.Sequential(layers))
