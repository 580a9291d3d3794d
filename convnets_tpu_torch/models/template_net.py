"""Template for adding an architecture (counterpart of
convnets_tpu/models/template_net.py). Copy this file, rename 'mynetwork',
fill in the layers and import it in models/__init__.py: the model is then
available through build_model() and the CLI.
"""

from __future__ import annotations

from convnets_tpu_torch import nn
from convnets_tpu_torch.models.base import Builder, Model, register

# variant configs keyed by Settings.kind
CONFIG = {
    "base": [32, 64],
}


@register("mynetwork")
def build_mynetwork(setting) -> Model:
    filters = CONFIG[str(setting.kind)]
    b = Builder(setting)
    layers = []
    for f in filters:
        layers.append(b.conv_block(f, kernel=3, padding=1))
        layers.append(nn.MaxPool2d(2, stride=2))
    layers += [
        nn.GlobalAvgPool2d(),
        b.dropout(),
        b.linear(setting.num_classes),
    ]
    return Model("MyNetwork", setting, nn.Sequential(layers))
