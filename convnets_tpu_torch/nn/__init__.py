from convnets_tpu_torch.nn.module import Module, current_policy, use_policy  # noqa: F401
from convnets_tpu_torch.nn.layers import (  # noqa: F401
    Add, BatchNorm2d, Conv2d, ConvBNReLU, Dropout, GlobalAvgPool2d, Identity, Linear,
    MaxPool2d, ReLU, Sequential, conv_block,
)
