from convnets_tpu_torch.nn.module import (  # noqa: F401
    Module, current_generator, current_policy, use_generator, use_policy,
)
from convnets_tpu_torch.nn.layers import (  # noqa: F401
    Add, AvgPool2d, BatchNorm2d, Concat, Conv2d, ConvBNReLU, Dropout, Flatten, GlobalAvgPool2d,
    Identity, Linear, MaxPool2d, ReLU, Remat, Sequential, conv_block,
)
