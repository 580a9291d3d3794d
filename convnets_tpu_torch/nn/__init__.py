from convnets_tpu_torch.nn.module import (  # noqa: F401
    MaskTape, Module, count_params, count_state, current_generator, current_policy, recomputing,
    summarize, use_generator, use_policy,
)
from convnets_tpu_torch.nn.layers import (  # noqa: F401
    AdaptiveAvgPool2d, Add, AvgPool2d, BatchNorm2d, ChannelShuffle, Concat, Conv2d, ConvBNReLU,
    Dropout, Flatten, GlobalAvgPool2d, Identity, Lambda, Linear, MaxPool2d, ReLU, Remat,
    Sequential, Sigmoid, conv_block, dropout, write_running,
)
from convnets_tpu_torch.nn.trace import activation_trace  # noqa: F401
