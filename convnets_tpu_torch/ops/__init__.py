"""Plain tensor ops, NHWC. Every hand-written kernel lives in `ops.kernels`;
the functions here are plain PyTorch and serve as the kernels' oracles."""

from convnets_tpu_torch.ops.activations import (  # noqa: F401
    channel_shuffle, dropout, flatten, relu, sigmoid, softmax,
)
from convnets_tpu_torch.ops.conv import conv2d, conv2d_depthwise, linear  # noqa: F401
from convnets_tpu_torch.ops.losses import (  # noqa: F401
    correct_count, cross_entropy_sum, mixup_cross_entropy_sum,
)
from convnets_tpu_torch.ops.norm import batch_norm_inference, batch_norm_train  # noqa: F401
from convnets_tpu_torch.ops.pool import avg_pool2d, global_avg_pool2d, max_pool2d  # noqa: F401
