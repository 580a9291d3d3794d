"""Plain tensor ops, NHWC. Every hand-written kernel lives in `ops.kernels`;
the functions here are plain PyTorch and serve as the kernels' oracles."""

from convnets_tpu_torch.ops.activations import (  # noqa: F401
    apply_dropout, channel_shuffle, dropout, dropout_mask, flatten, relu, sigmoid, softmax,
)
from convnets_tpu_torch.ops.conv import conv2d, conv2d_depthwise, linear  # noqa: F401
from convnets_tpu_torch.ops.losses import (  # noqa: F401
    correct_count, cross_entropy_sum, mixup_cross_entropy_sum,
)
from convnets_tpu_torch.ops.norm import (  # noqa: F401
    batch_norm_inference, batch_norm_train, batch_stats, bn_apply_stats,
)
from convnets_tpu_torch.ops.pool import (  # noqa: F401
    adaptive_avg_pool2d, avg_pool2d, global_avg_pool2d, max_pool2d,
)
from convnets_tpu_torch.ops import initializers  # noqa: F401
