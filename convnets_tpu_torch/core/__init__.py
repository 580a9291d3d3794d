from convnets_tpu_torch.core.precision import (  # noqa: F401
    DEFAULT_POLICY, MIXED_POLICY, LossScale, Policy, policy_from_setting,
)
from convnets_tpu_torch.core.rng import set_reproducible_mode  # noqa: F401
from convnets_tpu_torch.core import shapes  # noqa: F401
