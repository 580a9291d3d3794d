from convnets_tpu_torch.tune.sampler import ParameterSampler  # noqa: F401
from convnets_tpu_torch.tune.tuner import Tuner  # noqa: F401
