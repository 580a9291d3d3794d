from convnets_tpu_torch.models.base import Builder, Model, build_model, register  # noqa: F401
from convnets_tpu_torch.models import resnet  # noqa: F401  (registers "resnet")
