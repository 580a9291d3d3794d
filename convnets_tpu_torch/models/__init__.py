from convnets_tpu_torch.models.base import Builder, Model, build_model, register  # noqa: F401
# each import registers its family: "resnet", "mobilenet_v1", "densenet", "resnext"
from convnets_tpu_torch.models import densenet, mobilenet_v1, resnet, resnext  # noqa: F401
