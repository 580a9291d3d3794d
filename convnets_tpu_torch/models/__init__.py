from convnets_tpu_torch.models.base import (  # noqa: F401
    Builder, Model, available_models, build_model, register,
)
from convnets_tpu_torch.models.blocks import SEUnit, SKConv  # noqa: F401
# each import registers its families
from convnets_tpu_torch.models import (  # noqa: F401
    alexnet, convnet, densenet, inceptionnet_v1, mobilenet_v1, resnet, resnext, se_resnet,
    senet, shufflenet_v1, sk_resnet, sknet, squeezenet, template_net, vggnet,
)
