from convnets_tpu_torch.data.datasets import (  # noqa: F401
    CIFAR10_MEAN, CIFAR10_STD, CINIC_MEAN, CINIC_STD, MNIST_MEAN, MNIST_STD, ArrayDataset,
    Dataset, ImageFolderDataset, cifar10, mnist, synthetic_dataset,
)
from convnets_tpu_torch.data.loader import (  # noqa: F401
    DataLoader, DeviceCacheLoader, device_prefetch,
)
from convnets_tpu_torch.data.augment import augment_batch, normalize  # noqa: F401
from convnets_tpu_torch.data.manager import DataMngr  # noqa: F401
from convnets_tpu_torch.data.stream import ShardRotationLoader  # noqa: F401
