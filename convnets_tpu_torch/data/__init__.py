from convnets_tpu_torch.data.datasets import (  # noqa: F401
    CIFAR10_MEAN, CIFAR10_STD, CINIC_MEAN, CINIC_STD, MNIST_MEAN, MNIST_STD, ArrayDataset,
    Dataset, ImageFolderDataset, cifar10, mnist, synthetic_dataset,
)
from convnets_tpu_torch.data.loader import DataLoader, device_prefetch  # noqa: F401
