"""DataMngr: the reference's data-manager surface (counterpart of
convnets_tpu/data/manager.py).

load_train / load_valid / load_test return loaders over an ImageFolder
layout (CINIC-10 by default) with the `augment` and `normalize` flags the
Trainer reads (train: Settings.data_augment; valid and test: no
augmentation; all: Settings.data_norm). The route of each split, by the
JAX package's rule (manager.py:61-87): Settings.device_cache wins where it
is set; otherwise a split of at most DEVICE_CACHE_AUTO_BYTES decoded bytes
goes to DeviceCacheLoader; a larger split with `load_raw` rotates through
the device in chunks (ShardRotationLoader, data/stream.py), unless
CONVNETS_TPU_STREAM=0 (the JAX package's switch) sends it to the host
DataLoader. With a data-parallel `mesh`, each loader is this rank's host
slice (host_id = its data rank, num_hosts = the data group's size) unless
the call names one.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from convnets_tpu_torch.data.datasets import CINIC_MEAN, CINIC_STD, Dataset, ImageFolderDataset
from convnets_tpu_torch.data.loader import DataLoader, DeviceCacheLoader
from convnets_tpu_torch.data.stream import ShardRotationLoader
from convnets_tpu_torch.parallel.mesh import data_rank, data_size


class DataMngr:
    # Settings.device_cache None → auto: splits up to this many decoded
    # bytes live on the device (a CINIC-10 split is 276 MB)
    DEVICE_CACHE_AUTO_BYTES = 1 << 30

    def __init__(self, setting, root: Optional[str] = None, device="cuda",
                 datasets: Optional[Dict[str, Dataset]] = None, mesh=None):
        """`datasets`: {split: Dataset} in place of the ImageFolder splits
        under `root` (in-memory or synthetic data). `device`: where a
        DeviceCacheLoader keeps its split and a ShardRotationLoader its
        chunks. `mesh`: the data-parallel mesh whose data rank and size give
        the loaders' default host slice."""
        self.setting = setting
        axis = getattr(setting, "data_axis", None) or "data"
        self.hosts = ((0, 1) if mesh is None
                      else (data_rank(mesh, axis), data_size(mesh, axis)))
        # data/CINIC-10 and data/cache/<dataset>-<split>.npy under the
        # working directory, as in the JAX package
        base = os.path.join(os.getcwd(), "data")
        self.root = os.path.join(base, "CINIC-10") if root is None else root
        self.cache_dir = os.path.join(base, "cache")
        self.device = device
        self.batch_size = setting.batch_size
        self.data_augment = setting.data_augment
        self.data_norm = setting.data_norm
        self.mean = CINIC_MEAN
        self.std = CINIC_STD
        self._datasets = dict(datasets or {})

    def _dataset(self, split: str) -> Dataset:
        if split not in self._datasets:
            name = os.path.basename(os.path.normpath(self.root))
            self._datasets[split] = ImageFolderDataset(
                os.path.join(self.root, split),
                disk_cache=os.path.join(self.cache_dir, f"{name}-{split}.npy"))
        return self._datasets[split]

    def _use_device_cache(self, ds: Dataset) -> bool:
        flag = getattr(self.setting, "device_cache", None)
        if flag is not None:
            return bool(flag)
        return len(ds) * int(np.prod(ds.image_shape)) <= self.DEVICE_CACHE_AUTO_BYTES

    def _make_loader(self, split: str, shuffle: bool, host_id: Optional[int],
                     num_hosts: Optional[int]):
        if host_id is None or num_hosts is None:
            host_id, num_hosts = self.hosts
        ds = self._dataset(split)
        if self._use_device_cache(ds):
            return DeviceCacheLoader(ds, self.batch_size, shuffle=shuffle, seed=self.setting.seed,
                                     host_id=host_id, num_hosts=num_hosts, device=self.device)
        if hasattr(ds, "load_raw") and os.environ.get("CONVNETS_TPU_STREAM", "1") == "1":
            return ShardRotationLoader(ds, self.batch_size, shuffle=shuffle,
                                       seed=self.setting.seed, host_id=host_id,
                                       num_hosts=num_hosts, device=self.device)
        return DataLoader(ds, self.batch_size, shuffle=shuffle, seed=self.setting.seed,
                          num_workers=self.setting.num_workers, host_id=host_id,
                          num_hosts=num_hosts)

    def load_train(self, host_id: Optional[int] = None, num_hosts: Optional[int] = None):
        loader = self._make_loader("train", True, host_id, num_hosts)
        loader.augment = self.data_augment
        loader.normalize = self.data_norm
        return loader

    def load_valid(self, host_id: Optional[int] = None, num_hosts: Optional[int] = None):
        loader = self._make_loader("valid", False, host_id, num_hosts)
        loader.augment = False
        loader.normalize = self.data_norm
        return loader

    def load_test(self, host_id: Optional[int] = None, num_hosts: Optional[int] = None):
        # the reference shuffles the test loader deliberately for its
        # statistical subsampling protocol (mngrdata.py:211)
        loader = self._make_loader("test", True, host_id, num_hosts)
        loader.augment = False
        loader.normalize = self.data_norm
        return loader

    def info(self, split: str = "train") -> dict:
        return self._dataset(split).info()

    def inv_normalized(self, x: np.ndarray) -> np.ndarray:
        """Undo per-channel normalization (reference mngrdata.py:64-72)."""
        return x * self.std + self.mean
