"""Datasets (counterpart of convnets_tpu/data/datasets.py, copied: the
port imports nothing of the JAX package).

ImageFolderDataset is the torchvision ImageFolder equivalent the reference
feeds into its DataLoaders (reference mngrdata.py:139-215): a directory of
`<root>/<class>/<image>` files. Images are decoded on demand by a host
thread pool in the DataLoader, with the native codec (native/: libpng,
libjpeg and Pillow's BILINEAR resize in C++) first and PIL for a file the
codec cannot read or when it is off; everything downstream of decode
(dequantize, normalize) runs on the device, in the train and eval steps.

ArrayDataset serves in-memory numpy (MNIST/CIFAR-style arrays, synthetic
test data, pre-decoded caches).
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from convnets_tpu_torch import native

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp")

# Channel statistics of the CINIC-10 train split (reference mngrdata.py:61-62)
CINIC_MEAN = np.array([0.47889522, 0.47227842, 0.43047404], np.float32)
CINIC_STD = np.array([0.24205776, 0.23828046, 0.25874835], np.float32)
# Standard published channel statistics for the other bundled loaders
MNIST_MEAN = np.array([0.1307], np.float32)
MNIST_STD = np.array([0.3081], np.float32)
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


class Dataset:
    """Protocol: __len__, class_names, image_shape, load(indices)->(x,y).

    load returns x as float32 NHWC scaled to [0,1] (pre-normalization,
    matching torchvision ToTensor) and y as int32 labels. mean/std are the
    per-channel normalization statistics the engine applies when
    data_norm is on (default: CINIC-10's, the reference's only dataset).
    """

    class_names: List[str]
    image_shape: Tuple[int, int, int]
    mean: np.ndarray = CINIC_MEAN
    std: np.ndarray = CINIC_STD

    def __len__(self) -> int:
        raise NotImplementedError

    def load(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def info(self) -> dict:
        """Dataset summary incl. class distribution (reference mngrdata.py:74-137)."""
        labels = self.all_labels()
        counts = np.bincount(labels, minlength=len(self.class_names))
        return {
            "num_examples": len(self),
            "num_classes": len(self.class_names),
            "image_shape": tuple(self.image_shape),
            "class_distribution": {
                name: int(c) for name, c in zip(self.class_names, counts)
            },
        }

    def all_labels(self) -> np.ndarray:
        raise NotImplementedError


class ArrayDataset(Dataset):
    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 class_names: Optional[Sequence[str]] = None):
        assert images.ndim == 4, "images must be NHWC"
        assert len(images) == len(labels)
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        num_classes = int(self.labels.max()) + 1 if len(labels) else 0
        self.class_names = list(class_names) if class_names else [
            str(i) for i in range(num_classes)
        ]
        self.image_shape = tuple(images.shape[1:])

    def __len__(self):
        return len(self.images)

    def load(self, indices):
        x = self.images[indices]
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        return x.astype(np.float32), self.labels[indices]

    def load_raw(self, indices):
        """Bytes-preserving load: uint8 images stay uint8 so host→device
        transfer moves 4× fewer bytes; the jitted step converts to float
        on device (engine dequantizes, BASELINE 'on-device preprocessing')."""
        x = self.images[indices]
        if x.dtype != np.uint8:
            return self.load(indices)
        return x, self.labels[indices]

    def all_labels(self):
        return self.labels


class ImageFolderDataset(Dataset):
    """<root>/<class_name>/<image files>, classes sorted alphabetically
    (torchvision ImageFolder convention, so labels match the reference)."""

    # decode-cache budget: datasets whose decoded uint8 tensor fits under
    # this are decoded ONCE and kept in RAM. CINIC-10's 270k 32×32 images
    # are ~830 MB decoded — on a host with few cores, re-decoding 90k PNGs
    # every epoch bounds training throughput, while the cache turns epochs
    # 2+ into pure memory reads.
    CACHE_BUDGET_BYTES = 4 << 30
    # decoded splits smaller than this aren't worth persisting to disk
    MIN_PERSIST_BYTES = 32 << 20

    def __init__(self, root: str, image_size: Optional[Tuple[int, int]] = None,
                 cache: Optional[bool] = None, disk_cache: Optional[str] = None):
        if not os.path.isdir(root):
            raise FileNotFoundError(root)
        self.root = root
        self.class_names = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self._paths: List[str] = []
        labels = []
        for ci, cname in enumerate(self.class_names):
            cdir = os.path.join(root, cname)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self._paths.append(os.path.join(cdir, fname))
                    labels.append(ci)
        self.labels = np.asarray(labels, np.int32)
        self._size = image_size
        self._cache = self._cached = None  # off during the shape probe
        if image_size is None:
            x, _ = self.load(np.array([0]))
            self.image_shape = tuple(x.shape[1:])
        else:
            self.image_shape = (*image_size, 3)
        decoded_bytes = len(self._paths) * int(np.prod(self.image_shape))
        if cache is None:
            cache = decoded_bytes <= self.CACHE_BUDGET_BYTES
        # splits too big for the RAM budget but with a disk-cache path
        # decode straight into a disk-backed memmap instead (the chunked
        # rotation loader of the JAX package's data/stream.py feeds from it)
        # — on a host with enough memory the page cache is the RAM cache,
        # without pinning the budget
        self._memmap_build = (not cache and disk_cache is not None
                              and decoded_bytes > self.CACHE_BUDGET_BYTES)
        if self._memmap_build:
            cache = True
        # disk_cache: persisted decode cache (one .npy of the whole split's
        # uint8 tensor). Decoding 90k 32×32 PNGs takes over a minute on one
        # core; with the file present, later processes mmap it instead.
        self._disk_cache_path = disk_cache if cache else None
        loaded = None
        if self._disk_cache_path and os.path.exists(self._disk_cache_path):
            arr = np.load(self._disk_cache_path, mmap_mode="r")
            # decoder-identity check: native decode matches PIL bit-exactly,
            # but their RESIZE paths differ by ±1 LSB — a resized cache
            # written under one decoder must not be silently reused under
            # the other (cached runs would stop being bit-reproducible
            # across hosts with/without the g++ toolchain). A missing
            # sidecar (legacy cache) is accepted as-is.
            tag = None
            try:
                with open(self._disk_cache_path + ".decoder") as f:
                    tag = f.read().strip()
            except OSError:
                pass
            if arr.shape == (len(self._paths), *self.image_shape) and (
                    tag is None or tag in ("any", self._decoder_id())):
                loaded = arr
                self._disk_cache_path = None  # nothing left to persist
        if loaded is not None:
            self._cache = loaded
            self._cached = np.ones(len(self._paths), bool)
            self._memmap_build = False
        elif self._memmap_build:
            # decode-once-to-disk: rows land in a .building.npy memmap,
            # atomically renamed to the cache path when every image is
            # decoded (a crashed half-decoded build is rebuilt from scratch)
            from numpy.lib.format import open_memmap

            os.makedirs(os.path.dirname(self._disk_cache_path) or ".",
                        exist_ok=True)
            self._build_path = self._disk_cache_path + ".building.npy"
            self._cache = open_memmap(
                self._build_path, mode="w+", dtype=np.uint8,
                shape=(len(self._paths), *self.image_shape))
            self._cached = np.zeros(len(self._paths), bool)
        else:
            self._cache = (np.zeros((len(self._paths), *self.image_shape), np.uint8)
                           if cache else None)
            # per-image "decoded" flags; rows are written by at most one decode
            # worker per epoch (disjoint batch indices), so no lock is needed
            self._cached = np.zeros(len(self._paths), bool) if cache else None
        # persistence, however, can be reached by several decode workers
        # finishing their last batches concurrently — serialize it
        self._persist_lock = threading.Lock()

    def __len__(self):
        return len(self._paths)

    def load(self, indices):
        x, y = self.load_raw(indices)
        return x.astype(np.float32) / 255.0, y

    def _decoder_id(self) -> str:
        """Identity of the decode path for the disk-cache sidecar tag.
        Without a resize the native codec and PIL decode bit for bit alike,
        so the cache is decoder-agnostic ("any"); a resized cache carries
        the resampler that produced it ("native" or "pil", whose resizes
        part by up to 2 levels), the tags the JAX package writes."""
        if self._size is None:
            return "any"
        return "native" if native.available() else "pil"

    def _decode(self, i: int) -> np.ndarray:
        # the native codec first (bit-identical decode, resize within 2
        # levels of PIL's); PIL for the formats it lacks or when it is off
        if native.available():
            out = native.decode_image(self._paths[int(i)], self._size)
            if out is not None:
                return out

        from PIL import Image

        with Image.open(self._paths[int(i)]) as im:
            im = im.convert("RGB")
            if self._size is not None and im.size != (self._size[1], self._size[0]):
                im = im.resize((self._size[1], self._size[0]), Image.BILINEAR)
            out = np.asarray(im, np.uint8)
        native.count_decode("pil")
        return out

    def load_raw(self, indices):
        if self._cache is not None:
            for i in indices:
                if not self._cached[i]:
                    self._cache[i] = self._decode(i)
                    self._cached[i] = True
            self._maybe_persist_cache()
            return self._cache[indices], self.labels[indices]
        return (np.stack([self._decode(i) for i in indices]),
                self.labels[indices])

    def _maybe_persist_cache(self):
        """Write the decode cache to disk once every image is decoded
        (atomic tmp+rename so concurrent readers never see a torn file)."""
        if self._disk_cache_path is None or not self._cached.all():
            return
        with self._persist_lock:
            # re-check under the lock: another decode thread may have
            # claimed (and cleared) the path while we waited
            path = self._disk_cache_path
            if path is None:
                return
            self._disk_cache_path = None
            if self._memmap_build:
                # rows already live in the .building.npy memmap — flush and
                # atomically publish, then reopen read-only (the writable
                # handle would otherwise keep dirty pages pinned)
                try:
                    self._cache.flush()
                    os.replace(self._build_path, path)
                    with open(path + ".decoder", "w") as f:
                        f.write(self._decoder_id())
                    self._cache = np.load(path, mmap_mode="r")
                except OSError:
                    pass
                self._memmap_build = False
                return
            if self._cache.nbytes < self.MIN_PERSIST_BYTES:
                return
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
                np.save(tmp, self._cache)
                os.replace(tmp, path)
                with open(path + ".decoder", "w") as f:
                    f.write(self._decoder_id())
            except OSError:
                pass  # cache persistence is best-effort

    def all_labels(self):
        return self.labels


def mnist(root: str, split: str = "train") -> ArrayDataset:
    """Load MNIST from the standard IDX files (BASELINE config #1:
    LeNet-5 on MNIST). Expects <root>/{train,t10k}-images-idx3-ubyte(.gz)
    and the matching labels file (no downloading — zero-egress env)."""
    import gzip
    import struct

    prefix = "train" if split == "train" else "t10k"

    def read(name):
        for path in (os.path.join(root, name), os.path.join(root, name + ".gz")):
            if os.path.exists(path):
                opener = gzip.open if path.endswith(".gz") else open
                with opener(path, "rb") as f:
                    return f.read()
        raise FileNotFoundError(f"{name}(.gz) not under {root}")

    raw = read(f"{prefix}-images-idx3-ubyte")
    magic, n, rows, cols = struct.unpack(">IIII", raw[:16])
    assert magic == 2051, f"bad IDX image magic {magic}"
    images = np.frombuffer(raw, np.uint8, offset=16).reshape(n, rows, cols, 1)

    raw = read(f"{prefix}-labels-idx1-ubyte")
    magic, n2 = struct.unpack(">II", raw[:8])
    assert magic == 2049 and n2 == n
    labels = np.frombuffer(raw, np.uint8, offset=8).astype(np.int32)
    ds = ArrayDataset(images, labels, class_names=[str(i) for i in range(10)])
    ds.mean, ds.std = MNIST_MEAN, MNIST_STD
    return ds


def cifar10(root: str, split: str = "train") -> ArrayDataset:
    """Load CIFAR-10 from the python-pickle batches
    (cifar-10-batches-py layout; BASELINE config #2)."""
    import pickle

    base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = root
    names = ([f"data_batch_{i}" for i in range(1, 6)]
             if split == "train" else ["test_batch"])
    xs, ys = [], []
    for name in names:
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    classes = ["airplane", "automobile", "bird", "cat", "deer",
               "dog", "frog", "horse", "ship", "truck"]
    ds = ArrayDataset(np.ascontiguousarray(x), np.asarray(ys, np.int32),
                      class_names=classes)
    ds.mean, ds.std = CIFAR10_MEAN, CIFAR10_STD
    return ds


def synthetic_dataset(n: int, image_shape=(32, 32, 3), num_classes=10, seed=0,
                      learnable=True) -> ArrayDataset:
    """Random images with a learnable class signal (per-class mean shift) so
    integration tests can verify that training reduces loss."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = rng.rand(n, *image_shape).astype(np.float32)
    if learnable:
        shift = (y[:, None].astype(np.float32) / num_classes - 0.5) * 0.8
        x = np.clip(x + shift[:, :, None, None], 0.0, 1.0)
    return ArrayDataset(x, y)
