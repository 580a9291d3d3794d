"""The port's host data feed (data/datasets.py, data/loader.py) against the
JAX package's on the CPU: the same datasets, permutations, padding and
weights byte for byte, and `device_prefetch` on the CPU. No tolerance:
every comparison is exact.
"""

import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from convnets_tpu.data import datasets as jds
from convnets_tpu.data import loader as jloader
from convnets_tpu_torch.data import datasets as tds
from convnets_tpu_torch.data import loader as tloader


@pytest.mark.parametrize("learnable", [True, False])
@pytest.mark.parametrize("shape,classes,seed", [((32, 32, 3), 10, 0), ((16, 12, 1), 4, 5)])
def test_synthetic_dataset_is_the_jax_one(shape, classes, seed, learnable):
    want = jds.synthetic_dataset(37, shape, classes, seed=seed, learnable=learnable)
    got = tds.synthetic_dataset(37, shape, classes, seed=seed, learnable=learnable)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.dtype == want.images.dtype and got.labels.dtype == want.labels.dtype
    assert got.class_names == want.class_names and got.image_shape == want.image_shape


def _uint8_pair(n=29):
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (n, 8, 8, 3)).astype(np.uint8)
    labels = rng.randint(0, 5, n).astype(np.int32)
    return (jds.ArrayDataset(images, labels), tds.ArrayDataset(images, labels))


def test_array_dataset_load_raw_keeps_uint8_and_load_scales():
    jd, td = _uint8_pair()
    idx = np.array([4, 0, 17, 4])
    for method in ("load_raw", "load"):
        (jx, jy), (tx, ty) = getattr(jd, method)(idx), getattr(td, method)(idx)
        assert tx.dtype == jx.dtype == (np.uint8 if method == "load_raw" else np.float32)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    # a float dataset's load_raw is its load
    fd = tds.synthetic_dataset(5, (4, 4, 3), 2)
    np.testing.assert_array_equal(fd.load_raw(np.arange(5))[0], fd.load(np.arange(5))[0])
    assert td.info() == jd.info()


def _epochs(loader, n=3):
    return [[tuple(np.copy(a) for a in batch) for batch in loader] for _ in range(n)]


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=7), dict(shuffle=False),
                                dict(shuffle=True, seed=1, drop_last=True),
                                dict(shuffle=True, seed=2, host_id=1, num_hosts=2)],
                         ids=["shuffle", "ordered", "drop_last", "host1of2"])
def test_data_loader_is_the_jax_one_over_three_epochs(kw, num_workers):
    jd, td = _uint8_pair()
    jl = jloader.DataLoader(jd, 8, num_workers=num_workers, **kw)
    tl = tloader.DataLoader(td, 8, num_workers=num_workers, **kw)
    assert len(tl) == len(jl) and tl.num_examples == jl.num_examples
    assert tl._host_count() == jl._host_count()
    want, got = _epochs(jl), _epochs(tl)
    assert tl.epoch == jl.epoch == 3
    for e, (we, ge) in enumerate(zip(want, got)):
        assert len(ge) == len(we)
        for b, (wb, gb) in enumerate(zip(we, ge)):
            for wa, ga in zip(wb, gb):
                assert ga.dtype == wa.dtype, (e, b)
                np.testing.assert_array_equal(ga, wa, err_msg=f"epoch {e} batch {b}")
    if kw["shuffle"]:  # the epochs really are different permutations
        assert not np.array_equal(got[0][0][1], got[1][0][1])
    if not kw.get("drop_last") and kw.get("num_hosts", 1) == 1:
        w = got[0][-1][2]  # 29 = 3·8 + 5: five real rows, three padded
        np.testing.assert_array_equal(w, [1] * 5 + [0] * 3)
        assert not got[0][-1][0][5:].any()


def test_data_loader_stops_its_producer_when_the_consumer_leaves():
    _, td = _uint8_pair(200)
    loader = tloader.DataLoader(td, 4, shuffle=True, num_prefetch=1, num_workers=2)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    assert threading.active_count() > before
    it.close()  # the consumer stops after one batch; close joins the producer
    assert threading.active_count() <= before


def test_data_loader_raises_a_decode_error_in_the_consumer():
    class Broken(tds.Dataset):
        class_names, image_shape = ["a"], (2, 2, 3)

        def __len__(self):
            return 4

        def load(self, idx):
            raise OSError("unreadable image")

    with pytest.raises(OSError, match="unreadable"):
        list(tloader.DataLoader(Broken(), 2))


def test_device_prefetch_on_the_cpu_yields_plain_tensors():
    _, td = _uint8_pair()
    loader = tloader.DataLoader(td, 8, shuffle=True, seed=3)
    want = _epochs(tloader.DataLoader(td, 8, shuffle=True, seed=3), 1)[0]
    got = list(tloader.device_prefetch(loader, size=2, device="cpu"))
    assert len(got) == len(want)
    for (x, y, w), (wx, wy, ww) in zip(got, want):
        assert x.device.type == "cpu" and x.dtype == torch.uint8  # 1 byte per value
        assert (y.dtype, w.dtype) == (torch.int32, torch.float32)
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)
        np.testing.assert_array_equal(w.numpy(), ww)
    # fewer batches than the prefetch depth
    one = tloader.DataLoader(td, 64)
    assert [b[0].shape[0] for b in tloader.device_prefetch(one, size=3, device="cpu")] == [64]


@pytest.fixture
def png_tree(tmp_path):
    rng = np.random.RandomState(11)
    for cls, n in (("cat", 3), ("ant", 2), ("dog", 4)):
        os.makedirs(tmp_path / cls)
        for i in range(n):
            img = rng.randint(0, 256, (10, 9, 3)).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / cls / f"{i:02d}.png")
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    return str(tmp_path)


@pytest.mark.parametrize("cache", [True, False])
def test_image_folder_dataset_is_the_jax_one(png_tree, cache):
    jd = jds.ImageFolderDataset(png_tree, cache=cache)
    td = tds.ImageFolderDataset(png_tree, cache=cache)
    assert td.class_names == jd.class_names == ["ant", "cat", "dog"]
    assert len(td) == len(jd) == 9 and td.image_shape == jd.image_shape == (10, 9, 3)
    np.testing.assert_array_equal(td.all_labels(), jd.all_labels())
    idx = np.array([8, 0, 3, 5])
    (tx, ty), (jx, jy) = td.load_raw(idx), jd.load_raw(idx)
    assert tx.dtype == np.uint8
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    loader = tloader.DataLoader(td, 4, shuffle=True, seed=0, num_workers=2)
    jl = jloader.DataLoader(jd, 4, shuffle=True, seed=0, num_workers=2)
    for (a, b, c), (d, e, f) in zip(loader, jl):
        np.testing.assert_array_equal(a, d)
        np.testing.assert_array_equal(b, e)
        np.testing.assert_array_equal(c, f)


def test_dataset_constants_are_the_jax_ones():
    for name in ("CINIC_MEAN", "CINIC_STD", "MNIST_MEAN", "MNIST_STD", "CIFAR10_MEAN",
                 "CIFAR10_STD", "IMG_EXTENSIONS"):
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name))


def test_mnist_and_cifar10_readers_are_the_jax_ones(tmp_path):
    import gzip
    import pickle
    import struct

    rng = np.random.RandomState(4)
    images, labels = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8), np.arange(5) % 10
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + images.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.astype(np.uint8).tobytes())
    cifar = tmp_path / "cifar-10-batches-py"
    os.makedirs(cifar)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8),
                         b"labels": list(rng.randint(0, 10, 3))}, f)
    for got, want in ((tds.mnist(str(tmp_path), "test"), jds.mnist(str(tmp_path), "test")),
                      (tds.cifar10(str(tmp_path)), jds.cifar10(str(tmp_path))),
                      (tds.cifar10(str(tmp_path), "test"), jds.cifar10(str(tmp_path), "test"))):
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.mean, want.mean)
        assert got.class_names == want.class_names
