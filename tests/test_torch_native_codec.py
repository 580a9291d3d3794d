"""The port's native image codec (convnets_tpu_torch/native) against the
JAX package's (convnets_tpu/native) and PIL, on the CPU.

Every image is drawn from a seed with numpy and written with PIL (the
16-bit RGB PNG by `_write_png16`: PIL cannot write one). The port's codec
equals the JAX codec bit for bit at every layout and size; against PIL it
meets tests/test_native_codec.py's bars: PNG decode exact, JPEG mean |Δ|
≤ 1.0, a resize max |Δ| ≤ 1, or ≤ 2 with mean ≤ 0.5 for the antialiased
shrink. The failure paths (missing file, the CONVNETS_TPU_NATIVE_DECODE
gate, a format the codec lacks, a failed build) and the route counters;
the port's ImageFolderDataset against the JAX one, its resized disk cache
shared both ways.
"""

import os
import struct
import time
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from convnets_tpu import native as jax_native
from convnets_tpu.data import datasets as jds
from convnets_tpu_torch import native
from convnets_tpu_torch.data import datasets as tds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL, BIG = (24, 20), (128, 96)  # (h, w) of the sources
# (source, output size): native, an upscale, the antialiased 128x96 -> 32x24 shrink
SIZES = {"native": (SMALL, None), "up": (SMALL, (64, 48)), "down": (BIG, (32, 24))}
PNG_LAYOUTS = ("rgb", "gray", "palette", "rgb16", "rgba", "trns")
FORMATS = PNG_LAYOUTS + ("jpeg",)


def _write_png16(path, rgb16):
    """A 16-bit-per-channel RGB PNG (colour type 2, depth 16), unfiltered."""
    h, w, _ = rgb16.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + row.astype(">u2").tobytes() for row in rgb16)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _write(path, fmt, hw, seed):
    """An image of layout `fmt` at hw = (h, w), drawn from `seed`."""
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    if fmt == "rgb16":
        _write_png16(path, rng.randint(0, 1 << 16, (*hw, 3)).astype(np.uint16))
    elif fmt == "gray":
        Image.fromarray(rgb[..., 0], "L").save(path)
    elif fmt == "palette":
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(path)
    elif fmt == "rgba":
        Image.fromarray(rng.randint(0, 256, (*hw, 4)).astype(np.uint8), "RGBA").save(path)
    elif fmt == "trns":  # an RGB PNG whose tRNS chunk makes one colour transparent
        rgb[0, 0] = (1, 2, 3)
        Image.fromarray(rgb).save(path, transparency=(1, 2, 3))
    elif fmt == "jpeg":
        Image.fromarray(rgb).save(path, quality=90)
    else:
        Image.fromarray(rgb).save(path)
    return str(path)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """{(format, size name): path} for every format and size."""
    d = tmp_path_factory.mktemp("codec")
    out = {}
    for i, fmt in enumerate(FORMATS):
        ext = "jpg" if fmt == "jpeg" else "png"
        for src in (SMALL, BIG):
            out[fmt, src] = _write(d / f"{fmt}_{src[0]}.{ext}", fmt, src, 10 + i)
    return out


def _pil(path, out_hw):
    with Image.open(path) as im:
        im = im.convert("RGB")
        if out_hw is not None:
            im = im.resize((out_hw[1], out_hw[0]), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def test_codec_builds_here_into_the_ports_build_dir():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    build = os.path.join(ROOT, "convnets_tpu_torch", "build", "native")
    assert native.BUILD_DIR == build and os.path.dirname(native.LIB_PATH) == build
    assert os.path.exists(native.LIB_PATH)
    assert not os.path.abspath(native.LIB_PATH).startswith(os.path.join(ROOT, "convnets_tpu", ""))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_codec_equals_the_jax_codec(images, fmt, size):
    src, out_hw = SIZES[size]
    path = images[fmt, src]
    got, want = native.decode_image(path, out_hw), jax_native.decode_image(path, out_hw)
    assert got is not None and want is not None
    assert got.shape == (*(out_hw or src), 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_codec_within_pil_bars(images, fmt, size):
    src, out_hw = SIZES[size]
    path = images[fmt, src]
    got, want = native.decode_image(path, out_hw), _pil(path, out_hw)
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    if fmt == "jpeg":  # IDCT rounding may legally differ between libjpeg builds
        assert d.mean() <= 1.0, d.mean()
    elif size == "native":
        np.testing.assert_array_equal(got, want)
    elif size == "up":
        assert d.max() <= 1, d.max()
    else:
        assert d.max() <= 2 and d.mean() <= 0.5, (d.max(), d.mean())


def test_gray16_png_keeps_the_high_byte(tmp_path):
    """A 16-bit gray PNG: both codecs keep each sample's high byte
    (libpng's strip_16), where PIL's convert("RGB") clips the 16-bit value
    at 255. The two codecs agree; PIL's route differs from them here."""
    a = np.random.RandomState(4).randint(0, 1 << 16, (12, 10)).astype(np.uint16)
    path = str(tmp_path / "g16.png")
    Image.fromarray(a.astype(np.int32)).convert("I;16").save(path)
    got = native.decode_image(path)
    np.testing.assert_array_equal(got, jax_native.decode_image(path))
    np.testing.assert_array_equal(got, np.repeat((a >> 8).astype(np.uint8)[..., None], 3, -1))
    np.testing.assert_array_equal(_pil(path, None)[..., 0], np.minimum(a, 255).astype(np.uint8))


def test_image_size_reads_the_header_only(tmp_path):
    """The size probe runs before every native-size decode: it must not
    pay a decode (the JAX test's bar, probe < full decode / 5)."""
    big = _write(tmp_path / "big.png", "rgb", (1024, 1024), 12)
    assert native.image_size(big) == jax_native.image_size(big) == (1024, 1024)
    t0 = time.perf_counter()
    for _ in range(20):
        assert native.image_size(big) == (1024, 1024)
    probe = (time.perf_counter() - t0) / 20
    t0 = time.perf_counter()
    native.decode_image(big)
    full = time.perf_counter() - t0
    assert probe < full / 5, (probe, full)


def test_missing_file_gives_none():
    assert native.decode_image("/nonexistent/x.png") is None
    assert native.decode_image("/nonexistent/x.png", (8, 8)) is None
    assert native.image_size("/nonexistent/x.png") is None


def test_env_gate_turns_the_codec_off_and_on(monkeypatch):
    monkeypatch.setenv(native.ENV_GATE, "0")
    assert not native.available()
    monkeypatch.setenv(native.ENV_GATE, "1")
    assert native.available()
    monkeypatch.delenv(native.ENV_GATE)
    assert native.available()


def _tree(root, fmt="png", hw=(12, 12), per_class=3, extra_bmp=False):
    """<root>/{a,b}/<i>.<fmt> drawn from a seed; a .bmp in class b if asked."""
    rng = np.random.RandomState(3)
    for c in ("a", "b"):
        d = root / c
        d.mkdir(parents=True)
        for i in range(per_class):
            im = Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
            im.save(d / f"{i}.{fmt}", **({"quality": 90} if fmt == "jpg" else {}))
    if extra_bmp:
        Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(np.uint8)).save(root / "b" / "z.bmp")
    return str(root)


def test_bmp_goes_by_the_pil_route_and_is_counted(tmp_path):
    root = _tree(tmp_path / "set", extra_bmp=True)
    ds = tds.ImageFolderDataset(root, cache=False)
    native.reset_decodes()
    x, y = ds.load_raw(np.arange(len(ds)))
    assert native.DECODES == {"native": 6, "pil": 1}
    want, _ = jds.ImageFolderDataset(root, cache=False).load_raw(np.arange(len(ds)))
    np.testing.assert_array_equal(x, want)
    np.testing.assert_array_equal(x[-1], _pil(os.path.join(root, "b", "z.bmp"), None))


def test_env_gate_sends_every_decode_to_pil(tmp_path, monkeypatch):
    root = _tree(tmp_path / "set")
    monkeypatch.setenv(native.ENV_GATE, "0")
    ds = tds.ImageFolderDataset(root, image_size=(16, 16), cache=False)
    native.reset_decodes()
    x, _ = ds.load_raw(np.arange(len(ds)))
    assert native.DECODES == {"native": 0, "pil": 6}
    assert ds._decoder_id() == "pil"
    for i, p in enumerate(ds._paths):
        np.testing.assert_array_equal(x[i], _pil(p, (16, 16)))


@pytest.mark.parametrize("how", ["bad_compiler", "no_compiler"])
def test_failed_build_warns_once_and_keeps_its_error(tmp_path, monkeypatch, how):
    """A build that fails leaves the codec off, warns once with g++'s
    output and keeps it in build_error(); the dataset decodes with PIL."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    if how == "bad_compiler":
        gxx = bindir / "g++"
        gxx.write_text("#!/bin/sh\necho 'imgcodec.cpp:30:10: fatal error: png.h: "
                       "No such file or directory' >&2\nexit 1\n")
        gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "build" / "libimgcodec.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.warns(RuntimeWarning, match="native image codec unavailable") as record:
        assert not native.available()
    error = native.build_error()
    assert error is not None and error in str(record[0].message)
    if how == "bad_compiler":
        assert "g++ exited 1" in error and "png.h: No such file or directory" in error
    else:
        assert "g++ failed to run" in error
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native.available() and native.decode_image("/nonexistent/x.png") is None
    root = _tree(tmp_path / "set")
    native.reset_decodes()
    ds = tds.ImageFolderDataset(root, image_size=(16, 16), cache=False)
    ds.load_raw(np.arange(len(ds)))
    assert native.DECODES["native"] == 0 and ds._decoder_id() == "pil"


def test_rebuilds_when_the_source_is_newer(tmp_path, monkeypatch):
    src = tmp_path / "imgcodec.cpp"
    src.write_text(open(native.SRC_PATH).read())
    lib = tmp_path / "build" / "libimgcodec.so"
    monkeypatch.setattr(native, "SRC_PATH", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH", str(lib))
    for attr, value in (("_lib", None), ("_load_failed", False), ("_build_error", None)):
        monkeypatch.setattr(native, attr, value)
    assert native.available()
    built = os.path.getmtime(lib)
    os.utime(src, (built + 10, built + 10))
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    assert os.path.getmtime(lib) > built
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".tmp")]


@pytest.mark.parametrize("compiler", ["works", "fails"])
def test_a_library_that_does_not_load_is_built_again(tmp_path, monkeypatch, compiler):
    """A library newer than the source that does not load here (one that
    another host built, against libraries this host lacks) is built again;
    where that build fails, build_error() says both."""
    lib = tmp_path / "build" / "libimgcodec.so"
    lib.parent.mkdir()
    lib.write_bytes(b"not a shared object")
    os.utime(lib, (os.path.getmtime(native.SRC_PATH) + 10,) * 2)
    monkeypatch.setattr(native, "BUILD_DIR", str(lib.parent))
    monkeypatch.setattr(native, "LIB_PATH", str(lib))
    for attr, value in (("_lib", None), ("_load_failed", False), ("_build_error", None)):
        monkeypatch.setattr(native, attr, value)
    if compiler == "works":
        assert native.available() and native.build_error() is None
        path = _write(tmp_path / "x.png", "rgb", SMALL, 5)
        np.testing.assert_array_equal(native.decode_image(path), _pil(path, None))
        return
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ there
    with pytest.warns(RuntimeWarning, match="does not load here"):
        assert not native.available()
    assert "so it was built again: g++ failed to run" in native.build_error()


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("image_size", [None, (16, 20)])
@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_imagefolder_load_raw_equals_jax(tmp_path, monkeypatch, fmt, image_size, gate):
    root = _tree(tmp_path / "set", fmt=fmt)
    monkeypatch.setenv(native.ENV_GATE, gate)
    ds, jd = (mod.ImageFolderDataset(root, image_size=image_size) for mod in (tds, jds))
    assert ds.image_shape == jd.image_shape
    assert ds._decoder_id() == jd._decoder_id() == (
        "any" if image_size is None else {"1": "native", "0": "pil"}[gate])
    idx = np.arange(len(ds))
    (x, y), (jx, jy) = ds.load_raw(idx), jd.load_raw(idx)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("writer,reader,tag_gate,reused", [
    ("jax", "port", "1", True), ("port", "jax", "1", True),
    ("jax", "port", "0", False), ("port", "jax", "0", False)])
def test_resized_disk_cache_is_shared(tmp_path, monkeypatch, writer, reader, tag_gate, reused):
    """A resized cache written by one package is reused by the other under
    the same decoder (tag "native"); a cache written with the codec off
    (tag "pil") is not reused where the codec is on."""
    mods = {"jax": jds, "port": tds}
    for mod in mods.values():
        monkeypatch.setattr(mod.ImageFolderDataset, "MIN_PERSIST_BYTES", 0)
    root = _tree(tmp_path / "set", hw=(20, 24))
    cache = str(tmp_path / "cache" / "train.npy")
    monkeypatch.setenv(native.ENV_GATE, tag_gate)
    w = mods[writer].ImageFolderDataset(root, image_size=(16, 16), cache=True, disk_cache=cache)
    want, _ = w.load_raw(np.arange(len(w)))
    assert open(cache + ".decoder").read() == {"1": "native", "0": "pil"}[tag_gate]
    monkeypatch.setenv(native.ENV_GATE, "1")
    r = mods[reader].ImageFolderDataset(root, image_size=(16, 16), cache=True, disk_cache=cache)
    assert bool(r._cached.all()) == reused and (r._disk_cache_path is None) == reused
    native.reset_decodes()
    got, _ = r.load_raw(np.arange(len(r)))
    if reader == "port":
        assert native.DECODES["native"] == (0 if reused else len(r))
    if reused:
        np.testing.assert_array_equal(got, want)
    else:  # decoded anew by the codec, and the cache rewritten under its tag
        np.testing.assert_array_equal(got, [native.decode_image(p, (16, 16)) for p in r._paths])
        assert open(cache + ".decoder").read() == "native"

