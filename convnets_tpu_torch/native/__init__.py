"""Native (C++) image decode for the host input pipeline (counterpart of
convnets_tpu/native, copied: the port imports nothing of the JAX package).

imgcodec.cpp decodes PNG (libpng) and JPEG (libjpeg) to RGB8, dropping
alpha as PIL's convert("RGB") does, fused with Pillow's antialiased
BILINEAR resize. It is host code, not a CUDA kernel: it feeds
`data/datasets.py:ImageFolderDataset`, which falls back to PIL for a file
the codec cannot read (.bmp, .ppm, .webp) or when the codec is off.

The library is compiled on first use with `g++ -O3 -shared -fPIC
-std=c++17 ... -lpng -ljpeg` into `convnets_tpu_torch/build/native/`,
rebuilt when the source is newer than it, and bound with ctypes. Each
process compiles into a file of its own and renames it into place, so
processes may build at once. Nothing is compiled at import.

`CONVNETS_TPU_NATIVE_DECODE=0` turns the codec off (`available()` is then
False and the dataset decodes with PIL). A failed build is not silent: it
warns once with the tail of g++'s output, which `build_error()` returns.
`DECODES` counts the images decoded per route, "native" here and "pil"
in the dataset's fallback, so a run can show which route its data took.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Dict, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_PATH = os.path.join(_HERE, "imgcodec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libimgcodec.so")
ENV_GATE = "CONVNETS_TPU_NATIVE_DECODE"

DECODES: Dict[str, int] = {"native": 0, "pil": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_build_error: Optional[str] = None


def reset_decodes() -> None:
    for route in DECODES:
        DECODES[route] = 0


def count_decode(route: str) -> None:
    """One image decoded on `route` ("native" or "pil"); decode threads
    count concurrently, hence the lock."""
    with _count_lock:
        DECODES[route] += 1


def build_error() -> Optional[str]:
    """Why the codec could not be built or loaded in this process, or None."""
    return _build_error


def _build() -> Optional[str]:
    """Compile SRC_PATH into LIB_PATH; returns None, or the error text."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SRC_PATH, "-lpng", "-ljpeg",
           "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            return f"g++ exited {r.returncode}:\n{(r.stderr or r.stdout)[-2000:]}"
        os.replace(tmp, LIB_PATH)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ failed to run: {e}"
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _fail(message: str) -> None:
    global _load_failed, _build_error
    _load_failed, _build_error = True, message
    warnings.warn(f"native image codec unavailable, decoding with PIL: {message}",
                  RuntimeWarning, stacklevel=3)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.cn_decode_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_int, ctypes.c_int]
    lib.cn_decode_file.restype = ctypes.c_int
    lib.cn_image_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.cn_image_size.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built first if it is missing or older than the
    source; a library that does not load here (one another host built,
    against libraries this host lacks) is built again. None, after one
    warning, when that fails."""
    global _lib
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        context = ""
        if os.path.exists(LIB_PATH) and os.path.getmtime(SRC_PATH) <= os.path.getmtime(LIB_PATH):
            try:
                _lib = _bind(ctypes.CDLL(LIB_PATH))
                return _lib
            except OSError as e:
                context = f"{LIB_PATH} does not load here ({e}), so it was built again: "
        error = _build()
        if error is not None:
            _fail(context + error)
            return None
        try:
            _lib = _bind(ctypes.CDLL(LIB_PATH))
        except OSError as e:
            _fail(f"{context}loading {LIB_PATH} failed: {e}")
    return _lib


def available() -> bool:
    """True when the codec is on (ENV_GATE is not "0") and built or
    buildable on this host."""
    if os.environ.get(ENV_GATE, "1") == "0":
        return False
    return _load() is not None


def image_size(path: str):
    """(h, w) of the image at `path` from its header alone, or None."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.cn_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_image(path: str, out_hw=None) -> Optional[np.ndarray]:
    """Decode (and resize to `out_hw` = (h, w), if given) into an RGB uint8
    array of shape (h, w, 3); None on any failure, for the caller's PIL
    fallback. The foreign call releases the GIL, so the DataLoader's decode
    threads run in parallel."""
    lib = _load()
    if lib is None:
        return None
    if out_hw is None:
        out_hw = image_size(path)
        if out_hw is None:
            return None
    h, w = int(out_hw[0]), int(out_hw[1])
    out = np.empty((h, w, 3), np.uint8)
    if lib.cn_decode_file(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          h, w) != 0:
        return None
    count_decode("native")
    return out
