"""Hand-written CUDA kernels for Hopper (counterpart of convnets_tpu/ops/pallas).

Sources live in `convnets_tpu_torch/csrc/*.cu`. At first use each is
compiled with nvcc for sm_90a, all at once in parallel, and the objects
are linked into one shared library with a plain C interface
(`build/libconvnets_kernels.so`), rebuilt when a source is newer than the
library, and bound with ctypes. Nothing is compiled when this package is
imported.

Every wrapper takes its plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches its kernel or raises: there is no fallback on
the card. `LAUNCHES` counts kernel launches per wrapper, so a run can show
that its path went through the kernels.

The dense conv (`conv2d_fused`, `conv2d_stats`) runs the plan that
`conv_plan` picks from dtype and shape: bf16 on the tensor cores (wgmma
fed through a shared-memory ring, csrc/conv_wgmma.cu), fp32 on the CUDA
cores (csrc/conv_fused.cu), which only the fp32 checks use. The grouped
conv (`grouped_conv2d_fused`, `grouped_conv2d_stats`) runs the plan of
`grouped_plan`: bf16 at Cin/G = Cout/G in {4, 8, 16, 32} with Cin % 64 ==
0 on the tensor cores (the grouped mode of csrc/conv_wgmma.cu, route
"wgmma"), the other bf16 shapes but Cin/G = 2 (ShuffleNet's grouped 1x1s
among them) on the tensor cores too (csrc/grouped_wgmma.cu, route
"wgmma_wide"), fp32 and bf16 at Cin/G = 2 on the CUDA cores
(csrc/grouped_conv.cu, "simt"); `ROUTE_LAUNCHES` counts their launches
per route. Both conv families take any stride and
dilation, and the grouped one any number of groups: the kernels address
the tap (ky, kx) of output pixel (oy, ox) at input row oy·sh − ph + ky·dh
and column ox·sw − pw + kx·dw. The window kernels (`depthwise_conv2d`,
any channel multiplier and dilation; `max_pool2d`, `avg_pool2d`,
`pool2d_backward`) run on the CUDA cores on the route that
`depthwise_plan` / `pool_plan` pick by shape: "vector" (8 channels per
thread in 16-byte vectors) or "loop" (one thread per element);
`ROUTE_LAUNCHES` counts their launches per route. `bottleneck_block` runs
the route of `block_plan`: bf16 at Cmid in {64, 128, 256} with Cin % 64 ==
0 on the tensor cores (three chained wgmma products with h1 and h2 in
shared memory, csrc/block_wgmma.cu), fp32 and the other bf16 shapes on the
CUDA cores (csrc/block.cu); `ROUTE_LAUNCHES` counts its launches per route
too.

The trainable functions (`conv2d_train`, `grouped_conv2d_train`,
`conv_bn_relu_train`, `depthwise_train`, `pool2d_train`) are
`torch.autograd.Function`s: their forwards go through the wrappers above,
and their conv backwards are plain PyTorch (cuDNN on the card), as the JAX
package leaves its backwards to XLA. Two backwards are kernels: the
pool's (its max forward writes the tap of each window's first maximum and
the `pool2d_backward` kernel gathers dx from it) and the BN part of
`conv_bn_relu_train`, whose normalize + ReLU forward (`bn_act_forward`)
and BN backward (`bn_act_backward`) run csrc/bn_act.cu on the route of
`bn_act_plan`, counted per route in `ROUTE_LAUNCHES`. `bottleneck_block`
(a whole identity bottleneck in one launch) has no caller in the models,
as in the JAX package.

The Winograd F(2,3) / F(4,3) path of the dense 3x3 stride-1 convs
(`winograd_conv2d`, `winograd_conv2d_stats`, `winograd_conv2d_train`;
opt-in through CONVNETS_TPU_WINOGRAD, ops/winograd.py) runs its input and
output transforms on csrc/winograd.cu (`winograd_input`,
`winograd_output`, the latter with the bias, folded-BN or statistics
epilogue) and its batched product on cuBLAS.

The eval path's five kernels, and the Winograd conv, are also torch custom ops
(`torch.ops.convnets_torch.*`, registered by `library.py` when this
package is imported), which the eval-mode layers call, so `torch.export`
can trace and save a model that runs them.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

from convnets_tpu_torch.core.shapes import to_pair

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libconvnets_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

LAUNCHES: Dict[str, int] = {"conv2d_fused": 0, "conv2d_stats": 0, "conv2d_stats_reduce": 0,
                             "max_pool2d": 0, "avg_pool2d": 0, "depthwise_conv2d": 0,
                             "grouped_conv2d_fused": 0, "grouped_conv2d_stats": 0,
                             "bottleneck_block": 0, "pool2d_backward": 0,
                             "bn_act_forward": 0, "bn_act_backward_sums": 0,
                             "bn_act_backward_reduce": 0, "bn_act_backward_apply": 0,
                             "winograd_input": 0, "winograd_output": 0}
# launches per route of the kernels whose route is chosen by shape: the
# window kernels, the block, the grouped convs and the BN passes of the
# fused conv sites
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {
    **{name: {"vector": 0, "loop": 0}
       for name in ("depthwise_conv2d", "max_pool2d", "avg_pool2d", "pool2d_backward",
                    "bn_act_forward", "bn_act_backward_sums", "bn_act_backward_apply")},
    "bottleneck_block": {"wgmma": 0, "simt": 0},
    **{name: {"wgmma": 0, "wgmma_wide": 0, "simt": 0}
       for name in ("grouped_conv2d_fused", "grouped_conv2d_stats")}}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # dtype, x, w, scale, shift, y, n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw,
    # dh, dw, route, bm, bn, gather, relu, stream
    "conv_fused_launch": [_I, _P, _P, _P, _P, _P] + [_I] * 20 + [_P],
    # dtype, x, w, y, partial, n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw,
    # route, bm, bn, gather, stream
    "conv_stats_launch": [_I, _P, _P, _P, _P] + [_I] * 19 + [_P],
    # partial, out, blocks, cout, stream
    "stats_reduce_launch": [_P, _P, _I, _I, _P],
    # dtype, x, y, taps, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, route, r, stream
    "max_pool_launch": [_I, _P, _P, _P] + [_I] * 14 + [_P],
    # dtype, x, y, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, route, r, stream
    "avg_pool_launch": [_I, _P, _P] + [_I] * 14 + [_P],
    # dtype, mode, g, taps, dx, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, route, stream
    "pool_backward_launch": [_I, _I, _P, _P, _P] + [_I] * 13 + [_P],
    # dtype, x, w, y, n, h, w, c, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw, route, cb,
    # th, tw, r, ry, stream
    "depthwise_launch": [_I, _P, _P, _P] + [_I] * 21 + [_P],
    # dtype, x, w, scale, shift, y, n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw,
    # dh, dw, groups, route, relu, stream
    "grouped_fused_launch": [_I, _P, _P, _P, _P, _P] + [_I] * 18 + [_P],
    # dtype, x, w, y, partial, n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw,
    # groups, route, stream
    "grouped_stats_launch": [_I, _P, _P, _P, _P] + [_I] * 17 + [_P],
    "grouped_block_rows": [],
    # dtype, x, w1, w2, w3, sb, out, n, h, w, cin, cmid, relu_out, route, th, stream
    "bottleneck_launch": [_I, _P, _P, _P, _P, _P, _P] + [_I] * 8 + [_P],
    # dtype, y, sums, scale, bias, out, mean, var, inv, m, c, n, eps, relu, route, tx,
    # rowblocks, stream
    "bn_act_forward_launch": [_I] + [_P] * 8 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
    # dtype, g, y, mean, inv, scale, bias, partial, m, c, relu, route, tx, rowblocks, stream
    "bn_act_sums_launch": [_I] + [_P] * 7 + [_I] * 6 + [_P],
    # dtype, g, y, mean, inv, scale, bias, sums, dy, m, c, n, relu, route, tx, rowblocks,
    # stream
    "bn_act_apply_launch": [_I] + [_P] * 8 + [_I] * 7 + [_P],
    # dtype, x, v, n, h, w, c, th, tw, ph, pw, m, vec, stream
    "winograd_input_launch": [_I, _P, _P] + [_I] * 10 + [_P],
    # dtype, mm, y, scale, shift, partial, n, oh, ow, o, th, tw, m, vec, epi, relu, tx, ty,
    # stream
    "winograd_output_launch": [_I] + [_P] * 5 + [_I] * 12 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTE_LAUNCHES.values():
        for route in routes:
            routes[route] = 0


def count_launch(name: str, route: str) -> None:
    """One launch of a window kernel, the block, a grouped conv or a BN
    pass on `route`."""
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[name][route] += 1


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _stale() -> bool:
    """The library is missing or older than a source or a header it includes."""
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in _sources() + headers)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale: one nvcc
    per source, all started together, then one link. Returns the
    compilers' output (register and shared-memory use when `verbose`)."""
    with _lock:
        if not _stale():
            return ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
        objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o") for src in _sources()]
        tmp = f"{LIB_PATH}.{tag}"
        procs = []
        try:
            procs += [subprocess.Popen([nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                                       "-c", "-o", obj, src], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(_sources(), objs)]
            log = []
            for src, proc in zip(_sources(), procs):
                out = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{out}")
                log.append(out)
            r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
            os.replace(tmp, LIB_PATH)
        finally:
            for proc in procs:  # none outlives a failed build
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for path in (*objs, tmp):
                if os.path.exists(path):
                    os.remove(path)
        return "".join(log) + r.stdout + r.stderr


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        build()
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(LIB_PATH)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = handle
    return _lib


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def check_cuda_operand(name: str, t: torch.Tensor, dtype=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of a dtype the kernels
    take (and of `dtype`, when given) whose offsets fit in 32 bits."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is None and t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements exceed the kernels' 32-bit indexing")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fits_conv(stride, dilation, groups: int) -> bool:
    """Envelope of conv2d_fused / conv2d_stats / conv2d_train: dense, any
    stride and dilation >= 1 (AlexNet's 11x11/4 stem among them)."""
    return groups == 1 and min(*to_pair(stride), *to_pair(dilation)) >= 1


def fits_grouped(cin: int, cout: int, stride, dilation, groups: int) -> bool:
    """Envelope of the grouped kernels (grouped_conv2d_fused/_stats and
    grouped_conv2d_train): every grouped conv the JAX package's Conv2d
    takes that is not depthwise. JAX's Pallas path
    (ops/pallas/__init__.py:fits_grouped: 2 <= Cin/G <= 32, at most 64
    groups, undilated, stride 1 or 2) widened by dilation, by Cin/G above
    32, by any number of groups and by any stride per axis (the rest runs
    on lax there): groups > 1 dividing Cin and Cout, Cin/G >= 2, stride and
    dilation >= 1."""
    return (groups > 1 and cin % groups == 0 and cout % groups == 0 and cin // groups >= 2
            and min(*to_pair(stride), *to_pair(dilation)) >= 1)


def fits_depthwise(cin: int, cout: int, dilation, groups: int) -> bool:
    """Envelope of depthwise_conv2d: one group per input channel (groups ==
    Cin), Cout a multiple m >= 1 of Cin (the channel multiplier), any
    dilation >= 1 and stride. JAX's Pallas path (fits_depthwise there:
    multiplier 1, undilated) widened by the multiplier and dilation it
    leaves to lax."""
    return (groups == cin and cout % cin == 0 and cout >= cin
            and min(to_pair(dilation)) >= 1)


from convnets_tpu_torch.ops.kernels.conv import (  # noqa: E402
    ConvPlan, GroupedPlan, conv2d_fused, conv2d_fused_plain, conv2d_stats, conv2d_stats_plain,
    conv2d_train, conv_plan, grouped_conv2d_fused, grouped_conv2d_fused_plain,
    grouped_conv2d_stats, grouped_conv2d_stats_plain, grouped_conv2d_train, grouped_plan,
    grouped_slices, grouped_wide_tiles,
)
from convnets_tpu_torch.ops.kernels.pool import (  # noqa: E402
    WindowPlan, avg_pool2d, avg_pool2d_plain, max_pool2d, max_pool2d_plain, pool2d_backward,
    pool2d_backward_plain, pool2d_train, pool_plan,
)
from convnets_tpu_torch.ops.kernels.depthwise import (  # noqa: E402
    depthwise_conv2d, depthwise_conv2d_plain, depthwise_plan, depthwise_train,
)
from convnets_tpu_torch.ops.kernels.bn_act import (  # noqa: E402
    BNActPlan, bn_act_backward, bn_act_backward_plain, bn_act_forward, bn_act_forward_plain,
    bn_act_plan,
)
from convnets_tpu_torch.ops.kernels.fused import conv_bn_relu_train  # noqa: E402
from convnets_tpu_torch.ops.kernels.block import (  # noqa: E402
    BlockPlan, block_plan, bottleneck_block, bottleneck_block_plain, fits_block,
)
from convnets_tpu_torch.ops.kernels.winograd import (  # noqa: E402
    winograd_conv2d, winograd_conv2d_plain, winograd_conv2d_stats, winograd_conv2d_stats_plain,
    winograd_conv2d_train, winograd_input, winograd_output, winograd_output_stats,
)
from convnets_tpu_torch.ops.kernels import library  # noqa: E402,F401  (registers the ops)

__all__ = [
    "BNActPlan", "BlockPlan", "ConvPlan", "GroupedPlan", "LAUNCHES", "ROUTE_LAUNCHES",
    "WindowPlan", "avg_pool2d", "avg_pool2d_plain", "block_plan", "bn_act_backward",
    "bn_act_backward_plain", "bn_act_forward", "bn_act_forward_plain", "bn_act_plan",
    "bottleneck_block", "bottleneck_block_plain", "build", "conv2d_fused", "conv2d_fused_plain",
    "conv2d_stats", "conv2d_stats_plain", "conv2d_train", "conv_bn_relu_train", "conv_plan",
    "count_launch", "depthwise_conv2d", "depthwise_conv2d_plain", "depthwise_plan", "depthwise_train",
    "fits_block", "fits_conv", "fits_depthwise", "fits_grouped", "grouped_conv2d_fused",
    "grouped_conv2d_fused_plain", "grouped_conv2d_stats", "grouped_conv2d_stats_plain",
    "grouped_conv2d_train", "grouped_plan", "grouped_slices", "grouped_wide_tiles", "lib",
    "max_pool2d",
    "max_pool2d_plain", "pool2d_backward", "pool2d_backward_plain", "pool2d_train",
    "pool_plan", "reset_launches", "winograd_conv2d", "winograd_conv2d_plain",
    "winograd_conv2d_stats", "winograd_conv2d_stats_plain", "winograd_conv2d_train",
    "winograd_input", "winograd_output", "winograd_output_stats",
]
