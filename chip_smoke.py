#!/usr/bin/env python3
"""Drive the PyTorch port's ResNet-50, MobileNet-v1, DenseNet-121 and
ResNeXt-50 serving and train paths, and the whole-bottleneck-block kernel,
on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in the order they run; any failure exits non-zero without the
final line:
  0. device: needs CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them.
  1. build: compiles convnets_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
     compiler per source, all started together.
  1b. SASS: the HGMMA instructions of every tensor-core conv instantiation
     (cuobjdump -sass; none may have 0), the grouped mode's 8 among them
     (Cin/G = 4, 8, 16, 32, both epilogues), the block's 3 (Cmid = 64,
     128, 256), and no bf16 instantiation of the dense CUDA-core conv loop.
  2a. conv plans vs plain: every branch of conv_plan (PLAN_SHAPES: the
     7x7x3 stem at N=1, the 3x3x3 stem, Cin=12, Cout=32, 24 and 27, a 1x1
     stride-2 p0, Cin=40, M=49 < BM, two RN50 shapes at b256), fp32 and
     bf16, both epilogues (y with and without scale/shift/ReLU; y, Σy, Σy²).
  2. serving kernels vs plain: every distinct conv shape of the port's own
     RN50@224 modules, at batch 8, fp32 (TF32 off) and bf16, with and
     without ReLU, plus the stem max-pool, each against its plain PyTorch
     version on the card; max error, tolerance and CUDA-event times.
  4. train kernels vs plain: conv2d_stats (y, Σy, Σy²) and its reduction
     at every distinct RN50@224 conv shape at batch 8 in fp32 and bf16;
     conv_bn_relu_train and conv2d_train forward and gradients at the stem
     and a 3x3/2 shape; pool2d_train dx at the stem pool (exact).
  4b. conv2d_fused, conv2d_stats and conv2d_fused with no epilogue (the
     forward of conv2d_train) in bf16 at batch 256 at every distinct
     RN50@224 shape, beside cuDNN's bf16 F.conv2d: ms and TFLOP/s per
     shape, summed by layer use into the kernels line (ms_b256,
     library_ms_b256, bound_ms_b256).
  5. the train slice, RN50 at 3x224x224, 1000 classes, weights made with
     numpy from --seed in the JAX variable layout and loaded by the bridge:
     (i) one fp32 SGD step at batch 8, kernel path vs plain path (loss,
     every gradient, BN running statistics); (ii) ten bf16 Adam steps on
     one batch of 32, the kernel path's loss must fall; (iii) bf16
     throughput at batch 256 with bench.py's settings (Adam, weight decay
     1e-4, dropout 0.5), synthetic uint8 batch on the card, kernel and
     plain paths in turns, launches per step (exactly 53 conv2d_stats, 53
     reductions, 1 max_pool2d, 0 conv2d_fused), peak memory and a
     torch.profiler split of three steps; (iv) one step of the
     batch_norm=False RN50 at batch 32 (53 conv2d_fused launches, finite
     gradients).
  3. the serving slice, on the bf16 RN50 that phase 5 (ii) trained (with
     the served normalization; zero-learning-rate steps then bring its BN
     running statistics to its batch, so eval mode computes what it
     learned): its 32 training images as uint8 requests at batch 1, 8 and
     64 with baked normalization; finite logits, exactly 53 conv and 1
     pool launch per forward, argmax agreement with the plain versions,
     the count of distinct classes and the share served as the learned
     label; an fp32 forward vs plain; serving img/s at batch 64 and 256
     (kernel and plain paths in turns) and a torch.profiler table of
     three b64 requests, with the bytes of each host-to-device copy read
     from its memcpy events (the uint8 request's, not 4x them as fp32)
     and a copy's share of a request's device time (every family).
  6. this slice's kernels vs plain, batch 8, fp32 (TF32 off) and bf16:
     depthwise_conv2d at the 9 distinct MobileNet-v1@224 depthwise shapes,
     avg_pool2d at the 3 DenseNet-121@224 transitions; depthwise_train
     forward and dx/dw at a stride-1 and a stride-2 shape; pool2d_train in
     avg mode, forward and dx, at the first transition.
  7. MobileNet-v1 and DenseNet-121 at 3x224x224, 1000 classes, weights
     from --seed in the JAX layout, each as phases 5 and 3 drive RN50:
     (i) the fp32 SGD step at batch 8, kernel vs plain, with the
     perturbed-weight control; (ii) ten bf16 Adam steps on one batch of
     32, the loss must fall; (iii) serving that trained model: uint8
     requests at batch 8 and 64 (exact launches per forward: MobileNet 14
     conv2d_fused + 13 depthwise_conv2d; DenseNet-121 120 conv2d_fused + 1
     max_pool2d + 3 avg_pool2d), argmax agreement with the plain path,
     distinct classes, an fp32 forward vs plain, serving img/s at batch
     256; (iv) bench.py's train step at TRAIN_BATCH[arch] (exact launches
     per step: MobileNet 14 conv2d_stats + 14 reductions + 13 depthwise;
     DenseNet-121 1 conv2d_stats + 1 reduction + 119 conv2d_fused + 1
     max_pool2d + 3 avg_pool2d), img/s on both paths in turns, peak memory
     and a profiler split.
  8. this slice's kernels vs plain, fp32 (TF32 off) and bf16: the grouped
     conv at the 7 distinct ResNeXt-50@224 grouped shapes at batch 8, each
     with its grouped_plan route (bf16 must be wgmma, fp32 simt), both
     epilogues (y with and without scale/shift/ReLU; y, Σy, Σy², the sums
     against those of the kernel's own stored y), the bf16 simt route
     timed beside; both epilogues at every branch of grouped_plan
     (GROUPED_PLAN_SHAPES: Cin/G = 4, 8, 16, 32 at N=1, stride 2, p0, a
     1x1, and two bf16 simt shapes);
     grouped_conv2d_train and grouped conv_bn_relu_train forward and
     gradients at a stride-1 and a stride-2 shape; bottleneck_block at
     RN50's three identity shapes (56²×256/64, 28²×512/128, 14²×1024/256)
     at batch 8 on its block_plan routes (bf16 wgmma, fp32 simt), the bf16
     wgmma route also against the simt route on the same inputs, one
     relu_out=False case and one zero-halo case (W1 = 0, b1 > 0) in bf16,
     and a bf16 shape off the wgmma route (Cmid = 32, simt); then the block
     A/B of scripts/tpu_block_ab.py at batch 256, chains of 6 and 4 blocks:
     the kernel (every launch on the wgmma route), the simt route, its plain
     version, the port's serving composition (three conv2d_fused launches,
     the add and the ReLU) and three cuDNN convs, with ms per chain, TFLOP/s
     and each arm's ratio to the kernel.
  8b. rows 1g and 5g and row 8's forward (grouped_conv2d_fused with no
     epilogue) in bf16 at batch 256 at the 7 grouped shapes: the wgmma
     route, the simt route on the same inputs, cuDNN's bf16 grouped
     F.conv2d and the bound, ms and TFLOP/s per shape, summed by layer use
     into the kernels line (ms_b256, simt_ms_b256, library_ms_b256,
     bound_ms_b256).
  9. ResNeXt-50 (32x4d) at 3x224x224, 1000 classes, weights from --seed in
     the JAX layout, as phase 7 drives its families (exact launches per
     forward: 37 conv2d_fused + 16 grouped_conv2d_fused + 1 max_pool2d;
     per step: 37 conv2d_stats + 16 grouped_conv2d_stats + 53 reductions +
     1 max_pool2d), then (v) one step of the batch_norm=False ResNeXt-50 at
     batch 32 (16 grouped_conv2d_train forwards, finite gradients).
  last lines: the card's name and power limit, the kernels JSON line (per
  kernel: launches on its main path, max error against the plain version,
  kernel, plain and library-call ms (device time, time_ms), and the bound: the larger of the
  bytes it must move over 3.35 TB/s and its operations over the peak rate
  of their type, 989 TFLOP/s for bf16 products, 67 TFLOP/s for other
  arithmetic), then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

CONV_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-2, 1e-2)}  # (atol, rtol)
# conv2d_stats sums: |Δ Σy| ≤ tol·Σ|y| and |Δ Σy²| ≤ tol·Σy² (fp32: summation
# order only; bf16: also y's one-ulp roundings where the accumulations differ)
STATS_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# gradients, ‖Δ‖₂ / ‖g‖₂ per tensor. Where z rounds to ~0 on one path only,
# the ReLU mask flips and that element's whole cotangent moves: one flip
# shifts a conv gradient by several % of its largest element, so the
# max-based error (printed beside) cannot carry the check, while the L2
# error moves by ~1e-3 per flip. A wrong formula moves it by O(1).
GRAD_TOL = {"float32": 1e-2, "bfloat16": 5e-2}
# the whole fp32 step at init is ill-conditioned: the plain path against
# itself with its conv weights perturbed by 1e-7 relative (the "control",
# run beside the check) differs by ~2e-2 per gradient leaf in L2 for RN50;
# the bar sits above that, far below the O(1) of a wrong formula
STEP_GRAD_TOL = 0.1
CONTROL_PERTURBATION = 1e-7
POOL_TOL = 0.0  # a max of the same values is exact in either dtype
# avg pool: fp32 max|Δ| / max|ref| (only the fp32 summation order may
# differ); bf16: one ulp of each element (both round the same fp32 sum)
AVG_POOL_TOL = 1e-6
ARGMAX_MIN = 0.99
SERVE_BATCHES = (1, 8, 64)  # RN50
ZOO_SERVE_BATCHES = (8, 64)  # MobileNet-v1, DenseNet-121, ResNeXt-50
THROUGHPUT_BATCHES = {"resnet": (64, 256), "mobilenet_v1": (64, 256), "densenet": (256,),
                      "resnext": (256,)}
IMAGENET_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
REPS = 10  # timed launches per kernel measurement
IMAGE = 224
KERNEL_BATCH = 8
STEP_BATCH = 8  # phases 5 (i), 7 (i)
LEARN_BATCH, LEARN_STEPS = 32, 10  # phases 5 (ii), 7 (ii), 9 (ii)
# (ii)'s Adam learning rate. ResNeXt's classifier reads 100,352 non-negative
# features (no global pool): an Adam step moves each weight by ~lr, so each
# logit by ~lr·Σx, which at 1e-3 is tens of logits per step and the loss
# climbs after three steps on both paths; the others read ≤ 2048.
LEARN_LR = {"resnet": 1e-3, "mobilenet_v1": 1e-3, "densenet": 1e-3, "resnext": 1e-4}
# zero-lr steps that bring (ii)'s BN running statistics to its batch's:
# momentum 0.1 leaves 0.9^k of the initial running var (~1), which must be
# small beside a layer's true var. MobileNet's depthwise outputs (He
# fan-out init, std sqrt(2/(9C))) have var far below 1: after 40 steps the
# 1.5% left over dominated them and eval mode served every image as one
# class (train mode had learned all 32). 0.9^200 ≈ 7e-10.
SETTLE_STEPS = 200
WARMUP, TIMED = 5, 20  # bench.py's protocol
# bench.py's batch per family (its first choice, 256, fits on an 80 GB card
# for all three: RN50 13.5 GiB, PERF.md §6; bench.py falls back to 128, 64)
TRAIN_BATCH = {"resnet": 256, "mobilenet_v1": 256, "densenet": 256, "resnext": 256}
NOBN_BATCH = 32  # phases 5 (iv), 9 (v)
FAMILIES = {"resnet": "50", "mobilenet_v1": "v1", "densenet": "121", "resnext": "50"}
# kernel launches per forward (serving) and per train step, per family
SERVE_LAUNCHES = {
    "resnet": {"conv2d_fused": 53, "max_pool2d": 1},
    "mobilenet_v1": {"conv2d_fused": 14, "depthwise_conv2d": 13},
    "densenet": {"conv2d_fused": 120, "max_pool2d": 1, "avg_pool2d": 3},
    "resnext": {"conv2d_fused": 37, "grouped_conv2d_fused": 16, "max_pool2d": 1},
}
TRAIN_LAUNCHES = {
    "resnet": {"conv2d_stats": 53, "conv2d_stats_reduce": 53, "max_pool2d": 1,
               "pool2d_backward": 1},
    "mobilenet_v1": {"conv2d_stats": 14, "conv2d_stats_reduce": 14, "depthwise_conv2d": 13},
    "densenet": {"conv2d_stats": 1, "conv2d_stats_reduce": 1, "conv2d_fused": 119,
                 "max_pool2d": 1, "avg_pool2d": 3, "pool2d_backward": 4},
    "resnext": {"conv2d_stats": 37, "grouped_conv2d_stats": 16, "conv2d_stats_reduce": 53,
                "max_pool2d": 1, "pool2d_backward": 1},
}
# the window kernels, whose route (vector or loop) is chosen by shape: on
# every family's paths each launch must take the vector route
WINDOW_ROUTED = ("depthwise_conv2d", "max_pool2d", "avg_pool2d", "pool2d_backward")
OUR_KERNELS = ("conv_wgmma_kernel<", "conv_kernel<", "stats_reduce_kernel", "pool_vec_kernel<",
               "pool_bwd_kernel<", "depthwise_kernel<", "depthwise_vec_kernel<",
               "grouped_conv_kernel<", "bottleneck_kernel<")
# the window kernels as the profiler names them, for their share of a
# request's or a step's device time
WINDOW_KERNELS = (("depthwise", ("depthwise_kernel<", "depthwise_vec_kernel<")),
                  ("pool", ("pool_vec_kernel<", "pool_bwd_kernel<")))
# the grouped conv's kernels as the profiler names them: the grouped mode of
# conv_wgmma_kernel<64, STATS, true, CG> and the CUDA-core loop
GROUPED_KERNELS = tuple(f"conv_wgmma_kernel<64, {st}, true, {cg}>" for st in ("false", "true")
                        for cg in (4, 8, 16, 32)) + ("grouped_conv_kernel<",)
# phase 2a: every branch of conv_plan, (N, H, W, Cin, Cout, k, stride, pad, what)
PLAN_SHAPES = (
    (1, 224, 224, 3, 64, 7, 2, 3, "7x7x3 stem at N=1 (scalar gather, K=147)"),
    (2, 224, 224, 3, 32, 3, 2, 1, "3x3x3 stem (scalar gather, K=27, BN 32)"),
    (8, 56, 56, 12, 256, 3, 1, 1, "Cin=12 (scalar gather, BN 128)"),
    (2, 14, 14, 12, 64, 3, 1, 1, "Cin=12 (scalar gather, BN 64)"),
    (2, 28, 28, 128, 32, 3, 1, 1, "Cout=32 (BN 32)"),
    (2, 14, 14, 64, 24, 3, 1, 1, "Cout=24 (scalar B load, one ragged tile)"),
    (2, 14, 14, 64, 27, 3, 1, 1, "Cout=27 (odd: single-value stores)"),
    (2, 28, 28, 256, 512, 1, 2, 0, "1x1 stride 2 p0"),
    (2, 14, 14, 40, 64, 1, 1, 0, "Cin=40 (K=40 < 64)"),
    (1, 7, 7, 512, 2048, 1, 1, 0, "M=49 < BM"),
    (256, 56, 56, 64, 64, 3, 1, 1, "RN50 b256 3x3 (BN 64)"),
    (256, 14, 14, 256, 1024, 1, 1, 0, "RN50 b256 1x1 (BN 128)"),
)
# phase 8: every branch of grouped_plan, (N, H, W, Cin, Cout, G, k, stride,
# pad, bf16 route, what); fp32 always takes "simt"
GROUPED_PLAN_SHAPES = (
    (1, 7, 7, 128, 128, 32, 3, 1, 1, "wgmma", "Cin/G=4 at N=1 (M=49 < BM)"),
    (1, 7, 7, 256, 256, 32, 3, 1, 1, "wgmma", "Cin/G=8 at N=1"),
    (1, 7, 7, 512, 512, 32, 3, 1, 1, "wgmma", "Cin/G=16 at N=1"),
    (1, 7, 7, 1024, 1024, 32, 3, 1, 1, "wgmma", "Cin/G=32 at N=1"),
    (2, 15, 15, 128, 128, 32, 3, 2, 1, "wgmma", "Cin/G=4 stride 2, odd input"),
    (2, 14, 14, 256, 256, 8, 3, 2, 1, "wgmma", "Cin/G=32, G=8, stride 2"),
    (2, 16, 16, 256, 256, 16, 3, 1, 0, "wgmma", "Cin/G=16, 3x3 p0"),
    (2, 14, 14, 128, 128, 16, 1, 1, 0, "wgmma", "1x1 Cin/G=8 (KT=1 < ring slots)"),
    (2, 14, 14, 64, 64, 32, 3, 1, 1, "simt", "Cin/G=2 (bf16 simt)"),
    (2, 14, 14, 128, 256, 32, 3, 1, 1, "simt", "Cout/G=8 != Cin/G=4 (bf16 simt)"),
)
B256 = 256  # phases 4b, 8b: rows 1, 5 (RN50) and 1g, 5g (ResNeXt-50) at this batch
B256_KEYS = ("ms_b256", "library_ms_b256", "bound_ms_b256")
# rows 1g, 5g and 8 also carry the CUDA-core grouped loop's times (phases 8,
# 8b), row 10 its CUDA-core route's b256 time (phase 8)
SIMT_KEYS = ("simt_ms", "simt_ms_b256")
# rows 2, 3, 4 and 9 also carry their plain version's time at b256, rows 2,
# 3 and 9 their loop route's (phase 6b)
PLAIN_B256, LOOP_B256 = "plain_ms_b256", "loop_ms_b256"
# the block A/B of scripts/tpu_block_ab.py: (H, Cin, Cmid, blocks RN50 chains there)
BLOCK_SHAPES = ((14, 1024, 256, 6), (28, 512, 128, 4))
BLOCK_BATCH = 256
# phase 8's block checks at N=8: RN50's three identity shapes (H, Cin, Cmid),
# all on the wgmma route in bf16, and a bf16 shape off it (Cmid = 32)
BLOCK_CHECK_SHAPES = ((56, 256, 64), (28, 512, 128), (14, 1024, 256))
BLOCK_SIMT_SHAPE = (14, 256, 32)
# bottleneck_block vs its plain version: fp32 sums in another order; bf16
# also h1/h2 roundings one ulp apart (the bar of tests/test_block_kernel.py)
BLOCK_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 5e-2)}
# the bound of a kernel: the H100 SXM's published peaks at 700 W: bf16
# tensor-core products, other arithmetic at the fp32 CUDA-core rate, device
# memory
PEAK_BF16 = 989e12
PEAK_OTHER = 67e12
HBM_BPS = 3.35e12
DEVICE = "cuda"


def say(*args):
    print(*args, flush=True)


def die(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync():
    import torch

    torch.cuda.synchronize()


_SLEEP_CYCLES_PER_S = []


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events).
    A device-side sleep queued first, about 1.5× the host time the calls
    take to enqueue (at most 0.2 s), lets the host queue them all before
    the first starts, so a call that the host launches more slowly than the
    card runs it (the wrappers at N=8) is timed on the card, not at the
    host's pace."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not _SLEEP_CYCLES_PER_S:  # the sleep's clock, once
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_S.append(1e7 / (start.elapsed_time(end) / 1e3))
    fn()
    sync()
    t0 = time.perf_counter()
    fn()  # the host time of one call
    host = time.perf_counter() - t0
    sync()
    torch.cuda._sleep(int(_SLEEP_CYCLES_PER_S[0] * min(0.2, 1.5 * reps * host)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launches_of(counts: dict) -> dict:
    """A full LAUNCHES dict: `counts`, zero for every other kernel."""
    from convnets_tpu_torch.ops import kernels

    return {k: counts.get(k, 0) for k in kernels.LAUNCHES}


def check_routes(what, launches, failures):
    """Each launch of a window kernel (WINDOW_ROUTED) in a run took the
    vector route: the run's ROUTE_LAUNCHES against its LAUNCHES."""
    from convnets_tpu_torch.ops import kernels

    routes = {k: dict(kernels.ROUTE_LAUNCHES[k]) for k in WINDOW_ROUTED}
    off = [k for k, r in routes.items() if r["loop"] or r["vector"] != launches[k]]
    say(f"{what}: window kernel launches, vector / loop route: "
        + ", ".join(f"{k} {r['vector']} / {r['loop']}" for k, r in routes.items())
        + (" ok" if not off else " FAIL"))
    if off:
        failures.append(f"{what}: window kernels off the vector route: {routes}")


def model_layers(model):
    """(kind, H, W, Cin, Cout, k, stride, pad, relu, groups) of every conv
    and pool of the model, in forward order, from its own modules. kind:
    "conv" (a fused ConvBNReLU), "gconv" (a grouped one), "dwconv" (a
    depthwise conv), "plainconv" (a Conv2d outside a ConvBNReLU), "maxpool",
    "avgpool"."""
    from convnets_tpu_torch import nn

    out = []

    def conv(kind, c, shape, relu):
        if c.groups > 1:
            kind = "dwconv" if c.groups == shape[3] else "gconv"
        out.append((kind, shape[1], shape[2], shape[3], c.out_channels, c.kernel[0],
                    c.stride[0], c.padding[0], relu, c.groups))

    def walk(mod, shape):
        if isinstance(mod, nn.ConvBNReLU):
            conv("conv", mod._modules["0"], shape, mod.act)
        elif isinstance(mod, nn.Conv2d):
            conv("plainconv", mod, shape, False)
        elif isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            kind = "maxpool" if isinstance(mod, nn.MaxPool2d) else "avgpool"
            stride = mod.kernel if mod.stride is None else mod.stride
            out.append((kind, shape[1], shape[2], shape[3], shape[3], mod.kernel, stride,
                        mod.padding, False, 1))
        elif isinstance(mod, (nn.Add, nn.Concat)):
            for branch in mod._modules.values():
                walk(branch, shape)
        elif isinstance(mod, nn.Sequential):
            for child in mod._modules.values():
                walk(child, shape)
                shape = child.out_shape(shape)
        elif isinstance(mod, nn.Remat):
            walk(mod.child, shape)

    walk(model.module, model.batch_shape(1))
    return out


def distinct_shapes(model, kinds=("conv",)):
    """{(H, W, Cin, Cout, k, stride, pad, groups): [relu flag of each layer]}."""
    distinct = {}
    for _, h, w, cin, cout, k, s, p, relu, g in (l for l in model_layers(model)
                                                 if l[0] in kinds):
        distinct.setdefault((h, w, cin, cout, k, s, p, g), []).append(relu)
    return distinct


def conv_work(n, h, w, cin, cout, k, s, p, groups=1, itemsize=2):
    """(FLOPs, bytes) of one conv call: 2·M·(k²·Cin/G)·Cout multiply-adds,
    and x and w read once, y written once, in the dtype of `itemsize`."""
    from convnets_tpu_torch.core.shapes import conv_out_size

    oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
    flops = 2 * n * oh * ow * cout * k * k * (cin // groups)
    return flops, itemsize * (n * h * w * cin + k * k * (cin // groups) * cout + n * oh * ow * cout)


def forward_gflop(model) -> float:
    """Multiply-adds ×2 of the model's convs per image, counted from its
    modules (the pools, BN and the linear add < 0.1%, except ResNeXt's
    100,352 → 1000 classifier, which forward_linear_gflop counts)."""
    total = 0
    for kind, h, w, cin, cout, k, s, p, _, g in model_layers(model):
        if not kind.endswith("pool"):
            total += conv_work(1, h, w, cin, cout, k, s, p, g)[0]
    return total / 1e9


def forward_linear_gflop(model) -> float:
    """2·in·out of the model's classifier per image."""
    from convnets_tpu_torch import nn

    return sum(2 * m.weight.numel() for m in model.modules() if isinstance(m, nn.Linear)) / 1e9


def entry(summary, name):
    """A kernel's row of the JSON line: max error, the kernel's, plain
    version's and library call's ms, and its bound, each summed over the
    calls added to it."""
    return summary.setdefault(name, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                     "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0})


def add_times(row, uses, k_ms, p_ms, flops, nbytes, lib_ms=None, peak=PEAK_BF16):
    """Add `uses` calls of one shape to a row: measured ms, and the bound
    max(flops / peak, bytes / HBM) of each call."""
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / HBM_BPS
    row["ms"] += uses * k_ms
    row["plain_ms"] += uses * p_ms
    row["ops_ms"] += uses * ops_ms
    row["bytes_ms"] += uses * bytes_ms
    row["bound_ms"] += uses * max(ops_ms, bytes_ms)
    if lib_ms is not None:
        row["library_ms"] = (row["library_ms"] or 0.0) + uses * lib_ms


def nchw(t):
    """The NCHW view of an NHWC tensor (channels_last in memory), as cuDNN
    and F's pools take it."""
    return t.permute(0, 3, 1, 2)


def oihw(w):
    """An HWIO weight as a channels_last OIHW tensor."""
    import torch

    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def random_jax_variables(model, seed: int, conv_gain=None) -> dict:
    """numpy weights in the tree convnets_tpu's init produces for this model
    (HWIO conv w, (in, out) linear w, BN params/state), drawn from `seed`.
    conv_gain: conv std gain·sqrt(2 / fan_in) instead of He fan-out, for a
    net without BN, whose activations He init lets grow past bf16's range."""
    from convnets_tpu_torch import bridge

    rng = np.random.default_rng(seed)
    tree = {"params": {}, "state": {}}
    for path, (mod, tname) in sorted(bridge.jax_layout(model).items()):
        shape = tuple(getattr(mod, tname).shape)
        leaf = path[-1]
        if leaf == "w" and len(shape) == 4:
            kh, kw, i, o = shape
            fan = o * kh * kw if conv_gain is None else i * kh * kw
            v = rng.standard_normal(shape) * (conv_gain or 1.0) * np.sqrt(2.0 / fan)
        elif leaf == "w":
            v = rng.standard_normal(shape) * 0.01
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, shape)
        else:  # BN bias / mean, linear bias
            v = rng.standard_normal(shape) * 0.05
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = v.astype(np.float32)
    return tree


PLAIN = {"conv2d_fused": "conv2d_fused_plain", "conv2d_stats": "conv2d_stats_plain",
         "max_pool2d": "max_pool2d_plain", "avg_pool2d": "avg_pool2d_plain",
         "pool2d_backward": "pool2d_backward_plain",
         "depthwise_conv2d": "depthwise_conv2d_plain",
         "grouped_conv2d_fused": "grouped_conv2d_fused_plain",
         "grouped_conv2d_stats": "grouped_conv2d_stats_plain",
         "bottleneck_block": "bottleneck_block_plain"}


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel call of the model (and of the trainable functions,
    which call the wrappers through the kernels package) to the plain
    PyTorch versions, for the on-card comparison only; the package itself
    never does this."""
    from convnets_tpu_torch.ops import kernels

    saved = {name: getattr(kernels, name) for name in PLAIN}
    for name, plain in PLAIN.items():
        setattr(kernels, name, getattr(kernels, plain))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def within(got, ref, atol, rtol) -> bool:
    return bool(((got.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all())


def dname_of(dtype) -> str:
    return str(dtype).split(".")[-1]


def phase_kernels(model, failures):
    """Kernel vs plain at every distinct RN50@224 conv shape and the stem
    pool, batch 8. Returns the per-kernel summary for the JSON line."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    layers = model_layers(model)
    convs = [l for l in layers if l[0] == "conv"]
    pools = [l for l in layers if l[0] == "maxpool"]
    want = SERVE_LAUNCHES["resnet"]
    if len(convs) != want["conv2d_fused"] or len(pools) != want["max_pool2d"]:
        failures.append(f"RN50 walk found {len(convs)} convs, {len(pools)} pools")
    distinct = distinct_shapes(model)

    g = torch.Generator(device=DEVICE).manual_seed(0)
    n = KERNEL_BATCH
    summary = {}
    conv_row, pool_row = entry(summary, "conv2d_fused"), entry(summary, "max_pool2d")
    say("conv shapes (N=8): H W Cin Cout k s p | dtype relu | max_abs_err tol | "
        "kernel_ms plain_ms cudnn_bf16_ms | uses")
    for (h, w, cin, cout, k, s, p, _), relus in sorted(distinct.items()):
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x, wt = x32.to(dtype).contiguous(), w32.to(dtype).contiguous()
            dname = dname_of(dtype)
            atol, rtol = CONV_TOL[dname]
            # the same conv through cuDNN in bf16 (channels_last): the
            # library time, not a contract check
            xc, wc = nchw(x32.to(torch.bfloat16)), oihw(w32.to(torch.bfloat16))
            cudnn_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p), REPS)
            for relu in (False, True):
                args = (x, wt, scale, shift)
                kw = dict(stride=s, padding=p, relu=relu)
                got = kernels.conv2d_fused(*args, **kw)
                ref = kernels.conv2d_fused_plain(*args, **kw)
                sync()
                err = float((got.float() - ref.float()).abs().max())
                ok = within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
                k_ms = time_ms(lambda: kernels.conv2d_fused(*args, **kw), REPS)
                p_ms = time_ms(lambda: kernels.conv2d_fused_plain(*args, **kw), REPS)
                uses = relus.count(relu)
                say(f"  {h} {w} {cin} {cout} {k} {s} {p} | {dname} {int(relu)} | "
                    f"{err:.3e} {atol:g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'} | "
                    f"{k_ms:.4f} {p_ms:.4f} {cudnn_ms:.4f} | {uses}")
                if not ok:
                    failures.append(f"conv {h}x{w} {cin}->{cout} k{k} s{s} {dname} relu={relu}: "
                                    f"err {err:.3e}")
                conv_row["err"] = max(conv_row["err"], err)
                if dtype == torch.bfloat16:
                    flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p)
                    add_times(conv_row, uses, k_ms, p_ms, flops, nbytes + 8 * cout, cudnn_ms)

    _, h, w, c, _, k, s, p, _, _ = pools[0]
    x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
    say("stem max-pool (N=8): H W C k s p | dtype | max_abs_err | kernel_ms plain_ms "
        "F.max_pool2d_ms")
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        got = kernels.max_pool2d(x, k, s, p)
        ref = kernels.max_pool2d_plain(x, k, s, p)
        sync()
        err = float((got.float() - ref.float()).abs().max())
        ok = got.shape == ref.shape and err <= POOL_TOL
        k_ms = time_ms(lambda: kernels.max_pool2d(x, k, s, p), REPS)
        p_ms = time_ms(lambda: kernels.max_pool2d_plain(x, k, s, p), REPS)
        lib_ms = time_ms(lambda: F.max_pool2d(nchw(x), k, s, p), REPS)
        dname = dname_of(dtype)
        say(f"  {h} {w} {c} {k} {s} {p} | {dname} | {err:.3e} {'ok' if ok else 'FAIL'} | "
            f"{k_ms:.4f} {p_ms:.4f} {lib_ms:.4f}")
        if not ok:
            failures.append(f"max_pool2d {dname}: err {err:.3e}")
        pool_row["err"] = max(pool_row["err"], err)
        if dtype == torch.bfloat16:
            add_times(pool_row, 1, k_ms, p_ms, k * k * got.numel(),
                      2 * (x.numel() + got.numel()), lib_ms, PEAK_OTHER)
    say(f"RN50 conv layers at N=8 bf16, summed over the 53 layers: kernel "
        f"{conv_row['ms']:.3f} ms, plain {conv_row['plain_ms']:.3f} ms, cuDNN bf16 "
        f"{conv_row['library_ms']:.3f} ms, bound {conv_row['bound_ms']:.4f} ms")
    return summary


def model_setting(arch, seed, mixed, **kw):
    fields = dict(kind=FAMILIES[arch], input_size=(3, IMAGE, IMAGE), num_classes=1000,
                  batch_norm=True, init_params=True, dropout_rate=0.5, mixed_precision=mixed,
                  seed=seed, learning_rate=0.01, weight_decay=1e-4, optimizer="adam")
    fields.update(kw)
    return types.SimpleNamespace(**fields)


def make_model(arch, seed, mixed, conv_gain=None, **kw):
    """The family's model at 224² on the card, numpy weights from `seed`
    loaded by the bridge."""
    from convnets_tpu_torch import bridge
    from convnets_tpu_torch.models import build_model

    model = build_model(arch, model_setting(arch, seed, mixed, **kw), device=DEVICE)
    bridge.load_jax_variables(model, random_jax_variables(model, seed, conv_gain))
    return model


def rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


def l2_err(got, ref) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30))


def check_trainable(name, label, fn, args, dname, g, summary, failures, out_tol,
                    work=(0, 0), lib=None, peak=PEAK_BF16):
    """Forward and every gradient of fn(*args), the kernel path against the
    same function with the plain versions swapped in; fwd+bwd times, and
    those of `lib` (the same function as one PyTorch call, NHWC in and out)
    where there is one. work: (FLOPs, bytes) of one fwd+bwd in bf16."""
    import torch

    cot = None

    def run(f=fn):
        nonlocal cot
        ins = [a.detach().clone().requires_grad_() for a in args]
        out = f(*ins)
        if cot is None or cot.shape != out.shape:
            cot = torch.randn(out.shape, device=DEVICE, generator=g).to(out.dtype)
        return [out.detach(), *torch.autograd.grad(out, ins, cot)]

    got = run()
    with plain_kernels():
        ref = run()
    sync()
    out_err = rel_err(got[0], ref[0])
    grad_l2 = [l2_err(a, b) for a, b in zip(got[1:], ref[1:])]
    grad_max = [rel_err(a, b) for a, b in zip(got[1:], ref[1:])]
    flips = int(((got[0] > 0) != (ref[0] > 0)).sum())
    ok = (out_err <= out_tol and max(grad_l2) <= GRAD_TOL[dname]
          and all(bool(torch.isfinite(t).all()) for t in got))
    k_ms = time_ms(run, 3)
    with plain_kernels():
        p_ms = time_ms(run, 3)
    lib_ms = None if lib is None else time_ms(lambda: run(lib), 3)
    say(f"  {name} {label} | {dname} | {out_err:.2e} ({out_tol:g}) | "
        f"{' '.join(f'{e:.2e}' for e in grad_l2)} ({GRAD_TOL[dname]:g}) "
        f"[{' '.join(f'{e:.1e}' for e in grad_max)}] | {flips} {'ok' if ok else 'FAIL'} | "
        f"{k_ms:.4f} {p_ms:.4f} {'-' if lib_ms is None else f'{lib_ms:.4f}'}")
    if not ok:
        failures.append(f"{name} {label} {dname}: out {out_err:.2e}, gradients {grad_l2}")
    row = entry(summary, name)
    row["err"] = max(row["err"], max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got, ref)))
    if dname == "bfloat16":
        add_times(row, 1, k_ms, p_ms, *work, lib_ms, peak)


def conv_train_work(n, h, w, cin, cout, k, s, p, groups=1):
    """(FLOPs, bytes) of a bf16 conv's fwd+bwd: three products (y, dx, dw);
    x, w and the cotangent read, y, dx and dw written."""
    flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p, groups)
    return 3 * flops, 2 * nbytes


def conv_lib(s, p, groups=1):
    """F.conv2d (cuDNN on the card) on NHWC x and HWIO w, NHWC out."""
    import torch.nn.functional as F

    return lambda a, b: F.conv2d(nchw(a), b.permute(3, 2, 0, 1), stride=s, padding=p,
                                 groups=groups).permute(0, 2, 3, 1)


def pool_lib(mode, k, s, p):
    """F.max_pool2d / F.avg_pool2d on NHWC x, NHWC out."""
    import torch.nn.functional as F

    pool = F.max_pool2d if mode == "max" else F.avg_pool2d
    return lambda a: pool(nchw(a), k, s, p).permute(0, 2, 3, 1)


def conv_out_size(size, k, s, p):
    from convnets_tpu_torch.core.shapes import conv_out_size as out

    return out(size, k, s, p)


def stats_check(got, ref, dname, own=False):
    """(ok, y max|Δ|, Σ error, Σ² error) of conv2d_stats' (y, Σy, Σy²)
    against its plain version: y within CONV_TOL, |ΔΣ| / max Σ|y| and
    |ΔΣ²| / Σ² within STATS_TOL. own: the sums against those of the
    kernel's own stored y (the epilogue's contract), for shapes with so few
    rows per channel that y's one-ulp roundings alone move Σ² past the bar
    (at M = 49 one bf16 ulp of the largest of 49 values moves Σ² by up to
    2·2⁻⁸·max y² / Σy², ~2e-3); y is still held to the plain version."""
    import torch

    (y, s1, s2), (ry, r1, r2) = got, ref
    sync()
    atol, rtol = CONV_TOL[dname]
    err = float((y.float() - ry.float()).abs().max())
    y_ok = within(y, ry, atol, rtol)
    if own:
        ry, yf = y, y.float()
        r1, r2 = yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))
    e1 = float((s1 - r1).abs().max() / ry.float().abs().sum(dim=(0, 1, 2)).max().clamp_min(1e-30))
    e2 = float(((s2 - r2).abs() / r2.clamp_min(1e-30)).max())
    ok = y_ok and max(e1, e2) <= STATS_TOL[dname] and bool(torch.isfinite(s2).all())
    return ok, err, e1, e2


def phase_conv_plans(failures):
    """Phase 2a: every branch of conv_plan (PLAN_SHAPES) against the plain
    versions, fp32 and bf16, both epilogues: y without and with
    scale/shift/ReLU; y, Σy, Σy² (the sums against those of the kernel's
    own stored y, see stats_check)."""
    import torch

    from convnets_tpu_torch.ops import kernels

    g = torch.Generator(device=DEVICE).manual_seed(6)
    say("conv plans: N H W Cin Cout k s p | dtype plan | fused y err, relu=0 / 1 (tol) | "
        "stats y err, Σ rel, Σ² rel (tol) | what")
    for n, h, w, cin, cout, k, s, p, what in PLAN_SHAPES:
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        m = n * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            atol, rtol = CONV_TOL[dname]
            x, wt = x32.to(dtype), w32.to(dtype)
            plan = kernels.conv_plan(dtype, m, cin, cout)
            errs, ok = [], plan.route == ("wgmma" if dtype == torch.bfloat16 else "simt")
            for epi in (None, (scale, shift)):
                kw = dict(stride=s, padding=p, relu=epi is not None)
                got = kernels.conv2d_fused(x, wt, *(epi or ()), **kw)
                ref = kernels.conv2d_fused_plain(x, wt, *(epi or ()), **kw)
                sync()
                errs.append(float((got.float() - ref.float()).abs().max()))
                ok = ok and within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
                del got, ref
            kw = dict(stride=s, padding=p)
            s_ok, y_err, e1, e2 = stats_check(kernels.conv2d_stats(x, wt, **kw),
                                              kernels.conv2d_stats_plain(x, wt, **kw), dname,
                                              own=True)
            say(f"  {n} {h} {w} {cin} {cout} {k} {s} {p} | {dname} {plan.route} {plan.bm}x{plan.bn} "
                f"{plan.gather} | {errs[0]:.3e} / {errs[1]:.3e} ({atol:g}+{rtol:g}|ref|) "
                f"{'ok' if ok else 'FAIL'} | {y_err:.3e}, {e1:.2e}, {e2:.2e} "
                f"({STATS_TOL[dname]:g}) {'ok' if s_ok else 'FAIL'} | {what}")
            if not (ok and s_ok):
                failures.append(f"conv plan {what} {dname}: fused {errs}, stats y {y_err:.3e} "
                                f"Σ {e1:.2e} Σ² {e2:.2e}")
        del x32, w32


def phase_b256_conv(model, summary):
    """Phase 4b: rows 1 and 5 in bf16 at batch B256 at every distinct
    RN50@224 conv shape, and row 7's forward (conv2d_fused with no
    epilogue), beside cuDNN's bf16 F.conv2d on the same inputs
    (channels_last), each summed by layer use into the rows' ms_b256,
    library_ms_b256 and bound_ms_b256."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    g = torch.Generator(device=DEVICE).manual_seed(7)
    fused, stats = summary["conv2d_fused"], summary["conv2d_stats"]
    train = entry(summary, "conv2d_train")
    for row in (fused, stats, train):
        row.update(dict.fromkeys(B256_KEYS, 0.0))
    total = 0
    say(f"conv at batch {B256}, bf16: H W Cin Cout k s p | plan | conv2d_fused ms TFLOP/s | "
        f"conv2d_stats ms TFLOP/s | no epilogue (row 7's forward) ms | cuDNN ms TFLOP/s | "
        f"bound ms | uses")
    for (h, w, cin, cout, k, s, p, _), relus in sorted(distinct_shapes(model).items()):
        x = torch.randn(B256, h, w, cin, device=DEVICE, generator=g).to(torch.bfloat16)
        wt = (torch.randn(k, k, cin, cout, device=DEVICE, generator=g)
              / np.sqrt(k * k * cin)).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        xc, wc = nchw(x), oihw(wt)
        f_ms = time_ms(lambda: kernels.conv2d_fused(x, wt, scale, shift, stride=s, padding=p,
                                                    relu=True), REPS)
        s_ms = time_ms(lambda: kernels.conv2d_stats(x, wt, stride=s, padding=p), REPS)
        t_ms = time_ms(lambda: kernels.conv2d_fused(x, wt, stride=s, padding=p), REPS)
        c_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p), REPS)
        flops, nbytes = conv_work(B256, h, w, cin, cout, k, s, p)
        bound = 1e3 * max(flops / PEAK_BF16, (nbytes + 8 * cout) / HBM_BPS)
        uses = len(relus)
        total += uses * flops
        m = B256 * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
        plan = kernels.conv_plan(torch.bfloat16, m, cin, cout)
        say(f"  {h} {w} {cin} {cout} {k} {s} {p} | {plan.bm}x{plan.bn} {plan.gather} | "
            f"{f_ms:.4f} {flops / f_ms / 1e9:.1f} | {s_ms:.4f} {flops / s_ms / 1e9:.1f} | "
            f"{t_ms:.4f} | {c_ms:.4f} {flops / c_ms / 1e9:.1f} | {bound:.4f} | {uses}")
        for row, ms in ((fused, f_ms), (stats, s_ms), (train, t_ms)):
            row["ms_b256"] += uses * ms
            row["library_ms_b256"] += uses * c_ms
            row["bound_ms_b256"] += uses * bound
        del x, wt, xc, wc
    lib_ms = fused["library_ms_b256"]
    say(f"RN50 conv layers at b{B256} bf16, summed over the 53 layers ({total / 1e9:.1f} GFLOP): "
        f"conv2d_fused {fused['ms_b256']:.3f} ms ({total / fused['ms_b256'] / 1e9:.1f} TFLOP/s, "
        f"{fused['ms_b256'] / lib_ms:.3f}x cuDNN), conv2d_stats {stats['ms_b256']:.3f} ms "
        f"({total / stats['ms_b256'] / 1e9:.1f} TFLOP/s, {stats['ms_b256'] / lib_ms:.3f}x cuDNN), "
        f"no epilogue {train['ms_b256']:.3f} ms, cuDNN bf16 {lib_ms:.3f} ms ({total / lib_ms / 1e9:.1f} TFLOP/s), bound "
        f"{fused['bound_ms_b256']:.4f} ms")


def sass_check(failures):
    """Phase 1b: HGMMA instructions in the SASS of each tensor-core conv
    instantiation of the built library (each must have some; the grouped
    mode's, CG > 0, at Cin/G = 4, 8, 16 and 32 with both epilogues, listed
    apart), and no bf16 instantiation of the dense CUDA-core loop
    `conv_kernel`. The grouped CUDA-core loop keeps its bf16 instantiation:
    grouped_plan names the shapes it serves."""
    import re
    import shutil

    from convnets_tpu_torch.ops import kernels

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    r = subprocess.run([tool, "-sass", kernels.LIB_PATH], capture_output=True, text=True)
    if r.returncode != 0:
        failures.append(f"cuobjdump -sass failed ({r.returncode}): {r.stderr.strip()[:300]}")
        return
    counts, wide, fn = {}, {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = wide[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
        elif fn is not None and re.search(r"\b(LDG|LDGSTS)\.E\S*\.128\b", line):
            wide[fn] += 1
    wgmma = {f: c for f, c in counts.items() if "conv_wgmma_kernel" in f}
    # conv_wgmma_kernel<BN, STATS, VEC_A, CG> in the mangled name
    grouped = {}
    for f, c in wgmma.items():
        m = re.search(r"conv_wgmma_kernelILi(\d+)ELb([01])ELb([01])ELi(\d+)E", f)
        if m and int(m.group(4)) > 0:
            grouped[(int(m.group(4)), "stats" if m.group(2) == "1" else "fused")] = c
    simt_bf16 = [f for f in counts if "11conv_kernelI" in f and "bfloat16" in f]
    say(f"SASS: HGMMA instructions per conv_wgmma_kernel instantiation "
        f"{sorted(wgmma.values())} (total {sum(wgmma.values())}, {len(wgmma)} instantiations); "
        f"grouped mode (Cin/G, epilogue): {dict(sorted(grouped.items()))}; "
        f"bf16 instantiations of the dense CUDA-core conv_kernel: {len(simt_bf16)}")
    if not wgmma or min(wgmma.values()) == 0:
        failures.append(f"HGMMA count per conv_wgmma_kernel instantiation: {wgmma}")
    want = {(cg, e) for cg in (4, 8, 16, 32) for e in ("fused", "stats")}
    if set(grouped) != want or min(grouped.values(), default=0) == 0:
        failures.append(f"grouped wgmma instantiations and their HGMMA counts: {grouped}")
    if simt_bf16:
        failures.append(f"bf16 CUDA-core conv loop in the library: {simt_bf16}")
    # the block's tensor-core route, block_wgmma_kernel<Cmid, MB1>: one per
    # Cmid of kernels.block.WGMMA_CMID
    block = {}
    for f, c in counts.items():
        m = re.search(r"block_wgmma_kernelILi(\d+)ELi(\d+)E", f)
        if m:
            block[int(m.group(1))] = c
    say(f"SASS: HGMMA instructions per block_wgmma_kernel instantiation (Cmid: count): "
        f"{dict(sorted(block.items()))}")
    if set(block) != set(kernels.block.WGMMA_CMID) or min(block.values(), default=0) == 0:
        failures.append(f"block_wgmma_kernel instantiations and their HGMMA counts: {block}")
    # the window kernels' vector instantiations (8 channels per thread):
    # depthwise_vec_kernel<T, K, S, R>, pool_vec_kernel<T, AVG, TAPS, 8, R>,
    # pool_bwd_kernel<T, AVG, 8>; each must move its data in 128-bit global
    # loads or 128-bit asynchronous copies (LDGSTS)
    vector = {f: wide[f] for f in wide
              if "depthwise_vec_kernel" in f or re.search(r"pool_vec_kernelI\w+?Lb[01]ELb[01]ELi8E", f)
              or re.search(r"pool_bwd_kernelI\w+?Lb[01]ELi8E", f)}
    kinds = {k: sorted(c for f, c in vector.items() if k in f)
             for k in ("depthwise_vec_kernel", "pool_vec_kernel", "pool_bwd_kernel")}
    say(f"SASS: 128-bit LDG / LDGSTS per vector instantiation of the window kernels: {kinds}")
    if [len(v) for v in kinds.values()] != [4, 12, 4] or min(vector.values(), default=0) == 0:
        failures.append(f"window kernels' vector instantiations without 128-bit loads: {kinds}")


def phase_train_kernels(model, failures):
    """conv2d_stats at every distinct RN50@224 conv shape; conv_bn_relu_train,
    conv2d_train and pool2d_train forward + gradients, kernel vs plain."""
    import torch

    from convnets_tpu_torch.ops import kernels

    import torch.nn.functional as F

    lib = kernels.lib()
    g = torch.Generator(device=DEVICE).manual_seed(1)
    n = KERNEL_BATCH
    summary = {}
    stats_row, reduce_row = entry(summary, "conv2d_stats"), entry(summary, "conv2d_stats_reduce")
    say("conv2d_stats (N=8): H W Cin Cout k s p | dtype | y_err tol, Σ rel, Σ² rel (tol) | "
        "kernel_ms plain_ms cudnn_bf16_ms | reduce: blocks err kernel_ms plain_ms | uses")
    for (h, w, cin, cout, k, s, p, _), relus in sorted(distinct_shapes(model).items()):
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        xc, wc = nchw(x32.to(torch.bfloat16)), oihw(w32.to(torch.bfloat16))
        cudnn_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p), REPS)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype).contiguous(), w32.to(dtype).contiguous()
            kw = dict(stride=s, padding=p)
            ok, err, e1, e2 = stats_check(kernels.conv2d_stats(x, wt, **kw),
                                          kernels.conv2d_stats_plain(x, wt, **kw), dname)
            atol, rtol = CONV_TOL[dname]
            k_ms = time_ms(lambda: kernels.conv2d_stats(x, wt, **kw), REPS)
            p_ms = time_ms(lambda: kernels.conv2d_stats_plain(x, wt, **kw), REPS)
            # the reduction alone, on partial sums of this shape's block count
            m = n * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
            blocks = kernels.conv_plan(dtype, m, cin, cout).partial_rows(m)
            part = torch.randn(blocks, 2, cout, device=DEVICE, generator=g)
            out = torch.empty(2, cout, device=DEVICE)

            def reduce():
                kernels.check_launch("stats_reduce", lib.stats_reduce_launch(
                    part.data_ptr(), out.data_ptr(), blocks, cout, kernels.stream_ptr(part)))

            reduce()
            sync()
            r_err = float((out - part.sum(0)).abs().max())
            r_ok = r_err <= 1e-4 * float(part.abs().sum(0).max())
            r_ms = time_ms(reduce, REPS)
            rp_ms = time_ms(lambda: part.sum(0), REPS)
            say(f"  {h} {w} {cin} {cout} {k} {s} {p} | {dname} | {err:.3e} {atol:g}+{rtol:g}|ref|, "
                f"{e1:.2e}, {e2:.2e} ({STATS_TOL[dname]:g}) {'ok' if ok and r_ok else 'FAIL'} | "
                f"{k_ms:.4f} {p_ms:.4f} {cudnn_ms:.4f} | {blocks} {r_err:.2e} {r_ms:.4f} "
                f"{rp_ms:.4f} | {len(relus)}")
            if not (ok and r_ok):
                failures.append(f"conv2d_stats {h}x{w} {cin}->{cout} k{k} s{s} {dname}: y {err:.3e}"
                                f" Σ {e1:.2e} Σ² {e2:.2e} reduce {r_err:.2e}")
            stats_row["err"] = max(stats_row["err"], err)
            reduce_row["err"] = max(reduce_row["err"], r_err)
            if dtype == torch.bfloat16:
                flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p)
                add_times(stats_row, len(relus), k_ms, p_ms, flops, nbytes + 8 * cout, cudnn_ms)
                # the partials read once, the sums written once; part.sum(0)
                # is both the plain version and the library call
                add_times(reduce_row, len(relus), r_ms, rp_ms, part.numel(),
                          4 * (part.numel() + out.numel()), rp_ms, PEAK_OTHER)
    say(f"RN50 conv2d_stats at N=8 bf16, summed over the 53 layers: kernel "
        f"{stats_row['ms']:.3f} ms (reduction alone {reduce_row['ms']:.3f}), plain "
        f"{stats_row['plain_ms']:.3f} ms, cuDNN bf16 conv {stats_row['library_ms']:.3f} ms, "
        f"bound {stats_row['bound_ms']:.4f} ms")

    # the trainable functions: forward and every gradient, the kernel path
    # against the same function with the plain versions swapped in
    shapes = [(IMAGE, IMAGE, 3, 64, 7, 2, 3), (IMAGE // 4, IMAGE // 4, 128, 128, 3, 2, 1)]
    say("trainable functions (N=8): fn H Cin Cout k s | dtype | out max|Δ|/max|ref| (tol) | "
        "gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | ReLU mask flips | fwd+bwd kernel_ms "
        "plain_ms library_ms")
    for h, w, cin, cout, k, s, p in shapes:
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        sc32 = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        bi32 = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype), w32.to(dtype)
            label = f"{h} {cin} {cout} {k} {s}"
            work = conv_train_work(n, h, w, cin, cout, k, s, p)
            check_trainable("conv_bn_relu_train", label, lambda a, b, c, d: kernels.conv_bn_relu_train(
                a, b, c, d, s, p)[0], [x, wt, sc32, bi32], dname, g, summary, failures,
                CONV_TOL[dname][1], work)
            check_trainable("conv2d_train", label, lambda a, b: kernels.conv2d_train(a, b, s, p),
                            [x, wt], dname, g, summary, failures, CONV_TOL[dname][1], work,
                            conv_lib(s, p))

    # the stem pool's dx: the same VJP on the same forward, so exactly equal
    _, h, w, c, _, k, s, p, _, _ = [l for l in model_layers(model) if l[0] == "maxpool"][0]
    pool_row = entry(summary, "pool2d_train")
    x32 = torch.relu(torch.randn(n, h, w, c, device=DEVICE, generator=g))  # tied zeros
    for dtype in (torch.float32, torch.bfloat16):
        dname = dname_of(dtype)

        def run():
            xi = x32.to(dtype).requires_grad_()
            out = kernels.pool2d_train(xi, "max", k, s, p)
            return [out.detach(), *torch.autograd.grad(out, xi, torch.ones_like(out))]

        def run_lib():
            xi = x32.to(dtype).requires_grad_()
            out = pool_lib("max", k, s, p)(xi)
            return [out.detach(), *torch.autograd.grad(out, xi, torch.ones_like(out))]

        got = run()
        with plain_kernels():
            ref = run()
        sync()
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
        k_ms = time_ms(run, REPS)
        with plain_kernels():
            p_ms = time_ms(run, REPS)
        lib_ms = time_ms(run_lib, REPS)
        say(f"  pool2d_train {h} {c} {k} {s} | {dname} | out and dx max|Δ| {err:.3e} "
            f"(exact) {'ok' if err <= POOL_TOL else 'FAIL'} | {k_ms:.4f} {p_ms:.4f} {lib_ms:.4f}")
        if err > POOL_TOL:
            failures.append(f"pool2d_train {dname}: err {err:.3e}")
        pool_row["err"] = max(pool_row["err"], err)
        if dtype == torch.bfloat16:
            # x and the cotangent read, y and dx written; k² compares each way
            add_times(pool_row, 1, k_ms, p_ms, 2 * k * k * got[0].numel(),
                      4 * (x32.numel() + got[0].numel()), lib_ms, PEAK_OTHER)
    return summary


def avg_pool_ok(got, ref, dname):
    """(ok, error as bounded): fp32 max|Δ| / max|ref|; bf16 max |Δ| / ulp(ref)."""
    d = (got.float() - ref.float()).abs()
    if dname == "float32":
        err = float(d.max() / ref.float().abs().max().clamp_min(1e-30))
        return err <= AVG_POOL_TOL, err
    err = float((d / bf16_ulp(ref)).max())
    return err <= 1.0, err


def bf16_ulp(ref):
    """The bf16 ulp of each element of ref: 2^(floor(log2|ref|) - 7)."""
    import torch

    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def phase_zoo_kernels(failures):
    """This slice's kernels vs plain at batch 8: depthwise_conv2d at every
    distinct MobileNet-v1@224 depthwise shape, avg_pool2d at DenseNet-121's
    transitions, and the trainable depthwise conv and avg pool."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels

    mobilenet = build_model("mobilenet_v1", model_setting("mobilenet_v1", 0, True), device=DEVICE)
    densenet = build_model("densenet", model_setting("densenet", 0, True), device=DEVICE)
    dw = distinct_shapes(mobilenet, ("dwconv",))
    pools = distinct_shapes(densenet, ("avgpool",))
    n_dw = sum(len(v) for v in dw.values())
    n_avg = sum(len(v) for v in pools.values())
    if (len(dw), n_dw, len(pools), n_avg) != (9, SERVE_LAUNCHES["mobilenet_v1"]["depthwise_conv2d"],
                                              3, SERVE_LAUNCHES["densenet"]["avg_pool2d"]):
        failures.append(f"zoo walk found {len(dw)} depthwise shapes ({n_dw} layers), "
                        f"{len(pools)} avg pools ({n_avg} layers)")
    g = torch.Generator(device=DEVICE).manual_seed(2)
    n = KERNEL_BATCH
    summary = {}
    dw_row, avg_row = entry(summary, "depthwise_conv2d"), entry(summary, "avg_pool2d")
    say("depthwise_conv2d (N=8): H W C k s p | dtype | max_abs_err tol | kernel_ms plain_ms "
        "cudnn_bf16_ms | uses")
    for (h, w, c, _, k, s, p, _), uses in sorted(dw.items()):
        x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, 1, c, device=DEVICE, generator=g) / k
        xc, wc = nchw(x32.to(torch.bfloat16)), oihw(w32.to(torch.bfloat16))
        cudnn_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, groups=c), REPS)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype), w32.to(dtype)
            kw = dict(stride=s, padding=p)
            got = kernels.depthwise_conv2d(x, wt, **kw)
            ref = kernels.depthwise_conv2d_plain(x, wt, **kw)
            sync()
            atol, rtol = CONV_TOL[dname]
            err = float((got.float() - ref.float()).abs().max())
            ok = within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
            k_ms = time_ms(lambda: kernels.depthwise_conv2d(x, wt, **kw), REPS)
            p_ms = time_ms(lambda: kernels.depthwise_conv2d_plain(x, wt, **kw), REPS)
            say(f"  {h} {w} {c} {k} {s} {p} | {dname} | {err:.3e} {atol:g}+{rtol:g}|ref| "
                f"{'ok' if ok else 'FAIL'} | {k_ms:.4f} {p_ms:.4f} {cudnn_ms:.4f} | {len(uses)}")
            if not ok:
                failures.append(f"depthwise_conv2d {h}x{w} C{c} s{s} {dname}: err {err:.3e}")
            dw_row["err"] = max(dw_row["err"], err)
            if dtype == torch.bfloat16:
                add_times(dw_row, len(uses), k_ms, p_ms,
                          *conv_work(n, h, w, c, c, k, s, p, groups=c), cudnn_ms)

    say(f"avg_pool2d (N=8): H W C k s p | dtype | error (fp32: max|Δ|/max|ref| ≤ {AVG_POOL_TOL:g}; "
        f"bf16: max |Δ|/ulp ≤ 1) | kernel_ms plain_ms F.avg_pool2d_ms | uses")
    for (h, w, c, _, k, s, p, _), uses in sorted(pools.items()):
        x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x = x32.to(dtype)
            got = kernels.avg_pool2d(x, k, s, p)
            ref = kernels.avg_pool2d_plain(x, k, s, p)
            sync()
            ok, err = avg_pool_ok(got, ref, dname)
            ok = ok and got.shape == ref.shape
            k_ms = time_ms(lambda: kernels.avg_pool2d(x, k, s, p), REPS)
            p_ms = time_ms(lambda: kernels.avg_pool2d_plain(x, k, s, p), REPS)
            lib_ms = time_ms(lambda: F.avg_pool2d(nchw(x), k, s, p), REPS)
            say(f"  {h} {w} {c} {k} {s} {p} | {dname} | {err:.3e} {'ok' if ok else 'FAIL'} | "
                f"{k_ms:.4f} {p_ms:.4f} {lib_ms:.4f} | {len(uses)}")
            if not ok:
                failures.append(f"avg_pool2d {h}x{w} C{c} {dname}: err {err:.3e}")
            avg_row["err"] = max(avg_row["err"], float((got.float() - ref.float()).abs().max()))
            if dtype == torch.bfloat16:
                add_times(avg_row, len(uses), k_ms, p_ms, k * k * got.numel(),
                          2 * (x.numel() + got.numel()), lib_ms, PEAK_OTHER)
    say(f"MobileNet-v1 depthwise layers at N=8 bf16, summed over the 13 layers: kernel "
        f"{dw_row['ms']:.4f} ms, plain {dw_row['plain_ms']:.4f} ms, cuDNN bf16 "
        f"{dw_row['library_ms']:.4f} ms, bound {dw_row['bound_ms']:.4f} ms; DenseNet-121 avg "
        f"pools, summed over the 3: kernel {avg_row['ms']:.4f} ms, plain "
        f"{avg_row['plain_ms']:.4f} ms, F.avg_pool2d {avg_row['library_ms']:.4f} ms")

    say("trainable functions (N=8): fn H C s | dtype | out max|Δ|/max|ref| (tol) | "
        "gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | sign flips | fwd+bwd kernel_ms plain_ms "
        "library_ms")
    for h, c, s in ((IMAGE // 4, 128, 1), (IMAGE // 4, 128, 2)):
        x32 = torch.randn(n, h, h, c, device=DEVICE, generator=g)
        w32 = torch.randn(3, 3, 1, c, device=DEVICE, generator=g) / 3
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            check_trainable("depthwise_train", f"{h} {c} {s}",
                            lambda a, b: kernels.depthwise_train(a, b, s, 1),
                            [x32.to(dtype), w32.to(dtype)], dname, g, summary, failures,
                            CONV_TOL[dname][1], conv_train_work(n, h, h, c, c, 3, s, 1, c),
                            conv_lib(s, 1, c))
    (h, w, c, _, k, s, p, _), _ = sorted(pools.items())[-1]  # the first transition, 56²
    x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
    out_numel = n * (h // s) * (w // s) * c
    for dtype in (torch.float32, torch.bfloat16):
        dname = dname_of(dtype)
        check_trainable("pool2d_train_avg", f"{h} {c} {k} {s}",
                        lambda a: kernels.pool2d_train(a, "avg", k, s, p), [x32.to(dtype)],
                        dname, g, summary, failures,
                        AVG_POOL_TOL if dname == "float32" else 2.0 ** -7,
                        (2 * k * k * out_numel, 4 * (x32.numel() + out_numel)),
                        pool_lib("avg", k, s, p), PEAK_OTHER)
    return summary


def pool_backward_lib(mode, x, k, s, p):
    """ATen's pool backward as one call on NCHW views of NHWC tensors: the
    same dx from g and, for max, F.max_pool2d's own indices."""
    import torch
    import torch.nn.functional as F

    xc = nchw(x)
    if mode == "max":
        idx = F.max_pool2d(xc, k, s, p, return_indices=True)[1]
        return lambda g: torch.ops.aten.max_pool2d_with_indices_backward(
            nchw(g), xc, [k, k], [s, s], [p, p], [1, 1], False, idx)
    return lambda g: torch.ops.aten.avg_pool2d_backward(nchw(g), xc, [k, k], [s, s], [p, p],
                                                        False, True, None)


def phase_window_routes(summary, failures):
    """Phase 6, the window kernels' two routes at batch 8, fp32 and bf16:
    the vector route against the loop, bit for bit (torch.equal), at the 9
    MobileNet-v1 depthwise shapes and at every pool shape of the four
    families (y, the max pool's taps, and pool2d_backward's dx); the taps
    and dx against their plain versions (taps and max dx exact, avg dx
    fp32 1e-6 relative, bf16 one ulp); pool2d_backward alone beside its
    plain version and ATen's backward (the pool2d_backward row)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import pool as kpool

    g = torch.Generator(device=DEVICE).manual_seed(11)
    n = KERNEL_BATCH
    row = entry(summary, "pool2d_backward")
    say("window kernels' routes (N=8): kernel H W C k s p | dtype | plan | vector == loop | "
        "vs plain: taps, dx error (ok) | pool2d_backward kernel_ms plain_ms ATen_ms | uses")
    for kind, shapes in window_layers().items():
        for (h, w, c, _, k, s, p, _), uses in sorted(shapes.items()):
            x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
            for dtype in (torch.float32, torch.bfloat16):
                dname, x = dname_of(dtype), x32.to(dtype)
                vs_plain, times = "-", ""
                if kind == "dwconv":
                    name = "depthwise_conv2d"
                    wt = (torch.randn(k, k, 1, c, device=DEVICE, generator=g) / k).to(dtype)
                    plan = kernels.depthwise_plan(n, h, w, c, k, k, s, p, dtype)
                    same = torch.equal(
                        kernels.depthwise_conv2d(x, wt, stride=s, padding=p, route="vector"),
                        kernels.depthwise_conv2d(x, wt, stride=s, padding=p, route="loop"))
                    ok = same
                else:
                    mode = kind[:3]
                    name = f"{mode}_pool2d"
                    plan = kernels.pool_plan(n, h, w, c, k, k, s, p, dtype)
                    taps = mode == "max"
                    ya, ta = kpool._forward(mode, x, k, s, p, taps, route="vector")
                    yb, tb = kpool._forward(mode, x, k, s, p, taps, route="loop")
                    cot = torch.randn(ya.shape, device=DEVICE, generator=g).to(dtype)
                    bwd = (mode, cot, ta, (h, w), dtype, k, s, p)
                    da = kernels.pool2d_backward(*bwd, route="vector")
                    db = kernels.pool2d_backward(*bwd, route="loop")
                    same = (torch.equal(ya, yb) and torch.equal(da, db)
                            and (ta is None or torch.equal(ta, tb)))
                    ref = kernels.pool2d_backward_plain(*bwd)
                    sync()
                    taps_ok = ta is None or torch.equal(
                        ta, kernels.max_pool2d_plain(x, k, s, p, taps=True)[1])
                    if mode == "max":
                        err = float((da.float() - ref.float()).abs().max())
                        dx_ok = err == 0.0
                    else:
                        dx_ok, err = avg_pool_ok(da, ref, dname)
                    ok = same and taps_ok and dx_ok
                    vs_plain = f"{'-' if ta is None else taps_ok}, {err:.3e} ({dx_ok})"
                    row["err"] = max(row["err"], float((da.float() - ref.float()).abs().max()))
                    if dtype == torch.bfloat16:
                        k_ms = time_ms(lambda: kernels.pool2d_backward(*bwd), REPS)
                        p_ms = time_ms(lambda: kernels.pool2d_backward_plain(*bwd), REPS)
                        lib = pool_backward_lib(mode, x, k, s, p)
                        lib_ms = time_ms(lambda: lib(cot), REPS)
                        # g (and the taps) read, dx written; a compare-add per
                        # covering window of each input element
                        nbytes = 2 * (cot.numel() + x.numel()) + (cot.numel() if taps else 0)
                        add_times(row, len(uses), k_ms, p_ms, (-(-k // s)) ** 2 * x.numel(), nbytes,
                                  lib_ms, PEAK_OTHER)
                        times = f"{k_ms:.4f} {p_ms:.4f} {lib_ms:.4f}"
                say(f"  {name} {h} {w} {c} {k} {s} {p} | {dname} | {plan.route} {plan.cb}x"
                    f"{plan.th}x{plan.tw}/{plan.ry}x{plan.r} | {same} | {vs_plain} | {times} | {len(uses)}")
                if not ok or plan.route != "vector":
                    failures.append(f"{name} {h}x{w} C{c} k{k} s{s} {dname}: route {plan.route}, "
                                    f"vector == loop {same}, vs plain {vs_plain}")


def window_layers():
    """{kind: {(H, W, Cin, Cout, k, stride, pad, groups): [relu flags]}} of
    the window kernels' layers: MobileNet-v1@224's depthwise convs (9
    shapes, 13 layers), the stem max pool that RN50, DN121 and ResNeXt-50
    share (RN50's modules) and DN121@224's avg pools (3 shapes)."""
    from convnets_tpu_torch.models import build_model

    out = {}
    for arch, kind in (("mobilenet_v1", "dwconv"), ("resnet", "maxpool"), ("densenet", "avgpool")):
        model = build_model(arch, model_setting(arch, 0, True), device=DEVICE)
        out[kind] = distinct_shapes(model, (kind,))
        del model
    return out


def pool_train_ms(mode, x, k, s, p, g):
    """Device ms of pool2d_train's forward + backward on x with cotangent g:
    the kernel path, the plain path (plain_kernels) and F's pool with its
    own backward, NHWC in and out."""
    import torch

    from convnets_tpu_torch.ops import kernels

    def run(fn):
        xi = x.detach().requires_grad_()
        out = fn(xi)
        return torch.autograd.grad(out, xi, g)

    ours = lambda a: kernels.pool2d_train(a, mode, k, s, p)  # noqa: E731
    k_ms = time_ms(lambda: run(ours), REPS)
    with plain_kernels():
        p_ms = time_ms(lambda: run(ours), REPS)
    lib_ms = time_ms(lambda: run(pool_lib(mode, k, s, p)), REPS)
    return k_ms, p_ms, lib_ms


def phase_b256_windows(summary):
    """Phase 6b: rows 2, 3, 4 and 9 in bf16 at batch B256: depthwise_conv2d
    at MobileNet-v1's 9 depthwise shapes (13 layers), max_pool2d at the stem,
    avg_pool2d at DN121's 3 transitions, and pool2d_train forward +
    backward at the stem (max) and the first transition (avg), each beside
    its plain version, the one F call (cuDNN / ATen) and its bound, and the
    forward kernels beside their loop route on the same inputs, summed by
    layer use into the rows' ms_b256, plain_ms_b256, loop_ms_b256,
    library_ms_b256 and bound_ms_b256."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import pool as kpool

    g = torch.Generator(device=DEVICE).manual_seed(10)
    layers = window_layers()
    rows = {name: entry(summary, name) for name in
            ("depthwise_conv2d", "max_pool2d", "avg_pool2d", "pool2d_train", "pool2d_train_avg")}
    for name, row in rows.items():
        row.update(dict.fromkeys(B256_KEYS + (PLAIN_B256,), 0.0))
        if not name.startswith("pool2d_train"):
            row[LOOP_B256] = 0.0

    def add(row, uses, k_ms, p_ms, lib_ms, nbytes, ops, loop_ms=None):
        bound = 1e3 * max(ops / PEAK_OTHER, nbytes / HBM_BPS)
        row["ms_b256"] += uses * k_ms
        row[PLAIN_B256] += uses * p_ms
        row["library_ms_b256"] += uses * lib_ms
        row["bound_ms_b256"] += uses * bound
        if loop_ms is not None:
            row[LOOP_B256] += uses * loop_ms
        return bound

    say(f"window kernels at batch {B256}, bf16: kernel H W C k s p | plan | kernel ms GB/s | "
        f"loop route ms | plain ms | F ms | bound ms, share | uses")
    for kind, shapes in layers.items():
        for (h, w, c, _, k, s, p, _), uses in sorted(shapes.items()):
            x = torch.randn(B256, h, w, c, device=DEVICE, generator=g).to(torch.bfloat16)
            oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
            out_numel = B256 * oh * ow * c
            if kind == "dwconv":
                name = "depthwise_conv2d"
                plan = kernels.depthwise_plan(B256, h, w, c, k, k, s, p, torch.bfloat16)
                wt = (torch.randn(k, k, 1, c, device=DEVICE, generator=g) / k).to(torch.bfloat16)
                xc, wc = nchw(x), oihw(wt)
                kw = dict(stride=s, padding=p)
                k_ms = time_ms(lambda: kernels.depthwise_conv2d(x, wt, **kw), REPS)
                l_ms = time_ms(lambda: kernels.depthwise_conv2d(x, wt, **kw, route="loop"), REPS)
                p_ms = time_ms(lambda: kernels.depthwise_conv2d_plain(x, wt, **kw), REPS)
                lib_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, groups=c), REPS)
                flops, nbytes = conv_work(B256, h, w, c, c, k, s, p, groups=c)
            else:
                name, mode = ("max_pool2d", "max") if kind == "maxpool" else ("avg_pool2d", "avg")
                plan = kernels.pool_plan(B256, h, w, c, k, k, s, p, torch.bfloat16)
                fn, plain = getattr(kernels, name), getattr(kernels, PLAIN[name])
                k_ms = time_ms(lambda: fn(x, k, s, p), REPS)
                l_ms = time_ms(lambda: kpool._forward(mode, x, k, s, p, route="loop"), REPS)
                p_ms = time_ms(lambda: plain(x, k, s, p), REPS)
                lib_ms = time_ms(lambda: pool_lib(mode, k, s, p)(x), REPS)
                flops, nbytes = k * k * out_numel, 2 * (x.numel() + out_numel)
            bound = add(rows[name], len(uses), k_ms, p_ms, lib_ms, nbytes, flops, l_ms)
            say(f"  {name} {h} {w} {c} {k} {s} {p} | {plan.route} {plan.cb}x{plan.th}x{plan.tw}/"
                f"{plan.ry}x{plan.r} | {k_ms:.4f} {nbytes / k_ms / 1e6:.1f} | {l_ms:.4f} | {p_ms:.4f} | "
                f"{lib_ms:.4f} | {bound:.4f}, {100 * bound / k_ms:.1f}% | {len(uses)}")
            if kind != "dwconv" and h == max(shape[0] for shape in shapes):
                # pool2d_train at the stem and at the first transition:
                # x and the cotangent read, y and dx written
                name = "pool2d_train" if mode == "max" else "pool2d_train_avg"
                cot = torch.randn(B256, oh, ow, c, device=DEVICE, generator=g).to(torch.bfloat16)
                k_ms, p_ms, lib_ms = pool_train_ms(mode, x, k, s, p, cot)
                bound = add(rows[name], 1, k_ms, p_ms, lib_ms, 4 * (x.numel() + out_numel),
                            2 * k * k * out_numel)
                say(f"  {name} (fwd+bwd) {h} {w} {c} {k} {s} {p} | | {k_ms:.4f} | | {p_ms:.4f} | "
                    f"{lib_ms:.4f} | {bound:.4f}, {100 * bound / k_ms:.1f}% | 1")
                del cot
            del x
    for name, row in rows.items():
        loop = f", loop route {row[LOOP_B256]:.4f} ms" if LOOP_B256 in row else ""
        say(f"{name} at b{B256} bf16, summed over its layers: kernel {row['ms_b256']:.4f} ms"
            f"{loop}, plain {row[PLAIN_B256]:.4f} ms, F {row['library_ms_b256']:.4f} ms "
            f"({row['ms_b256'] / row['library_ms_b256']:.3f}x), bound {row['bound_ms_b256']:.4f} ms "
            f"({100 * row['bound_ms_b256'] / row['ms_b256']:.1f}% of it)")


def train_state(model, **kw):
    from convnets_tpu_torch.train import build_train_step, create_train_state

    state = create_train_state(model)
    return state, build_train_step(state, **kw)


def relu_outputs(model):
    """The modules whose outputs are ReLU outputs: fused ConvBNReLUs with
    ReLU, Adds with post-ReLU, and ReLU layers outside a ConvBNReLU."""
    from convnets_tpu_torch import nn

    inner = {id(m._modules["2"]) for m in model.modules()
             if isinstance(m, nn.ConvBNReLU) and m.act}
    return [m for m in model.modules()
            if (isinstance(m, nn.ConvBNReLU) and m.act) or getattr(m, "post_relu", False)
            or (isinstance(m, nn.ReLU) and id(m) not in inner)]


def step_check(arch, seed, failures):
    """(i) one fp32 SGD step at batch 8 with dropout 0: kernel path vs plain
    path, and the plain path against itself with perturbed conv weights."""
    import torch

    from convnets_tpu_torch import bridge

    rng = np.random.default_rng(seed + 2)
    x = torch.from_numpy(rng.integers(0, 256, (STEP_BATCH, IMAGE, IMAGE, 3),
                                      dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, 1000, STEP_BATCH)).to(DEVICE)
    # SGD with no momentum or decay at lr 2^20: the update lr·g is exact and
    # dwarfs p, so (p_before - p_after) / lr reads the step's gradients back
    # to fp32 rounding
    lr = 2.0 ** 20
    results, masks = {}, {}
    for path in ("kernel", "plain", "control"):
        model = make_model(arch, seed, False, dropout_rate=0.0, optimizer="sgd",
                           learning_rate=lr, momentum=0.0, weight_decay=0.0)
        if path == "control":
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            with torch.no_grad():
                for p in model.parameters():
                    if p.ndim == 4:
                        p.mul_(1 + CONTROL_PERTURBATION * torch.randn(
                            p.shape, device=DEVICE, generator=gen))
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        masks[path] = []
        for mod in relu_outputs(model):
            mod.register_forward_hook(lambda m, i, o, out=masks[path]: out.append(o > 0))
        state, step = train_state(model)
        with plain_kernels() if path != "kernel" else contextlib.nullcontext():
            loss, _ = step(state, x, y)
        sync()
        grads = {k: (before[k] - p.detach()) / lr for k, p in model.named_parameters()}
        results[path] = (float(loss), grads, bridge.export_jax_variables(model)["state"])
        del model, state
    flips = {k: sum(int((a != b).sum()) for a, b in zip(masks[k], masks["plain"]))
             for k in ("kernel", "control")}
    relu_elems = sum(m.numel() for m in masks["plain"])
    del masks
    (lk, gk, sk), (lp, gp, sp) = results["kernel"], results["plain"]
    gc = results["control"][1]
    c_l2 = sorted(l2_err(gc[k], gp[k]) for k in gp)
    loss_rel = abs(lk - lp) / abs(lp)
    g_l2 = {k: l2_err(gk[k], gp[k]) for k in gp}
    g_max = {k: rel_err(gk[k], gp[k]) for k in gp}
    worst_l2, worst_max = max(g_l2, key=g_l2.get), max(g_max, key=g_max.get)
    flat_k, flat_p = bridge._flatten(sk), bridge._flatten(sp)
    s_err = max(float(np.abs(flat_k[k] - flat_p[k]).max() / max(np.abs(flat_p[k]).max(), 1e-30))
                for k in flat_p)
    ok = (loss_rel <= 1e-4 and g_l2[worst_l2] <= STEP_GRAD_TOL and s_err <= 1e-4
          and np.isfinite(lk) and all(bool(torch.isfinite(t).all()) for t in gk.values()))
    say(f"(i) fp32 {arch} SGD step (batch {STEP_BATCH}), kernel vs plain path: loss {lk:.6f} vs "
        f"{lp:.6f} (rel {loss_rel:.2e}, tol 1e-4); ReLU mask flips {flips['kernel']} of "
        f"{relu_elems}; gradients over {len(gp)} leaves: worst "
        f"‖Δ‖/‖g‖ {g_l2[worst_l2]:.2e} at {worst_l2} (tol {STEP_GRAD_TOL:g}), worst "
        f"max|Δ|/max|g| {g_max[worst_max]:.2e} at {worst_max} (max|g| "
        f"{float(gp[worst_max].abs().max()):.3e}); median ‖Δ‖/‖g‖ "
        f"{float(np.median(list(g_l2.values()))):.2e}; BN running stats rel {s_err:.2e} "
        f"(tol 1e-4) {'ok' if ok else 'FAIL'}\n    control, plain vs plain with conv weights "
        f"×(1 + {CONTROL_PERTURBATION:g}·N(0,1)): loss {results['control'][0]:.6f}, "
        f"{flips['control']} flips, ‖Δ‖/‖g‖ median {c_l2[len(c_l2) // 2]:.2e} max {c_l2[-1]:.2e}")
    if not ok:
        failures.append(f"fp32 {arch} train step: loss {loss_rel:.2e}, grads "
                        f"{g_l2[worst_l2]:.2e}, BN {s_err:.2e}")


def learn_check(arch, seed, failures):
    """(ii) bf16 learning check: ten Adam steps on one batch of 32, both
    paths, with the normalization the serving check bakes in. Returns the
    kernel path's model with its batch and labels, its BN running
    statistics brought to that batch, to be served."""
    import torch

    rng = np.random.default_rng(seed + 3)
    x = torch.from_numpy(rng.integers(0, 256, (LEARN_BATCH, IMAGE, IMAGE, 3),
                                      dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, 1000, LEARN_BATCH)).to(DEVICE)
    losses = {}
    for path in ("plain", "kernel"):
        model = make_model(arch, seed, True, dropout_rate=0.0, learning_rate=LEARN_LR[arch])
        state, step = train_state(model, norm=True, stats=IMAGENET_STATS)
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            losses[path] = [float(step(state, x, y)[0]) for _ in range(LEARN_STEPS)]
    # steps at lr 0 leave the weights as they are and bring the BN running
    # statistics (momentum 0.1) to this batch's, so eval mode computes what
    # train mode learned
    state.lr = 0.0
    for _ in range(SETTLE_STEPS):
        step(state, x, y)
    del state
    falls = losses["kernel"][-1] < losses["kernel"][0] and all(np.isfinite(losses["kernel"]))
    say(f"(ii) bf16 {arch}, {LEARN_STEPS} Adam steps (lr {LEARN_LR[arch]:g}) on one batch of "
        f"{LEARN_BATCH}, "
        f"loss per step:\n  kernel {[round(v, 3) for v in losses['kernel']]}\n"
        f"  plain  {[round(v, 3) for v in losses['plain']]}\n"
        f"  kernel path's loss falls: {'ok' if falls else 'FAIL'}")
    if not falls:
        failures.append(f"bf16 {arch} loss did not fall: {losses['kernel']}")
    return model, x.cpu().numpy(), y.cpu().numpy()


def nobn_check(arch, seed, failures):
    """The batch_norm=False net, one bf16 Adam step: conv2d_train on every
    dense conv, grouped_conv2d_train on every grouped one (RN50: phase 5
    (iv); ResNeXt-50: phase 9 (v)). Its launches are those of the served
    forward and the stem pool's backward."""
    import torch

    from convnets_tpu_torch.ops import kernels

    model = make_model(arch, seed, True, conv_gain=0.5, batch_norm=False)
    state, step = train_state(model, debug=True)
    rng = np.random.default_rng(seed + 4)
    x = torch.from_numpy(rng.integers(0, 256, (NOBN_BATCH, IMAGE, IMAGE, 3),
                                      dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, 1000, NOBN_BATCH)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sync()
    kernels.reset_launches()
    loss, _, gnorm = step(state, x, y, generator=gen)
    sync()
    launches = dict(kernels.LAUNCHES)
    want = launches_of({**SERVE_LAUNCHES[arch],
                        "pool2d_backward": TRAIN_LAUNCHES[arch]["pool2d_backward"]})
    check_routes(f"{arch} batch_norm=False step", launches, failures)
    ok = launches == want and bool(torch.isfinite(gnorm)) and bool(torch.isfinite(loss))
    say(f"bf16 {arch} batch_norm=False, one Adam step at batch {NOBN_BATCH}: launches "
        f"{launches} (expected {want}); loss {float(loss):.4f}, gradient global norm "
        f"{float(gnorm):.4e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{arch} no-BN step: launches {launches}, loss {float(loss)}, "
                        f"|g| {float(gnorm)}")
    return launches


def train_throughput(arch, seed, failures):
    """bench.py's train step at TRAIN_BATCH[arch], bf16, kernel and plain
    paths in turns on one model; returns (launches of one kernel run, img/s)."""
    import torch

    from convnets_tpu_torch.ops import kernels

    batch = TRAIN_BATCH[arch]
    model = make_model(arch, seed, True)
    gflop_train = 3 * (forward_gflop(model) + forward_linear_gflop(model))
    state, step = train_state(model)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 256, (batch, IMAGE, IMAGE, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 1000, (batch,), device=DEVICE, generator=gen)

    def seconds_per_step():
        for _ in range(WARMUP):
            step(state, x, y, generator=gen)
        sync()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            loss, _ = step(state, x, y, generator=gen)
        sync()
        if not bool(torch.isfinite(loss)):
            failures.append(f"{arch} b{batch} train step: loss {float(loss)}")
        return (time.perf_counter() - t0) / TIMED

    runs = {"kernel": [], "plain": []}
    launch_runs, peak = [], 0
    want = launches_of(TRAIN_LAUNCHES[arch])
    for path in ("plain", "kernel", "kernel", "plain"):  # in turns, one card
        if path == "kernel":
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            runs[path].append(seconds_per_step())
        if path == "kernel":
            peak = max(peak, torch.cuda.max_memory_allocated())
            launch_runs.append(dict(kernels.LAUNCHES))
            check_routes(f"{arch} b{batch} train run", launch_runs[-1], failures)
            per_step = {k: v / (WARMUP + TIMED) for k, v in launch_runs[-1].items()}
            if per_step != want:
                failures.append(f"{arch} b{batch} train launches per step {per_step} != {want}")
    dt, dt_plain = (float(np.mean(runs[p])) for p in ("kernel", "plain"))
    rate = batch / dt
    say(f"(iii/iv) train {arch}@224 bf16 b{batch} (Adam, wd 1e-4, dropout 0.5, uint8 batch on "
        f"the card): kernel path {rate:.1f} img/s ({1e3 * dt:.2f} ms/step; runs "
        f"{[round(1e3 * t, 2) for t in runs['kernel']]} ms), plain path "
        f"{batch / dt_plain:.1f} img/s ({1e3 * dt_plain:.2f} ms/step; runs "
        f"{[round(1e3 * t, 2) for t in runs['plain']]} ms); peak memory (kernel path) "
        f"{peak / 2 ** 30:.2f} GiB; {rate * gflop_train / 1e3:.2f} TFLOP/s of model "
        f"arithmetic ({gflop_train:.3f} GFLOP/img: 3 × the forward convs and classifier)")
    say(f"    launches per kernel run of {WARMUP + TIMED} steps: {launch_runs} "
        f"(per step expected {want})")
    print_train_profile(arch, step, state, x, y, gen)
    return launch_runs[0], rate


def device_split(prof, ours):
    """(all device µs, µs of device events whose name has one of `ours`,
    device µs under aten::convolution_backward) of a profile."""
    from torch.autograd import DeviceType

    def dev(e):
        t = getattr(e, "device_time_total", None)
        return float(e.cuda_time_total if t is None else t)

    events = prof.events()
    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(dev(e) for e in kernels)
    mine = sum(dev(e) for e in kernels if any(n in e.name for n in ours))
    bwd = sum(dev(e) for e in events if e.name == "aten::convolution_backward")
    return total, mine, bwd


def window_shares(prof, total_us, per):
    """Device ms per request or step (`per` of them traced) of each group of
    WINDOW_KERNELS, and its share of `total_us`."""
    parts = []
    for label, names in WINDOW_KERNELS:
        us = device_split(prof, names)[1]
        parts.append(f"{label} {us / per / 1e3:.4f} ms ({100 * us / max(total_us, 1e-9):.2f}%)")
    return ", ".join(parts)


def print_table(prof, what):
    say(f"profile ({what}, sorted by device time):")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=18)
    for line in table.splitlines():
        say("  " + line)


def print_train_profile(arch, step, state, x, y, gen):
    """torch.profiler over 3 train steps: device time of the port's forward
    kernels, of the backward convs (aten::convolution_backward), and the rest."""
    from torch.profiler import ProfilerActivity, profile

    step(state, x, y, generator=gen)
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, x, y, generator=gen)
        sync()
    host = time.perf_counter() - t0
    print_table(prof, f"{arch} train b{x.shape[0]} x 3")
    device, ours, bwd = device_split(prof, OUR_KERNELS)
    grouped = device_split(prof, GROUPED_KERNELS)[1]
    say(f"{arch} train device time over 3 steps: {device / 1e3:.3f} ms (host clock under the "
        f"profiler {1e3 * host:.1f} ms); the port's kernels "
        f"({', '.join(OUR_KERNELS)}) {ours / 1e3:.3f} ms "
        f"({100 * ours / max(device, 1e-9):.2f}%; of them the grouped conv "
        f"{grouped / 1e3:.3f} ms, {100 * grouped / max(device, 1e-9):.2f}%); backward convs "
        f"(aten::convolution_backward, cuDNN) {bwd / 1e3:.3f} ms "
        f"({100 * bwd / max(device, 1e-9):.2f}%); everything else "
        f"{(device - ours - bwd) / 1e3:.3f} ms")
    say(f"{arch} train b{x.shape[0]}, window kernels per step: {window_shares(prof, device, 3)}")


def serve_check(served, arch, seed, serve_batches, failures):
    """Serve the family's model that learn_check trained, on the images it
    learned, as uint8 requests; returns the launch counts of those
    requests."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    model, images, labels = served
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    rng = np.random.default_rng(seed + 1)
    order = np.concatenate([np.arange(len(images))] * -(-max(serve_batches) // len(images)))
    requests = [images[order[:b]] for b in serve_batches]
    server(requests[0])  # first call: kernels loaded, allocator warm
    sync()

    kernels.reset_launches()
    outs = [server(r) for r in requests]
    sync()
    launches = dict(kernels.LAUNCHES)

    want = launches_of({k: v * len(serve_batches) for k, v in SERVE_LAUNCHES[arch].items()})
    say(f"{arch} served batches {serve_batches}: launches {launches} (expected {want})")
    if launches != want:
        failures.append(f"{arch} launch counts {launches} != {want}")
    check_routes(f"{arch} served batches {serve_batches}", launches, failures)
    for b, y in zip(serve_batches, outs):
        if tuple(y.shape) != (b, 1000) or y.dtype != torch.float32:
            failures.append(f"{arch} batch {b}: logits {tuple(y.shape)} {y.dtype}")
        if not bool(torch.isfinite(y).all()):
            failures.append(f"{arch} batch {b}: non-finite logits")

    with plain_kernels():
        refs = [server(r) for r in requests]
    sync()
    if dict(kernels.LAUNCHES) != launches:
        failures.append(f"{arch}: the plain comparison launched kernels")
    got = torch.cat([o.argmax(-1) for o in outs])
    ref = torch.cat([o.argmax(-1) for o in refs])
    agree = float((got == ref).float().mean())
    diff = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    top2 = torch.cat([r.topk(2, dim=-1).values for r in refs])
    gap = float((top2[:, 0] - top2[:, 1]).min())
    learned = float((got.cpu() == torch.from_numpy(labels[np.concatenate(
        [order[:b] for b in serve_batches])]).long()).float().mean())
    say(f"bf16 serving of the trained {arch} vs plain on the card: argmax agreement "
        f"{agree:.4f} over {got.numel()} images (min {ARGMAX_MIN}); distinct argmax classes "
        f"{ref.unique().numel()} (plain) / {got.unique().numel()} (kernel); served class = "
        f"learned label for {learned:.4f} of them; smallest top-2 gap {gap:.4e}, max |logit "
        f"diff| {diff:.4e} (max |logit| {scale:.4e})")
    if agree < ARGMAX_MIN:
        failures.append(f"{arch} argmax agreement {agree:.4f} < {ARGMAX_MIN}")

    # the same network in fp32 (TF32 off): kernel path vs plain path, tight
    model32 = make_model(arch, seed, False)
    x = torch.from_numpy(images[:8]).to(DEVICE).float() / 255.0
    with torch.inference_mode():
        y32 = model32(x)
        with plain_kernels():
            r32 = model32(x)
    rel = float((y32 - r32).abs().max() / r32.abs().max())
    say(f"fp32 {arch} forward (batch 8) vs plain: max |diff| / max |logit| = {rel:.3e} (tol 1e-4)")
    if not (rel <= 1e-4 and bool(torch.isfinite(y32).all())):
        failures.append(f"fp32 {arch} relative diff {rel:.3e}")
    del model32

    def seconds_per_batch(req, iters=10):
        for _ in range(2):
            server(req)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            server(req)
        sync()
        return (time.perf_counter() - t0) / iters

    for b in THROUGHPUT_BATCHES[arch]:
        req = rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
        runs = {"kernel": [], "plain": []}
        for path in ("plain", "kernel", "kernel", "plain"):  # in turns, one card
            with plain_kernels() if path == "plain" else contextlib.nullcontext():
                runs[path].append(seconds_per_batch(req))
        dt, dt_plain = (float(np.mean(runs[p])) for p in ("kernel", "plain"))
        say(f"serving {arch}@224 bf16, uint8 requests from host, batch {b}: "
            f"{b / dt:.1f} img/s ({1e3 * dt:.2f} ms/batch; runs "
            f"{[round(1e3 * t, 2) for t in runs['kernel']]} ms); through the plain "
            f"versions {b / dt_plain:.1f} img/s ({1e3 * dt_plain:.2f} ms/batch)")

    from torch.profiler import ProfilerActivity, profile

    req = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    server(req)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            server(req)
        sync()
    print_table(prof, f"{arch} serving batch 64 x 3")
    copies = h2d_copies(prof)
    device, ours = device_split(prof, OUR_KERNELS)[:2]
    grouped = device_split(prof, GROUPED_KERNELS)[1]
    # the trace may miss a request's copy (its kernels are all there): a
    # request's device time is its share of the kernels plus one copy
    copy_us = float(np.mean([us for _, us in copies])) if copies else 0.0
    request_us = (device - sum(us for _, us in copies)) / 3 + copy_us
    say(f"{arch} serving batch 64: host-to-device copies traced over 3 requests: "
        f"{len(copies)}, bytes each {sorted({b for b, _ in copies})} (the uint8 request is "
        f"{req.nbytes}; as fp32 it would be {4 * req.nbytes}); {copy_us / 1e3:.3f} ms per copy, "
        f"{100 * copy_us / max(request_us, 1e-9):.2f}% of a request's device time "
        f"({request_us / 1e3:.3f} ms); the port's kernels {ours / 3e3:.3f} ms per request (of "
        f"them the grouped conv {grouped / 3e3:.3f} ms)")
    say(f"{arch} serving batch 64, window kernels per request: "
        f"{window_shares(prof, 3 * request_us, 3)}")
    if not copies or any(b != req.nbytes for b, _ in copies):
        failures.append(f"{arch} serving: host-to-device copies of {[b for b, _ in copies]} bytes "
                        f"for a {req.nbytes}-byte uint8 request")
    return launches


def h2d_copies(prof):
    """[(bytes, device µs)] of each host-to-device copy in a profile, read
    from its Chrome trace (the memcpy events' "bytes")."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return [(int(e.get("args", {}).get("bytes", 0)), float(e.get("dur", 0))) for e in copies]


def phase_family(arch, seed, failures):
    """Phase 7 for one family: (i) the fp32 step check, (ii) the bf16
    learning check, (iii) serving the model (ii) trained, (iv) bench.py's
    train step. Returns (serving launches, train launches)."""
    from convnets_tpu_torch.models import build_model

    probe = build_model(arch, model_setting(arch, seed, True), device=DEVICE)
    say(f"{arch}@224: forward convs {forward_gflop(probe):.4f} GFLOP/img, classifier "
        f"{forward_linear_gflop(probe):.4f} (mul+add = 2)")
    del probe
    step_check(arch, seed, failures)
    served = learn_check(arch, seed, failures)
    serve_launches = serve_check(served, arch, seed, ZOO_SERVE_BATCHES, failures)
    del served
    train_launches, _ = train_throughput(arch, seed, failures)
    return serve_launches, train_launches


def grouped_shapes():
    """{(H, W, Cin, Cout, k, stride, pad, groups): [relu flag of each layer]}
    of ResNeXt-50@224's grouped convs (7 shapes, 16 layers), from its own
    modules."""
    from convnets_tpu_torch.models import build_model

    model = build_model("resnext", model_setting("resnext", 0, True), device=DEVICE)
    return distinct_shapes(model, ("gconv",))


def grouped_check(x, wt, groups, scale, shift, s, p, dname):
    """Both grouped epilogues against their plain versions on one input:
    (ok, fused y err relu=0 / 1, stats ok, stats y err, Σ err, Σ² err), the
    sums against those of the kernel's own stored y (stats_check)."""
    import torch

    from convnets_tpu_torch.ops import kernels

    atol, rtol = CONV_TOL[dname]
    errs, ok = [], True
    for relu in (False, True):
        kw = dict(stride=s, padding=p, relu=relu)
        got = kernels.grouped_conv2d_fused(x, wt, groups, scale, shift, **kw)
        ref = kernels.grouped_conv2d_fused_plain(x, wt, groups, scale, shift, **kw)
        sync()
        errs.append(float((got.float() - ref.float()).abs().max()))
        ok = ok and within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
        del got, ref
    kw = dict(stride=s, padding=p)
    s_ok, y_err, e1, e2 = stats_check(kernels.grouped_conv2d_stats(x, wt, groups, **kw),
                                      kernels.grouped_conv2d_stats_plain(x, wt, groups, **kw),
                                      dname, own=True)
    return ok, errs, s_ok, y_err, e1, e2


def grouped_route_ms(x, wt, groups, scale, shift, s, p, relu, route, reps=REPS):
    """Device ms of grouped_conv2d_fused (scale/shift, `relu`) and of
    grouped_conv2d_stats with their main loop forced to `route`, through
    the wrappers' launch path (the library refuses a route not built for
    the shape)."""
    from convnets_tpu_torch.ops.kernels import conv as kconv

    f_ms = time_ms(lambda: kconv._launch_fused("grouped_conv2d_fused", x, wt, scale, shift, s,
                                               p, relu, groups, route), reps)
    s_ms = time_ms(lambda: kconv._launch_stats("grouped_conv2d_stats", x, wt, s, p, groups,
                                               route), reps)
    return f_ms, s_ms


def phase_grouped_kernels(failures):
    """Phase 8, grouped conv: the plan of every distinct ResNeXt-50@224
    grouped shape (bf16 wgmma, fp32 simt); both epilogues at each at batch
    8, fp32 and bf16, with the bf16 simt route timed beside; both
    epilogues at every branch of grouped_plan (GROUPED_PLAN_SHAPES); and
    the two trainable grouped functions at a stride-1 and a stride-2
    shape."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    distinct = grouped_shapes()
    n_layers = sum(len(v) for v in distinct.values())
    if (len(distinct), n_layers) != (7, SERVE_LAUNCHES["resnext"]["grouped_conv2d_fused"]):
        failures.append(f"ResNeXt-50 walk found {len(distinct)} grouped shapes ({n_layers} layers)")
    rows = kernels.lib().grouped_block_rows()
    if rows != kernels.GroupedPlan("wgmma", 4).bm:
        failures.append(f"grouped_block_rows() {rows} != the plans' 128 rows per partial")
    g = torch.Generator(device=DEVICE).manual_seed(3)
    n = KERNEL_BATCH
    summary = {}
    fused_row = entry(summary, "grouped_conv2d_fused")
    stats_row = entry(summary, "grouped_conv2d_stats")
    for row in (fused_row, stats_row):
        row["simt_ms"] = 0.0
    say("grouped conv (N=8): H W Cin Cout k s p G | dtype route | fused y err, relu=0 / 1 (tol) | "
        "stats y err, Σ rel, Σ² rel vs own y (tol) | fused kernel_ms plain_ms simt_ms, stats "
        "kernel_ms plain_ms simt_ms, cudnn_bf16_ms | uses")
    for (h, w, cin, cout, k, s, p, groups), relus in sorted(distinct.items()):
        cg = cin // groups
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cg, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cg)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        xc, wc = nchw(x32.to(torch.bfloat16)), oihw(w32.to(torch.bfloat16))
        cudnn_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, groups=groups), REPS)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            atol, rtol = CONV_TOL[dname]
            x, wt = x32.to(dtype).contiguous(), w32.to(dtype).contiguous()
            plan = kernels.grouped_plan(dtype, cin, cout, groups)
            want = "wgmma" if dtype == torch.bfloat16 else "simt"
            ok, errs, s_ok, y_err, e1, e2 = grouped_check(x, wt, groups, scale, shift, s, p, dname)
            ok = ok and plan.route == want
            relu = relus[0]
            fk, sk = grouped_route_ms(x, wt, groups, scale, shift, s, p, relu, plan.route)
            fp = time_ms(lambda: kernels.grouped_conv2d_fused_plain(
                x, wt, groups, scale, shift, stride=s, padding=p, relu=relu), REPS)
            sp = time_ms(lambda: kernels.grouped_conv2d_stats_plain(x, wt, groups, stride=s,
                                                                    padding=p), REPS)
            fs, ss = (grouped_route_ms(x, wt, groups, scale, shift, s, p, relu, "simt")
                      if plan.route == "wgmma" else (fk, sk))
            say(f"  {h} {w} {cin} {cout} {k} {s} {p} {groups} | {dname} {plan.route} | "
                f"{errs[0]:.3e} / {errs[1]:.3e} ({atol:g}+{rtol:g}|ref|) {'ok' if ok else 'FAIL'} | "
                f"{y_err:.3e}, {e1:.2e}, {e2:.2e} ({STATS_TOL[dname]:g}) "
                f"{'ok' if s_ok else 'FAIL'} | {fk:.4f} {fp:.4f} {fs:.4f}, {sk:.4f} {sp:.4f} "
                f"{ss:.4f}, {cudnn_ms:.4f} | {len(relus)}")
            if not (ok and s_ok):
                failures.append(f"grouped conv {h}x{w} {cin}->{cout} s{s} G{groups} {dname} "
                                f"{plan.route} (want {want}): fused {errs}, stats y {y_err:.3e} "
                                f"Σ {e1:.2e} Σ² {e2:.2e}")
            fused_row["err"] = max(fused_row["err"], *errs)
            stats_row["err"] = max(stats_row["err"], y_err)
            if dtype == torch.bfloat16:
                flops, nbytes = conv_work(n, h, w, cin, cout, k, s, p, groups)
                add_times(fused_row, len(relus), fk, fp, flops, nbytes + 8 * cout, cudnn_ms)
                add_times(stats_row, len(relus), sk, sp, flops, nbytes + 8 * cout, cudnn_ms)
                fused_row["simt_ms"] += len(relus) * fs
                stats_row["simt_ms"] += len(relus) * ss
            del x, wt
    say(f"ResNeXt-50 grouped convs at N=8 bf16, summed over the 16 layers: fused kernel "
        f"{fused_row['ms']:.4f} ms (plain {fused_row['plain_ms']:.4f}, simt route "
        f"{fused_row['simt_ms']:.4f}), stats kernel {stats_row['ms']:.4f} ms (plain "
        f"{stats_row['plain_ms']:.4f}, simt route {stats_row['simt_ms']:.4f}), cuDNN bf16 "
        f"grouped conv {fused_row['library_ms']:.4f} ms, bound {fused_row['bound_ms']:.4f} ms")

    gp = torch.Generator(device=DEVICE).manual_seed(8)
    say("grouped plans: N H W Cin Cout G k s p | dtype route | fused y err, relu=0 / 1 (tol) | "
        "stats y err, Σ rel, Σ² rel vs own y (tol) | what")
    for n_, h, w, cin, cout, groups, k, s, p, route, what in GROUPED_PLAN_SHAPES:
        cg = cin // groups
        x32 = torch.randn(n_, h, w, cin, device=DEVICE, generator=gp)
        w32 = torch.randn(k, k, cg, cout, device=DEVICE, generator=gp) / np.sqrt(k * k * cg)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=gp)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=gp)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            atol, rtol = CONV_TOL[dname]
            plan = kernels.grouped_plan(dtype, cin, cout, groups)
            want = route if dtype == torch.bfloat16 else "simt"
            ok, errs, s_ok, y_err, e1, e2 = grouped_check(x32.to(dtype), w32.to(dtype), groups,
                                                          scale, shift, s, p, dname)
            ok = ok and plan.route == want
            say(f"  {n_} {h} {w} {cin} {cout} {groups} {k} {s} {p} | {dname} {plan.route} | "
                f"{errs[0]:.3e} / {errs[1]:.3e} ({atol:g}+{rtol:g}|ref|) {'ok' if ok else 'FAIL'} | "
                f"{y_err:.3e}, {e1:.2e}, {e2:.2e} ({STATS_TOL[dname]:g}) "
                f"{'ok' if s_ok else 'FAIL'} | {what}")
            if not (ok and s_ok):
                failures.append(f"grouped plan {what} {dname} {plan.route} (want {want}): fused "
                                f"{errs}, stats y {y_err:.3e} Σ {e1:.2e} Σ² {e2:.2e}")
            fused_row["err"] = max(fused_row["err"], *errs)
            stats_row["err"] = max(stats_row["err"], y_err)

    say("trainable grouped functions (N=8): fn H Cin Cout s G | dtype | out max|Δ|/max|ref| "
        "(tol) | gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | ReLU mask flips | fwd+bwd "
        "kernel_ms plain_ms library_ms")
    groups = 32
    for h, c, s in ((IMAGE // 4, 128, 1), (IMAGE // 4, 256, 2)):
        x32 = torch.randn(n, h, h, c, device=DEVICE, generator=g)
        w32 = torch.randn(3, 3, c // groups, c, device=DEVICE, generator=g) / np.sqrt(9 * c // groups)
        sc32 = 1.0 + 0.1 * torch.randn(c, device=DEVICE, generator=g)
        bi32 = 0.1 * torch.randn(c, device=DEVICE, generator=g)
        work = conv_train_work(n, h, h, c, c, 3, s, 1, groups)
        for dtype in (torch.float32, torch.bfloat16):
            dname = dname_of(dtype)
            x, wt = x32.to(dtype), w32.to(dtype)
            label = f"{h} {c} {c} {s} {groups}"
            check_trainable("grouped_conv2d_train", label,
                            lambda a, b: kernels.grouped_conv2d_train(a, b, groups, s, 1),
                            [x, wt], dname, g, summary, failures, CONV_TOL[dname][1], work,
                            conv_lib(s, 1, groups))
            check_trainable("conv_bn_relu_train_grouped", label,
                            lambda a, b, c_, d: kernels.conv_bn_relu_train(
                                a, b, c_, d, s, 1, groups=groups)[0],
                            [x, wt, sc32, bi32], dname, g, summary, failures,
                            CONV_TOL[dname][1], work)
    return summary


def phase_b256_grouped(summary):
    """Phase 8b: rows 1g and 5g in bf16 at batch B256 at every distinct
    ResNeXt-50@224 grouped shape, and row 8's forward (grouped_conv2d_fused
    with no epilogue): the wgmma route, the simt route on the same inputs,
    cuDNN's bf16 grouped F.conv2d (channels_last) and the bound, each
    summed by layer use into the rows' ms_b256, simt_ms_b256,
    library_ms_b256 and bound_ms_b256."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import conv as kconv

    g = torch.Generator(device=DEVICE).manual_seed(9)
    fused, stats = summary["grouped_conv2d_fused"], summary["grouped_conv2d_stats"]
    train = entry(summary, "grouped_conv2d_train")
    for row in (fused, stats, train):
        row.update(dict.fromkeys(B256_KEYS + ("simt_ms_b256",), 0.0))
    total = total_bytes = 0
    say(f"grouped conv at batch {B256}, bf16: H W Cin Cout k s p G | route | fused ms TFLOP/s | "
        f"stats ms TFLOP/s | no epilogue (row 8's forward) ms | simt route: fused ms, stats ms, "
        f"no epilogue ms | cuDNN ms TFLOP/s | bound ms | uses")
    for (h, w, cin, cout, k, s, p, groups), relus in sorted(grouped_shapes().items()):
        cg = cin // groups
        x = torch.randn(B256, h, w, cin, device=DEVICE, generator=g).to(torch.bfloat16)
        wt = (torch.randn(k, k, cg, cout, device=DEVICE, generator=g)
              / np.sqrt(k * k * cg)).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        xc, wc = nchw(x), oihw(wt)
        plan = kernels.grouped_plan(torch.bfloat16, cin, cout, groups)
        times = {}
        for route in (plan.route, "simt"):
            f_ms, s_ms = grouped_route_ms(x, wt, groups, scale, shift, s, p, True, route)
            t_ms = time_ms(lambda: kconv._launch_fused("grouped_conv2d_fused", x, wt, None, None,
                                                       s, p, False, groups, route), REPS)
            times[route] = (f_ms, s_ms, t_ms)
        c_ms = time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p, groups=groups), REPS)
        flops, nbytes = conv_work(B256, h, w, cin, cout, k, s, p, groups)
        bound = 1e3 * max(flops / PEAK_BF16, (nbytes + 8 * cout) / HBM_BPS)
        uses = len(relus)
        total += uses * flops
        total_bytes += uses * nbytes
        (f_ms, s_ms, t_ms), simt = times[plan.route], times["simt"]
        say(f"  {h} {w} {cin} {cout} {k} {s} {p} {groups} | {plan.route} | "
            f"{f_ms:.4f} {flops / f_ms / 1e9:.1f} | {s_ms:.4f} {flops / s_ms / 1e9:.1f} | "
            f"{t_ms:.4f} | {simt[0]:.4f}, {simt[1]:.4f}, {simt[2]:.4f} | "
            f"{c_ms:.4f} {flops / c_ms / 1e9:.1f} | {bound:.4f} | {uses}")
        for row, ms, sm in ((fused, f_ms, simt[0]), (stats, s_ms, simt[1]), (train, t_ms, simt[2])):
            row["ms_b256"] += uses * ms
            row["simt_ms_b256"] += uses * sm
            row["library_ms_b256"] += uses * c_ms
            row["bound_ms_b256"] += uses * bound
        del x, wt, xc, wc
    lib_ms = fused["library_ms_b256"]
    say(f"ResNeXt-50 grouped convs at b{B256} bf16, summed over the 16 layers ({total / 1e9:.1f} "
        f"GFLOP, {total_bytes / 1e9:.3f} GB): grouped_conv2d_fused {fused['ms_b256']:.3f} ms "
        f"({total / fused['ms_b256'] / 1e9:.1f} TFLOP/s, {fused['ms_b256'] / lib_ms:.3f}x cuDNN; "
        f"simt route {fused['simt_ms_b256']:.3f} ms), grouped_conv2d_stats {stats['ms_b256']:.3f} "
        f"ms ({stats['ms_b256'] / lib_ms:.3f}x cuDNN; simt route {stats['simt_ms_b256']:.3f} ms), "
        f"no epilogue {train['ms_b256']:.3f} ms (simt route {train['simt_ms_b256']:.3f}), cuDNN "
        f"bf16 {lib_ms:.3f} ms ({total / lib_ms / 1e9:.1f} TFLOP/s), bound "
        f"{fused['bound_ms_b256']:.4f} ms")


def block_args(n, h, cin, cmid, dtype, g):
    """A random identity bottleneck of tpu_block_ab.py's construction: x,
    w1 (Cin, Cmid), s1, b1, w2 (3, 3, Cmid, Cmid), s2, b2, w3 (Cmid, Cin),
    s3, b3; weights in `dtype`, scales U(0.9, 1.1), shifts N(0, 0.01)."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, device=DEVICE, generator=g)

    def uni(c):
        return 0.9 + 0.2 * torch.rand(c, device=DEVICE, generator=g)

    return [rnd(n, h, h, cin).to(dtype), (rnd(cin, cmid) / np.sqrt(cin)).to(dtype), uni(cmid),
            0.01 * rnd(cmid), (rnd(3, 3, cmid, cmid) / np.sqrt(9 * cmid)).to(dtype), uni(cmid),
            0.01 * rnd(cmid), (rnd(cmid, cin) / np.sqrt(cmid)).to(dtype), uni(cin),
            0.01 * rnd(cin)]


def block_work(n, h, cin, cmid):
    """(FLOPs, bytes) of one bf16 block: three products; x and the weights
    read once, out written once (h1 and h2 stay on chip)."""
    flops = 2 * n * h * h * (2 * cin * cmid + 9 * cmid * cmid)
    return flops, 2 * (2 * n * h * h * cin + 2 * cin * cmid + 9 * cmid * cmid)


def serving_composition(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The block as the port serves RN50 today: three conv2d_fused launches
    (BN folded into their epilogues), the residual add and the ReLU in
    x.dtype."""
    from convnets_tpu_torch.ops import kernels

    cin, cmid = w1.shape
    h1 = kernels.conv2d_fused(x, w1.reshape(1, 1, cin, cmid), s1, b1, relu=True)
    h2 = kernels.conv2d_fused(h1, w2, s2, b2, padding=1, relu=True)
    y = kernels.conv2d_fused(h2, w3.reshape(1, 1, cmid, cin), s3, b3)
    return (y + x).clamp_min(0)


def cudnn_composition(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The same block through three cuDNN bf16 convs (channels_last) and
    eager epilogues: a library yardstick, never the port's path."""
    import torch.nn.functional as F

    cin, cmid = w1.shape
    xc = nchw(x)

    def bn(y, sc, sh):
        return y * sc.view(1, -1, 1, 1).to(y.dtype) + sh.view(1, -1, 1, 1).to(y.dtype)

    h1 = bn(F.conv2d(xc, oihw(w1.reshape(1, 1, cin, cmid))), s1, b1).clamp_min(0)
    h2 = bn(F.conv2d(h1, oihw(w2), padding=1), s2, b2).clamp_min(0)
    out = (bn(F.conv2d(h2, oihw(w3.reshape(1, 1, cmid, cin))), s3, b3) + xc).clamp_min(0)
    return out.permute(0, 2, 3, 1)  # NHWC, channels_last in memory


def block_route_launches():
    """(wgmma, simt) launches of bottleneck_block since the last reset."""
    from convnets_tpu_torch.ops import kernels

    routes = kernels.ROUTE_LAUNCHES["bottleneck_block"]
    return routes["wgmma"], routes["simt"]


def phase_block(failures):
    """Phase 8, bottleneck_block: checked against its plain version at
    batch 8 on each route, then the A/B of scripts/tpu_block_ab.py at
    batch 256 (chains of 6 and 4 blocks). Returns (summary, launches of
    the kernel arm's timed chains)."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.ops.kernels import block as kblock

    g = torch.Generator(device=DEVICE).manual_seed(4)
    summary = {}
    row = entry(summary, "bottleneck_block")

    def simt(*args, relu_out=True):
        return kblock._launch_block(*args, relu_out=relu_out, route="simt")

    def check(label, args, want_route, relu_out=True, against_simt=False):
        dname = dname_of(args[0].dtype)
        n, h, w, cin = args[0].shape
        plan = kernels.block_plan(args[0].dtype, n, h, w, cin, args[1].shape[1])
        sync()
        kernels.reset_launches()
        got = kernels.bottleneck_block(*args, relu_out=relu_out)
        sync()
        routes = block_route_launches()
        ref = kernels.bottleneck_block_plain(*args, relu_out=relu_out)
        err = float((got.float() - ref.float()).abs().max())
        atol, rtol = BLOCK_TOL[dname]
        ok = (within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
              and plan.route == want_route
              and routes == ((1, 0) if want_route == "wgmma" else (0, 1)))
        line = (f"  {label} | {dname} {plan.route} th={plan.th} | {err:.3e} "
                f"({atol:g}+{rtol:g}|ref|)")
        if against_simt:
            other = simt(*args, relu_out=relu_out)
            sync()
            s_err = float((got.float() - other.float()).abs().max())
            s_ok = within(got, other, atol, rtol)
            ok = ok and s_ok
            line += f" | vs simt {s_err:.3e}"
        say(line + (" ok" if ok else f" FAIL (launches wgmma/simt {routes})"))
        if not ok:
            failures.append(f"bottleneck_block {label} {dname}: err {err:.3e}, route "
                            f"{plan.route} (want {want_route}), launches {routes}")
        row["err"] = max(row["err"], err)
        return got

    say("bottleneck_block (N=8): H Cin Cmid | dtype route | max_abs_err (tol) | vs simt | "
        "kernel_ms plain_ms simt_ms")
    for h, cin, cmid in BLOCK_CHECK_SHAPES:
        args32 = block_args(KERNEL_BATCH, h, cin, cmid, torch.float32, g)
        for dtype in (torch.float32, torch.bfloat16):
            args = [a.to(dtype) if i in (0, 1, 4, 7) else a for i, a in enumerate(args32)]
            bf = dtype == torch.bfloat16
            check(f"{h} {cin} {cmid}", args, "wgmma" if bf else "simt", against_simt=bf)
            k_ms = time_ms(lambda: kernels.bottleneck_block(*args), REPS)
            p_ms = time_ms(lambda: kernels.bottleneck_block_plain(*args), REPS)
            s_ms = time_ms(lambda: simt(*args), REPS) if bf else k_ms
            say(f"    {h} {cin} {cmid} {dname_of(dtype)}: {k_ms:.4f} {p_ms:.4f} {s_ms:.4f}")
    # the bf16 wgmma route without the final ReLU, and with a zero halo: W1 =
    # 0 and b1 > 0 make h1 = ReLU(b1) > 0 inside the image, which the 3x3
    # conv must not see outside it
    h, cin, cmid = BLOCK_CHECK_SHAPES[1]
    args = block_args(KERNEL_BATCH, h, cin, cmid, torch.bfloat16, g)
    check(f"{h} {cin} {cmid} relu_out=False", args, "wgmma", relu_out=False, against_simt=True)
    args[1] = torch.zeros_like(args[1])
    args[3] = args[3].abs() + 0.5
    args[0] = torch.zeros_like(args[0])
    got = check(f"{h} {cin} {cmid} zero halo", args, "wgmma", relu_out=False, against_simt=True)
    if torch.equal(got[:, 0, 0], got[:, h // 2, h // 2]):
        failures.append("bottleneck_block zero halo: a corner equals an interior pixel")
    h, cin, cmid = BLOCK_SIMT_SHAPE
    check(f"{h} {cin} {cmid} off the wgmma route", block_args(
        KERNEL_BATCH, h, cin, cmid, torch.bfloat16, g), "simt")

    # the A/B: each arm runs the chain of blocks RN50 runs at that shape
    arms = {"kernel": kernels.bottleneck_block, "simt": simt,
            "plain": kernels.bottleneck_block_plain, "serving": serving_composition,
            "cudnn": cudnn_composition}
    say(f"block A/B (scripts/tpu_block_ab.py's, batch {BLOCK_BATCH}, bf16): shape | arm "
        f"ms/chain TFLOP/s ratio-to-kernel")
    launches = 0
    for h, cin, cmid, chain in BLOCK_SHAPES:
        args = block_args(BLOCK_BATCH, h, cin, cmid, torch.bfloat16, g)

        def run(block):
            v = args[0]
            for _ in range(chain):
                v = block(v, *args[1:])
            return v

        times = {}
        for arm in ("plain", "kernel", "simt", "serving", "cudnn"):
            if arm == "kernel":
                sync()
                kernels.reset_launches()
            with torch.inference_mode():
                times[arm] = time_ms(lambda: run(arms[arm]), 3)
            if arm == "kernel":
                sync()
                n_arm = kernels.LAUNCHES["bottleneck_block"]
                launches += n_arm
                if block_route_launches() != (n_arm, 0):
                    failures.append(f"block A/B {h}x{cin}/{cmid}: kernel arm launches "
                                    f"(wgmma, simt) {block_route_launches()} of {n_arm}")
        flops, nbytes = block_work(BLOCK_BATCH, h, cin, cmid)
        for arm, ms in times.items():
            say(f"  {h}x{cin}/{cmid} x{chain} | {arm} {ms:.3f} {chain * flops / ms / 1e9:.2f} "
                f"{ms / times['kernel']:.3f}")
        add_times(row, chain, times["kernel"] / chain, times["plain"] / chain, flops, nbytes,
                  times["cudnn"] / chain)
        for key, arm in (("serving_ms", "serving"), ("simt_ms_b256", "simt")):
            row[key] = row.get(key, 0.0) + times[arm]
    return summary, launches


SOURCES = {  # kernel: (source, TPU kernel it replaces)
    "conv2d_fused": ("convnets_tpu_torch/csrc/conv_wgmma.cu", "convnets_tpu/ops/pallas/conv.py:391"),
    "max_pool2d": ("convnets_tpu_torch/csrc/pool.cu", "convnets_tpu/ops/pallas/pool.py:88"),
    "avg_pool2d": ("convnets_tpu_torch/csrc/pool.cu", "convnets_tpu/ops/pallas/pool.py:94"),
    "conv2d_stats": ("convnets_tpu_torch/csrc/conv_wgmma.cu", "convnets_tpu/ops/pallas/conv.py:543"),
    "conv2d_stats_reduce": ("convnets_tpu_torch/csrc/conv_fused.cu",
                            "convnets_tpu/ops/pallas/conv.py:543"),
    "conv_bn_relu_train": ("convnets_tpu_torch/ops/kernels/fused.py",
                           "convnets_tpu/ops/pallas/fused.py:35"),
    "conv2d_train": ("convnets_tpu_torch/ops/kernels/conv.py", "convnets_tpu/ops/pallas/conv.py:675"),
    "pool2d_train": ("convnets_tpu_torch/ops/kernels/pool.py", "convnets_tpu/ops/pallas/pool.py:100"),
    "pool2d_train_avg": ("convnets_tpu_torch/ops/kernels/pool.py",
                         "convnets_tpu/ops/pallas/pool.py:100"),
    "pool2d_backward": ("convnets_tpu_torch/csrc/pool.cu", "convnets_tpu/ops/pallas/pool.py:111"),
    "depthwise_conv2d": ("convnets_tpu_torch/csrc/depthwise.cu",
                         "convnets_tpu/ops/pallas/conv.py:755"),
    "depthwise_train": ("convnets_tpu_torch/ops/kernels/depthwise.py",
                        "convnets_tpu/ops/pallas/conv.py:702"),
    "grouped_conv2d_fused": ("convnets_tpu_torch/csrc/conv_wgmma.cu",
                             "convnets_tpu/ops/pallas/conv.py:391"),
    "grouped_conv2d_stats": ("convnets_tpu_torch/csrc/conv_wgmma.cu",
                             "convnets_tpu/ops/pallas/conv.py:543"),
    "grouped_conv2d_train": ("convnets_tpu_torch/ops/kernels/conv.py",
                             "convnets_tpu/ops/pallas/conv.py:647"),
    "conv_bn_relu_train_grouped": ("convnets_tpu_torch/ops/kernels/fused.py",
                                   "convnets_tpu/ops/pallas/fused.py:35"),
    "bottleneck_block": ("convnets_tpu_torch/csrc/block_wgmma.cu",
                         "convnets_tpu/ops/pallas/block.py:122"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and data")
    ap.add_argument("--phases", default=None,
                    help="run only these phases (comma-separated, e.g. 6b,7), print no "
                         "kernels line and no result line: a development aid")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    try:
        import torch
        from convnets_tpu_torch.ops import kernels
    except ImportError as e:
        die(f"cannot import the port ({e}); run from the repository root")

    # phase 0: device
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        die(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(card)

    # phase 1: build
    t_all = t0 = time.perf_counter()
    log = kernels.build(verbose=True)
    kernels.lib()
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "warning" in line.lower()):
            say("  ptxas: " + line.strip())

    failures = []
    sass_check(failures)
    from convnets_tpu_torch.models import build_model

    summary, serve, train, nobn = {}, {}, {}, {}
    state = {}

    def probe():
        if "probe" not in state:
            state["probe"] = build_model("resnet", model_setting("resnet", args.seed, True),
                                         device=DEVICE)
        return state["probe"]

    def phase_5():
        step_check("resnet", args.seed, failures)
        state["served"] = learn_check("resnet", args.seed, failures)
        nobn["resnet"] = nobn_check("resnet", args.seed, failures)
        train["resnet"] = train_throughput("resnet", args.seed, failures)[0]

    def phase_3():
        serve["resnet"] = serve_check(state.pop("served"), "resnet", args.seed, SERVE_BATCHES,
                                      failures)

    def phase_7():
        for arch in ("mobilenet_v1", "densenet"):
            serve[arch], train[arch] = phase_family(arch, args.seed, failures)

    def phase_8():
        summary.update(phase_grouped_kernels(failures))
        block_summary, state["block"] = phase_block(failures)
        summary.update(block_summary)

    def phase_9():
        serve["resnext"], train["resnext"] = phase_family("resnext", args.seed, failures)
        nobn["resnext"] = nobn_check("resnext", args.seed, failures)

    phases = {
        "2a": lambda: phase_conv_plans(failures),
        "2": lambda: summary.update(phase_kernels(probe(), failures)),
        "4": lambda: summary.update(phase_train_kernels(probe(), failures)),
        "4b": lambda: phase_b256_conv(probe(), summary),
        "5": phase_5,
        "3": phase_3,
        "6": lambda: (summary.update(phase_zoo_kernels(failures)),
                      phase_window_routes(summary, failures)),
        "6b": lambda: phase_b256_windows(summary),
        "7": phase_7,
        "8": phase_8,
        "8b": lambda: phase_b256_grouped(summary),
        "9": phase_9,
    }
    chosen = list(phases) if args.phases is None else args.phases.split(",")
    if any(p not in phases for p in chosen) or ("3" in chosen and "5" not in chosen):
        die(f"--phases: a comma-separated subset of {','.join(phases)} (3 needs 5)")
    for name in phases:
        if name in chosen:
            t0 = time.perf_counter()
            phases[name]()
            if name == "4b":
                state.pop("probe", None)  # RN50's probe model is not needed later
            say(f"[phase {name}: {time.perf_counter() - t0:.1f} s]")
    say(f"[all phases: {time.perf_counter() - t_all:.1f} s]")
    if args.phases is not None:  # a development run: no kernels line, no result
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1 if failures else 0)

    # launches, each from the path that runs the kernel: serving (rows 1, 2,
    # 3, 9 and the grouped forward), the b256 train runs (rows 4, 5, 6, 9's
    # depthwise_train, the grouped statistics), the batch_norm=False steps
    # (rows 7 and 8) and the block A/B (row 10)
    launches = {"conv2d_fused": serve["resnet"]["conv2d_fused"],
                "max_pool2d": serve["resnet"]["max_pool2d"],
                "avg_pool2d": serve["densenet"]["avg_pool2d"],
                "conv2d_stats": train["resnet"]["conv2d_stats"],
                "conv2d_stats_reduce": train["resnet"]["conv2d_stats_reduce"],
                "conv_bn_relu_train": train["resnet"]["conv2d_stats"],
                "pool2d_train": train["resnet"]["max_pool2d"],
                "pool2d_train_avg": train["densenet"]["avg_pool2d"],
                "pool2d_backward": train["resnet"]["pool2d_backward"],
                "conv2d_train": nobn["resnet"]["conv2d_fused"],
                "depthwise_conv2d": serve["mobilenet_v1"]["depthwise_conv2d"],
                "depthwise_train": train["mobilenet_v1"]["depthwise_conv2d"],
                "grouped_conv2d_fused": serve["resnext"]["grouped_conv2d_fused"],
                "grouped_conv2d_stats": train["resnext"]["grouped_conv2d_stats"],
                "grouped_conv2d_train": nobn["resnext"]["grouped_conv2d_fused"],
                "conv_bn_relu_train_grouped": train["resnext"]["grouped_conv2d_stats"],
                "bottleneck_block": state["block"]}
    for name in SOURCES:
        if launches[name] <= 0:
            failures.append(f"{name}: no launch on its main path")
    say(card)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": summary[name]["err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"],
         "bound_by": ("operations" if summary[name]["ops_ms"] >= summary[name]["bytes_ms"]
                      else "bytes"),
         "library_ms": summary[name]["library_ms"],
         **{k: summary[name][k] for k in B256_KEYS + (PLAIN_B256, LOOP_B256) + SIMT_KEYS
            + ("serving_ms",) if k in summary[name]}}
        for name, (src, rep) in SOURCES.items()]}))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
