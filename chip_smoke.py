#!/usr/bin/env python3
"""Drive the PyTorch port's ResNet-50 serving and train paths on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in the order they run; any failure exits non-zero without the
final line:
  0. device: needs CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them.
  1. build: compiles convnets_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  2. serving kernels vs plain: every distinct conv shape of the port's own
     RN50@224 modules, at batch 8, fp32 (TF32 off) and bf16, with and
     without ReLU, plus the stem max-pool, each against its plain PyTorch
     version on the card; max error, tolerance and CUDA-event times.
  4. train kernels vs plain: conv2d_stats (y, Σy, Σy²) and its reduction
     at every distinct RN50@224 conv shape at batch 8 in fp32 and bf16;
     conv_bn_relu_train and conv2d_train forward and gradients at the stem
     and a 3x3/2 shape; pool2d_train dx at the stem pool (exact).
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
     (kernel and plain paths in turns) and a torch.profiler table.
  last line: {"ok": true, "device": {...}}.
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
# the whole fp32 RN50 step at init is ill-conditioned: the plain path
# against itself with its conv weights perturbed by 1e-7 relative (the
# "control", run beside the check) differs by ~2e-2 per gradient leaf in
# L2; the bar sits above that, far below the O(1) of a wrong formula
STEP_GRAD_TOL = 0.1
CONTROL_PERTURBATION = 1e-7
POOL_TOL = 0.0  # a max of the same values is exact in either dtype
ARGMAX_MIN = 0.99
SERVE_BATCHES = (1, 8, 64)
THROUGHPUT_BATCHES = (64, 256)
CONV_PER_FORWARD, POOL_PER_FORWARD = 53, 1
IMAGENET_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
REPS = 10  # timed launches per kernel measurement
IMAGE = 224
KERNEL_BATCH = 8
STEP_BATCH = 8  # phase 5 (i)
LEARN_BATCH, LEARN_STEPS = 32, 10  # phase 5 (ii)
SETTLE_STEPS = 40  # zero-lr steps that bring (ii)'s BN running stats up to date
TRAIN_BATCH, WARMUP, TIMED = 256, 5, 20  # phase 5 (iii), bench.py's protocol
NOBN_BATCH = 32  # phase 5 (iv)
RN50_GFLOP_TRAIN = 3 * 8.174  # per image: forward convs ×3 (PERF.md §4)
DEVICE = "cuda"


def say(*args):
    print(*args, flush=True)


def die(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    import torch

    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rn50_layers(model):
    """(kind, H, W, Cin, Cout, k, stride, pad, relu) of every ConvBNReLU and
    MaxPool2d of the model, in forward order, from its own modules."""
    from convnets_tpu_torch import nn

    out = []

    def walk(mod, shape):
        if isinstance(mod, nn.ConvBNReLU):
            c = mod._modules["0"]
            out.append(("conv", shape[1], shape[2], shape[3], c.out_channels,
                        c.kernel[0], c.stride[0], c.padding[0], mod.act))
        elif isinstance(mod, nn.MaxPool2d):
            out.append(("pool", shape[1], shape[2], shape[3], shape[3],
                        mod.kernel, mod.stride, mod.padding, False))
        elif isinstance(mod, nn.Add):
            for branch in mod._modules.values():
                walk(branch, shape)
        elif isinstance(mod, nn.Sequential):
            for child in mod._modules.values():
                walk(child, shape)
                shape = child.out_shape(shape)

    walk(model.module, model.batch_shape(1))
    return out


def distinct_convs(model):
    """{(H, W, Cin, Cout, k, stride, pad): [relu flag of each layer]}."""
    distinct = {}
    for _, h, w, cin, cout, k, s, p, relu in (l for l in rn50_layers(model) if l[0] == "conv"):
        distinct.setdefault((h, w, cin, cout, k, s, p), []).append(relu)
    return distinct


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
         "max_pool2d": "max_pool2d_plain"}


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


def phase_kernels(model, failures):
    """Kernel vs plain at every distinct RN50@224 conv shape and the stem
    pool, batch 8. Returns the per-kernel summary for the JSON line."""
    import torch
    import torch.nn.functional as F

    from convnets_tpu_torch.ops import kernels

    layers = rn50_layers(model)
    convs = [l for l in layers if l[0] == "conv"]
    pools = [l for l in layers if l[0] == "pool"]
    if len(convs) != CONV_PER_FORWARD or len(pools) != POOL_PER_FORWARD:
        failures.append(f"RN50 walk found {len(convs)} convs, {len(pools)} pools")
    distinct = distinct_convs(model)

    g = torch.Generator(device=DEVICE).manual_seed(0)
    n = KERNEL_BATCH
    summary = {"conv2d_fused": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0},
               "max_pool2d": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}}
    say("conv shapes (N=8): H W Cin Cout k s p | dtype relu | max_abs_err tol | "
        "kernel_ms plain_ms cudnn_bf16_ms | uses")
    for (h, w, cin, cout, k, s, p), relus in sorted(distinct.items()):
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        scale = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        shift = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x, wt = x32.to(dtype).contiguous(), w32.to(dtype).contiguous()
            dname = str(dtype).split(".")[-1]
            atol, rtol = CONV_TOL[dname]
            # the same conv through cuDNN in bf16 (channels_last): a library
            # time for context, not a contract check
            xc = x32.to(torch.bfloat16).permute(0, 3, 1, 2)
            wc = w32.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
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
                summary["conv2d_fused"]["err"] = max(summary["conv2d_fused"]["err"], err)
                if dtype == torch.bfloat16:
                    summary["conv2d_fused"]["ms"] += uses * k_ms
                    summary["conv2d_fused"]["plain_ms"] += uses * p_ms

    _, h, w, c, _, k, s, p, _ = pools[0]
    x32 = torch.randn(n, h, w, c, device=DEVICE, generator=g)
    say("stem max-pool (N=8): H W C k s p | dtype | max_abs_err | kernel_ms plain_ms")
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        got = kernels.max_pool2d(x, k, s, p)
        ref = kernels.max_pool2d_plain(x, k, s, p)
        sync()
        err = float((got.float() - ref.float()).abs().max())
        ok = got.shape == ref.shape and err <= POOL_TOL
        k_ms = time_ms(lambda: kernels.max_pool2d(x, k, s, p), REPS)
        p_ms = time_ms(lambda: kernels.max_pool2d_plain(x, k, s, p), REPS)
        dname = str(dtype).split(".")[-1]
        say(f"  {h} {w} {c} {k} {s} {p} | {dname} | {err:.3e} {'ok' if ok else 'FAIL'} | "
            f"{k_ms:.4f} {p_ms:.4f}")
        if not ok:
            failures.append(f"max_pool2d {dname}: err {err:.3e}")
        summary["max_pool2d"]["err"] = max(summary["max_pool2d"]["err"], err)
        if dtype == torch.bfloat16:
            summary["max_pool2d"]["ms"], summary["max_pool2d"]["plain_ms"] = k_ms, p_ms
    say(f"RN50 conv layers at N=8 bf16, summed over the 53 layers: kernel "
        f"{summary['conv2d_fused']['ms']:.3f} ms, plain {summary['conv2d_fused']['plain_ms']:.3f} ms")
    return summary


def rn50_setting(seed, mixed, **kw):
    fields = dict(kind="50", input_size=(3, IMAGE, IMAGE), num_classes=1000, batch_norm=True,
                  init_params=True, dropout_rate=0.5, mixed_precision=mixed, seed=seed,
                  learning_rate=0.01, weight_decay=1e-4, optimizer="adam")
    fields.update(kw)
    return types.SimpleNamespace(**fields)


def make_rn50(seed, mixed, conv_gain=None, **kw):
    """RN50 on the card with numpy weights from `seed` loaded by the bridge."""
    from convnets_tpu_torch import bridge
    from convnets_tpu_torch.models import build_model

    model = build_model("resnet", rn50_setting(seed, mixed, **kw), device=DEVICE)
    bridge.load_jax_variables(model, random_jax_variables(model, seed, conv_gain))
    return model


def rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


def l2_err(got, ref) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30))


def phase_train_kernels(model, failures):
    """conv2d_stats at every distinct RN50@224 conv shape; conv_bn_relu_train,
    conv2d_train and pool2d_train forward + gradients, kernel vs plain."""
    import torch

    from convnets_tpu_torch.ops import kernels

    lib = kernels.lib()
    g = torch.Generator(device=DEVICE).manual_seed(1)
    n = KERNEL_BATCH
    names = ("conv2d_stats", "conv2d_stats_reduce", "conv_bn_relu_train", "conv2d_train",
             "pool2d_train")
    summary = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in names}
    say("conv2d_stats (N=8): H W Cin Cout k s p | dtype | y_err tol, Σ rel, Σ² rel (tol) | "
        "kernel_ms plain_ms | reduce: blocks err kernel_ms plain_ms | uses")
    for (h, w, cin, cout, k, s, p), relus in sorted(distinct_convs(model).items()):
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, wt = x32.to(dtype).contiguous(), w32.to(dtype).contiguous()
            kw = dict(stride=s, padding=p)
            y, s1, s2 = kernels.conv2d_stats(x, wt, **kw)
            ry, r1, r2 = kernels.conv2d_stats_plain(x, wt, **kw)
            sync()
            atol, rtol = CONV_TOL[dname]
            err = float((y.float() - ry.float()).abs().max())
            e1 = float((s1 - r1).abs().max() / ry.float().abs().sum(dim=(0, 1, 2)).max())
            e2 = float(((s2 - r2).abs() / r2.clamp_min(1e-30)).max())
            ok = (within(y, ry, atol, rtol) and max(e1, e2) <= STATS_TOL[dname]
                  and bool(torch.isfinite(s2).all()))
            k_ms = time_ms(lambda: kernels.conv2d_stats(x, wt, **kw), REPS)
            p_ms = time_ms(lambda: kernels.conv2d_stats_plain(x, wt, **kw), REPS)
            # the reduction alone, on partial sums of this shape's block count
            blocks = -(-(n * y.shape[1] * y.shape[2]) // lib.conv_block_rows())
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
                f"{k_ms:.4f} {p_ms:.4f} | {blocks} {r_err:.2e} {r_ms:.4f} {rp_ms:.4f} | {len(relus)}")
            if not (ok and r_ok):
                failures.append(f"conv2d_stats {h}x{w} {cin}->{cout} k{k} s{s} {dname}: y {err:.3e}"
                                f" Σ {e1:.2e} Σ² {e2:.2e} reduce {r_err:.2e}")
            summary["conv2d_stats"]["err"] = max(summary["conv2d_stats"]["err"], err)
            summary["conv2d_stats_reduce"]["err"] = max(summary["conv2d_stats_reduce"]["err"], r_err)
            if dtype == torch.bfloat16:
                for key, (a, b) in (("conv2d_stats", (k_ms, p_ms)),
                                    ("conv2d_stats_reduce", (r_ms, rp_ms))):
                    summary[key]["ms"] += len(relus) * a
                    summary[key]["plain_ms"] += len(relus) * b
    say(f"RN50 conv2d_stats at N=8 bf16, summed over the 53 layers: kernel "
        f"{summary['conv2d_stats']['ms']:.3f} ms (reduction alone "
        f"{summary['conv2d_stats_reduce']['ms']:.3f}), plain "
        f"{summary['conv2d_stats']['plain_ms']:.3f} ms")

    # the trainable functions: forward and every gradient, the kernel path
    # against the same function with the plain versions swapped in
    shapes = [(IMAGE, IMAGE, 3, 64, 7, 2, 3), (IMAGE // 4, IMAGE // 4, 128, 128, 3, 2, 1)]
    say("trainable functions (N=8): fn H Cin Cout k s | dtype | out max|Δ|/max|ref| (tol) | "
        "gradients ‖Δ‖/‖g‖ (tol) [max|Δ|/max|g|] | ReLU mask flips | fwd+bwd kernel_ms plain_ms")
    for h, w, cin, cout, k, s, p in shapes:
        x32 = torch.randn(n, h, w, cin, device=DEVICE, generator=g)
        w32 = torch.randn(k, k, cin, cout, device=DEVICE, generator=g) / np.sqrt(k * k * cin)
        sc32 = 1.0 + 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        bi32 = 0.1 * torch.randn(cout, device=DEVICE, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, wt = x32.to(dtype), w32.to(dtype)
            fns = {
                "conv_bn_relu_train": (lambda a, b, c, d: kernels.conv_bn_relu_train(
                    a, b, c, d, s, p)[0], [x, wt, sc32, bi32]),
                "conv2d_train": (lambda a, b: kernels.conv2d_train(a, b, s, p), [x, wt]),
            }
            cot = None
            for name, (fn, args) in fns.items():
                def run():
                    nonlocal cot
                    ins = [a.detach().clone().requires_grad_() for a in args]
                    out = fn(*ins)
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
                ok = (out_err <= CONV_TOL[dname][1] and max(grad_l2) <= GRAD_TOL[dname]
                      and all(bool(torch.isfinite(t).all()) for t in got))
                k_ms = time_ms(run, 3)
                with plain_kernels():
                    p_ms = time_ms(run, 3)
                say(f"  {name} {h} {cin} {cout} {k} {s} | {dname} | {out_err:.2e} "
                    f"({CONV_TOL[dname][1]:g}) | {' '.join(f'{e:.2e}' for e in grad_l2)} "
                    f"({GRAD_TOL[dname]:g}) [{' '.join(f'{e:.1e}' for e in grad_max)}] | "
                    f"{flips} {'ok' if ok else 'FAIL'} | {k_ms:.4f} {p_ms:.4f}")
                if not ok:
                    failures.append(f"{name} {h}x{w} {cin}->{cout} k{k} {dname}: out {out_err:.2e}"
                                    f", gradients {grad_l2}")
                summary[name]["err"] = max(summary[name]["err"],
                                           max(float((a.float() - b.float()).abs().max())
                                               for a, b in zip(got, ref)))
                if dtype == torch.bfloat16:
                    summary[name]["ms"] += k_ms
                    summary[name]["plain_ms"] += p_ms

    # the stem pool's dx: the same VJP on the same forward, so exactly equal
    _, h, w, c, _, k, s, p, _ = [l for l in rn50_layers(model) if l[0] == "pool"][0]
    x32 = torch.relu(torch.randn(n, h, w, c, device=DEVICE, generator=g))  # tied zeros
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]

        def run():
            xi = x32.to(dtype).requires_grad_()
            out = kernels.pool2d_train(xi, "max", k, s, p)
            return [out.detach(), *torch.autograd.grad(out, xi, torch.ones_like(out))]

        got = run()
        with plain_kernels():
            ref = run()
        sync()
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
        k_ms = time_ms(run, REPS)
        with plain_kernels():
            p_ms = time_ms(run, REPS)
        say(f"  pool2d_train {h} {c} {k} {s} | {dname} | out and dx max|Δ| {err:.3e} "
            f"(exact) {'ok' if err <= POOL_TOL else 'FAIL'} | {k_ms:.4f} {p_ms:.4f}")
        if err > POOL_TOL:
            failures.append(f"pool2d_train {dname}: err {err:.3e}")
        summary["pool2d_train"]["err"] = max(summary["pool2d_train"]["err"], err)
        if dtype == torch.bfloat16:
            summary["pool2d_train"]["ms"], summary["pool2d_train"]["plain_ms"] = k_ms, p_ms
    return summary


def train_state(model, **kw):
    from convnets_tpu_torch.train import build_train_step, create_train_state

    state = create_train_state(model)
    return state, build_train_step(state, **kw)


def phase_train_step(seed, failures):
    """(i) fp32 one SGD step, kernel path vs plain path; (ii) bf16 loss falls;
    (iv) the batch_norm=False step. Returns the no-BN step's launches and,
    for phase 3, (ii)'s kernel-path model with its batch and labels."""
    import torch

    from convnets_tpu_torch import bridge, nn
    from convnets_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed + 2)

    def batch(b):
        x = torch.from_numpy(rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)).to(DEVICE)
        return x, torch.from_numpy(rng.integers(0, 1000, b)).to(DEVICE)

    # (i) SGD with no momentum or decay at lr 2^20: the update lr·g is exact
    # and dwarfs p, so (p_before - p_after) / lr reads the step's gradients
    # back to fp32 rounding
    lr = 2.0 ** 20
    x, y = batch(STEP_BATCH)
    results, masks = {}, {}
    for path in ("kernel", "plain", "control"):
        model = make_rn50(seed, False, dropout_rate=0.0, optimizer="sgd", learning_rate=lr,
                          momentum=0.0, weight_decay=0.0)
        if path == "control":
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            with torch.no_grad():
                for p in model.parameters():
                    if p.ndim == 4:
                        p.mul_(1 + CONTROL_PERTURBATION * torch.randn(
                            p.shape, device=DEVICE, generator=gen))
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        masks[path] = []
        for mod in model.modules():  # every ReLU's mask: ConvBNReLU outputs, post-add ReLUs
            if isinstance(mod, (nn.ConvBNReLU, nn.Add)) and getattr(
                    mod, "act", getattr(mod, "post_relu", False)):
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
    say(f"(i) fp32 RN50 SGD step (batch {STEP_BATCH}), kernel vs plain path: loss {lk:.6f} vs "
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
        failures.append(f"fp32 train step: loss {loss_rel:.2e}, grads {g_l2[worst_l2]:.2e}, "
                        f"BN {s_err:.2e}")

    # (ii) bf16 learning check: ten Adam steps on one batch, both paths, with
    # the normalization phase 3 serves with
    x, y = batch(LEARN_BATCH)
    losses = {}
    for path in ("plain", "kernel"):
        model = make_rn50(seed, True, dropout_rate=0.0, learning_rate=1e-3)
        state, step = train_state(model, norm=True, stats=IMAGENET_STATS)
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            losses[path] = [float(step(state, x, y)[0]) for _ in range(LEARN_STEPS)]
    # the kernel path's model is served in phase 3: steps at lr 0 leave its
    # weights as they are and bring its BN running statistics (momentum
    # 0.1) to this batch's, so eval mode computes what train mode learned
    state.lr = 0.0
    for _ in range(SETTLE_STEPS):
        step(state, x, y)
    served = (model, x.cpu().numpy(), y.cpu().numpy())
    del state
    falls = losses["kernel"][-1] < losses["kernel"][0] and all(np.isfinite(losses["kernel"]))
    say(f"(ii) bf16 RN50, {LEARN_STEPS} Adam steps (lr 1e-3) on one batch of {LEARN_BATCH}, "
        f"loss per step:\n  kernel {[round(v, 3) for v in losses['kernel']]}\n"
        f"  plain  {[round(v, 3) for v in losses['plain']]}\n"
        f"  kernel path's loss falls: {'ok' if falls else 'FAIL'}")
    if not falls:
        failures.append(f"bf16 loss did not fall: {losses['kernel']}")

    # (iv) the batch_norm=False configuration: conv2d_train on every conv
    model = make_rn50(seed, True, conv_gain=0.5, batch_norm=False)
    state, step = train_state(model, debug=True)
    x, y = batch(NOBN_BATCH)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sync()
    kernels.reset_launches()
    loss, _, gnorm = step(state, x, y, generator=gen)
    sync()
    launches = dict(kernels.LAUNCHES)
    want = {"conv2d_fused": CONV_PER_FORWARD, "conv2d_stats": 0, "conv2d_stats_reduce": 0,
            "max_pool2d": POOL_PER_FORWARD}
    ok = launches == want and bool(torch.isfinite(gnorm)) and bool(torch.isfinite(loss))
    say(f"(iv) bf16 RN50 batch_norm=False, one Adam step at batch {NOBN_BATCH}: launches "
        f"{launches} (expected {want}); loss {float(loss):.4f}, gradient global norm "
        f"{float(gnorm):.4e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"no-BN step: launches {launches}, loss {float(loss)}, |g| {float(gnorm)}")
    return launches, served


def phase_train_throughput(seed, failures):
    """(iii) bench.py's RN50@224 b256 bf16 train step, kernel and plain paths
    in turns on one model; returns (model, per-run launches, img/s)."""
    import torch

    from convnets_tpu_torch.ops import kernels

    model = make_rn50(seed, True)
    state, step = train_state(model)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 256, (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=torch.uint8, device=DEVICE,
                      generator=gen)
    y = torch.randint(0, 1000, (TRAIN_BATCH,), device=DEVICE, generator=gen)

    def seconds_per_step():
        for _ in range(WARMUP):
            step(state, x, y, generator=gen)
        sync()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            loss, _ = step(state, x, y, generator=gen)
        sync()
        if not bool(torch.isfinite(loss)):
            failures.append(f"b{TRAIN_BATCH} train step: loss {float(loss)}")
        return (time.perf_counter() - t0) / TIMED

    runs = {"kernel": [], "plain": []}
    launch_runs, peak = [], 0
    want = {"conv2d_fused": 0, "conv2d_stats": CONV_PER_FORWARD,
            "conv2d_stats_reduce": CONV_PER_FORWARD, "max_pool2d": POOL_PER_FORWARD}
    for path in ("plain", "kernel", "kernel", "plain"):  # in turns, one card
        if path == "kernel":
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            runs[path].append(seconds_per_step())
        if path == "kernel":
            peak = max(peak, torch.cuda.max_memory_allocated())
            launch_runs.append(dict(kernels.LAUNCHES))
            per_step = {k: v / (WARMUP + TIMED) for k, v in launch_runs[-1].items()}
            if per_step != want:
                failures.append(f"b{TRAIN_BATCH} train launches per step {per_step} != {want}")
    dt, dt_plain = (float(np.mean(runs[p])) for p in ("kernel", "plain"))
    rate = TRAIN_BATCH / dt
    say(f"(iii) train RN50@224 bf16 b{TRAIN_BATCH} (Adam, wd 1e-4, dropout 0.5, uint8 batch on "
        f"the card): kernel path {rate:.1f} img/s ({1e3 * dt:.2f} ms/step; runs "
        f"{[round(1e3 * t, 2) for t in runs['kernel']]} ms), plain path "
        f"{TRAIN_BATCH / dt_plain:.1f} img/s ({1e3 * dt_plain:.2f} ms/step; runs "
        f"{[round(1e3 * t, 2) for t in runs['plain']]} ms); peak memory (kernel path) "
        f"{peak / 2 ** 30:.2f} GiB; {rate * RN50_GFLOP_TRAIN / 1e3:.2f} TFLOP/s of model "
        f"arithmetic ({RN50_GFLOP_TRAIN:.3f} GFLOP/img)")
    say(f"    launches per kernel run of {WARMUP + TIMED} steps: {launch_runs} "
        f"(per step expected {want})")
    print_train_profile(step, state, x, y, gen)
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


def print_table(prof, what):
    say(f"profile ({what}, sorted by device time):")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=18)
    for line in table.splitlines():
        say("  " + line)


def print_train_profile(step, state, x, y, gen):
    """torch.profiler over 3 train steps: device time of the port's forward
    kernels, of the backward convs (aten::convolution_backward), and the rest."""
    from torch.profiler import ProfilerActivity, profile

    step(state, x, y, generator=gen)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, x, y, generator=gen)
        sync()
    print_table(prof, f"train b{TRAIN_BATCH} x 3")
    device, ours, bwd = device_split(
        prof, ("conv_kernel<", "stats_reduce_kernel", "max_pool_kernel"))
    say(f"train device time over 3 steps: {device / 1e3:.3f} ms; forward kernels (conv_kernel, "
        f"stats_reduce_kernel, max_pool_kernel) {ours / 1e3:.3f} ms "
        f"({100 * ours / max(device, 1e-9):.2f}%); backward convs (aten::convolution_backward, "
        f"cuDNN) {bwd / 1e3:.3f} ms ({100 * bwd / max(device, 1e-9):.2f}%); everything else "
        f"{(device - ours - bwd) / 1e3:.3f} ms")


def phase_serve(served, seed, failures):
    """Serve RN50@224 uint8 requests through the port: the model phase 5 (ii)
    trained, on the images it learned; returns launch counts."""
    import torch

    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    model, images, labels = served
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    rng = np.random.default_rng(seed + 1)
    order = np.concatenate([np.arange(len(images))] * -(-max(SERVE_BATCHES) // len(images)))
    requests = [images[order[:b]] for b in SERVE_BATCHES]
    server(requests[0])  # first call: kernels loaded, allocator warm
    sync()

    kernels.reset_launches()
    outs = [server(r) for r in requests]
    sync()
    launches = dict(kernels.LAUNCHES)

    n_fwd = len(SERVE_BATCHES)
    want = {"conv2d_fused": CONV_PER_FORWARD * n_fwd, "conv2d_stats": 0,
            "conv2d_stats_reduce": 0, "max_pool2d": POOL_PER_FORWARD * n_fwd}
    say(f"served batches {SERVE_BATCHES}: launches {launches} (expected {want})")
    if launches != want:
        failures.append(f"launch counts {launches} != {want}")
    for b, y in zip(SERVE_BATCHES, outs):
        if tuple(y.shape) != (b, 1000) or y.dtype != torch.float32:
            failures.append(f"batch {b}: logits {tuple(y.shape)} {y.dtype}")
        if not bool(torch.isfinite(y).all()):
            failures.append(f"batch {b}: non-finite logits")

    with plain_kernels():
        refs = [server(r) for r in requests]
    sync()
    if dict(kernels.LAUNCHES) != launches:
        failures.append("the plain comparison launched kernels")
    got = torch.cat([o.argmax(-1) for o in outs])
    ref = torch.cat([o.argmax(-1) for o in refs])
    agree = float((got == ref).float().mean())
    diff = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    top2 = torch.cat([r.topk(2, dim=-1).values for r in refs])
    gap = float((top2[:, 0] - top2[:, 1]).min())
    learned = float((got.cpu() == torch.from_numpy(labels[np.concatenate(
        [order[:b] for b in SERVE_BATCHES])]).long()).float().mean())
    say(f"bf16 serving of the trained RN50 vs plain on the card: argmax agreement {agree:.4f} "
        f"over {got.numel()} images (min {ARGMAX_MIN}); distinct argmax classes "
        f"{ref.unique().numel()} (plain) / {got.unique().numel()} (kernel); served class = "
        f"learned label for {learned:.4f} of them; smallest top-2 gap {gap:.4e}, max |logit "
        f"diff| {diff:.4e} (max |logit| {scale:.4e})")
    if agree < ARGMAX_MIN:
        failures.append(f"argmax agreement {agree:.4f} < {ARGMAX_MIN}")

    # the same network in fp32 (TF32 off): kernel path vs plain path, tight
    model32 = make_rn50(seed, False)
    x = torch.from_numpy(requests[1]).to(DEVICE).float() / 255.0
    with torch.inference_mode():
        y32 = model32(x)
        with plain_kernels():
            r32 = model32(x)
    rel = float((y32 - r32).abs().max() / r32.abs().max())
    say(f"fp32 RN50 forward (batch 8) vs plain: max |diff| / max |logit| = {rel:.3e} (tol 1e-4)")
    if not (rel <= 1e-4 and bool(torch.isfinite(y32).all())):
        failures.append(f"fp32 RN50 relative diff {rel:.3e}")
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

    for b in THROUGHPUT_BATCHES:
        req = rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
        runs = {"kernel": [], "plain": []}
        for path in ("plain", "kernel", "kernel", "plain"):  # in turns, one card
            with plain_kernels() if path == "plain" else contextlib.nullcontext():
                runs[path].append(seconds_per_batch(req))
        dt, dt_plain = (float(np.mean(runs[p])) for p in ("kernel", "plain"))
        say(f"serving RN50@224 bf16, uint8 requests from host, batch {b}: "
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
    print_table(prof, "serving batch 64 x 3")
    return launches


SOURCES = {  # kernel: (source, TPU kernel it replaces)
    "conv2d_fused": ("convnets_tpu_torch/csrc/conv_fused.cu", "convnets_tpu/ops/pallas/conv.py:391"),
    "max_pool2d": ("convnets_tpu_torch/csrc/pool.cu", "convnets_tpu/ops/pallas/pool.py:88"),
    "conv2d_stats": ("convnets_tpu_torch/csrc/conv_fused.cu", "convnets_tpu/ops/pallas/conv.py:543"),
    "conv2d_stats_reduce": ("convnets_tpu_torch/csrc/conv_fused.cu",
                            "convnets_tpu/ops/pallas/conv.py:543"),
    "conv_bn_relu_train": ("convnets_tpu_torch/ops/kernels/fused.py",
                           "convnets_tpu/ops/pallas/fused.py:35"),
    "conv2d_train": ("convnets_tpu_torch/ops/kernels/conv.py", "convnets_tpu/ops/pallas/conv.py:675"),
    "pool2d_train": ("convnets_tpu_torch/ops/kernels/pool.py", "convnets_tpu/ops/pallas/pool.py:100"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and data")
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
    t0 = time.perf_counter()
    log = kernels.build(verbose=True)
    kernels.lib()
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say("  ptxas: " + line.strip())

    failures = []
    from convnets_tpu_torch.models import build_model

    t0 = time.perf_counter()
    probe = build_model("resnet", rn50_setting(args.seed, True))
    summary = phase_kernels(probe, failures)
    say(f"[phase 2: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    summary.update(phase_train_kernels(probe, failures))
    del probe
    say(f"[phase 4: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    nobn_launches, served = phase_train_step(args.seed, failures)
    train_launches, _ = phase_train_throughput(args.seed, failures)
    say(f"[phase 5: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    serve_launches = phase_serve(served, args.seed, failures)
    say(f"[phase 3: {time.perf_counter() - t0:.1f} s]")

    # launches, each from the path that runs the kernel: serving (rows 1, 2),
    # the b256 train run (rows 4, 5, 6) and the batch_norm=False step (row 7)
    launches = {"conv2d_fused": serve_launches["conv2d_fused"],
                "max_pool2d": serve_launches["max_pool2d"],
                "conv2d_stats": train_launches["conv2d_stats"],
                "conv2d_stats_reduce": train_launches["conv2d_stats_reduce"],
                "conv_bn_relu_train": train_launches["conv2d_stats"],
                "pool2d_train": train_launches["max_pool2d"],
                "conv2d_train": nobn_launches["conv2d_fused"]}
    say(card)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": summary[name]["err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name, (src, rep) in SOURCES.items()]}))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
