#!/usr/bin/env python3
"""Drive the PyTorch port's ResNet-50 serving path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure exits non-zero without the final line:
  0. device: needs CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them.
  1. build: compiles convnets_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  2. kernels vs plain: every distinct conv shape of the port's own
     RN50@224 modules, at batch 8, fp32 (TF32 off) and bf16, with and
     without ReLU, plus the stem max-pool, each against its plain PyTorch
     version on the card; max error, tolerance and CUDA-event times.
  3. the slice: RN50 at 3x224x224, 1000 classes, bf16 compute, weights
     made with numpy from --seed in the JAX variable layout and loaded by
     the bridge, served as uint8 requests at batch 1, 8 and 64 with baked
     normalization. Checks finite logits, exactly 53 conv and 1 pool
     launch per forward, and argmax agreement with the same forward
     through the plain versions; then serving img/s at batch 64 and 256
     (kernel and plain paths in turns) and a torch.profiler table of three
     batch-64 requests.
  4. last line: {"ok": true, "device": {...}}.
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
POOL_TOL = 0.0  # a max of the same values is exact in either dtype
ARGMAX_MIN = 0.99
SERVE_BATCHES = (1, 8, 64)
THROUGHPUT_BATCHES = (64, 256)
CONV_PER_FORWARD, POOL_PER_FORWARD = 53, 1
IMAGENET_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
REPS = 10  # timed launches per kernel measurement


def say(*args):
    print(*args, flush=True)


def die(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
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


def random_jax_variables(model, seed: int) -> dict:
    """numpy weights in the tree convnets_tpu's init produces for this model
    (HWIO conv w, (in, out) linear w, BN params/state), drawn from `seed`."""
    from convnets_tpu_torch import bridge

    rng = np.random.default_rng(seed)
    tree = {"params": {}, "state": {}}
    for path, (mod, tname) in sorted(bridge.jax_layout(model).items()):
        shape = tuple(getattr(mod, tname).shape)
        leaf = path[-1]
        if leaf == "w" and len(shape) == 4:
            kh, kw, _, o = shape
            v = rng.standard_normal(shape) * np.sqrt(2.0 / (o * kh * kw))
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


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain PyTorch versions (for the
    on-card comparison only; the package itself never does this)."""
    from convnets_tpu_torch.ops import kernels

    saved = kernels.conv2d_fused, kernels.max_pool2d
    kernels.conv2d_fused, kernels.max_pool2d = kernels.conv2d_fused_plain, kernels.max_pool2d_plain
    try:
        yield
    finally:
        kernels.conv2d_fused, kernels.max_pool2d = saved


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
    distinct = {}
    for _, h, w, cin, cout, k, s, p, relu in convs:
        distinct.setdefault((h, w, cin, cout, k, s, p), []).append(relu)

    g = torch.Generator(device="cuda").manual_seed(0)
    n = 8
    summary = {"conv2d_fused": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0},
               "max_pool2d": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}}
    say("conv shapes (N=8): H W Cin Cout k s p | dtype relu | max_abs_err tol | "
        "kernel_ms plain_ms cudnn_bf16_ms | uses")
    for (h, w, cin, cout, k, s, p), relus in sorted(distinct.items()):
        x32 = torch.randn(n, h, w, cin, device="cuda", generator=g)
        w32 = torch.randn(k, k, cin, cout, device="cuda", generator=g) / np.sqrt(k * k * cin)
        scale = 1.0 + 0.1 * torch.randn(cout, device="cuda", generator=g)
        shift = 0.1 * torch.randn(cout, device="cuda", generator=g)
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
                torch.cuda.synchronize()
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
    x32 = torch.randn(n, h, w, c, device="cuda", generator=g)
    say("stem max-pool (N=8): H W C k s p | dtype | max_abs_err | kernel_ms plain_ms")
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        got = kernels.max_pool2d(x, k, s, p)
        ref = kernels.max_pool2d_plain(x, k, s, p)
        torch.cuda.synchronize()
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


def phase_slice(seed, failures):
    """Serve RN50@224 uint8 requests through the port; returns launch counts."""
    import torch

    from convnets_tpu_torch import bridge
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.ops import kernels
    from convnets_tpu_torch.serve import ServingModel

    def make(mixed):
        setting = types.SimpleNamespace(
            kind="50", input_size=(3, 224, 224), num_classes=1000, batch_norm=True,
            init_params=True, dropout_rate=0.5, mixed_precision=mixed, seed=seed)
        model = build_model("resnet", setting, device="cuda")
        bridge.load_jax_variables(model, random_jax_variables(model, seed))
        return model

    model = make(True)
    server = ServingModel(model, input_dtype="uint8", stats=IMAGENET_STATS)
    rng = np.random.default_rng(seed + 1)
    requests = [rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8) for b in SERVE_BATCHES]
    server(requests[0])  # first call: kernels loaded, allocator warm
    torch.cuda.synchronize()

    kernels.reset_launches()
    outs = [server(r) for r in requests]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    n_fwd = len(SERVE_BATCHES)
    want = {"conv2d_fused": CONV_PER_FORWARD * n_fwd, "max_pool2d": POOL_PER_FORWARD * n_fwd}
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
    torch.cuda.synchronize()
    if dict(kernels.LAUNCHES) != launches:
        failures.append("the plain comparison launched kernels")
    got = torch.cat([o.argmax(-1) for o in outs])
    ref = torch.cat([o.argmax(-1) for o in refs])
    agree = float((got == ref).float().mean())
    diff = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    top2 = torch.cat([r.topk(2, dim=-1).values for r in refs])
    gap = float((top2[:, 0] - top2[:, 1]).min())
    say(f"bf16 serving vs plain on the card: argmax agreement {agree:.4f} over {got.numel()} "
        f"images (min {ARGMAX_MIN}; {ref.unique().numel()} distinct classes, smallest "
        f"top-2 gap {gap:.4e}), max |logit diff| {diff:.4e} (max |logit| {scale:.4e})")
    if agree < ARGMAX_MIN:
        failures.append(f"argmax agreement {agree:.4f} < {ARGMAX_MIN}")

    # the same network in fp32 (TF32 off): kernel path vs plain path, tight
    model32 = make(False)
    x = torch.from_numpy(requests[1]).cuda().float() / 255.0
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            server(req)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    throughput = {}
    for b in THROUGHPUT_BATCHES:
        req = rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
        runs = {"kernel": [], "plain": []}
        for path in ("plain", "kernel", "kernel", "plain"):  # in turns, one card
            with plain_kernels() if path == "plain" else contextlib.nullcontext():
                runs[path].append(seconds_per_batch(req))
        dt, dt_plain = (float(np.mean(runs[p])) for p in ("kernel", "plain"))
        throughput[b] = b / dt
        say(f"serving RN50@224 bf16, uint8 requests from host, batch {b}: "
            f"{throughput[b]:.1f} img/s ({1e3 * dt:.2f} ms/batch; runs "
            f"{[round(1e3 * t, 2) for t in runs['kernel']]} ms); through the plain "
            f"versions {b / dt_plain:.1f} img/s ({1e3 * dt_plain:.2f} ms/batch)")

    print_profile(server, rng)
    return launches, throughput


def print_profile(server, rng):
    """torch.profiler over 3 batch-64 requests: device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    req = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    server(req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            server(req)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
    say("profile (batch 64 x 3, sorted by device time):")
    for line in table.splitlines():
        say("  " + line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and requests")
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

    probe = build_model("resnet", types.SimpleNamespace(
        kind="50", input_size=(3, 224, 224), num_classes=1000, mixed_precision=True))
    summary = phase_kernels(probe, failures)
    del probe
    launches, _ = phase_slice(args.seed, failures)

    sources = {"conv2d_fused": ("convnets_tpu_torch/csrc/conv_fused.cu",
                                "convnets_tpu/ops/pallas/conv.py:391"),
               "max_pool2d": ("convnets_tpu_torch/csrc/pool.cu",
                              "convnets_tpu/ops/pallas/pool.py:88")}
    say(card)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": summary[name]["err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]}))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
