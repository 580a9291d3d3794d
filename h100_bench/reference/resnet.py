"""Plain PyTorch ResNet / ResNeXt bottleneck networks, built from a
configuration file of the benchmark, as functions of a dict of tensors.

This is the benchmark's yardstick for `correct`: it imports nothing of the
program and takes nothing the program made. Its layouts are PyTorch's
own: images NCHW, conv weights OIHW, the linear head's weight (in, out).
The head flattens NHWC order where the configuration says "flatten", so
that it reads the map as the configuration states it.

precision "fp32" runs every conv and the head in float32 with TF32 off
(`fp32_mode`). "fp8" is the control, an FP8 training recipe: wherever a
bfloat16 program stores a tensor (each conv's input, weight and output,
each BN and ReLU output, the head's input and weight) it is rounded to
float8 e4m3 on the way forward and its gradient to e5m2 on the way back,
one scale per tensor (its largest magnitude at the format's largest
value); products accumulate in float32. "bf16" rounds at the same places
to bfloat16, the gradient passed through: a witness for what bfloat16
rounding alone does, not the yardstick.

Batch norm follows PyTorch: batch statistics over (N, H, W) with the
biased variance in train mode, the running statistics updated with the
unbiased one at momentum 0.1, the running statistics in eval mode.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_mode():
    """float32 products with TF32 off, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


E5M2_MAX = 57344.0


def _scaled_round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """t rounded to the float8 `dtype` under one scale for the tensor (its
    largest magnitude at `top`), back in float32."""
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """float8 as an FP8 training recipe uses it: the value rounded to e4m3
    on the way forward, its gradient rounded to e5m2 on the way back."""

    @staticmethod
    def forward(ctx, t):
        return _scaled_round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t in float8: e4m3 forward, e5m2 gradient, one scale per tensor."""
    return _Fp8.apply(t)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, back in float32; the gradient passes through."""
    return t + (t.detach().to(torch.bfloat16).to(torch.float32) - t.detach())


def _round(t, precision):
    """t where a program at `precision` stores it: each conv's input,
    weight and output, each BN / ReLU output, the head's input and weight."""
    if precision == "fp8":
        return fp8_round(t)
    if precision == "bf16":
        return bf16_round(t)
    return t


def conv_sites(cfg: dict):
    """(name, cin, cout, k, stride, padding, groups) of every conv, in the
    order the forward runs them: the stem, then per block c1, c2, c3 and
    the projection shortcut `sc` where the block has one."""
    c = cfg["input_size"][0]
    st = cfg["stem"]
    sites = [("stem", c, st["out"], st["kernel"], st["stride"], st["padding"], 1)]
    cin = st["out"]
    i = 0
    for width, repeats, stride in cfg["stages"]:
        cout = width * cfg["expansion"]
        for r in range(repeats):
            s = stride if r == 0 else 1
            sites += [(f"b{i}.c1", cin, width, 1, 1, 0, 1),
                      (f"b{i}.c2", width, width, 3, s, 1, cfg["groups"]),
                      (f"b{i}.c3", width, cout, 1, 1, 0, 1)]
            if s != 1 or cin != cout:
                sites.append((f"b{i}.sc", cin, cout, 1, s, 0, 1))
            cin, i = cout, i + 1
    return sites


def num_blocks(cfg: dict) -> int:
    return sum(r for _, r, _ in cfg["stages"])


def head_in(cfg: dict) -> int:
    """The head's input width (the last map flattened, or its channels)."""
    _, h, w = cfg["input_size"]
    cout = cfg["stages"][-1][0] * cfg["expansion"]
    h = (h + 2 * cfg["stem"]["padding"] - cfg["stem"]["kernel"]) // cfg["stem"]["stride"] + 1
    p = cfg["stem"]["pool"]
    h = (h + 2 * p["padding"] - p["kernel"]) // p["stride"] + 1
    for _, _, s in cfg["stages"]:
        h = (h + 2 - 3) // s + 1
    return cout if cfg["head"] == "global_avg_pool" else h * h * cout


def leaf_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every tensor of the network and its shape: per conv site
    `<site>.weight` (OIHW) and its BN's `<site>.bn.weight`, `.bias`,
    `.running_mean`, `.running_var`; `fc.weight` (in, out) and `fc.bias`."""
    shapes = {}
    for name, cin, cout, k, _, _, g in conv_sites(cfg):
        shapes[f"{name}.weight"] = (cout, cin // g, k, k)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.bn.{leaf}"] = (cout,)
    shapes["fc.weight"] = (head_in(cfg), cfg["num_classes"])
    shapes["fc.bias"] = (cfg["num_classes"],)
    return shapes


def is_buffer(name: str) -> bool:
    return name.endswith("running_mean") or name.endswith("running_var")


def _bn(x, t, site, train, bn_cfg, new_stats):
    w, b = t[f"{site}.bn.weight"], t[f"{site}.bn.bias"]
    rm, rv = t[f"{site}.bn.running_mean"], t[f"{site}.bn.running_var"]
    eps = bn_cfg["eps"]
    if not train:
        return (x - rm[None, :, None, None]) * torch.rsqrt(rv + eps)[None, :, None, None] \
            * w[None, :, None, None] + b[None, :, None, None]
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    n = x.shape[0] * x.shape[2] * x.shape[3]
    m = bn_cfg["momentum"]
    new_stats[f"{site}.bn.running_mean"] = (1 - m) * rm + m * mean.detach()
    new_stats[f"{site}.bn.running_var"] = (1 - m) * rv + m * var.detach() * (n / (n - 1))
    return (x - mean[None, :, None, None]) * torch.rsqrt(var + eps)[None, :, None, None] \
        * w[None, :, None, None] + b[None, :, None, None]


def forward(cfg: dict, t: Dict[str, torch.Tensor], images: torch.Tensor, *, train: bool,
            keep: Optional[torch.Tensor] = None, precision: str = "fp32",
            new_stats: Optional[dict] = None) -> torch.Tensor:
    """Logits (N, classes) in float32 of uint8 NHWC `images`. train: batch
    statistics (written into `new_stats`) and dropout by the bool `keep`
    mask of the head's input; eval: the running statistics, no dropout."""
    if new_stats is None:
        new_stats = {}
    x = images.float().permute(0, 3, 1, 2) / 255.0
    sites = {s[0]: s for s in conv_sites(cfg)}

    def conv_bn(x, site, relu):
        _, _, _, _, stride, pad, g = sites[site]
        w = _round(t[f"{site}.weight"], precision)
        y = F.conv2d(_round(x, precision), w, stride=stride, padding=pad, groups=g)
        y = _bn(_round(y, precision), t, site, train, cfg["batch_norm"], new_stats)
        return _round(F.relu(y) if relu else y, precision)

    x = conv_bn(x, "stem", True)
    p = cfg["stem"]["pool"]
    x = F.max_pool2d(x, p["kernel"], p["stride"], p["padding"])
    for i in range(num_blocks(cfg)):
        h = conv_bn(x, f"b{i}.c1", True)
        h = conv_bn(h, f"b{i}.c2", True)
        h = conv_bn(h, f"b{i}.c3", False)
        sc = conv_bn(x, f"b{i}.sc", False) if f"b{i}.sc" in sites else x
        x = F.relu(h + sc)
    if cfg["head"] == "global_avg_pool":
        x = x.mean(dim=(2, 3))
    else:
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    if train and keep is not None:
        rate = cfg["dropout_rate"]
        x = torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))
    w = _round(t["fc.weight"], precision)
    return _round(x, precision) @ w + t["fc.bias"]


def cross_entropy_sum(logits, labels, weights=None):
    nll = -torch.log_softmax(logits.float(), dim=-1).gather(-1, labels.long()[:, None])[:, 0]
    if weights is not None:
        nll = nll * weights
    return nll.sum()


def adam_step(cfg: dict, lr: float, params: dict, grads: dict, m: dict, v: dict,
              count: int) -> None:
    """One Adam step in place, the weight decay added to the gradient."""
    o = cfg["optimizer"]
    b1, b2, eps, wd = o["b1"], o["b2"], o["eps"], o["weight_decay"]
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    with torch.no_grad():
        for k, g in grads.items():
            g = g + wd * params[k]
            m[k].mul_(b1).add_((1 - b1) * g)
            v[k].mul_(b2).add_((1 - b2) * g * g)
            params[k].sub_(lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps))


def train_steps(cfg: dict, lr: float, tensors: Dict[str, torch.Tensor], batches,
                precision: str = "fp32", half_batch: bool = False,
                grads_at: Sequence[int] = (0,), states_at: Sequence[int] = ()) -> dict:
    """Run len(batches) train steps from `tensors` (left unchanged) over
    `batches`, each (images uint8 NHWC, labels, keep mask of the head's
    input). Returns each step's loss; `grads`, the gradient as Adam gets it
    (with the weight decay) at each step of `grads_at`; `states`, every
    tensor before each step of `states_at`; `stats`, the BN running
    statistics after each step; and every tensor after the last step.
    half_batch: a fault, the loss of the first half of each batch doubled
    in place of the whole batch's."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in tensors.items() if not is_buffer(k)}
    buffers = {k: v.detach().clone().float() for k, v in tensors.items() if is_buffer(k)}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    wd = cfg["optimizer"]["weight_decay"]
    losses, grads_out, states, stats_out = [], {}, {}, []
    with fp32_mode():
        for step, (images, labels, keep) in enumerate(batches):
            if step in states_at:
                states[step] = {**{k: p.detach().clone() for k, p in params.items()},
                                **{k: b.clone() for k, b in buffers.items()}}
            new_stats = {}
            logits = forward(cfg, {**params, **buffers}, images, train=True, keep=keep,
                             precision=precision, new_stats=new_stats)
            if half_batch:
                n = labels.shape[0] // 2
                loss = 2.0 * cross_entropy_sum(logits[:n], labels[:n])
            else:
                loss = cross_entropy_sum(logits, labels)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if step in grads_at:
                grads_out[step] = {k: (g + wd * params[k].detach()) for k, g in grads.items()}
            losses.append(float(loss.detach()))
            adam_step(cfg, lr, {k: p.data for k, p in params.items()}, grads, m, v, step + 1)
            buffers.update(new_stats)
            stats_out.append({k: v.detach().clone() for k, v in new_stats.items()})
            del logits, loss, grads
    after = {k: p.detach() for k, p in params.items()}
    after.update(buffers)
    return {"losses": np.array(losses), "grads": grads_out, "states": states, "stats": stats_out,
            "after": after}


def eval_logits(cfg: dict, tensors: Dict[str, torch.Tensor], images: torch.Tensor,
                precision: str = "fp32", rows: int = 64) -> torch.Tensor:
    """The eval forward's float32 logits, `rows` images at a time."""
    outs = []
    with fp32_mode(), torch.no_grad():
        for i in range(0, images.shape[0], rows):
            outs.append(forward(cfg, tensors, images[i:i + rows], train=False,
                                precision=precision))
    return torch.cat(outs)
