"""A configuration's weights and a train split, made from the seed on the
device in a few large draws, the weights' names and layouts in the
program under test, and the program's model loaded with them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference import resnet as ref


def make_tensors(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the network in the reference's names and layouts,
    float32: conv weights He normal (fan out), BN scale U(0.5, 1.5), bias
    and running mean U(-0.1, 0.1), running var U(0.5, 1.5), the head's
    weight N(0, 0.45 / sqrt(its inputs)), 0.0099 for a 2048-wide head, and
    bias 0. Three draws: one normal for the convs and
    the head, one uniform for the BN leaves."""
    shapes = ref.leaf_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    normal = [k for k in shapes if k.endswith(".weight") and ".bn." not in k]
    uniform = [k for k in shapes if ".bn." in k]
    sizes_n = [math.prod(shapes[k]) for k in normal]
    sizes_u = [math.prod(shapes[k]) for k in uniform]
    flat_n = torch.randn(sum(sizes_n), generator=g, device=device)
    flat_u = torch.rand(sum(sizes_u), generator=g, device=device)
    out = {}
    for k, part in zip(normal, torch.split(flat_n, sizes_n)):
        if k == "fc.weight":
            std = 0.45 / math.sqrt(shapes[k][0])
        else:
            cout, _, kh, kw = shapes[k]
            std = math.sqrt(2.0 / (cout * kh * kw))
        out[k] = (part * std).view(shapes[k])
    for k, part in zip(uniform, torch.split(flat_u, sizes_u)):
        lo, hi = (0.5, 1.5) if k.endswith((".weight", "running_var")) else (-0.1, 0.1)
        out[k] = (lo + (hi - lo) * part).view(shapes[k])
    out["fc.bias"] = torch.zeros(shapes["fc.bias"], device=device)
    return out


def make_split(n: int, cfg: dict, seed: int, device, chunk: int = 512):
    """n uint8 NHWC images and their labels, uniform over the classes.

    Each image is a coarse 8x8 pattern, half its class's and half its own,
    spread bilinearly over the image, with fine noise on top: so the
    images differ as photographs do in their large shapes, and a class
    signal is there to learn. (Pixel noise alone makes every image look
    alike to the deep layers, whose batch statistics then shrink to
    nothing against their means.)"""
    c, h, w = cfg["input_size"]
    g = torch.Generator(device=device).manual_seed((int(seed) + 1) % (2 ** 63))
    labels = torch.randint(0, cfg["num_classes"], (n,), dtype=torch.int32, generator=g,
                           device=device)
    classes = torch.rand((cfg["num_classes"], c, 8, 8), generator=g, device=device)
    images = torch.empty((n, h, w, c), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        k = min(chunk, n - i)
        coarse = 0.5 * classes[labels[i:i + k].long()] + \
            0.5 * torch.rand((k, c, 8, 8), generator=g, device=device)
        x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        x = x + 0.1 * torch.randn((k, c, h, w), generator=g, device=device)
        images[i:i + k] = (x.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1)
    return images, labels


def port_names(cfg: dict) -> Dict[str, str]:
    """The reference's tensor names -> the program's state_dict names. The
    program's model is one Sequential: the stem conv site at 0, its pool at
    1, block i at 2 + i (body 0 with its sites 0, 1, 2; shortcut 1), then
    the pool or flatten, the dropout and the linear head."""
    names = {}
    for site, *_ in ref.conv_sites(cfg):
        if site == "stem":
            prefix = "module.0"
        else:
            block, conv = site[1:].split(".")
            prefix = f"module.{2 + int(block)}." + {"c1": "0.0", "c2": "0.1", "c3": "0.2",
                                                     "sc": "1"}[conv]
        names[f"{site}.weight"] = f"{prefix}.0.weight"
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            names[f"{site}.bn.{leaf}"] = f"{prefix}.1.{leaf}"
    head = 2 + ref.num_blocks(cfg) + 2
    names["fc.weight"] = f"module.{head}.weight"
    names["fc.bias"] = f"module.{head}.bias"
    return names


def to_port(name: str, t: torch.Tensor) -> torch.Tensor:
    """A reference tensor in the program's layout: conv weights OIHW ->
    HWIO; the rest as they are."""
    if t.ndim == 4:
        return t.permute(2, 3, 1, 0).contiguous()
    return t


def from_port(t: torch.Tensor) -> torch.Tensor:
    """A tensor of the program in the reference's layout (HWIO -> OIHW)."""
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1)
    return t


def port_state_dict(cfg: dict, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    names = port_names(cfg)
    return {names[k]: to_port(k, v) for k, v in tensors.items()}


def port_model(cfg: dict, seed: int, device, batch: int):
    """The program's model of `cfg`: `build_model` under the configuration's
    settings, then the benchmark's weights through `load_state_dict`."""
    import tempfile

    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.settings import Settings
    o = cfg["optimizer"]
    setting = Settings(kind=cfg["kind"], input_size=tuple(cfg["input_size"]),
                       num_classes=cfg["num_classes"], batch_size=batch,
                       mixed_precision=cfg["precision"]["compute"] == "bfloat16",
                       data_augment=cfg["data_augment"], data_norm=cfg["data_norm"],
                       dropout_rate=cfg["dropout_rate"], weight_decay=o["weight_decay"],
                       learning_rate=cfg["assumed"]["learning_rate"], optimizer=o["name"],
                       seed=seed, output_dir=tempfile.gettempdir())
    model = build_model(cfg["arch"], setting, device=device)
    model.load_state_dict(port_state_dict(cfg, make_tensors(cfg, seed, device)))
    return model
