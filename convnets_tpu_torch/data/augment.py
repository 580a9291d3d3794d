"""On-device augmentation and normalization (counterpart of
convnets_tpu/data/augment.py).

Each random transform is two functions: one draws its parameters from an
explicit `torch.Generator` on the batch's device (`*_draws`: nothing
crosses from the host), the other applies given parameters and is
deterministic (`*_apply`). The port's generators cannot give JAX's bits,
so the tests draw the parameters with `jax.random` as the JAX package
does and hand them to the apply functions.

The crop(pad) + flip + affine of the train path composes into one inverse
affine map per image, applied as one bilinear resample of the batch
(`_bilinear_sample`, a gather); where the map is axis-aligned (crop + flip
alone, RandomResizedCrop, the eval center crop) the resample is separable
and runs as two batched fp32 matrix products (`_separable_resample`), as
the JAX package computes it outside any Pallas kernel (augment.py:131-136).
No Pallas kernel corresponds to either: both are plain PyTorch, in fp32
(a float32 matmul on the card runs in full fp32 unless TF32 is enabled).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from convnets_tpu_torch.data.datasets import CINIC_MEAN, CINIC_STD


def normalize(x, mean=CINIC_MEAN, std=CINIC_STD):
    """(x - mean) / std per channel; x NHWC in [0, 1]. mean/std: arrays, or
    tensors already on x's device (the steps keep theirs there)."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _uniform(generator, n, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=generator.device)


# --- cutout ---------------------------------------------------------------

class CutoutDraws(NamedTuple):
    """Each image's square center, fp32 (N,): row cy, column cx."""
    cy: torch.Tensor
    cx: torch.Tensor


def cutout_draws(generator: torch.Generator, n: int, h: int, w: int) -> CutoutDraws:
    """Centers uniform over the image's integer pixels (augment.py:38-40)."""
    dev = generator.device
    return CutoutDraws(torch.randint(0, h, (n,), generator=generator, device=dev).float(),
                       torch.randint(0, w, (n,), generator=generator, device=dev).float())


def cutout_apply(x, draws: CutoutDraws, size: int):
    """DeVries & Taylor cutout: one size×size square per image zeroed, its
    center anywhere on the image, so it may hang off the edges
    (augment.py:30-47)."""
    _, h, w, _ = x.shape
    yy = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w)
    half = size / 2.0
    keep = ((yy - draws.cy[:, None, None]).abs() >= half) | \
           ((xx - draws.cx[:, None, None]).abs() >= half)
    return x * keep[..., None].to(x.dtype)


def cutout(generator: torch.Generator, x, size: int):
    return cutout_apply(x, cutout_draws(generator, *x.shape[:3]), size)


# --- crop + flip + affine ---------------------------------------------------

class AffineDraws(NamedTuple):
    """Per-image draws of augment_batch (augment.py:52-58), (N,) each:
    rotation and shear in degrees, scale, the crop's integer translation
    (tx, ty, fp32) and the flip (bool)."""
    angle: torch.Tensor
    shear: torch.Tensor
    scale: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    flip: torch.Tensor


class AffineMatrices(NamedTuple):
    """Per-image inverse maps, output → input coordinates about the image
    center: x_in = a·xo + b·yo + cx + tx, y_in = c·xo + d·yo + cy + ty."""
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor


def affine_draws(generator: torch.Generator, n: int, *, degrees=15.0, shear_deg=15.0,
                 scale_range=(0.75, 1.25), crop_pad=4, hflip_p=0.5) -> AffineDraws:
    dev = generator.device
    return AffineDraws(
        _uniform(generator, n, -degrees, degrees), _uniform(generator, n, -shear_deg, shear_deg),
        _uniform(generator, n, scale_range[0], scale_range[1]),
        torch.randint(-crop_pad, crop_pad + 1, (n,), generator=generator, device=dev).float(),
        torch.randint(-crop_pad, crop_pad + 1, (n,), generator=generator, device=dev).float(),
        torch.rand(n, generator=generator, device=dev) < hflip_p)


def affine_matrices(draws: AffineDraws) -> AffineMatrices:
    """The inverse of R(angle)·Shear(x)·S(scale), then the flip on x, the
    translation last (augment.py:60-69)."""
    angle = draws.angle * (math.pi / 180)
    shear = draws.shear * (math.pi / 180)
    flip = draws.flip.float() * -2.0 + 1.0
    cos, sin, tan = torch.cos(angle), torch.sin(angle), torch.tan(shear)
    inv_s = 1.0 / draws.scale
    return AffineMatrices(inv_s * (cos + sin * tan) * flip, inv_s * (-sin + cos * tan),
                          inv_s * sin * flip, inv_s * cos, draws.tx, draws.ty)


def augment_apply(x, m: AffineMatrices, do_affine: bool = True):
    """Apply the maps to x (N, H, W, C) float in [0, 1]; same shape and
    dtype. do_affine False (crop + flip: a = ±1, b = c = 0, d = 1) takes
    the separable path (augment.py:89-97)."""
    _, h, w, _ = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows = torch.arange(h, dtype=torch.float32, device=x.device)
    cols = torch.arange(w, dtype=torch.float32, device=x.device)
    if not do_affine:
        xs = m.a[:, None] * (cols[None] - cx) + cx + m.tx[:, None]
        ys = m.d[:, None] * (rows[None] - cy) + cy + m.ty[:, None]
        return _separable_resample(x, ys, xs)
    yo = (rows[:, None].expand(h, w) - cy)[None]
    xo = (cols[None, :].expand(h, w) - cx)[None]
    col = lambda v: v[:, None, None]  # noqa: E731
    xs = col(m.a) * xo + col(m.b) * yo + cx + col(m.tx)
    ys = col(m.c) * xo + col(m.d) * yo + cy + col(m.ty)
    return _bilinear_sample(x, xs, ys)


def augment_batch(generator: torch.Generator, x, *, degrees=15.0, shear_deg=15.0,
                  scale_range=(0.75, 1.25), crop_pad=4, hflip_p=0.5, do_affine=True):
    """Random crop(pad) + hflip + affine as one resample (augment.py:74).
    With do_affine False the rotation, shear and scale are drawn from empty
    ranges (0, 0, 1), as the JAX package draws them."""
    if not do_affine:
        degrees, shear_deg, scale_range = 0.0, 0.0, (1.0, 1.0)
    draws = affine_draws(generator, x.shape[0], degrees=degrees, shear_deg=shear_deg,
                         scale_range=scale_range, crop_pad=crop_pad, hflip_p=hflip_p)
    return augment_apply(x, affine_matrices(draws), do_affine)


def _separable_resample(x, ys, xs):
    """Axis-aligned bilinear resample as two batched fp32 matrix products
    (augment.py:110-136): x (N, H, W, C), ys (N, OH), xs (N, OW) source
    coordinates. The tent weights max(0, 1 − |s − coord|) put (1 − frac,
    frac) on the two source taps and vanish outside the image, which is
    _bilinear_sample's zero border."""
    _, h, w, _ = x.shape
    sy = torch.arange(h, dtype=torch.float32, device=x.device)
    sx = torch.arange(w, dtype=torch.float32, device=x.device)
    wy = torch.clamp_min(1.0 - (sy[None, None] - ys[:, :, None]).abs(), 0.0)  # (N, OH, H)
    wx = torch.clamp_min(1.0 - (sx[None, None] - xs[:, :, None]).abs(), 0.0)  # (N, OW, W)
    tmp = torch.einsum("nih,nhwc->niwc", wy, x.float())
    return torch.einsum("njw,niwc->nijc", wx, tmp).to(x.dtype).contiguous()


def _bilinear_sample(x, xs, ys):
    """Per-image bilinear gather (augment.py:138-166): x (N, H, W, C),
    xs/ys (N, OH, OW) source coordinates; zero outside the source."""
    n, h, w, _ = x.shape
    oh, ow = xs.shape[1], xs.shape[2]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx = (xs - x0)[..., None].to(x.dtype)
    fy = (ys - y0)[..., None].to(x.dtype)
    batch = torch.arange(n, device=x.device).view(n, 1, 1).expand(n, oh, ow)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = x[batch, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return vals * inside[..., None].to(x.dtype)

    top = gather(y0, x0) * (1 - fx) + gather(y0, x0 + 1) * fx
    bot = gather(y0 + 1, x0) * (1 - fx) + gather(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


# --- RandomResizedCrop and the eval center crop --------------------------------

class ResizedCropDraws(NamedTuple):
    """Per-image draws of random_resized_crop_batch (augment.py:186-200),
    (N,) each: the area's uniform, the log aspect ratio, the offsets'
    uniforms and the flip (bool)."""
    area_u: torch.Tensor
    log_ratio: torch.Tensor
    x_u: torch.Tensor
    y_u: torch.Tensor
    flip: torch.Tensor


def resized_crop_draws(generator: torch.Generator, n: int, *,
                       ratio_range=(3.0 / 4.0, 4.0 / 3.0), hflip_p=0.5) -> ResizedCropDraws:
    return ResizedCropDraws(
        torch.rand(n, generator=generator, device=generator.device),
        _uniform(generator, n, math.log(ratio_range[0]), math.log(ratio_range[1])),
        torch.rand(n, generator=generator, device=generator.device),
        torch.rand(n, generator=generator, device=generator.device),
        torch.rand(n, generator=generator, device=generator.device) < hflip_p)


def resized_crop_apply(x, out_hw, draws: ResizedCropDraws, *, scale_range=(0.08, 1.0)):
    """The crop box in closed form — area uniform over the range feasible
    for the drawn aspect — then flip and resize to out_hw as one separable
    resample (augment.py:186-212). The box and the source coordinates are
    computed in fp64 and rounded once to fp32: exp and sqrt round
    differently on the card and on the CPU, and at 256² one fp32 ulp of a
    coordinate moves a pixel by up to 3e-5."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    ratio = torch.exp(draws.log_ratio.double())  # crop_w / crop_h
    hw = float(h * w)
    max_area = torch.minimum(torch.clamp_max((w * w) / ratio, scale_range[1] * hw),
                             (h * h) * ratio)
    min_area = torch.clamp_max(max_area, scale_range[0] * hw)
    area = min_area + draws.area_u.double() * (max_area - min_area)
    cw = torch.clamp_max(torch.sqrt(area * ratio), float(w))
    ch = torch.clamp_max(torch.sqrt(area / ratio), float(h))
    x_off = draws.x_u.double() * (w - cw)
    y_off = draws.y_u.double() * (h - ch)
    yy = torch.arange(oh, dtype=torch.float64, device=x.device)[None]
    xx = torch.arange(ow, dtype=torch.float64, device=x.device)[None]
    xx = torch.where(draws.flip[:, None], (ow - 1) - xx, xx)
    xs = (xx + 0.5) * (cw[:, None] / ow) + x_off[:, None] - 0.5
    ys = (yy + 0.5) * (ch[:, None] / oh) + y_off[:, None] - 0.5
    return _separable_resample(x, ys.float(), xs.float())


def random_resized_crop_batch(generator: torch.Generator, x, out_hw, *,
                              scale_range=(0.08, 1.0), ratio_range=(3.0 / 4.0, 4.0 / 3.0),
                              hflip_p=0.5):
    """RandomResizedCrop + horizontal flip as one resample (augment.py:169):
    x (N, H, W, C) in [0, 1] → (N, *out_hw, C)."""
    draws = resized_crop_draws(generator, x.shape[0], ratio_range=ratio_range,
                               hflip_p=hflip_p)
    return resized_crop_apply(x, tuple(out_hw), draws, scale_range=scale_range)


def center_crop_resize(x, out_hw, *, enlarge=1.0 / 0.875):
    """Eval resize (short side = out·enlarge) → center crop out_hw, one
    separable resample (augment.py:215): torchvision's Resize(256) +
    CenterCrop(224) for enlarge = 256/224."""
    n, h, w, _ = x.shape
    oh, ow = out_hw
    scale = min(h, w) / (min(oh, ow) * enlarge)  # source pixels per output pixel
    y_off = (h - oh * scale) / 2.0
    x_off = (w - ow * scale) / 2.0
    yy = torch.arange(oh, dtype=torch.float32, device=x.device)[None]
    xx = torch.arange(ow, dtype=torch.float32, device=x.device)[None]
    xs = (xx + 0.5) * scale + x_off - 0.5
    ys = (yy + 0.5) * scale + y_off - 0.5
    return _separable_resample(x, ys.expand(n, oh), xs.expand(n, ow))


# --- mixup ------------------------------------------------------------------

class MixupDraws(NamedTuple):
    """One λ ~ Beta(α, α) per batch, drawn on the host (fp32: a float, or
    the fp32 0-d device tensor a captured step reads it from), and one
    permutation of the batch (on the device)."""
    lam: object
    perm: torch.Tensor


def mixup_lambda(host_generator: torch.Generator, alpha: float) -> float:
    """λ from `host_generator` (a CPU generator: torch draws no Beta variate
    from a generator, so λ is numpy's Beta under a seed drawn from it),
    rounded to fp32."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=host_generator))
    return float(np.float32(np.random.default_rng(seed).beta(alpha, alpha)))


def mixup_perm(generator: torch.Generator, n: int) -> torch.Tensor:
    """The order of n uniform keys from `generator`: made and sorted on its
    device, where torch.randperm may draw a short permutation on the host
    and copy it."""
    keys = torch.rand(n, generator=generator, device=generator.device)
    return torch.argsort(keys)


def mixup_draws(generator: torch.Generator, host_generator: torch.Generator, n: int,
                alpha: float) -> MixupDraws:
    """λ from `host_generator`, the permutation from `generator` (on the
    batch's device)."""
    return MixupDraws(mixup_lambda(host_generator, alpha), mixup_perm(generator, n))


def mixup_apply(x, draws: MixupDraws, y: Optional[torch.Tensor] = None):
    """λ·x + (1 − λ)·x[perm] in x.dtype, λ and 1 − λ rounded to it
    (engine.py:220-222); with labels, also y[perm]. A float λ becomes a CPU
    scalar (no copy to the card); a tensor λ is used where it lies."""
    lam = torch.as_tensor(draws.lam, dtype=torch.float32)
    mixed = lam.to(x.dtype) * x + (1.0 - lam).to(x.dtype) * x[draws.perm]
    return mixed if y is None else (mixed, y[draws.perm])
