"""Winograd F(2,3) / F(4,3) convolution (counterpart of
convnets_tpu/ops/winograd.py): the gate, the Lavin & Gray transforms and
the plain PyTorch composition.

F(m,3) computes an m×m output tile from an (m+2)×(m+2) input tile with
(m+2)² products instead of 9m². The composition is three stages:
- the input transform: tiles of the padded input (stride m, a = m + 2
  wide) become V = Bᵀ d B, (a², P, C) with P = N·th·tw tiles, in fp32,
  then cast to the compute dtype;
- the a² batched product M = V·U with U the transformed weight (a², C,
  O), fp32 out whatever the operands' dtype (JAX's
  preferred_element_type=float32: keeping M in fp32 took the bf16 error
  of F(4,3) from 2.1% to 1.7%, convnets_tpu/ops/winograd.py:146-151);
- the output transform y = Aᵀ M A in fp32, the bias added in fp32, one
  cast, the bottom and right tile-rounding pad cropped off.

`conv2d_winograd_plain` is that composition with the JAX package's
rounding points; the CPU runs it and it is the card's reference. On the
card the two transforms are the kernels of ops/kernels/winograd.py
(csrc/winograd.cu) and the product a batched cuBLAS call, as the JAX
package leaves its einsum to XLA. `conv2d_winograd` is the public entry
(the JAX function's signature): the kernels for a CUDA tensor, the plain
composition for a CPU one.

Gate (read on every forward call by nn/layers.py Conv2d and ConvBNReLU,
so a CUDA-graph capture freezes what it read):
  CONVNETS_TPU_WINOGRAD = "0"/unset → off (the direct conv kernels)
                          "2" / "4" → F(2,3) / F(4,3) wherever it fits
                          "auto"    → the per-shape table (`route`)
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# Lavin & Gray transforms, exact in float64 (cast to fp32 where used).
_BT = {
    2: np.array(
        [[1, 0, -1, 0],
         [0, 1, 1, 0],
         [0, -1, 1, 0],
         [0, 1, 0, -1]], np.float64),
    4: np.array(
        [[4, 0, -5, 0, 1, 0],
         [0, -4, -4, 1, 1, 0],
         [0, 4, -4, -1, 1, 0],
         [0, -2, -1, 2, 1, 0],
         [0, 2, -1, -2, 1, 0],
         [0, 4, 0, -5, 0, 1]], np.float64),
}
_G = {
    2: np.array(
        [[1, 0, 0],
         [0.5, 0.5, 0.5],
         [0.5, -0.5, 0.5],
         [0, 0, 1]], np.float64),
    4: np.array(
        [[1 / 4, 0, 0],
         [-1 / 6, -1 / 6, -1 / 6],
         [-1 / 6, 1 / 6, -1 / 6],
         [1 / 24, 1 / 12, 1 / 6],
         [1 / 24, -1 / 12, 1 / 6],
         [0, 0, 1]], np.float64),
}
_AT = {
    2: np.array(
        [[1, 1, 1, 0],
         [0, 1, -1, -1]], np.float64),
    4: np.array(
        [[1, 1, 1, 1, 1, 0],
         [0, 1, -1, 2, -2, 0],
         [0, 1, 1, 4, 4, 0],
         [0, 1, -1, 8, -8, 1]], np.float64),
}


_TABLES = {"BT": _BT, "G": _G, "AT": _AT}
_ON_DEVICE: dict = {}


def _mat(name: str, m: int, device) -> torch.Tensor:
    """Bᵀ, G or Aᵀ of F(m,3) in fp32 on `device`. All six are copied there
    together at the first request, and kept: a CUDA-graph capture refuses
    a copy from pageable host memory, and a capture follows an eager
    step."""
    device = torch.device(device)
    if device not in _ON_DEVICE:
        _ON_DEVICE[device] = {(k, mm): torch.tensor(t[mm], dtype=torch.float32, device=device)
                              for k, t in _TABLES.items() for mm in t}
    return _ON_DEVICE[device][(name, m)]


def fits(kernel, stride, dilation, groups) -> bool:
    """The envelope Winograd F(m,3) covers: dense 3x3 stride-1 conv."""
    return (tuple(kernel) == (3, 3) and tuple(stride) == (1, 1)
            and tuple(dilation) == (1, 1) and groups == 1)


# measured per-shape table for mode "auto": (H, Cin, Cout) → m or None;
# empty, as the JAX package's (entries come only from whole-step A/Bs)
_AUTO_TABLE: dict = {}
_AUTO_DEFAULT_M = None


def _env_table():
    """CONVNETS_TPU_WINOGRAD_TABLE='{"h,cin,cout": m}' overrides the auto
    table (the JAX package's experiment hook)."""
    raw = os.environ.get("CONVNETS_TPU_WINOGRAD_TABLE")
    if not raw:
        return None
    table = {}
    for k, v in json.loads(raw).items():
        h, cin, cout = (int(t) for t in k.split(","))
        table[(h, cin, cout)] = int(v)
    return table


def route(h: int, cin: int, cout: int):
    """Tile size to use for this shape, or None for the direct conv."""
    mode = os.environ.get("CONVNETS_TPU_WINOGRAD", "0").strip().lower()
    if mode in ("", "0", "off"):
        return None
    if mode in ("2", "4"):
        return int(mode)
    if mode == "auto":
        table = _env_table()
        if table is not None:
            return table.get((h, cin, cout))
        return _AUTO_TABLE.get((h, cin, cout), _AUTO_DEFAULT_M)
    return None


def tiling(h: int, w: int, padding, m: int):
    """(oh, ow, th, tw): the output size of a 3x3 stride-1 conv and the
    m×m tiles that cover it (the last ones reach past it)."""
    ph, pw = padding
    oh, ow = h + 2 * ph - 2, w + 2 * pw - 2
    if oh < 1 or ow < 1:
        raise ValueError(f"winograd: input {h}x{w} with padding {padding} gives no output")
    return oh, ow, -(-oh // m), -(-ow // m)


def transform_weight(w: torch.Tensor, m: int, compute_dtype) -> torch.Tensor:
    """(3, 3, C, O) → (a, a, C, O) in compute_dtype; transform in fp32."""
    g = _mat("G", m, w.device)
    return torch.einsum("ak,bl,klco->abco", g, g, w.float()).to(compute_dtype)


def input_transform_plain(x: torch.Tensor, m: int, padding) -> torch.Tensor:
    """x (N, H, W, C) → V (a², N·th·tw, C) in x.dtype: the conv padding on
    all sides and the tile-rounding pad at the bottom and right as zeros,
    Bᵀ d B in fp32, one cast."""
    ph, pw = padding
    n, h, w, c = x.shape
    _, _, th, tw = tiling(h, w, padding, m)
    a = m + 2
    eh, ew = th * m + 2 - (h + 2 * ph), tw * m + 2 - (w + 2 * pw)
    xp = torch.nn.functional.pad(x, (0, 0, pw, pw + ew, ph, ph + eh))
    tiles = torch.stack([torch.stack([xp[:, i:i + (th - 1) * m + 1:m, j:j + (tw - 1) * m + 1:m]
                                      for j in range(a)]) for i in range(a)]).float()
    bt = _mat("BT", m, x.device)
    v = torch.einsum("ai,bj,ijnpqc->abnpqc", bt, bt, tiles).to(x.dtype)
    return v.reshape(a * a, n * th * tw, c)


def batched_product(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """M = V·U, (a², P, C) × (a², C, O) → (a², P, O) fp32. bf16 operands
    give their exact products summed in fp32 (never a bf16 M); fp32 ones an
    fp32 product (TF32 only if the caller enabled it for matmuls)."""
    if v.dtype == torch.float32:
        return torch.bmm(v, u)
    if v.device.type == "cuda":
        return torch.bmm(v, u, out_dtype=torch.float32)
    return torch.bmm(v.float(), u.float())


def output_transform_plain(mm: torch.Tensor, n: int, oh: int, ow: int, m: int, dtype,
                           bias=None, scale=None, shift=None, relu: bool = False):
    """M (a², P, O) fp32 → y (N, oh, ow, O) in `dtype`: Aᵀ M A in fp32,
    cropped to the valid outputs, then in fp32 either + bias (fp32 of the
    given vector) or ·scale + shift, then ReLU if asked, then one cast."""
    a = m + 2
    th, tw = -(-oh // m), -(-ow // m)
    o = mm.shape[-1]
    at = _mat("AT", m, mm.device)
    y = torch.einsum("xa,yb,abnpqo->npxqyo", at, at, mm.reshape(a, a, n, th, tw, o))
    y = y.reshape(n, th * m, tw * m, o)[:, :oh, :ow, :]
    if bias is not None:
        y = y + bias.float()
    if scale is not None:
        y = y * scale.float() + shift.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(dtype)


def conv2d_winograd_plain(x: torch.Tensor, w: torch.Tensor, b=None, *, padding=0,
                          m: int = 4, scale=None, shift=None, relu: bool = False) -> torch.Tensor:
    """3x3 stride-1 dense conv through Winograd F(m,3) in plain PyTorch,
    convnets_tpu/ops/winograd.py:conv2d_winograd's rounding points: V and
    U in x.dtype from fp32 transforms, M fp32, the output transform and
    the bias (b rounded to x.dtype by the caller, as the JAX layer does)
    in fp32, one cast. x (N, H, W, C); w (3, 3, C, O); padding int or
    (ph, pw). scale/shift/relu: the folded-BN epilogue of
    output_transform_plain in place of the bias (no JAX counterpart)."""
    ph, pw = (padding, padding) if isinstance(padding, int) else tuple(padding)
    n, h, wd, _ = x.shape
    oh, ow, _, _ = tiling(h, wd, (ph, pw), m)
    v = input_transform_plain(x, m, (ph, pw))
    a = m + 2
    u = transform_weight(w, m, x.dtype).reshape(a * a, w.shape[2], w.shape[3])
    return output_transform_plain(batched_product(v, u), n, oh, ow, m, x.dtype, b, scale, shift,
                                  relu)


def conv2d_winograd(x: torch.Tensor, w: torch.Tensor, b=None, *, padding=0,
                    m: int = 4) -> torch.Tensor:
    """3x3 stride-1 dense conv via Winograd F(m,3)
    (convnets_tpu/ops/winograd.py:conv2d_winograd): ops.conv2d(x, w, b,
    padding=padding)'s semantics. x (N, H, W, C); w (3, 3, C, O); b (O,)
    or None, added in fp32 before the one cast to x.dtype; padding int or
    (ph, pw). A CUDA tensor runs the Winograd kernels
    (ops/kernels/winograd.py:winograd_conv2d: the input kernel, the
    batched product, the output kernel with the bias in its epilogue), a
    CPU one `conv2d_winograd_plain`; neither falls back to a direct conv.
    A weight that is not (3, 3, C, O) raises ValueError, as JAX's einsum
    does (JAX broadcasts a 1x1 weight where the port raises), and so does
    an m other than 2 or 4 (a KeyError of JAX's table there)."""
    if w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[-1]:
        raise ValueError(f"conv2d_winograd: weight {tuple(w.shape)} for input "
                         f"{tuple(x.shape)}: (3, 3, Cin, Cout)")
    if m not in _BT:
        raise ValueError(f"conv2d_winograd: m={m} (F(2,3) or F(4,3))")
    if x.device.type == "cpu":
        return conv2d_winograd_plain(x, w, b, padding=padding, m=m)
    from convnets_tpu_torch.ops import kernels

    return kernels.winograd_conv2d(x, w, b, padding=padding, m=m)
