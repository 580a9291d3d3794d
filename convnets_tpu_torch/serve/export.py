"""The single-file serving artifact, built on `torch.export`, and
ServingModel, which serves a live model or a loaded artifact
(counterpart of convnets_tpu/serve/export.py).

What is served: the eval forward (`_ServingForward`). NHWC input — fp32
pixels in [0, 1], or raw uint8 (the wire format, dequantized by ·1/255 on
the device) — then an optional baked per-channel normalization, the model
in its compute dtype, and fp32 logits or softmax probabilities out. Every
conv and pool of the model is a custom op of ops/kernels/library.py, so
the traced program names the kernels, and each picks its plan when it
runs, from that call's batch: one artifact serves any batch size with the
plan of each.

The export is `torch.export.export` of that forward, non-strict, in eval
mode under no_grad, with the batch a `torch.export.Dim` unless
`batch_size` fixes it; the weights travel inside the program.

Artifact layout (single file)::

    CONVNETS_TORCH_EXPORT\\x00 | u32 meta_len (little-endian) | meta JSON (utf-8) | payload

where payload is the `torch.export.save` bytes. The metadata has the JAX
package's keys (`torch_version` in place of `jax_version`), the input
contract (the wire, and whether the host must normalize, with what), and
the payload's length and sha256, which `load_artifact` checks.
`load_artifact` needs no model code: it imports the op library, never
`convnets_tpu_torch.models`.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from convnets_tpu_torch.data.datasets import CINIC_MEAN, CINIC_STD
from convnets_tpu_torch.ops import softmax
from convnets_tpu_torch.ops.kernels import library  # noqa: F401  (the program's ops)

MAGIC = b"CONVNETS_TORCH_EXPORT\x00"


def _check_choices(output: str, input_dtype: str) -> None:
    if output not in ("logits", "probs"):
        raise ValueError(f"output must be 'logits' or 'probs', got {output!r}")
    if input_dtype not in ("float32", "uint8"):
        raise ValueError(f"input_dtype must be 'float32' or 'uint8', got {input_dtype!r}")


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


class _ServingForward(torch.nn.Module):
    """The served program: the request's dtype to fp32 (·1/255 for a uint8
    wire, as convnets_tpu/serve/export.py:55-58), the baked mean/std
    (:59-60), the model in its compute dtype, fp32 logits or probabilities
    (:63-66)."""

    def __init__(self, model, output: str, stats, input_dtype: str):
        super().__init__()
        self.net = model.module
        self.compute_dtype = model.policy.compute_dtype
        self.output = output
        self.uint8 = input_dtype == "uint8"
        device = _device_of(model)
        for name, value in zip(("mean", "std"), stats if stats is not None else (None, None)):
            self.register_buffer(name, None if value is None else torch.as_tensor(
                np.asarray(value, np.float32).reshape(1, 1, 1, -1), device=device))

    def forward(self, x):
        x = x.float()
        if self.uint8:
            x = x * (1.0 / 255.0)
        if self.mean is not None:
            x = (x - self.mean) / self.std
        y = self.net(x.to(self.compute_dtype)).float()
        if self.output == "probs":
            y = softmax(y, axis=-1)
        return y


def _metadata(model, *, output: str, batch_size, platforms, class_names=None, stats=None,
              input_dtype: str = "float32", norm_stats=None) -> dict:
    """The JAX artifact's keys (export.py:105-122), torch_version for
    jax_version, and the input contract: a model trained with data_norm
    whose normalization is not baked expects the host to apply
    `norm_stats` (default CINIC-10's, the Trainer's default)."""
    setting = model.setting
    data_norm = bool(getattr(setting, "data_norm", False))
    host_norm = None
    if data_norm and stats is None:
        # CINIC-10's: the Trainer's normalization when its dataset carries none
        mean, std = (CINIC_MEAN, CINIC_STD) if norm_stats is None else norm_stats
        host_norm = {"mean": [float(v) for v in np.ravel(mean)],
                     "std": [float(v) for v in np.ravel(std)]}
    return {
        "format": 1,
        "model_name": model.model_name,
        "arch_kind": str(setting.kind),
        "input_size_chw": list(setting.input_size),
        "input_layout": "NHWC",
        "input_dtype": input_dtype,
        "num_classes": int(setting.num_classes),
        "output": output,
        "batch": "symbolic" if batch_size is None else int(batch_size),
        "platforms": list(platforms),
        "normalization_baked": stats is not None,
        "class_names": list(class_names) if class_names else None,
        "torch_version": torch.__version__,
        "input_contract": {
            "layout": "NHWC", "dtype": input_dtype,
            "range": [0, 255] if input_dtype == "uint8" else [0.0, 1.0],
            "data_norm": data_norm, "normalization_baked": stats is not None,
            "host_normalization": host_norm},
    }


class ServingModel:
    """``__call__`` runs the serving forward on a batch (a single HWC image
    gains a batch axis) on the serving device; ``predict`` returns class
    indices, or names when the model carries them. Built from a live port
    model (``ServingModel(model, ...)``) or from a loaded artifact
    (``load_artifact``); both run the same forward.

    A request must match the wire dtype: a uint8 wire takes only uint8
    arrays, a float32 wire only floating ones (float64 and float16 are cast
    to float32); anything else raises TypeError. This deliberately differs
    from convnets_tpu/serve/export.py:163-166, which casts silently, cutting
    [0, 1] floats to 0/1 on a uint8 wire and passing 0-255 integers without
    the /255 on a float wire (ADVICE.md finding 1)."""

    def __init__(self, model, *, output: str = "logits",
                 stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 input_dtype: str = "float32",
                 class_names: Optional[Sequence[str]] = None):
        _check_choices(output, input_dtype)
        self.model = model.eval()
        self.device = _device_of(model)
        self._forward = _ServingForward(model, output, stats, input_dtype).eval()
        self.meta = _metadata(model, output=output, batch_size=None,
                              platforms=[self.device.type], class_names=class_names,
                              stats=stats, input_dtype=input_dtype)

    @classmethod
    def from_program(cls, program: torch.export.ExportedProgram, meta: dict,
                     device) -> "ServingModel":
        """Serve a loaded program on `device` (where its constants lie)."""
        self = cls.__new__(cls)
        self.model = None
        self.device = torch.device(device)
        self._forward = program.module()
        self.meta = meta
        return self

    def __call__(self, x):
        x = torch.as_tensor(x)
        if self.meta["input_dtype"] == "uint8":
            if x.dtype != torch.uint8:
                raise TypeError(f"this model serves uint8 requests, got {x.dtype}")
        elif x.is_floating_point():
            x = x.to(torch.float32)
        else:
            raise TypeError(f"this model serves float32 requests in [0, 1], got {x.dtype}")
        if x.ndim == 3:
            x = x[None]
        with torch.inference_mode():
            # the request crosses to the device in its own dtype (a uint8
            # wire moves 1 byte per value); the forward converts it there
            return self._forward(x.to(self.device))

    def predict(self, x):
        idx = torch.argmax(self(x), dim=-1).cpu().numpy()
        names = self.meta.get("class_names")
        if names:
            return [names[i] for i in idx]
        return idx


def export_model(model, *, batch_size: Optional[int] = None, output: str = "logits",
                 stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 input_dtype: str = "float32") -> torch.export.ExportedProgram:
    """The serving forward of `model` (on its device, with its current
    weights) as a `torch.export.ExportedProgram`.

    batch_size None: a symbolic batch (the program serves any batch size).
    output: "logits" (fp32) or "probs" (softmax). stats: optional (mean,
    std) per-channel arrays baked into the program. input_dtype: "float32"
    ([0, 1] pixels) or "uint8" (raw bytes on the wire, ·1/255 in the
    program; with stats, the normalization follows the dequantization)."""
    _check_choices(output, input_dtype)
    c, h, w = model.setting.input_size
    dtype = torch.uint8 if input_dtype == "uint8" else torch.float32
    # an example batch of 2: at 1, export would specialize the batch to 1
    example = torch.zeros((batch_size or 2, h, w, c), dtype=dtype, device=_device_of(model))
    dynamic = None if batch_size is not None else {"x": {0: torch.export.Dim("batch", min=1)}}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(_ServingForward(model, output, stats, input_dtype),
                                       (example,), dynamic_shapes=dynamic, strict=False)
    finally:
        model.train(was_training)


def save_artifact(path: str, model, *, batch_size: Optional[int] = None,
                  output: str = "logits",
                  stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                  class_names: Optional[Sequence[str]] = None,
                  input_dtype: str = "float32", norm_stats=None) -> dict:
    """Export the model (export_model's arguments) and write the
    single-file artifact, published atomically. `norm_stats`: the (mean,
    std) the model was trained with, written into the input contract when
    it is not baked. Returns the metadata."""
    program = export_model(model, batch_size=batch_size, output=output, stats=stats,
                           input_dtype=input_dtype)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    payload = buf.getvalue()
    meta = _metadata(model, output=output, batch_size=batch_size,
                     platforms=[_device_of(model).type], class_names=class_names, stats=stats,
                     input_dtype=input_dtype, norm_stats=norm_stats)
    meta["payload_bytes"] = len(payload)
    meta["payload_sha256"] = hashlib.sha256(payload).hexdigest()
    meta_bytes = json.dumps(meta).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(meta_bytes)))
        f.write(meta_bytes)
        f.write(payload)
    os.replace(tmp, path)
    return meta


def read_artifact(path: str) -> Tuple[dict, bytes]:
    """(metadata, payload) of an artifact file, checked: the magic, the
    header and metadata lengths, and the payload's length and sha256. Any
    fault raises ValueError naming the path."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise ValueError(f"{path}: not a convnets_tpu_torch export artifact (bad magic)")
    off = len(MAGIC)
    if len(data) < off + 4:
        raise ValueError(f"{path}: truncated header ({len(data)} bytes)")
    (meta_len,) = struct.unpack_from("<I", data, off)
    off += 4
    if len(data) < off + meta_len:
        raise ValueError(f"{path}: truncated metadata ({len(data) - off} of {meta_len} bytes)")
    try:
        meta = json.loads(data[off:off + meta_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable metadata ({e})") from e
    if not isinstance(meta, dict) or "payload_sha256" not in meta:
        raise ValueError(f"{path}: metadata without the payload's checksum")
    payload = data[off + meta_len:]
    if len(payload) != meta.get("payload_bytes"):
        raise ValueError(f"{path}: payload of {len(payload)} bytes, the metadata says "
                         f"{meta.get('payload_bytes')} (truncated or appended)")
    if hashlib.sha256(payload).hexdigest() != meta["payload_sha256"]:
        raise ValueError(f"{path}: payload checksum mismatch (corrupted)")
    return meta, payload


def load_artifact(path: str, device=None) -> ServingModel:
    """A ServingModel over the artifact at `path`, on `device` (default:
    the card; raises without one). A program exported on another device
    has its constants moved (torch.export.passes.move_to_device_pass)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_artifact: no CUDA device; pass device='cpu' to serve "
                               "on the CPU")
        device = "cuda"
    device = torch.device(device)
    meta, payload = read_artifact(path)
    program = torch.export.load(io.BytesIO(payload))
    if meta["platforms"] != [device.type]:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return ServingModel.from_program(program, meta, device)


def export_trainer(trainer, path: str, *, batch_size: Optional[int] = None,
                   output: str = "logits",
                   stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   class_names: Optional[Sequence[str]] = None,
                   input_dtype: str = "float32") -> dict:
    """Export a Trainer's current (typically checkpoint-loaded) model. The
    input contract's normalization is that of the train loader fit() last
    fed, else the Trainer's default."""
    names = class_names if class_names is not None else getattr(trainer, "class_names", None)
    loaders = getattr(trainer, "_fit_loaders", None) or {}
    norm_stats = trainer._resolve_stats(loaders["train"]) if "train" in loaders else None
    return save_artifact(path, trainer.model, batch_size=batch_size, output=output, stats=stats,
                         class_names=names, input_dtype=input_dtype, norm_stats=norm_stats)
