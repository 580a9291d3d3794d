"""Serving forward and ServingModel (counterpart of convnets_tpu/serve/export.py).

The served program is the eval forward: NHWC input — fp32 pixels in
[0, 1], or raw uint8 (the wire format, dequantized by ·1/255 on the
device) — then an optional baked per-channel normalization, the model in
its compute dtype, and fp32 logits or softmax probabilities out.

ServingModel wraps a live port model; the single-file artifact
(save_artifact / load_artifact) is ROADMAP.md modules item 8.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from convnets_tpu_torch.ops import softmax


def serving_forward(model, output: str = "logits",
                    stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                    input_dtype: str = "float32"):
    """Return forward(x) for the model's current device and weights."""
    if output not in ("logits", "probs"):
        raise ValueError(f"output must be 'logits' or 'probs', got {output!r}")
    if input_dtype not in ("float32", "uint8"):
        raise ValueError(f"input_dtype must be 'float32' or 'uint8', got {input_dtype!r}")
    device = next(model.parameters()).device
    compute_dtype = model.policy.compute_dtype
    if stats is not None:
        mean, std = (torch.as_tensor(np.asarray(s, np.float32).reshape(1, 1, 1, -1),
                                     device=device) for s in stats)
    else:
        mean = std = None

    def forward(x):
        # the request crosses to the device in its own dtype (a uint8 wire
        # moves 1 byte per value), then is converted there, as
        # convnets_tpu/serve/export.py:84 dequantizes in the graph
        x = x.to(device).float()
        if input_dtype == "uint8":
            x = x * (1.0 / 255.0)
        if mean is not None:
            x = (x - mean) / std
        y = model.module(x.to(compute_dtype)).float()
        if output == "probs":
            y = softmax(y, dim=-1)
        return y

    return forward


class ServingModel:
    """``__call__`` runs the serving forward on a batch (a single HWC image
    gains a batch axis); ``predict`` returns class indices, or names when
    the model carries them.

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
        self.model = model.eval()
        self._forward = serving_forward(model, output, stats, input_dtype)
        # the JAX artifact's metadata keys, with torch_version for jax_version
        self.meta = {
            "format": 1,
            "model_name": model.model_name,
            "arch_kind": str(model.setting.kind),
            "input_size_chw": list(model.setting.input_size),
            "input_layout": "NHWC",
            "input_dtype": input_dtype,
            "num_classes": int(model.setting.num_classes),
            "output": output,
            "batch": "symbolic",  # any batch size is served
            "platforms": [next(model.parameters()).device.type],
            "normalization_baked": stats is not None,
            "class_names": list(class_names) if class_names else None,
            "torch_version": torch.__version__,
        }

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
            return self._forward(x)

    def predict(self, x):
        idx = torch.argmax(self(x), dim=-1).cpu().numpy()
        names = self.meta.get("class_names")
        if names:
            return [names[i] for i in idx]
        return idx
