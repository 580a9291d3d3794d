"""JAX variables → port parameters, matched by path.

The JAX package keeps a model's weights as `{"params": tree, "state":
tree}`: nested dicts keyed by child name ('0', '1', …), leaves named by
the layer ('w', 'b', 'scale', 'bias', 'mean', 'var'). The port names its
children the same way, and each layer's `JAX_LEAVES` says which JAX leaf
each of its tensors is, so the mapping is mechanical:

  Conv2d       weight (HWIO, kept as is)  ← params/…/w;  bias ← params/…/b
  Linear       weight ((in, out), as is)  ← params/…/w;  bias ← params/…/b
  BatchNorm2d  weight ← params/…/scale, bias ← params/…/bias,
               running_mean ← state/…/mean, running_var ← state/…/var
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _root(model) -> torch.nn.Module:
    return getattr(model, "module", model)


def jax_layout(model) -> Dict[Path, Tuple[torch.nn.Module, str]]:
    """{("params" | "state", child, …, leaf): (port module, tensor name)}."""
    layout = {}
    for mod_path, mod in _root(model).named_modules():
        prefix = tuple(mod_path.split(".")) if mod_path else ()
        for tname, (collection, leaf) in getattr(mod, "JAX_LEAVES", {}).items():
            if getattr(mod, tname, None) is not None:
                layout[(collection, *prefix, leaf)] = (mod, tname)
    return layout


def _flatten(tree, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def load_jax_variables(model, variables) -> None:
    """Copy `variables` ({"params", "state"} nested dicts of arrays) into the
    port model. Raises ValueError on a leaf the model has no tensor for, a
    tensor no leaf fills, or a shape that differs."""
    flat = _flatten({"params": variables.get("params", {}),
                     "state": variables.get("state", {})})
    layout = jax_layout(model)
    unmapped = sorted("/".join(p) for p in flat.keys() - layout.keys())
    missing = sorted("/".join(p) for p in layout.keys() - flat.keys())
    if unmapped or missing:
        raise ValueError(f"JAX variables do not match the port model: "
                         f"unmapped leaves {unmapped[:8]}, missing leaves {missing[:8]}")
    for path, (mod, tname) in layout.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        dst = getattr(mod, tname)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape}, "
                             f"port {tname} shape {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.tensor(arr))
