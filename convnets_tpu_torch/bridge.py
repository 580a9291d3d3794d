"""JAX variables and optimizer state ↔ port tensors, matched by path.

The JAX package keeps a model's weights as `{"params": tree, "state":
tree}`: nested dicts keyed by child name ('0', '1', …), leaves named by
the layer ('w', 'b', 'scale', 'bias', 'mean', 'var'). The port names its
children the same way, and each layer's `JAX_LEAVES` says which JAX leaf
each of its tensors is, so the mapping is mechanical:

  Conv2d       weight (HWIO, kept as is)  ↔ params/…/w;  bias ↔ params/…/b
  Linear       weight ((in, out), as is)  ↔ params/…/w;  bias ↔ params/…/b
  BatchNorm2d  weight ↔ params/…/scale, bias ↔ params/…/bias,
               running_mean ↔ state/…/mean, running_var ↔ state/…/var

The JAX optimizer state's trees (Adam `mu`/`nu`, SGD `momentum`) have the
params tree's paths; the port's are dicts keyed by parameter name
(`named_parameters`). Adam's `count` is carried as is.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _root(model) -> torch.nn.Module:
    return getattr(model, "module", model)


def _walk(mod, prefix: Path = ()):
    yield prefix, mod
    for name, child in mod.named_children():
        yield from _walk(child, prefix if mod.JAX_TRANSPARENT else prefix + (name,))


def jax_layout(model) -> Dict[Path, Tuple[torch.nn.Module, str]]:
    """{("params" | "state", child, …, leaf): (port module, tensor name)}."""
    layout = {}
    for prefix, mod in _walk(_root(model)):
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


def _nest(flat: Dict[Path, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


def _match(layout_keys, flat_keys, what: str) -> None:
    unmapped = sorted("/".join(p) for p in flat_keys - layout_keys)
    missing = sorted("/".join(p) for p in layout_keys - flat_keys)
    if unmapped or missing:
        raise ValueError(f"{what} do not match the port model: "
                         f"unmapped leaves {unmapped[:8]}, missing leaves {missing[:8]}")


def _to_tensor(path: Path, arr, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(arr, dtype=np.float32)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape}, port shape "
                         f"{tuple(like.shape)}")
    return torch.tensor(arr)


def load_jax_variables(model, variables) -> None:
    """Copy `variables` ({"params", "state"} nested dicts of arrays) into the
    port model. Raises ValueError on a leaf the model has no tensor for, a
    tensor no leaf fills, or a shape that differs."""
    flat = _flatten({"params": variables.get("params", {}),
                     "state": variables.get("state", {})})
    layout = jax_layout(model)
    _match(layout.keys(), flat.keys(), "JAX variables")
    for path, (mod, tname) in layout.items():
        dst = getattr(mod, tname)
        src = _to_tensor(path, flat[path], dst)
        with torch.no_grad():
            dst.copy_(src)


def jax_tensors(model) -> dict:
    """The model's own tensors (not copies) as the JAX `{"params",
    "state"}` tree."""
    tree = _nest({path: getattr(mod, tname) for path, (mod, tname) in jax_layout(model).items()})
    return {"params": tree.get("params", {}), "state": tree.get("state", {})}


def export_jax_variables(model, tensors: Optional[Dict[Path, torch.Tensor]] = None) -> dict:
    """The port model's tensors as the JAX `{"params", "state"}` tree of
    fp32 numpy arrays (the inverse of load_jax_variables). tensors: {JAX
    path: tensor} to export instead of the live ones (copies taken
    earlier, as an asynchronous checkpoint takes them)."""
    if tensors is None:
        tensors = {path: getattr(mod, tname) for path, (mod, tname) in jax_layout(model).items()}
    flat = {path: t.detach().float().cpu().numpy() for path, t in tensors.items()}
    tree = _nest(flat)
    return {"params": tree.get("params", {}), "state": tree.get("state", {})}


def param_paths(model) -> Dict[str, Path]:
    """{port parameter name: its path in the JAX params tree}."""
    names = {id(p): name for name, p in model.named_parameters()}
    return {names[id(getattr(mod, tname))]: path[1:]
            for path, (mod, tname) in jax_layout(model).items() if path[0] == "params"}


_OPT_TREES = ("mu", "nu", "momentum")


def load_jax_opt_state(model, opt_state) -> dict:
    """A JAX AdamState / SGDState (or its `_asdict()`) → the port's fields:
    {"count": int, "mu": {name: tensor}, "nu": {…}} or {"momentum": {…}},
    tensors fp32 on the model's device."""
    fields = opt_state._asdict() if hasattr(opt_state, "_asdict") else dict(opt_state)
    paths = param_paths(model)
    params = dict(model.named_parameters())
    out = {}
    for key, value in fields.items():
        if key not in _OPT_TREES:
            out[key] = int(np.asarray(value))
            continue
        flat = _flatten(value)
        _match(set(paths.values()), flat.keys(), f"JAX optimizer state {key!r}")
        out[key] = {name: _to_tensor(path, flat[path], params[name]).to(params[name].device)
                    for name, path in paths.items()}
    return out


def export_jax_opt_state(model, opt_state) -> dict:
    """The port's optimizer state (a NamedTuple or dict of the fields
    load_jax_opt_state returns) → JAX-layout numpy trees; count as int32."""
    fields = opt_state._asdict() if hasattr(opt_state, "_asdict") else dict(opt_state)
    paths = param_paths(model)
    out = {}
    for key, value in fields.items():
        if key not in _OPT_TREES:
            out[key] = np.asarray(value, np.int32)
            continue
        out[key] = _nest({paths[name]: t.detach().float().cpu().numpy()
                          for name, t in value.items()})
    return out
