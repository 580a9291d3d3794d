"""Checkpoints in the JAX package's format (counterpart of
convnets_tpu/train/checkpoint.py).

One versioned, full-state file per checkpoint,
`<output_dir>/<ModelName><kind>-<unix-ts-version>-<suffix>.ckpt.npz`
(suffix best_loss, best_score or tuned): a numpy .npz whose arrays sit
under 'arr/<tree path>' keys ('/'-joined) and whose JSON metadata sits
under '__meta__'. The trees are the JAX package's, key for key: the port's
parameters, BN running statistics and optimizer state cross through
`bridge.export_jax_variables` / `export_jax_opt_state` on the way out and
`load_jax_variables` / `load_jax_opt_state` on the way in, so a file either
package writes resumes in the other. Only numpy and torch are needed.
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from convnets_tpu_torch import bridge
from convnets_tpu_torch.train import optim

SUFFIX_BEST_LOSS = "best_loss"
SUFFIX_BEST_SCORE = "best_score"
SUFFIX_TUNED = "tuned"
EXT = ".ckpt.npz"
FORMAT_VERSION = 1


def flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple (AdamState etc.)
        for k in tree._fields:
            out.update(flatten_tree(getattr(tree, k), f"{prefix}{k}/"))
    elif tree is None:
        pass
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def checkpoint_path(output_dir: str, model_name: str, version: int, suffix: str) -> str:
    return os.path.join(output_dir, f"{model_name}-{version}-{suffix}{EXT}")


def save_checkpoint(path: str, *, params, model_state, opt_state, lr, loss_scale,
                    epoch_results: dict, settings_dict: dict, scheduler_state: dict,
                    optimizer_name: str, extra: dict | None = None) -> str:
    """Write numpy trees (the JAX layout) and the metadata to `path`,
    published atomically (a tmp file, then os.replace)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for name, tree in (("params", params), ("model_state", model_state),
                       ("opt_state", opt_state)):
        for k, v in flatten_tree(tree, f"{name}/").items():
            arrays["arr/" + k] = v
    arrays["arr/lr"] = np.asarray(lr, np.float32)
    arrays["arr/loss_scale"] = np.asarray(loss_scale, np.float32)

    meta = {
        "epoch_results": epoch_results,
        "settings": _jsonable(settings_dict),
        "scheduler": scheduler_state,
        "optimizer": optimizer_name,
        "extra": _jsonable(extra or {}),
        "format_version": FORMAT_VERSION,
    }
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
             **arrays)
    # atomic publish: the write may run on the async checkpoint thread
    # while other processes (resume scripts, scans of the output dir) read
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """Returns (trees, meta): trees has params/model_state/opt_state/lr/loss_scale
    as numpy."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k[len("arr/"):]: z[k] for k in z.files if k.startswith("arr/")}
    nested = unflatten_tree(flat)
    trees = {
        "params": nested.get("params", {}),
        "model_state": nested.get("model_state", {}),
        "opt_state": nested.get("opt_state", {}),
        "lr": nested.get("lr"),
        "loss_scale": nested.get("loss_scale"),
    }
    return trees, meta


def load_jax_checkpoint(path: str) -> dict:
    """{'params': tree, 'state': tree} of numpy arrays — the model variables
    of a checkpoint written by either package, ready for
    `bridge.load_jax_variables`."""
    trees, _ = load_checkpoint(path)
    return {"params": trees["params"], "state": trees["model_state"]}


def rebuild_opt_state(model, nested: dict, optimizer_name: str):
    """The port's optimizer NamedTuple from a checkpoint's opt_state tree,
    its tensors fp32 on the model's device."""
    fields = bridge.load_jax_opt_state(model, nested)
    if optimizer_name == "adam":
        return optim.AdamState(count=fields["count"], mu=fields["mu"], nu=fields["nu"])
    if optimizer_name == "sgd":
        return optim.SGDState(momentum=fields["momentum"])
    raise ValueError(optimizer_name)


def state_tensors(state, clone: bool) -> dict:
    """What a checkpoint holds of a TrainState, as tensors on the model's
    device: {"variables": {JAX path: tensor}, "opt_state": {field: {name:
    tensor} or int}, "lr", "loss_scale"}. clone=True copies every tensor
    (on the current stream), so the result stays what it was when the
    train step later overwrites the live tensors in place."""
    def take(t):
        return t.detach().clone() if clone else t.detach()

    opt = {k: ({n: take(t) for n, t in v.items()} if isinstance(v, dict) else int(v))
           for k, v in state.opt_state._asdict().items()}
    return {"variables": {path: take(getattr(mod, tname))
                          for path, (mod, tname) in bridge.jax_layout(state.model).items()},
            "opt_state": opt, "lr": float(state.lr),
            "loss_scale": float(state.loss_scale.scale)}


def state_arrays(model, tensors: dict) -> dict:
    """`state_tensors`' result as the numpy trees save_checkpoint takes
    (params, model_state, opt_state, lr, loss_scale); the device-to-host
    copies happen here."""
    variables = bridge.export_jax_variables(model, tensors["variables"])
    return {"params": variables["params"], "model_state": variables["state"],
            "opt_state": bridge.export_jax_opt_state(model, tensors["opt_state"]),
            "lr": np.float32(tensors["lr"]), "loss_scale": np.float32(tensors["loss_scale"])}


def get_last_checkpoint(output_dir: str, model_name: str) -> str | None:
    """Highest-version checkpoint for this model (reference basemodel.py:892-915)."""
    if not os.path.isdir(output_dir):
        return None
    pat = re.compile(re.escape(model_name) + r"-(\d+)-(\w+)" + re.escape(EXT) + "$")
    best = None
    for fname in os.listdir(output_dir):
        m = pat.match(fname)
        if m:
            version = int(m.group(1))
            if best is None or version > best[0]:
                best = (version, os.path.join(output_dir, fname))
    return best[1] if best else None


def average_trees(trees):
    """Uniform average of same-structure trees of arrays (SWA-style tail
    averaging of the cosine endgame; Izmailov et al. 2018). Integer leaves
    (e.g. step counters) are taken from the first tree. Averaged BN running
    stats are NOT meaningful for averaged weights — re-estimate them with
    Trainer.reestimate_bn afterwards."""
    if not trees:
        raise ValueError("average_trees() needs at least one tree")
    flats = [flatten_tree(t) for t in trees]
    keys = flats[0].keys()
    out = {}
    for k in keys:
        first = np.asarray(flats[0][k])
        if np.issubdtype(first.dtype, np.integer):
            out[k] = first
        else:
            acc = np.zeros(first.shape, np.float64)
            for f in flats:
                acc += np.asarray(f[k], np.float64)
            out[k] = (acc / len(flats)).astype(first.dtype)
    return unflatten_tree(out)


def ema_trees(trees, decay=0.9):
    """Exponentially-weighted average of an ordered sequence of trees
    (oldest first): ema <- decay*ema + (1-decay)*tree. A recency-weighted
    variant of `average_trees` for cosine-tail snapshot averaging — later
    snapshots (lower lr, flatter minima) dominate. Integer leaves are taken
    from the LAST tree (freshest step counters). Re-estimate BN running
    stats afterwards, same as `average_trees`."""
    if not trees:
        raise ValueError("ema_trees() needs at least one tree")
    if not (0.0 <= decay < 1.0):
        raise ValueError(f"decay must be in [0, 1), got {decay}")
    flats = [flatten_tree(t) for t in trees]
    out = {}
    for k in flats[0].keys():
        last = np.asarray(flats[-1][k])
        if np.issubdtype(last.dtype, np.integer):
            out[k] = last
        else:
            acc = np.asarray(flats[0][k], np.float64)
            for f in flats[1:]:
                acc = decay * acc + (1.0 - decay) * np.asarray(f[k], np.float64)
            out[k] = acc.astype(last.dtype)
    return unflatten_tree(out)


def _jsonable(obj: Any):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().tolist()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)  # distributions / device objects etc.
