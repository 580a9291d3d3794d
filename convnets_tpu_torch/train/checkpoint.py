"""Read side of the JAX checkpoint format (counterpart of
convnets_tpu/train/checkpoint.py:load_checkpoint).

A `.ckpt.npz` holds arrays under 'arr/<tree path>' keys ('/'-joined) and
JSON metadata under '__meta__'. Only numpy is needed to read it. Writing
checkpoints and resuming training is ROADMAP.md modules item 6.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def unflatten_tree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_jax_checkpoint(path: str) -> dict:
    """{'params': tree, 'state': tree} of numpy arrays — the model variables
    of a checkpoint written by convnets_tpu, ready for
    `bridge.load_jax_variables`."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    with np.load(path, allow_pickle=False) as z:
        flat = {k[len("arr/"):]: z[k] for k in z.files if k.startswith("arr/")}
    nested = unflatten_tree(flat)
    return {"params": nested.get("params", {}), "state": nested.get("model_state", {})}
