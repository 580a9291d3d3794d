"""Random-number streams (counterpart of convnets_tpu/core/rng.py:key_for).

The JAX package folds a root key per purpose and per index
(`fold_in(fold_in(key(seed), stream), *extra)`). The port's counterpart is
a `torch.Generator` seeded by a fixed function of the same numbers, so one
(seed, stream, indices) always gives the same draws on one device. The
draws cannot equal JAX's bits: the generators differ.
"""

from __future__ import annotations

import numpy as np
import torch

# the stream ids of convnets_tpu/core/rng.py:_STREAMS
_STREAMS = {
    "init": 0,
    "dropout": 1,
    "data": 2,
    "augment": 3,
    "tune": 4,
    "bench": 5,
    "bn_reestimate": 6,
    "eval": 7,
}


def generator_for(seed: int, stream: str, *extra: int, device="cpu") -> torch.Generator:
    """A torch.Generator on `device` for a named stream (plus optional
    indices): the port's `key_for`. Its seed is a fixed hash of the numbers
    (numpy's SeedSequence over seed, the stream's id and the indices). The
    Trainer's dropout generator for step s of global epoch e is
    generator_for(seed, "dropout", e, s)."""
    entropy = [int(seed), _STREAMS[stream], *(int(e) for e in extra)]
    if any(v < 0 for v in entropy):
        raise ValueError(f"stream numbers must be non-negative, got {entropy}")
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(state[0]) << 31) ^ int(state[1]))
