"""Random-number streams (counterpart of convnets_tpu/core/rng.py:key_for).

The JAX package folds a root key per purpose and per index
(`fold_in(fold_in(key(seed), stream), *extra)`). The port's counterpart is
a `torch.Generator` seeded by a fixed function of the same numbers, so one
(seed, stream, indices) always gives the same draws on one device. The
draws cannot equal JAX's bits: the generators differ.
"""

from __future__ import annotations

import random

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
# the port's own streams, one per random purpose of the data side that the
# JAX package draws by splitting the step's augment key (engine.py:169,
# :218-219): the cutout squares and the mixup λ and permutation
_DATA_STREAMS = {"cutout": 8, "mixup": 9}


def seed_for(seed: int, stream: str, *extra: int) -> int:
    """The seed of generator_for(seed, stream, *extra): a fixed hash of the
    numbers (numpy's SeedSequence over seed, the stream's id and the
    indices)."""
    entropy = [int(seed), {**_STREAMS, **_DATA_STREAMS}[stream], *(int(e) for e in extra)]
    if any(v < 0 for v in entropy):
        raise ValueError(f"stream numbers must be non-negative, got {entropy}")
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator_for(seed: int, stream: str, *extra: int, device="cpu") -> torch.Generator:
    """A torch.Generator on `device` for a named stream (plus optional
    indices), seeded with seed_for(seed, stream, *extra): the port's
    `key_for`. The Trainer's dropout generator for step s of global epoch e
    is generator_for(seed, "dropout", e, s); its data side draws from the
    "augment", "cutout" and "mixup" streams at (e, s). numpy's
    SeedSequence ignores trailing zero indices: (seed, stream, 5) and
    (seed, stream, 5, 0) give the same generator, so no two index lists
    of one stream in use differ by trailing zeros alone."""
    return torch.Generator(device=device).manual_seed(seed_for(seed, stream, *extra))


class StepGenerators:
    """One long-lived generator per stream on `device`, for a step that is
    captured once and replayed (train/graph.py). `reseed(*index)` gives
    each the seed of generator_for(seed, stream, *index), which also
    restarts its offset at 0, so the draws of the next step or replay are
    those of that fresh generator. On the card the generators are
    registered with the graph before its capture (`register`): a replay
    then reads each one's seed and offset as they stand when it is
    launched."""

    def __init__(self, seed: int, streams, device):
        self.seed = int(seed)
        self.generators = {s: torch.Generator(device=device) for s in streams}

    def reseed(self, *index: int) -> None:
        for stream, g in self.generators.items():
            g.manual_seed(seed_for(self.seed, stream, *index))

    def register(self, graph) -> None:
        for g in self.generators.values():
            graph.register_generator_state(g)

    def __getitem__(self, stream: str) -> torch.Generator:
        return self.generators[stream]


def set_reproducible_mode(seed: int, deterministic: bool = False) -> None:
    """Seed the host RNGs (random, numpy) and torch's default generators.
    The port's own draws (dropout masks, augmentation) come from the
    streams above and do not depend on them; `deterministic` is the JAX
    package's argument, accepted and ignored as there."""
    del deterministic
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
