"""The random streams that decide a train run's inputs, worked out by the
benchmark itself: which rows each step trains on and which of the head's
inputs dropout keeps. Both follow the rules the program states for them
(a seeded permutation per epoch; a generator per (epoch, step) seeded by
a fixed hash), written again here so that the reference does not take
them from the program.
"""

from __future__ import annotations

import numpy as np
import torch

DROPOUT_STREAM = 1  # the stream id of dropout masks


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The split's row order in `epoch` (counted from 0) of a shuffling
    loader seeded with `seed`."""
    return np.random.RandomState((seed + epoch) % (2 ** 31)).permutation(n)


def stream_seed(seed: int, stream: int, *index: int) -> int:
    """The seed of the generator of (seed, stream, index...): numpy's
    SeedSequence over those numbers, two 32-bit words folded into one."""
    state = np.random.SeedSequence([int(seed), int(stream), *(int(i) for i in index)]) \
        .generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def dropout_keep(shape, rate: float, seed: int, epoch: int, step: int, device,
                 rank: int = 0) -> torch.Tensor:
    """The keep mask of the head's dropout at (epoch, step) on data rank
    `rank`."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, DROPOUT_STREAM, epoch,
                                                               step, rank))
    return torch.rand(shape, generator=g, device=device) < 1.0 - rate
