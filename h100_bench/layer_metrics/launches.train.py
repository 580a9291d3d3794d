"""launches.train: device kernels per train step in the traced slice."""

import readers


def read(sl, ctx):
    return readers.kernels_per_step(sl)
