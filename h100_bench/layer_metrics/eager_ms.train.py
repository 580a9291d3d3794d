"""eager_ms.train: device ms per train step in kernels that are neither the
port's (kernel_groups/port) nor cuDNN's or cuBLAS's (kernel_groups/library):
the eager adds, casts, dropout and Adam."""

import readers


def read(sl, ctx):
    return readers.eager_ms_per_step(sl)
