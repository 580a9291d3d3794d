"""cudnn_ms.train: device ms per train step in cuDNN's and cuBLAS's kernels
(kernel_groups/library): the trainable convs' backward and the head."""

import readers


def read(sl, ctx):
    return readers.library_ms_per_step(sl)
