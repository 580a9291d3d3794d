"""mfu.train: the traced slice's images/s x 3 x the forward's operations per
image (work.py, from the configuration; no recompute) over the bf16 peak."""

import readers
import work


def read(sl, ctx):
    return readers.mfu_pct(sl, work.train_flops_per_image(ctx["cfg"]), ctx["peaks"])
