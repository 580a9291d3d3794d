"""mfu.serve: the traced slice's served images/s x the forward's operations
per image (work.py) over the bf16 peak."""

import readers
import work


def read(sl, ctx):
    return readers.mfu_pct(sl, work.forward_flops_per_image(ctx["cfg"]), ctx["peaks"])
