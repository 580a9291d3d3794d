"""conv_roofline.serve: the sum of the served forward's conv bounds
(work.py) over the device time of the port's fused conv kernels."""

import readers


def read(sl, ctx):
    return readers.conv_roofline_pct(sl, ctx["cfg"], ctx["batch"], ctx["peaks"], False)
