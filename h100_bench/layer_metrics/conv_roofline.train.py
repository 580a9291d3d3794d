"""conv_roofline.train: the sum of the train step's forward conv bounds
(work.py) over the device time of the port's conv kernels and the statistics
reductions that follow them."""

import readers


def read(sl, ctx):
    return readers.conv_roofline_pct(sl, ctx["cfg"], ctx["batch"], ctx["peaks"], True)
