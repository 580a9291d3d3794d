"""idle_share.serve: the share of a traced serving slice in which no kernel or
copy ran on the device (1 - the union of busy spans over the slice)."""

import readers


def read(sl, ctx):
    return readers.idle_share_pct(sl)
