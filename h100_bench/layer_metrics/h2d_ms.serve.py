"""h2d_ms.serve: device ms per request of host-to-device copies."""

import readers


def read(sl, ctx):
    return readers.h2d_ms_per_request(sl)
