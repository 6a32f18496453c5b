"""The 95th percentile (nearest rank) of the wall time of every call in
the window, from its issue to its results on the host."""

import math


def read(ctx):
    if not ctx.call_s:
        return None
    ordered = sorted(ctx.call_s)
    return ordered[math.ceil(0.95 * len(ordered)) - 1] * 1e3
