"""The byzantine-frame ``round_kernel``'s share of its roofline: the least
time one launch needs (``bounds/round_kernel_byz.py``, the H100's published
peaks) over the mean device time of the ``round_kernel<true, true, ...>``
launches in the traced window (the other variants are left out)."""

import re

from gossipbench.bounds import round_kernel_byz

BYZ = re.compile(r"\bround_kernel<true,\s*true,")


def read(ctx):
    times = [e - s for s, e, name in ctx.dev if BYZ.search(name)]
    if not times:
        return None
    least = round_kernel_byz.bound_s(ctx.cfg, ctx.traffic, ctx.n)
    return 100.0 * least / (sum(times) / len(times) * 1e-6)
