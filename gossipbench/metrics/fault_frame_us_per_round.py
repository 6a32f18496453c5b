"""Device microseconds a period of the fault frame's gathers: the
``index_select`` of one phase from the plan's packed lanes and masks
(``faults._frame``), which ATen runs as ``indexSelectSmallIndex`` (one
index), over the periods the traced window ran. In a replayed call they
sit inside the graph, where the host's spans end."""

import re

GATHER = re.compile(r"\bindexSelectSmallIndex<")


def read(ctx):
    if not ctx.traced_rounds:
        return None
    times = [e - s for s, e, name in ctx.dev if GATHER.search(name)]
    if not times:
        return None
    return sum(times) / ctx.traced_rounds
