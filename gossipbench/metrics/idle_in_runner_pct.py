"""100 x the device's idle time while the host is inside a runner's call
(``sim.runner.call``) but outside every ``sim.graph.call``: the runner's
prologue, epilogue and loop, over the traced stretch's extent on the
profiler's clock (``spans.py``)."""

from gossipbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "runner")
