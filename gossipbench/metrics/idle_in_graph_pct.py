"""100 x the device's idle time while the host is inside a
``GraphCache`` call (the program's ``sim.graph.call`` span: the key, the
copies into and out of the static buffers, the replay's launch, the
outputs' clones), over the traced stretch's extent on the profiler's
clock (``spans.py``)."""

from gossipbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "graph")
