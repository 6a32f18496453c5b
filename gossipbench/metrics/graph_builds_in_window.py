"""The ``GraphCache`` set-up calls in the traced stretch: a key's first,
eager call (``sim.graph.eager``) and its capture (``sim.graph.capture``).
The warm-up makes every graph a cell uses, so anything but 0 is set-up
leaking into the measured window (``spans.py``)."""

from gossipbench import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r["graph_builds"]
