"""The mean host microseconds of a ``GraphCache`` call that replayed its
graph (a ``sim.graph.call`` span holding a ``sim.graph.launch``): the
key, the copies in, the launch, the copies back and the clones
(``spans.py``)."""

from gossipbench import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r["graph_us_per_replay"]
