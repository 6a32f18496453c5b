"""The mean host microseconds of a replayed ``GraphCache`` call's
``sim.graph.finish`` span: the launch counters, the copies of the
static buffers back into the donated tensors and the outputs' clones
(``spans.py``)."""

from gossipbench import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r["finish_us_per_replay"]
