"""The mean host microseconds of a replayed ``GraphCache`` call's
``sim.graph.prepare`` span: its key and the copies of the donated
tensors and arguments into the graph's static buffers (``spans.py``)."""

from gossipbench import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r["prepare_us_per_replay"]
