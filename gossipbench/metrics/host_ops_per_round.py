"""Outermost ``aten::`` host ops inside a runner's call
(``sim.runner.call``) and outside every graph replay
(``sim.graph.launch``), over the periods traced: the work a call runs
outside a captured graph (``spans.py``)."""

from gossipbench import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r["host_ops_per_round"]
