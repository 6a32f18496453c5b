"""The mean host microseconds a runner's call spends in its prologue
(the ``sim.runner.prologue`` spans of a ``sim.runner.call``: the device
conversions, the round keys, the carry; the lane engine's lanes), before
its first graph call (``spans.py``)."""

from gossipbench import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r["prologue_us_per_call"]
