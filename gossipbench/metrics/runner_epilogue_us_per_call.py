"""The mean host microseconds a runner's call spends in its epilogue
(the ``sim.runner.epilogue`` spans of a ``sim.runner.call``: the state
rebuilt from the carry, the lane engine's write-back, the result), after
its last graph call (``spans.py``)."""

from gossipbench import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r["epilogue_us_per_call"]
