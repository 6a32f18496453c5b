"""The mean host microseconds a sweep call spends starting its grid:
the ``sim.sweep.prologue`` spans of a ``sim.runner.call`` (the ``[G]``
initial state, the copy the engine runs on, the key stream), summed a
call (``spans.py``); None where the program opens none."""

from gossipbench import spans

PROLOGUE = "sim.sweep.prologue"


def read(ctx):
    r = spans.reading(ctx)
    if r is None:
        return None
    calls = [s for root in r["roots"] for s in root.walk()
             if s.name == spans.CALL
             and any(c.name == PROLOGUE for c in s.walk())]
    if not calls:
        return None
    return sum(spans._inside(calls, PROLOGUE)) / len(calls)
