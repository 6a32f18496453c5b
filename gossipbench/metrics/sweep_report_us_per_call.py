"""The mean host microseconds of the sweep's report a call: the
``sim.sweep.report`` span (the ``[G]`` counters, clocks and live
fractions copied to the host at once, the Pareto front, the winner);
None where the program opens none."""

from gossipbench import spans

REPORT = "sim.sweep.report"


def read(ctx):
    r = spans.reading(ctx)
    if r is None:
        return None
    us = [s.end - s.start for root in r["roots"] for s in root.walk()
          if s.name == REPORT]
    return sum(us) / len(us) if us else None
