"""100 x the device's idle time while the host is outside every program
span: the caller's own code between calls (its key, the read of the
results to the host), over the traced stretch's extent on the
profiler's clock (``spans.py``)."""

from gossipbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "caller")
