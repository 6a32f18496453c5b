"""Device microseconds a period under ``sim.coords.metrics``: the
quality row's estimates, its one sort of the N relative errors and its
order statistics (``annotated.py``), over the periods the traced window
ran."""

from gossipbench import annotated


def read(ctx):
    if not ctx.traced_rounds:
        return None
    us = annotated.under(ctx, (annotated.METRICS,))
    return None if us is None else us / ctx.traced_rounds
