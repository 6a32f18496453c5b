"""Device microseconds a period under ``sim.coords.step``: the probe
pairs, their round trips, the deadlines' estimates and the Vivaldi
relaxation (``annotated.py``), over the periods the traced window ran."""

from gossipbench import annotated


def read(ctx):
    if not ctx.traced_rounds:
        return None
    us = annotated.under(ctx, (annotated.STEP,))
    return None if us is None else us / ctx.traced_rounds
