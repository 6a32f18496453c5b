"""100 x the device time under the two coordinate spans
(``sim.coords.step``, ``sim.coords.metrics``) over the device's busy
time in the traced window, the annotations themselves left out of
both (``annotated.py``)."""

from gossipbench import annotated


def read(ctx):
    us = annotated.under(ctx)
    return None if us is None else 100.0 * us / annotated.busy_us(ctx)
