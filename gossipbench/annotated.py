"""Device time under the program's device-annotated spans in a traced
run: the coordinate step and the quality row (``sim.coords.step``,
``sim.coords.metrics``).

While a profiler records, such a span is one record function held open
across its launches (the program's ``utils.telemetry.span(...,
device=True)``), and the profiler annotates the device time of those
launches under the span's name: a device-side event of that name, from
the first of its operations' start to the last one's end. ``under``
reads, for each name, the device operations' busy time (the union of
their intervals, the annotations left out) that falls inside the
annotations of that name. A program without the spans reads nothing
(None).
"""

from __future__ import annotations

from typing import Optional

from gossipbench import spans, trace

STEP = "sim.coords.step"
METRICS = "sim.coords.metrics"
NAMES = (STEP, METRICS)


def operations(dev) -> list:
    """The device events that are operations (no annotation)."""
    return [e for e in dev if e[2] not in NAMES]


def under(ctx, names=NAMES) -> Optional[float]:
    """Device µs of the operations under the spans ``names`` in the
    traced window; None where the trace holds none of them."""
    marks = [(s, e) for s, e, name in ctx.dev if name in names]
    if not marks:
        return None
    busy = trace.busy(operations(ctx.dev))[1]
    return spans.overlap(busy, spans.union(marks))


def busy_us(ctx) -> float:
    """The device's busy µs in the traced window, annotations left
    out."""
    return trace.busy(operations(ctx.dev))[0]
