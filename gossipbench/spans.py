"""The program's own spans in a traced run, and the device's idle time
split by them.

The program marks stretches of its host code with begin and end marks
(``<name>:b``, ``<name>:e``: zero-work host events of the profiler's
trace, on its own clock). ``tree`` pairs them back into spans, one tree
a top-level span (a runner's call, ``sim.runner.call``): a span runs
from its begin mark's end to its end mark's start, and its parent is the
span it nests in.

``reading`` splits the device's idle time over the traced stretch's
extent (the earliest host or device event to the latest) by where the
host was at each idle instant:

* graph — inside a ``sim.graph.call`` (a ``GraphCache`` call: its key,
  the copies into and out of the static buffers, the replay's launch,
  the outputs' clones);
* runner — inside a program span, outside every ``sim.graph.call`` (the
  runner's prologue and epilogue, its loop between cache calls);
* caller — outside every program span (the caller's key, its read of
  the results).

The three partition the extent's idle time. A program without the marks
reads nothing here (None), and so does a trace with no device event.

``reading`` also gives the host time of the parts: a call's prologue
and epilogue (``sim.runner.prologue``, ``.epilogue``), a replay's
copies in (``sim.graph.prepare``) and copies back with the clones
(``sim.graph.finish``), and counts a cache's set-up calls
(``sim.graph.eager``, ``sim.graph.capture``) in the traced stretch,
which past the warm-up reads 0.
"""

from __future__ import annotations

import bisect
from typing import Optional

from gossipbench import trace

PREFIX = "sim."
CALL = "sim.runner.call"
GRAPH = "sim.graph.call"
LAUNCH = "sim.graph.launch"
PROLOGUE = "sim.runner.prologue"
EPILOGUE = "sim.runner.epilogue"
PREPARE = "sim.graph.prepare"
FINISH = "sim.graph.finish"
BUILDS = ("sim.graph.eager", "sim.graph.capture")


class Span:
    """A paired span: ``name``, ``start`` and ``end`` (µs on the
    profiler's clock) and its ``children`` in order."""

    __slots__ = ("name", "start", "end", "children")

    def __init__(self, name: str, start: float):
        self.name = name
        self.start = start
        self.end = None
        self.children: list = []

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def tree(host) -> list:
    """The top-level spans of sorted host events ``(start, end, name)``,
    each with its children. An end mark closes the innermost open span
    of its name; a span left open at the trace's end is dropped."""
    roots, stack = [], []
    for s, e, name in host:
        if not name.startswith(PREFIX):
            continue
        base, _, side = name.rpartition(":")
        if side == "b":
            stack.append(Span(base, e))
        elif side == "e":
            j = len(stack) - 1
            while j >= 0 and stack[j].name != base:
                j -= 1
            if j < 0:
                continue
            sp = stack[j]
            sp.end = s
            del stack[j:]
            (stack[-1].children if stack else roots).append(sp)
    return roots


def union(intervals) -> list:
    """Sorted, disjoint ``[start, end]`` pairs covering ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _length(merged) -> float:
    return sum(e - s for s, e in merged)


def overlap(a, b) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(dev, host, roots) -> Optional[dict]:
    """The extent (µs), its idle time and that time split into graph,
    runner and caller (see the module's doc); None without device
    events."""
    if not dev:
        return None
    events = dev + host
    extent = (min(s for s, _, _ in events), max(e for _, e, _ in events))
    busy = trace.busy(dev)[1]
    spans = union((r.start, r.end) for r in roots)
    graph = union((s.start, s.end) for r in roots for s in r.walk()
                  if s.name == GRAPH)
    idle = extent[1] - extent[0] - _length(busy)
    idle_prog = _length(spans) - overlap(spans, busy)
    idle_graph = _length(graph) - overlap(graph, busy)
    return {"extent_us": extent[1] - extent[0], "idle_us": idle,
            "graph_us": idle_graph, "runner_us": idle_prog - idle_graph,
            "caller_us": idle - idle_prog}


def host_ops(host, roots) -> int:
    """Outermost ``aten::`` host ops inside a ``sim.runner.call`` and
    outside every ``sim.graph.launch``: the host work a call does
    outside a graph's replay."""
    calls = union((r.start, r.end) for r in roots if r.name == CALL)
    launches = union((s.start, s.end) for r in roots for s in r.walk()
                     if s.name == LAUNCH)
    call_starts = [s for s, _ in calls]
    launch_starts = [s for s, _ in launches]
    count, outer_end = 0, float("-inf")
    for s, e, name in host:
        if not name.startswith("aten::"):
            continue
        if s < outer_end:
            continue                # inside another aten op
        outer_end = e
        i = bisect.bisect_right(call_starts, s) - 1
        if i < 0 or e > calls[i][1]:
            continue
        j = bisect.bisect_right(launch_starts, e)
        if j and launches[j - 1][1] > s:
            continue
        count += 1
    return count


def _mean(xs) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def _inside(parents, name: str) -> list:
    """For each span of ``parents``, the total µs of its descendants
    named ``name``."""
    return [sum(s.end - s.start for s in p.walk() if s.name == name)
            for p in parents]


def reading(ctx) -> Optional[dict]:
    """What the span metrics read, once a traced run: the span trees,
    the idle split, the mean host µs of a replayed ``sim.graph.call``
    and of its copies in and back, the mean host µs of a call's
    prologue and epilogue, the host ops a period and the cache's set-up
    calls; None where the trace holds no program span."""
    if "_spans" not in ctx.__dict__:
        roots = tree(ctx.host)
        ctx._spans = None
        if roots:
            every = [s for r in roots for s in r.walk()]
            calls = [s for s in every if s.name == CALL]
            replays = [s for s in every if s.name == GRAPH
                       and any(c.name == LAUNCH for c in s.children)]
            ctx._spans = {
                "roots": roots,
                "idle": idle_split(ctx.dev, ctx.host, roots),
                "graph_us_per_replay":
                    _mean([s.end - s.start for s in replays]),
                "prepare_us_per_replay": _mean(_inside(replays, PREPARE)),
                "finish_us_per_replay": _mean(_inside(replays, FINISH)),
                "prologue_us_per_call": _mean(_inside(calls, PROLOGUE)),
                "epilogue_us_per_call": _mean(_inside(calls, EPILOGUE)),
                "graph_builds": sum(s.name in BUILDS for s in every),
                "host_ops_per_round":
                    host_ops(ctx.host, roots) / ctx.traced_rounds
                    if ctx.traced_rounds else None}
    return ctx._spans


def idle_pct(ctx, part: str) -> Optional[float]:
    """100 x the idle time in ``part`` (graph, runner or caller) over
    the traced stretch's extent."""
    r = reading(ctx)
    if r is None or r["idle"] is None or r["idle"]["extent_us"] <= 0:
        return None
    return 100.0 * r["idle"][f"{part}_us"] / r["idle"]["extent_us"]
