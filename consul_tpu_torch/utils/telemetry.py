"""In-memory metrics registry and the simulation's spans.

The registry is the JAX package's ``consul_tpu/utils/telemetry.py``
``Metrics`` without labels, which no publisher sets, and without its
histograms and Prometheus text: counters (``incr``), gauges
(``gauge``), samples (``sample``, ``measure_since``), the
``/v1/agent/metrics`` JSON snapshot, ``reset`` and the process-wide
``default``. A sample keeps go-metrics' aggregate (count, sum, min,
max, mean) in constant memory. The flight publisher (``sim/flight.py``)
writes here unless the caller hands it another registry with ``incr``
and ``gauge``, such as an agent's.

``span(name)`` marks a stretch of the simulation's host code: the
runners' calls and their prologue and epilogue, and each
``GraphCache`` call with its parts. It costs nothing unless something
listens:

* while a ``torch.profiler`` records, a span writes a begin mark
  (``<name>:b``) and an end mark (``<name>:e``) into its trace, on the
  profiler's own clock. Each mark is a record function entered and left
  at once, so it encloses no launch and the profiler gives it no
  device-side annotation; the span runs from the begin mark's end to
  the end mark's start;
* inside ``armed(registry)`` each span's duration, in milliseconds of
  ``time.perf_counter``, lands in the registry as a sample named after
  the span (``sim.runner.call`` ...);
* inside ``timeline(device)`` each span that is not a ``device=True``
  span records a marker as it opens and as it closes: the host's
  ``time.perf_counter_ns`` and, on the card, a timing CUDA event on the
  current stream, taken from a pool made before the stretch. ``Timeline``
  below says when a marker takes one, and ``account`` what its
  ``read`` makes of them.

Otherwise ``span`` returns the shared ``OFF`` context: no allocation,
no clock read.

A ``device=True`` span also marks where a CUDA graph capture cuts its
body (``graphs.GraphCache``): inside ``cutting(cut)`` such a span calls
``cut(name)`` as it opens and ``cut(None)`` as it closes, whoever
listens, so that a replay can launch the part captured inside it
inside the span again while a profiler records (``annotating``).

The code that opens a span declares what the span's own stretches
(its time outside the spans it holds) launch, for a listening timeline:
``span(name, stretch=...)`` with ``EAGER`` (launches of any length, the
default), ``QUIET`` (nothing), ``REPLAY`` (one replay of a captured
graph) or ``GRAPH`` (a graph cache's call: nothing unless it holds no
other span, its body run inline; a wait inside it is the graph's).
``copying(name, nbytes)`` marks a group of device-to-device copies of
known bytes (``COPY``; ``GraphCache``'s copies into and out of its
static buffers and the outputs' clones); with no timeline it is ``OFF``.
This module matches no span by its name.

``count(values)`` adds a runner's device-summed counters to the armed
registries, once a call (the coordinate counters of
``round.run_rounds_flight``); ``listening()`` says whether one is armed,
so that a runner sums them only then.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


class Metrics:
    """Counters (summed), gauges (last value) and samples (count, sum,
    min and max), keyed by name."""

    def __init__(self, prefix: str = "consul") -> None:
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        # name -> [count, sum, min, max]
        self._samples: dict[str, list] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def sample(self, name: str, value: float) -> None:
        with self._lock:
            agg = self._samples.get(name)
            if agg is None:
                self._samples[name] = [1, value, value, value]
            else:
                agg[0] += 1
                agg[1] += value
                agg[2] = min(agg[2], value)
                agg[3] = max(agg[3], value)

    def measure_since(self, name: str, start: float) -> None:
        """A sample of the milliseconds since ``start``, a
        ``time.perf_counter()`` reading."""
        self.sample(name, (time.perf_counter() - start) * 1e3)

    def snapshot(self) -> dict:
        """The ``/v1/agent/metrics`` JSON shape."""
        with self._lock:
            return {
                "Counters": [{"Name": f"{self.prefix}.{k}", "Count": v,
                              "Labels": {}}
                             for k, v in sorted(self._counters.items())],
                "Gauges": [{"Name": f"{self.prefix}.{k}", "Value": v,
                            "Labels": {}}
                           for k, v in sorted(self._gauges.items())],
                "Samples": [{"Name": f"{self.prefix}.{k}", "Count": c,
                             "Sum": s, "Min": lo, "Max": hi,
                             "Mean": s / c, "Labels": {}}
                            for k, (c, s, lo, hi)
                            in sorted(self._samples.items())]}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._samples.clear()


#: the process-wide registry
default = Metrics()


# ------------------------------------------------------------ spans


class _Off:
    """The span of a site nobody listens to."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


#: what ``span`` returns while no profiler records and no registry is
#: armed
OFF = _Off()

#: the registries inside ``armed``
_armed: tuple = ()
#: the ``Timeline`` inside ``timeline``, or None
_line = None
_stack = threading.local()

#: what a span's own stretches launch, as the code opening it declares
#: (the module's doc); ``COPY`` is a ``copying`` group's
EAGER, QUIET, REPLAY, GRAPH, COPY = ("eager", "quiet", "replay", "graph",
                                     "copy")


def _mark(name: str) -> None:
    # the C++ record function: ~1 µs a mark under the CPU profiler,
    # against ~14 µs for ``torch.profiler.record_function``
    with _RecordFunctionFast(name):
        pass


class Span:
    """One stretch of host code: its ``name``, ``start`` and ``end``
    (``time.perf_counter`` seconds) and the span it nests in on the same
    thread (``parent``, None at the top). ``device``: held open as one
    record function while a profiler records, in place of the two
    marks. ``stretch``: what its own stretches launch, for a timeline."""

    __slots__ = ("name", "parent", "start", "end", "device", "stretch",
                 "_open", "_line")

    def __init__(self, name: str, device: bool = False,
                 stretch: str = EAGER) -> None:
        self.name = name
        self.device = device
        self.stretch = stretch
        self.parent = self.start = self.end = self._open = None
        self._line = None

    def __enter__(self) -> "Span":
        line = _line
        since = time.perf_counter_ns() if line is not None else 0
        self.parent = getattr(_stack, "top", None)
        _stack.top = self
        cut = getattr(_stack, "cut", None) if self.device else None
        if cut is not None:
            cut(self.name)
        if _profiler._is_profiler_enabled:
            if self.device:
                self._open = _profiler.record_function(self.name)
                self._open.__enter__()
            else:
                _mark(self.name + ":b")
        if line is not None and not self.device \
                and line.mark(OPEN_MARK, self.name, self.stretch,
                              since=since):
            self._line = line
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        if self._line is not None:
            self._line.mark(CLOSE_MARK, self.name, self.stretch,
                            since=time.perf_counter_ns())
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        elif _profiler._is_profiler_enabled and not self.device:
            _mark(self.name + ":e")
        cut = getattr(_stack, "cut", None) if self.device else None
        if cut is not None and exc[0] is None:
            # on an error the capture is abandoned where it stands
            cut(None)
        _stack.top = self.parent
        ms = (self.end - self.start) * 1e3
        for m in _armed:
            m.sample(self.name, ms)
        return False


def span(name: str, device: bool = False, stretch: str = EAGER):
    """A context for the stretch of host code ``name``: a ``Span`` while
    a ``torch.profiler`` records, a registry is armed or a timeline
    listens, else ``OFF``. ``device=True`` asks for the form the
    profiler annotates on the device, ``stretch`` says what the span's
    own stretches launch (the module's doc)."""
    if (_armed or _line or _profiler._is_profiler_enabled
            or (device and getattr(_stack, "cut", None) is not None)):
        return Span(name, device, stretch)
    return OFF


def annotating() -> bool:
    """Does a profiler record, so that a device span is annotated?"""
    return _profiler._is_profiler_enabled


@contextlib.contextmanager
def cutting(cut):
    """Inside this block (on this thread) each ``device=True`` span
    calls ``cut(name)`` as it opens and ``cut(None)`` as it closes: a
    CUDA graph capture that cuts its body there."""
    prev = getattr(_stack, "cut", None)
    _stack.cut = cut
    try:
        yield
    finally:
        _stack.cut = prev


def count(values: dict) -> None:
    """Add each of ``values`` (name -> a number, or a 0-d tensor, read
    here) to the armed registries' counters; reads nothing when none is
    armed. A runner publishes its device-summed counters so, once a
    call."""
    if not _armed:
        return
    read = {k: float(v) for k, v in values.items()}
    for m in _armed:
        for k, v in read.items():
            m.incr(k, v)


def listening() -> bool:
    """Is a registry armed? (A runner sums its counters only then.)"""
    return bool(_armed)


@contextlib.contextmanager
def armed(metrics: Metrics):
    """Inside this block every span's duration also lands in
    ``metrics`` as a sample named after the span."""
    global _armed
    _armed = _armed + (metrics,)
    try:
        yield metrics
    finally:
        left = list(_armed)
        left.remove(metrics)
        _armed = tuple(left)


# ------------------------------------------------------------ timeline

#: a marker's kinds: a span (or a copy group) opens or closes
OPEN_MARK, CLOSE_MARK = 0, 1
#: markers recorded on a drained stream to take the latency λ, and the
#: slack added to the largest of them
LAMBDA_MARKERS = 8
LAMBDA_SLACK_NS = 2000.0
#: bytes of the device-to-device copy timed once for the copy rate
RATE_BYTES = 64 << 20


class _Copies:
    """A group of copies of ``nbytes`` bytes, marked for a timeline."""

    __slots__ = ("line", "name", "nbytes", "on")

    def __init__(self, line: "Timeline", name: str, nbytes: int) -> None:
        self.line = line
        self.name = name
        self.nbytes = nbytes
        self.on = False

    def __enter__(self):
        self.on = self.line.mark(OPEN_MARK, self.name, COPY, self.nbytes)
        return self

    def __exit__(self, *exc) -> bool:
        if self.on:
            self.line.mark(CLOSE_MARK, self.name, COPY, self.nbytes,
                           since=time.perf_counter_ns())
        return False


def copying(name: str, nbytes: int):
    """A context around a group of device-to-device copies of
    ``nbytes`` bytes in all, named ``name`` in a timeline's reading: two
    markers while a timeline listens, else ``OFF``."""
    line = _line
    return OFF if line is None else _Copies(line, name, nbytes)


class _Frame:
    """A span open in ``account``: its name, its stretch, its open
    marker's index and bytes, the waits and busy time inside it, whether
    a ``REPLAY`` span closed right inside it, and the timeline's own
    host ns inside it."""

    __slots__ = ("name", "stretch", "at", "nbytes", "wait", "busy",
                 "replayed", "own")

    def __init__(self, name, stretch, at, nbytes) -> None:
        self.name, self.stretch, self.at, self.nbytes = \
            name, stretch, at, nbytes
        self.wait = self.busy = self.own = 0.0
        self.replayed = False


def _place(stack: list) -> str:
    """Where the host is: in a ``GRAPH`` span, in another span, or
    outside every span."""
    if any(f.stretch == GRAPH for f in stack):
        return "graph"
    return "runner" if stack else "caller"


def account(marks: list, dev: Optional[list], lam_ns: float = 0.0,
            bytes_per_ns: float = 1.0, costs: Optional[list] = None) -> dict:
    """The device's time between consecutive markers, split.

    ``marks``: ``(t, kind, name, nbytes, stretch)`` a marker, ``t`` the
    host's ns, ``kind`` ``OPEN_MARK`` or ``CLOSE_MARK``, ``stretch``
    what the span's own stretches launch (the module's doc). ``dev``: the ns on the
    host's clock at which the device reached each marker, or None (host
    times only). A marker counts as drained when the device reached it
    within ``lam_ns`` of its recording: the device had nothing left to
    run. ``costs``: per marker the timeline's own host ns before and
    after ``t`` (None: none).

    The stretch between two consecutive markers is, by the stretch of
    the innermost span open in it:

    * ``QUIET``, or ``GRAPH`` between its parts: nothing launched, all
      wait;
    * ``REPLAY``: busy, less the span's host time when its open marker
      was drained, or the part of it after the device reached the open
      marker (then wait);
    * ``COPY``: busy for its bytes at ``bytes_per_ns``, wait for the
      rest when its close was drained; all busy otherwise;
    * ``EAGER``, a ``GRAPH`` span that holds no other (its body run
      inline) or no span at all: wait when both markers were drained,
      else undecided, ``eager_us``.

    A wait, less the timeline's own host time inside the stretch
    (``self_us``: the device waited on the timeline, which an untimed
    run does not make it do), goes to where the host was (``graph``,
    ``runner``, ``caller``): ``extent_us`` = ``busy_us`` + ``eager_us``
    + the three waits + ``self_us``. Per span name: its count and its
    host, device and wait µs (the host's time between its two markers
    less the timeline's own inside it; the device's; the waits while it
    was open), summed; ``replays``: the same for the ``GRAPH`` spans
    that held a ``REPLAY`` one; ``calls``: each outermost span's name
    and host, device, busy and wait µs. Without ``dev`` every device
    field is None."""
    n = len(marks)
    if dev is not None:
        drained = [d - m[0] <= lam_ns for m, d in zip(marks, dev)]
    spans: dict = {}
    replays = [0, 0.0, 0.0]
    calls: list = []
    stack: list = []
    waits = {"graph": 0.0, "runner": 0.0, "caller": 0.0}
    busy = eager = own = 0.0
    for i, (t, kind, name, nbytes, stretch) in enumerate(marks):
        if kind == OPEN_MARK:
            stack.append(_Frame(name, stretch, i, nbytes))
        elif kind == CLOSE_MARK:
            j = len(stack) - 1
            while j >= 0 and stack[j].name != name:
                j -= 1
            if j >= 0:
                f = stack[j]
                del stack[j:]
                host = t - marks[f.at][0] - f.own
                d = dev[i] - dev[f.at] if dev is not None else None
                agg = spans.setdefault(name, [0, 0.0, 0.0, 0.0])
                agg[0] += 1
                agg[1] += host
                if dev is not None:
                    agg[2] += d
                    agg[3] += f.wait
                if f.stretch == REPLAY and stack \
                        and stack[-1].stretch == GRAPH:
                    stack[-1].replayed = True
                if f.stretch == GRAPH and f.replayed:
                    replays[0] += 1
                    replays[1] += host
                    replays[2] += d if dev is not None else 0.0
                if not stack:
                    calls.append((name, host, d, f.busy, f.wait))
        if i + 1 == n:
            break
        # the timeline's own host ns inside the stretch
        o = costs[i][1] + costs[i + 1][0] if costs else 0
        for f in stack:
            f.own += o
        if dev is None:
            continue
        iv = dev[i + 1] - dev[i]
        top = stack[-1] if stack else None
        role = top.stretch if top is not None else EAGER
        nxt = marks[i + 1]
        b = w = 0.0
        if iv < 0:
            # two streams' markers out of order: nothing is decided
            eager += iv
        elif role == COPY:
            b = iv
            if drained[i + 1]:
                b = min(iv, top.nbytes / bytes_per_ns)
                w = iv - b
        elif role == REPLAY:
            # the replay starts once its launch returns: the device waits
            # from its open (or from when it reached that, if later)
            w = min(iv, max(0.0, nxt[0] - (t if drained[i] else dev[i])))
            b = iv - w
        elif role == QUIET or (role == GRAPH and not (
                top.at == i and nxt[1] == CLOSE_MARK
                and nxt[2] == top.name)):
            w = iv
        elif drained[i] and drained[i + 1]:
            w = iv
        else:
            eager += iv
        busy += b
        if w:
            mine = min(w, o)
            own += mine
            w -= mine
            waits[_place(stack)] += w
        for f in stack:
            f.wait += w
            f.busy += b
    on = dev is not None and n > 0

    def us(x):
        return x * 1e-3 if on else None

    return {
        "markers": n,
        "extent_us": us(dev[-1] - dev[0]) if on else None,
        "busy_us": us(busy), "eager_us": us(eager), "self_us": us(own),
        "wait_us": {k: us(v) for k, v in waits.items()},
        "spans": {k: {"count": c, "host_us": h * 1e-3, "device_us": us(d),
                      "wait_us": us(w)}
                  for k, (c, h, d, w) in spans.items()},
        "replays": {"count": replays[0], "host_us": replays[1] * 1e-3,
                    "device_us": us(replays[2])},
        "calls": [{"name": k, "host_us": h * 1e-3, "device_us": us(d),
                   "busy_us": us(b), "wait_us": us(w)}
                  for k, h, d, b, w in calls]}


def idle_pct(reading: dict, place: Optional[str] = None) -> Optional[float]:
    """100 x a timeline reading's waits (all three, or the one at
    ``place``) over its extent, both less the timeline's own host time
    the device waited on (``self_us``); None without device times."""
    if not reading["extent_us"]:
        return None
    w = reading["wait_us"]
    total = sum(w.values()) if place is None else w[place]
    return 100.0 * total / (reading["extent_us"] - reading["self_us"])


def infer(times: list, reached: list, lat_ns: float) -> list:
    """Each marker's device time from the events that were recorded
    (``reached``, None for a marker that took none): a marker that ends
    a stretch launching nothing is reached once the one before it is and
    once the host has recorded it, ``lat_ns`` later."""
    out: list = []
    for t, d in zip(times, reached):
        if d is None:
            d = t + lat_ns if not out else max(out[-1], t + lat_ns)
        out.append(d)
    return out


class Timeline:
    """The markers of the spans (and copy groups) opened inside
    ``timeline(device)`` on the thread that opened it.

    On the card (``device`` a CUDA device) a marker is recorded only
    while the stream current when the timeline opened is current and
    not capturing (a capture's spans run on a side stream and record
    nothing). Each takes ``time.perf_counter_ns``; one that ends a
    stretch of some launch (every marker but those that end a stretch
    of a ``QUIET`` span, or of a ``GRAPH`` span between its parts) also
    records a timing event of the pool made here, so the hot path
    creates none,
    and the others' device times follow (``infer``): a timing event
    costs the host ~3 µs, and more where the stream has work queued.
    Here too, after a synchronise: one DtoD copy of ``RATE_BYTES`` timed
    (the copy rate), and ``LAMBDA_MARKERS`` markers on the drained
    stream, the first the anchor that puts every event on the host's
    clock; their median latency is an inferred marker's, their largest
    plus ``LAMBDA_SLACK_NS`` the λ of a drained one. Each marker also
    keeps the timeline's own host time around it (``account``'s
    ``costs``). A pool that runs out (``overflow``) leaves the device
    fields None. Elsewhere (``device`` None or the CPU) a marker is the
    host's time alone and ``read``'s device fields are None."""

    def __init__(self, device=None, events: int = 4096) -> None:
        self.device = torch.device(device) if device is not None else None
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.marks: list = []
        self.overflow = 0
        self.lam_ns = self.lat_ns = self.bytes_per_ns = None
        self._thread = threading.get_ident()
        self._done = False
        self._pool: list = []
        # per marker its event's index in the pool, or None; events used;
        # the timeline's own host ns before and after its time
        self._events: list = []
        self._used = 0
        self._costs: list = []
        # the (name, stretch) of the spans open, and the last marker's
        # (kind, name)
        self._opened: list = []
        self._last = None
        if self.cuda:
            self._calibrate(events)

    def _calibrate(self, events: int) -> None:
        dev = self.device
        with torch.cuda.device(dev):
            self._stream = torch.cuda.current_stream(dev)
            index = self._stream.device_index
            self._stream_id = self._stream.stream_id
            # the legacy default stream cannot capture
            self._capturable = self._stream_id != \
                torch.cuda.default_stream(dev).stream_id
            # the current stream's id without making a Stream object
            self._current = \
                lambda: torch._C._cuda_getCurrentStream(index)[0]
            self._pool = [torch.cuda.Event(enable_timing=True)
                          for _ in range(events)]
            for ev in self._pool:
                # a CUDA event is made at its first record
                ev.record(self._stream)
            src = torch.empty(RATE_BYTES, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            dst.copy_(src)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record(self._stream)
            dst.copy_(src)
            b.record(self._stream)
            b.synchronize()
            self.bytes_per_ns = RATE_BYTES / (a.elapsed_time(b) * 1e6)
            del src, dst
            cal = []
            for _ in range(LAMBDA_MARKERS):
                torch.cuda.synchronize(dev)
                ev = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter_ns()
                ev.record(self._stream)
                cal.append((t, ev))
            torch.cuda.synchronize(dev)
        self._anchor_t, self._anchor = cal[0]
        lat = sorted(self._on_host(ev) - t for t, ev in cal)
        self.lat_ns = lat[len(lat) // 2]
        self.lam_ns = lat[-1] + LAMBDA_SLACK_NS

    def _on_host(self, ev) -> float:
        """An event's device time in ns of the host's clock."""
        return self._anchor_t + self._anchor.elapsed_time(ev) * 1e6

    def _quiet(self, kind: int, name: str, stretch: str) -> bool:
        """Does the marker end a stretch that launches nothing (and move
        the spans open past it)?"""
        opened = self._opened
        top = opened[-1] if opened else (None, EAGER)
        quiet = top[1] == QUIET or (top[1] == GRAPH and not (
            kind == CLOSE_MARK and name == top[0]
            and self._last == (OPEN_MARK, name)))
        if kind == OPEN_MARK:
            opened.append((name, stretch))
        elif kind == CLOSE_MARK and any(o[0] == name for o in opened):
            while opened.pop()[0] != name:
                pass
        self._last = (kind, name)
        return quiet

    def mark(self, kind: int, name: str, stretch: str = EAGER,
             nbytes: int = 0, since: Optional[int] = None) -> bool:
        """Record a marker; False where none is recorded (another
        thread, another stream, a capture, a closed timeline). The
        timeline's own host time around it (from ``since``, when the
        span's code for it began, to the record's end) is kept too."""
        if since is None:
            since = time.perf_counter_ns()
        if self._done or threading.get_ident() != self._thread:
            return False
        i = None
        if self.cuda:
            if self._current() != self._stream_id or (
                    self._capturable
                    and torch.cuda.is_current_stream_capturing()):
                return False
            i = None if self._quiet(kind, name, stretch) else self._used
            if i is not None and i >= len(self._pool):
                self.overflow += 1
                i = None
        # the host's time right before the record, as the calibration
        # takes it
        t = time.perf_counter_ns()
        if i is not None:
            self._pool[i].record(self._stream)
            self._used = i + 1
        self.marks.append((t, kind, name, nbytes, stretch))
        self._events.append(i)
        self._costs.append((t - since, time.perf_counter_ns() - t))
        return True

    def read(self) -> dict:
        """``account`` of the markers (one synchronise on the card), with
        the ``lambda_us``, the copy rate (``dtod_bytes_per_us``) and the
        pool's ``overflow``."""
        dev = None
        if self.cuda and not self.overflow:
            torch.cuda.synchronize(self.device)
            dev = infer([m[0] for m in self.marks],
                        [None if i is None else self._on_host(self._pool[i])
                         for i in self._events], self.lat_ns)
        out = account(self.marks, dev, self.lam_ns or 0.0,
                      self.bytes_per_ns or 1.0, self._costs)
        out.update(
            lambda_us=self.lam_ns * 1e-3 if self.lam_ns else None,
            dtod_bytes_per_us=self.bytes_per_ns * 1e3
            if self.bytes_per_ns else None,
            overflow=self.overflow)
        return out


@contextlib.contextmanager
def timeline(device=None, events: int = 4096):
    """Inside this block every span (but the ``device=True`` ones) and
    every copy group records its markers into the yielded ``Timeline``
    (``events`` of them on the card); one timeline at a time."""
    global _line
    if _line is not None:
        raise RuntimeError("a timeline already listens")
    line = Timeline(device, events)
    _line = line
    try:
        yield line
    finally:
        _line = None
        line._done = True
