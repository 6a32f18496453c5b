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
  the span (``sim.runner.call`` ...).

Otherwise ``span`` returns the shared ``OFF`` context: no allocation,
no clock read.

A ``device=True`` span also marks where a CUDA graph capture cuts its
body (``graphs.GraphCache``): inside ``cutting(cut)`` such a span calls
``cut(name)`` as it opens and ``cut(None)`` as it closes, whoever
listens, so that a replay can launch the part captured inside it
inside the span again while a profiler records (``annotating``).

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
_stack = threading.local()


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
    marks."""

    __slots__ = ("name", "parent", "start", "end", "device", "_open")

    def __init__(self, name: str, device: bool = False) -> None:
        self.name = name
        self.device = device
        self.parent = self.start = self.end = self._open = None

    def __enter__(self) -> "Span":
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
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
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


def span(name: str, device: bool = False):
    """A context for the stretch of host code ``name``: a ``Span`` while
    a ``torch.profiler`` records or a registry is armed, else ``OFF``.
    ``device=True`` asks for the form the profiler annotates on the
    device (the module's doc)."""
    if (_armed or _profiler._is_profiler_enabled
            or (device and getattr(_stack, "cut", None) is not None)):
        return Span(name, device)
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
