"""In-memory metrics registry: the subset the simulation's publishers use.

A copy of the counter and gauge half of the JAX package's
``consul_tpu/utils/telemetry.py`` (``Metrics.incr``, ``Metrics.gauge``,
the ``/v1/agent/metrics`` JSON snapshot, ``reset`` and the process-wide
``default``), without labels, which no publisher sets. The flight
publisher (``sim/flight.py``) writes here unless the caller hands it
another registry with ``incr`` and ``gauge``, such as an agent's.
"""

from __future__ import annotations

import threading
from collections import defaultdict


class Metrics:
    """Counters (summed) and gauges (last value), keyed by name."""

    def __init__(self, prefix: str = "consul") -> None:
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> dict:
        """The ``/v1/agent/metrics`` JSON shape (no samples are kept)."""
        with self._lock:
            return {
                "Counters": [{"Name": f"{self.prefix}.{k}", "Count": v,
                              "Labels": {}}
                             for k, v in sorted(self._counters.items())],
                "Gauges": [{"Name": f"{self.prefix}.{k}", "Value": v,
                            "Labels": {}}
                           for k, v in sorted(self._gauges.items())],
                "Samples": []}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


#: the process-wide registry
default = Metrics()
