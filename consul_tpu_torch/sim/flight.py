"""Flight recorder: per-round telemetry rows, as tensors.

The port of the JAX package's ``consul_tpu/sim/flight.py``. A run
carries a ``[n_rows, N_COLS]`` f32 buffer on the state's device and
writes row ``i // record_every`` at the end of each decimation window
(and at the run's end), so the row holds the state at the window's end:

* gauge columns — time, live / suspect / wrongly-suspected fractions,
  mean informed, mean and max local health, the incarnation sum, the
  active fault phase — are the recorded round's;
* counter columns are the SimStats DELTA over the window (both engines
  keep the cumulative side in int32, so the subtraction is exact and the
  small delta survives the f32 cast); ``stats_from_trace`` rebuilds the
  cumulative series on the host in f64;
* coordinate columns carry ``coords.coord_metrics`` on coordinate runs
  and zeros otherwise.

The reference decides in a ``lax.cond`` whether a round ends a window;
here the round index is known on the host, so ``maybe_record`` is a
Python branch and skipped rounds launch nothing. The trace is fetched
once, after the run (``trace_columns``). ``FlightPublisher`` and
``publish_report`` turn traces and reports into ``sim.*`` counters and
gauges of a metrics registry (``utils.telemetry.default`` by default).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from consul_tpu_torch.sim import lanes as lanes_mod
from consul_tpu_torch.sim import registry
from consul_tpu_torch.sim.state import (DEAD, STATS_FIELDS, SUSPECT,
                                        SimStats, stats_vector)
from consul_tpu_torch.utils import telemetry
from consul_tpu_torch.utils.platform import DeviceLike, default_device

#: default decimation stride
DEFAULT_RECORD_EVERY = 10

GAUGE_COLUMNS = registry.FLIGHT_GAUGE_COLUMNS
COORD_COLUMNS = registry.FLIGHT_COORD_COLUMNS
FLIGHT_COLUMNS = GAUGE_COLUMNS + STATS_FIELDS + COORD_COLUMNS
N_COLS = len(FLIGHT_COLUMNS)
COL = {name: i for i, name in enumerate(FLIGHT_COLUMNS)}

_F32 = torch.float32


def n_trace_rows(rounds: int, record_every: int) -> int:
    """Rows a ``rounds``-round trace takes at the stride (the last
    window may be short; its row still records the run's end)."""
    if record_every <= 0:
        raise ValueError(f"record_every must be positive: {record_every}")
    return -(-rounds // record_every)


def empty_trace(rounds: int, record_every: int,
                device: DeviceLike = None, lead: tuple = ()) -> torch.Tensor:
    """A zeroed trace, ``lead + [n_rows, N_COLS]`` (``lead=(G,)``: one
    trace per grid point)."""
    return torch.zeros(tuple(lead) + (n_trace_rows(rounds, record_every),
                                      N_COLS),
                       dtype=_F32, device=default_device(device))


def trace_bytes(rounds: int, record_every: int) -> int:
    """Device bytes of a recorded trace."""
    return n_trace_rows(rounds, record_every) * N_COLS * 4


def _phase_col(phase, shape: tuple, dev) -> torch.Tensor:
    """The phase column: a host int written by a fill, or a device
    phase (``faults.phase_at``) broadcast as it is."""
    if isinstance(phase, torch.Tensor):
        return phase.to(_F32).reshape(()).expand(shape)
    return torch.full(shape, float(phase), dtype=_F32, device=dev)


def flight_row(*, up, status, informed, local_health, incarnation, t,
               stats_delta, phase,
               coord_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One [N_COLS] f32 row from post-round per-node tensors.

    ``stats_delta`` is the window's SimStats delta, or that delta as a
    ready [len(STATS_FIELDS)] f32 vector (``stats_vector`` order). ``t``
    is a 0-d tensor, ``phase`` a host int (-1 without a plan), written
    by a fill, not a copy from host memory, so a row never makes the
    host wait, or the device phase of ``faults.phase_at``; ``coord_row`` is the round's ``coords.coord_metrics`` or
    None (zeros). The five means reduce one stacked [5, N] tensor. This
    is the plain row: the kernel runner builds its rows on the card in
    one launch (``cuda_round.record_flight_row``), which the tests hold
    to this function."""
    dev = status.device
    upb = up if up.dtype == torch.bool else up != 0
    suspect = status == SUSPECT
    wrong = upb & (suspect | (status == DEAD))
    lh = local_health.to(_F32)
    means = torch.stack([upb.to(_F32), informed, suspect.to(_F32),
                         wrong.to(_F32), lh]).mean(1)
    sv = stats_delta if isinstance(stats_delta, torch.Tensor) \
        else stats_vector(stats_delta)
    if coord_row is None:
        coord_row = torch.zeros((len(COORD_COLUMNS),), dtype=_F32,
                                device=dev)
    return torch.cat([
        t.to(_F32).reshape(1), means, torch.max(lh).reshape(1),
        torch.sum(incarnation, dtype=_F32).reshape(1),
        _phase_col(phase, (1,), dev), sv.to(_F32), coord_row.to(_F32)])


def row_from_lanes(lanes: torch.Tensor, n_pool: int, t, phase,
                   stats_delta: SimStats) -> torch.Tensor:
    """One trace row from a reduced lane vector (``registry.REDUCE_LANES``,
    the lane engine's per-window output): the gauge means are the lane
    numerators over the pool size, the max-health gauge decodes the
    exceedance histogram, no per-node tensor is touched. A grid's
    ``[K, G]`` lanes (``[G]`` clock and counters) give ``[G, N_COLS]``."""
    lane = registry.LANE
    inv = 1.0 / float(n_pool)
    lead = tuple(lanes.shape[1:])
    dev = lanes.device
    gauges = torch.stack([
        t.to(_F32).expand(lead),
        lanes[lane["up_sum"]] * inv,
        lanes[lane["informed_sum"]] * inv,
        lanes[lane["suspect_sum"]] * inv,
        lanes[lane["wrong_sum"]] * inv,
        lanes[lane["lh_sum"]] * inv,
        lanes_mod.max_lh_from_lanes(lanes),
        lanes[lane["inc_sum"]],
        _phase_col(phase, lead, dev)], dim=-1)
    sv = torch.stack([getattr(stats_delta, f).to(_F32).expand(lead)
                      for f in STATS_FIELDS], dim=-1)
    coord = torch.zeros(lead + (len(COORD_COLUMNS),), dtype=_F32,
                        device=dev)
    return torch.cat([gauges, sv, coord], dim=-1)


def grid_flight_row(*, up, status, informed, local_health, incarnation, t,
                    stats_delta: SimStats, phase,
                    coord_row: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``flight_row`` of a grid state (``[G, N]`` lanes, ``[G]`` clock
    and counters) -> ``[G, N_COLS]``: per-row sums by ``lanes.tree_sum``,
    so a grid row is its one-point row bit for bit. ``coord_row`` is the
    grid's ``[G, 3]`` ``coords.coord_metrics`` or None (zeros)."""
    dev = status.device
    suspect = status == SUSPECT
    wrong = up & (suspect | (status == DEAD))
    lh = local_health.to(_F32)
    means = lanes_mod.tree_sum(torch.stack([
        up.to(_F32), informed, suspect.to(_F32), wrong.to(_F32), lh])) \
        / float(status.shape[-1])
    lead = tuple(t.shape)
    gauges = torch.cat([
        t.to(_F32).unsqueeze(0), means, torch.amax(lh, -1).unsqueeze(0),
        lanes_mod.tree_sum(incarnation.to(_F32)).unsqueeze(0),
        _phase_col(phase, (1,) + lead, dev)]).t()
    sv = torch.stack([getattr(stats_delta, f).to(_F32)
                      for f in STATS_FIELDS], dim=-1)
    if coord_row is None:
        coord_row = torch.zeros(lead + (len(COORD_COLUMNS),), dtype=_F32,
                                device=dev)
    return torch.cat([gauges, sv, coord_row.to(_F32)], dim=-1)


def record_row(buf: torch.Tensor, row: torch.Tensor, i: int,
               record_every: int) -> torch.Tensor:
    """Write ``row`` (run-local round ``i``) into its decimation slot,
    in place; a truncated last window lands in the last row. A grid's
    ``[G, n_rows, N_COLS]`` buffer takes a ``[G, N_COLS]`` row."""
    buf[..., min(i // record_every, buf.shape[-2] - 1), :] = row
    return buf


def maybe_record(carry, i: int, rounds: int, record_every: int, rec_fn):
    """``rec_fn(carry)`` iff run-local round ``i`` ends a decimation
    window or the run, else ``carry``. Amortized schedules (the
    megakernel's R rounds per call) call this on call boundaries only,
    with a stride that is a multiple of R."""
    if (i + 1) % record_every == 0 or i + 1 >= rounds:
        return rec_fn(carry)
    return carry


def stats_delta(cur: SimStats, prev: SimStats) -> SimStats:
    """Elementwise SimStats subtraction (int32 / f32 leaves: exact)."""
    return SimStats(*[a - b for a, b in zip(cur, prev)])


# ---------------------------------------------------------- host side


def _host(trace) -> np.ndarray:
    if isinstance(trace, torch.Tensor):
        trace = trace.detach().cpu().numpy()
    return np.asarray(trace)


def trace_columns(trace) -> dict:
    """Trace -> {column name: [n_rows] numpy array}: the one fetch."""
    tr = _host(trace)
    if tr.ndim != 2 or tr.shape[1] != N_COLS:
        raise ValueError(f"not a flight trace: shape {tr.shape}, "
                         f"expected [rows, {N_COLS}]")
    return {name: tr[:, i] for i, name in enumerate(FLIGHT_COLUMNS)}


def sweep_trace_columns(trace) -> list:
    """A batched [G, rows, N_COLS] trace -> one column dict per grid
    point, each what ``trace_columns`` gives for that point's trace."""
    tr = _host(trace)
    if tr.ndim != 3 or tr.shape[2] != N_COLS:
        raise ValueError(f"not a sweep trace: shape {tr.shape}, "
                         f"expected [grid, rows, {N_COLS}]")
    return [{name: tr[g, :, i] for i, name in enumerate(FLIGHT_COLUMNS)}
            for g in range(tr.shape[0])]


def stats_from_trace(trace) -> SimStats:
    """The per-round CUMULATIVE SimStats (f64 numpy leaves, leading
    [n_rows] axis) from a stride-1 trace of a run that began at zeroed
    stats — what ``metrics.phase_reports`` reads."""
    tr = _host(trace).astype(np.float64)
    return SimStats(**{f: np.cumsum(tr[:, COL[f]]) for f in STATS_FIELDS})


# ------------------------------------------------------------ publish


class FlightPublisher:
    """Publish flight traces into a metrics registry (``incr`` and
    ``gauge``; ``utils.telemetry.default`` unless one is given).

    Gauge columns become ``<prefix>.<col>`` gauges, set from the trace's
    last row; counter columns are per-window deltas, so a trace's column
    sum increments the ``<prefix>.<col>`` counter by that trace's events
    (a zero sum is not published). Publish each trace once: disjoint
    traces, as a chunked run gives, keep the registry's totals the
    run's. Coordinate gauges are set only for a trace whose coordinate
    columns are not all zero (a zero-filled ``rtt_err_med`` would read
    as a converged estimator, not as off)."""

    def __init__(self, metrics=None, prefix: str = "sim") -> None:
        self.metrics = telemetry.default if metrics is None else metrics
        self.prefix = prefix

    def publish_trace(self, trace) -> None:
        tr = _host(trace).astype(np.float64)
        if not tr.shape[0]:
            return
        for name in GAUGE_COLUMNS:
            self.metrics.gauge(f"{self.prefix}.{name}",
                               float(tr[-1, COL[name]]))
        for f in STATS_FIELDS:
            total = float(tr[:, COL[f]].sum())
            if total:
                self.metrics.incr(f"{self.prefix}.{f}", total)
        if tr[:, [COL[c] for c in COORD_COLUMNS]].any():
            for name in COORD_COLUMNS:
                self.metrics.gauge(f"{self.prefix}.{name}",
                                   float(tr[-1, COL[name]]))


def publish_report(report, metrics=None, prefix: str = "sim") -> None:
    """Publish an FDReport's numeric fields as ``<prefix>.fd.*`` gauges."""
    metrics = telemetry.default if metrics is None else metrics
    for k, v in report.to_dict().items():
        if isinstance(v, (int, float)):
            metrics.gauge(f"{prefix}.fd.{k}", float(v))
