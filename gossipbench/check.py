"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, number by number, each against its limit.

The numbers, each the largest over the calls checked:

* ``nodes_off`` — the share of nodes whose int lanes (status,
  incarnation, down_age, the suspicion timer's length, ticks and
  confirmations, local health) differ anywhere;
* ``informed_gap`` — the largest |difference| of ``informed`` among the
  nodes whose int lanes agree;
* ``counter_gap`` — the largest gap of the ten counters after the call,
  per node and period (the latency sum per node, period and probe
  interval);
* ``clock_off`` — how many of the clocks and round indices differ;
* ``trace_gap`` — where the call records flight rows: the largest gap
  of a row's column, the shares and means as they are, the maximum local
  health over ``awareness_max``, the incarnation sum and the counters
  per node, the clock relative to itself;
* ``scalars_gap`` — where the call carries the stale scalars: the
  largest relative gap of the 8.

Each limit is set from two readings, written beside it in PERF.md: the
largest the program gave over a dozen seeds or more, and the smallest
the control (the reference in bfloat16 in the program's place) gave.
"""

from __future__ import annotations

import math

import torch

INT_LANES = (0, 1, 3, 4, 5, 6, 7)
LAT = 4
N_GAUGES = 9
N_STATS = 10
NUMBERS = ("nodes_off", "informed_gap", "counter_gap", "clock_off",
           "trace_gap", "scalars_gap")


def _f(x) -> float:
    return float(torch.as_tensor(x).double().cpu())


def _stats_gap(got, want, P, rounds: int) -> float:
    per = P.n * rounds
    gap = 0.0
    for j in range(N_STATS):
        d = abs(_f(got[j]) - _f(want[j])) / per
        if j == LAT:
            d /= P.probe_interval
        gap = max(gap, d)
    return gap


def _trace_gap(got: torch.Tensor, want: torch.Tensor, P) -> float:
    if got.shape != want.shape:
        return math.inf
    g, w = got.double().cpu(), want.double().cpu()
    d = (g - w).abs()
    scale = torch.ones(d.shape[-1], dtype=torch.float64)
    scale[6] = P.awareness_max
    scale[7] = P.n
    scale[N_GAUGES:N_GAUGES + N_STATS] = P.n
    scale[N_GAUGES + LAT] = P.n * P.probe_interval
    d = d / scale
    d[:, 0] = (g[:, 0] - w[:, 0]).abs() / w[:, 0].abs().clamp_min(1.0)
    return _f(d.max())


def readings(pairs, P, traffic) -> dict:
    """``pairs``: (the program's outputs of a call, the reference's
    (state, trace, scalars) from the same start). Returns each number."""
    out = {k: 0.0 for k in NUMBERS[:4]}
    if traffic.get("flight_every") is not None:
        out["trace_gap"] = 0.0
    if traffic.get("carry"):
        out["scalars_gap"] = 0.0
    for got, (ref, trace, scalars) in pairs:
        lanes, want = got["lanes"], ref.lanes
        off = torch.zeros(lanes[0].shape, dtype=torch.bool,
                          device=lanes[0].device)
        for i in INT_LANES:
            off |= lanes[i].to(want[i].device) != want[i]
        out["nodes_off"] = max(out["nodes_off"],
                               _f(off.double().mean()))
        d = (lanes[2].to(want[2].device) - want[2]).abs()
        d = torch.where(off, 0.0, d)
        out["informed_gap"] = max(out["informed_gap"], _f(d.max()))
        out["counter_gap"] = max(out["counter_gap"], _stats_gap(
            got["stats"], ref.stats, P, traffic["rounds"]))
        out["clock_off"] += float(_f(got["t"]) != _f(ref.t)) \
            + float(_f(got["round_idx"]) != _f(ref.round_idx))
        if "trace_gap" in out:
            out["trace_gap"] = max(out["trace_gap"],
                                   _trace_gap(got["trace"], trace, P))
        if "scalars_gap" in out:
            g, w = got["scalars"].double().cpu(), scalars.double().cpu()
            rel = ((g - w).abs() / w.abs().clamp_min(1e-9)).max()
            out["scalars_gap"] = max(out["scalars_gap"], _f(rel))
    return {k: (math.inf if math.isnan(v) else v) for k, v in out.items()}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}): every number at or under
    its limit; a number with no limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in values.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
