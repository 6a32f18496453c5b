"""Failure-detector quality metrics from simulation runs.

Port of ``fd_report`` / ``FDReport``, ``PhaseReport`` /
``phase_reports``, ``trace_report``, ``blackbox_report``,
``propagation_curve`` and the sweep reports (``message_load``,
``pareto_front``, ``sweep_report``) from the JAX package's
``consul_tpu/sim/metrics.py``: false positives, detection latency and
the informed/live fractions of a finished run, the same counters split
by FaultPlan phase (from a per-round stats trace or a flight trace),
the black box's event totals with their exact cross-check against the
flight counters, and a sweep's Pareto ranking.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from consul_tpu_torch.sim import blackbox as blackbox_mod
from consul_tpu_torch.sim.flight import FLIGHT_COLUMNS, trace_columns
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import SimState, SimStats
from consul_tpu_torch.utils import telemetry


@dataclass
class FDReport:
    rounds: int
    sim_seconds: float
    n: int
    false_positives: int
    refutes: int
    suspicions: int
    true_deaths_declared: int
    crashes: int
    rejoins: int
    leaves: int
    mean_detect_latency_s: float
    fp_per_node_hour: float
    live_fraction: float
    mean_informed: float

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def fd_report(state: SimState, p: SimParams) -> FDReport:
    st = state.stats
    rounds = int(state.round_idx)
    sim_s = float(state.t)
    fp = int(st.false_positives)
    tp = int(st.true_deaths_declared)
    node_hours = p.n * sim_s / 3600.0
    return FDReport(
        rounds=rounds, sim_seconds=sim_s, n=p.n,
        false_positives=fp, refutes=int(st.refutes),
        suspicions=int(st.suspicions), true_deaths_declared=tp,
        crashes=int(st.crashes), rejoins=int(st.rejoins),
        leaves=int(st.leaves),
        mean_detect_latency_s=(float(st.detect_latency_sum) / tp
                               if tp else 0.0),
        fp_per_node_hour=fp / node_hours if node_hours > 0 else 0.0,
        live_fraction=float(state.up.float().mean()),
        mean_informed=float(state.informed.double().mean()),
    )


@dataclass
class PhaseReport:
    """FD-quality counters for ONE FaultPlan phase — the deltas of the
    cumulative SimStats between the phase's boundary rounds."""

    phase: str
    start_round: int
    rounds: int
    suspicions: int
    refutes: int
    false_positives: int
    true_deaths_declared: int
    crashes: int
    rejoins: int
    leaves: int
    attack_suspicions: int
    attack_false_positives: int
    mean_detect_latency_s: float
    fp_per_node_hour: float
    attack_fp_per_node_hour: float
    honest_fp_per_node_hour: float

    def to_dict(self) -> dict:
        return dict(self.__dict__)


_COUNTERS = ("suspicions", "refutes", "false_positives",
             "true_deaths_declared", "crashes", "rejoins", "leaves",
             "attack_suspicions", "attack_false_positives")


def _phase_quality(d: dict, lat: float, phase_s: float, n: int) -> dict:
    """The derived FD-quality rates of one phase window; the attack /
    honest FP split rides the adversary-attribution counters."""
    td = d["true_deaths_declared"]
    node_hours = n * phase_s / 3600.0
    fp = d["false_positives"]
    afp = d.get("attack_false_positives", 0)
    return {
        "mean_detect_latency_s": lat / td if td else 0.0,
        "fp_per_node_hour": (fp / node_hours
                             if node_hours > 0 else 0.0),
        "attack_fp_per_node_hour": (afp / node_hours
                                    if node_hours > 0 else 0.0),
        "honest_fp_per_node_hour": (max(fp - afp, 0) / node_hours
                                    if node_hours > 0 else 0.0),
    }


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def phase_reports(stats_trace: SimStats, plan,
                  p: SimParams) -> list[PhaseReport]:
    """Per-phase detection-quality reports from a per-round CUMULATIVE
    stats trace (``round.run_rounds_stats``, or
    ``flight.stats_from_trace`` of a stride-1 flight trace) whose round 0
    is plan round 0. Phases past the trace are omitted; a trace longer
    than the plan credits the excess to the last phase."""
    tr = SimStats(*[_leaf(x) for x in stats_trace])
    total = int(tr.false_positives.shape[0])
    out: list[PhaseReport] = []
    prev = {f: 0.0 for f in _COUNTERS}
    prev_lat = 0.0
    names, starts = plan.phase_names(), plan.starts
    for i, (name, start) in enumerate(zip(names, starts)):
        if start >= total:
            break
        end = min(starts[i + 1] if i + 1 < len(starts) else total, total)
        cur = {f: float(getattr(tr, f)[end - 1]) for f in _COUNTERS}
        lat = float(tr.detect_latency_sum[end - 1])
        d = {f: int(cur[f] - prev[f]) for f in _COUNTERS}
        out.append(PhaseReport(
            phase=name, start_round=start, rounds=end - start,
            **_phase_quality(d, lat - prev_lat,
                             (end - start) * p.probe_interval, p.n),
            **d))
        prev, prev_lat = cur, lat
    return out


def trace_report(trace, p: SimParams, plan=None, record_every: int = 1,
                 rounds: Optional[int] = None) -> dict:
    """Per-phase detection-latency / false-positive curves from a flight
    trace. Counter columns are per-window deltas, so a phase's totals
    are sums over its rows (a window straddling a phase boundary belongs
    to the phase that holds its end). Without ``rounds`` the last
    window's length is read off the t column."""
    cols = trace_columns(trace)
    n_rows = len(cols["t"])
    if rounds is not None:
        total = rounds
    elif n_rows > 1:
        last_w = int(round((cols["t"][-1] - cols["t"][-2])
                           / p.probe_interval))
        total = (n_rows - 1) * record_every + max(last_w, 1)
    else:
        total = n_rows * record_every
    # the round each row records: its window's end
    row_round = np.minimum((np.arange(n_rows) + 1) * record_every, total)
    if plan is not None:
        names, starts = plan.phase_names(), list(plan.starts)
    else:
        names, starts = ["run"], [0]
    phases = []
    for i, (name, start) in enumerate(zip(names, starts)):
        if start >= total:
            break
        end = min(starts[i + 1] if i + 1 < len(starts) else total, total)
        sel = (row_round > start) & (row_round <= end)
        d = {f: int(cols[f][sel].sum()) for f in _COUNTERS}
        lat = float(cols["detect_latency_sum"][sel].sum())
        phases.append({
            "phase": name, "start_round": int(start),
            "rounds": int(end - start), **d,
            **_phase_quality(d, lat, (end - start) * p.probe_interval,
                             p.n),
            "min_live_frac": (float(cols["live_frac"][sel].min())
                              if sel.any() else 1.0),
            "max_wrong_frac": (float(cols["wrong_frac"][sel].max())
                               if sel.any() else 0.0),
            "curve": {
                "round": [int(r) for r in row_round[sel]],
                "live_frac": [round(float(v), 6)
                              for v in cols["live_frac"][sel]],
                "wrong_frac": [round(float(v), 6)
                               for v in cols["wrong_frac"][sel]],
                "false_positives": [int(v)
                                    for v in cols["false_positives"][sel]],
                "rtt_err_med": [round(float(v), 6)
                                for v in cols["rtt_err_med"][sel]],
            },
        })
    return {"record_every": int(record_every), "rows": int(n_rows),
            "rounds": int(total), "columns": list(FLIGHT_COLUMNS),
            "phases": phases}


def blackbox_report(bb, p: SimParams, trace=None,
                    record_every: int = 1) -> dict:
    """Decoded black-box summary: per-code event totals over the
    tracked agents and ring-wrap accounting; when every agent was
    tracked at stride 1 with nothing dropped and the run's flight trace
    is given, the exact cross-check of ring totals against the flight
    counter columns (``crosscheck_agree``)."""
    timelines = blackbox_mod.decode_timeline(bb, p.probe_interval)
    totals = blackbox_mod.event_totals(timelines)
    dropped = sum(tl["dropped"] for tl in timelines.values())
    out: dict = {
        "tracked": len(timelines),
        "ring_len": int(bb.ring.shape[1]),
        "events": {k: v for k, v in totals.items() if v},
        "dropped_events": dropped,
    }
    exhaustive = (len(timelines) == p.n and record_every == 1
                  and dropped == 0)
    if trace is not None and exhaustive:
        cols = trace_columns(trace)

        def total(*names):
            return int(sum(cols[c].sum() for c in names))

        pairs = {
            "suspect_start": ("suspicions", total("suspicions")),
            "refute": ("refutes", total("refutes")),
            "crash": ("crashes", total("crashes")),
            "rejoin": ("rejoins", total("rejoins")),
            "leave": ("leaves", total("leaves")),
            "declare_dead": ("false_positives+true_deaths",
                             total("false_positives",
                                   "true_deaths_declared")),
            "attack_suspect_start": ("attack_suspicions",
                                     total("attack_suspicions")),
            "attack_false_positive": ("attack_false_positives",
                                      total("attack_false_positives")),
        }
        out["crosscheck"] = {
            ev: {"ring": totals[ev], "flight": flight_total,
                 "column": col, "agree": totals[ev] == flight_total}
            for ev, (col, flight_total) in pairs.items()}
        out["crosscheck_agree"] = all(
            c["agree"] for c in out["crosscheck"].values())
    return out


def propagation_curve(trace, probe_interval: float,
                      threshold: float = 0.9999):
    """From a per-round informed-fraction trace of one rumor: (the trace
    as numpy, the seconds to reach ``threshold`` coverage, inf if
    never)."""
    tr = _leaf(trace)
    hit = np.nonzero(tr >= threshold)[0]
    t = float(hit[0] + 1) * probe_interval if hit.size else float("inf")
    return tr, t


# ------------------------------------------------------------- sweeps


def message_load(p: SimParams) -> float:
    """Expected protocol messages per node per round, analytic from the
    point's constants: the direct probe's round trip (2), the indirect
    fan-out a direct miss triggers (4 legs per ping-req, plus the 2-leg
    TCP fallback when on), and the piggyback gossip fan-out."""
    miss = 1.0 - p.p_direct
    indirect = 4.0 * p.indirect_checks + (2.0 if p.tcp_fallback else 0.0)
    return 2.0 + miss * indirect + p.gossip_nodes * p.gossip_ticks_per_round


def pareto_front(rows: list, keys: tuple) -> list:
    """Indices of the non-dominated rows, minimizing every key (None
    reads as +inf)."""
    def val(r, k):
        v = r[k]
        return float("inf") if v is None else float(v)

    out = []
    for i, a in enumerate(rows):
        dominated = False
        for j, b in enumerate(rows):
            if i == j:
                continue
            if all(val(b, k) <= val(a, k) for k in keys) and \
                    any(val(b, k) < val(a, k) for k in keys):
                dominated = True
                break
        if not dominated:
            out.append(i)
    return out


#: the sweep's quality axes, all minimized
SWEEP_OBJECTIVES = ("mean_detect_latency_s", "fp_per_node_hour",
                    "msg_load")


def sweep_report(result, fp_budget: float = 1.0) -> dict:
    """Pareto-rank a sweep (``sweep.SweepResult``) on detection latency,
    false-positive rate and message load (reference ``sweep_report``).

    The ``[G]`` counters, clocks and live fractions come off the device
    in one copy (f64, exact for int32 and f32). The winner is the front
    point with the lowest latency within ``fp_budget`` false positives
    per node-hour, else the lowest-FP front point; a point that declared
    no real death has latency None and never wins. It runs under the
    span ``sim.sweep.report``."""
    with telemetry.span("sim.sweep.report"):
        from consul_tpu_torch.sim.params import SWEEPABLE_FIELDS

        states = result.states
        st = states.stats
        fields = list(SimStats._fields)
        host = torch.stack(
            [getattr(st, f).to(torch.float64) for f in fields]
            + [states.t.to(torch.float64),
               (states.down_age < 0).to(torch.float64).mean(-1)]).cpu().numpy()
        col = {f: host[i] for i, f in enumerate(fields)}
        sim_s, live = host[len(fields)], host[len(fields) + 1]
        swept = sorted(k for k in result.tp.leaves if k in SWEEPABLE_FIELDS)
        rows: list = []
        for i, pp in enumerate(result.points):
            tdd = int(col["true_deaths_declared"][i])
            fp = int(col["false_positives"][i])
            crashes = int(col["crashes"][i])
            node_hours = pp.n * float(sim_s[i]) / 3600.0
            lat = (float(col["detect_latency_sum"][i]) / tdd if tdd else None)
            rows.append({
                "point": i,
                "params": {k: getattr(pp, k) for k in swept},
                "mean_detect_latency_s": lat,
                "fp_per_node_hour": (fp / node_hours if node_hours > 0
                                     else 0.0),
                "msg_load": round(message_load(pp), 4),
                "false_positives": fp,
                "true_deaths_declared": tdd,
                "suspicions": int(col["suspicions"][i]),
                "refutes": int(col["refutes"][i]),
                "crashes": crashes,
                "missed_detections": max(crashes - tdd, 0),
                "missed_detection_rate": (max(crashes - tdd, 0) / crashes
                                          if crashes else 0.0),
                "attack_suspicions": int(col["attack_suspicions"][i]),
                "attack_false_positives": int(
                    col["attack_false_positives"][i]),
                "live_fraction": float(live[i]),
            })
        front = pareto_front(rows, SWEEP_OBJECTIVES)
        for i in front:
            rows[i]["pareto"] = True
        eligible = [i for i in front
                    if rows[i]["mean_detect_latency_s"] is not None
                    and rows[i]["fp_per_node_hour"] <= fp_budget]
        if eligible:
            winner = min(eligible,
                         key=lambda i: (rows[i]["mean_detect_latency_s"],
                                        rows[i]["msg_load"]))
        else:
            measured = [i for i in front
                        if rows[i]["mean_detect_latency_s"] is not None]
            pool = measured or front
            winner = min(pool, key=lambda i: (rows[i]["fp_per_node_hour"],
                                              rows[i]["msg_load"]))
        return {
            "grid_size": len(rows),
            "rounds": result.rounds,
            "swept": swept,
            "objectives": list(SWEEP_OBJECTIVES),
            "fp_budget_per_node_hour": fp_budget,
            "pareto": front,
            "winner": rows[winner],
            "points": rows,
        }
