"""Failure-detector quality metrics from simulation runs.

Port of ``fd_report`` / ``FDReport`` and ``PhaseReport`` /
``phase_reports`` from the JAX package's ``consul_tpu/sim/metrics.py``:
false positives, detection latency and the informed/live fractions of a
finished run, and the same counters split by FaultPlan phase.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import SimState, SimStats


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


def phase_reports(phase_end_stats: Sequence[SimStats], plan,
                  p: SimParams) -> list[PhaseReport]:
    """Per-phase detection-quality reports for a FaultPlan run from
    plan round 0.

    ``phase_end_stats[i]`` is the cumulative SimStats after phase i's
    last round — the only rows of a per-round trace the reference's
    ``phase_reports`` reads, so a runner cut at the phase starts
    supplies them without a per-round trace. Phases past the list are
    omitted."""
    out: list[PhaseReport] = []
    prev = {f: 0.0 for f in _COUNTERS}
    prev_lat = 0.0
    names, starts = plan.phase_names(), plan.starts
    for name, start, ph, st in zip(names, starts, plan.phases,
                                   phase_end_stats):
        cur = {f: float(getattr(st, f)) for f in _COUNTERS}
        lat = float(st.detect_latency_sum)
        d = {f: int(cur[f] - prev[f]) for f in _COUNTERS}
        out.append(PhaseReport(
            phase=name, start_round=start, rounds=ph.rounds,
            **_phase_quality(d, lat - prev_lat,
                             ph.rounds * p.probe_interval, p.n),
            **d))
        prev, prev_lat = cur, lat
    return out
