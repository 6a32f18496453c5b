"""Failure-detector quality metrics from simulation runs.

Port of ``fd_report`` / ``FDReport`` from the JAX package's
``consul_tpu/sim/metrics.py``: false positives, detection latency and the
informed/live fractions of a finished run.
"""

from __future__ import annotations

from dataclasses import dataclass

from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import SimState


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
