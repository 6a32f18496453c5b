"""The chaos suite and the coordinates scenario.

Port of the chaos and coordinates parts of the JAX package's
``consul_tpu/sim/scenarios.py``: ``chaos_plans`` (five honest classes,
four byzantine), ``BYZANTINE_CHAOS``, the phase lengths, and
``run_chaos``, which runs one class through the kernel runner
(``make_run_rounds_cuda(plan=, flight_every=1)``) and reports per-phase
detection quality and curves from its flight trace, with the black box
on request; ``coords_plan`` and ``run_coords``, the cold-start Vivaldi
convergence through a partition and heal on the live engine
(``round.run_rounds_flight``) with RTT-aware probe deadlines. The
BASELINE scenarios, the checkpointed options and
``run_byzantine_defense`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from consul_tpu_torch.config import GossipConfig
from consul_tpu_torch.faults import (ChurnBurst, CompiledFaultPlan, Eclipse,
                                     FaultPlan, Flap, ForgedAcks, NodeLoss,
                                     Partition, Phase, SlowNodes,
                                     SpuriousSuspicion, StaleReplay,
                                     compile_plan)
from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim.blackbox import default_tracked
from consul_tpu_torch.sim.coords import init_coords
from consul_tpu_torch.sim.cuda_round import make_run_rounds_cuda
from consul_tpu_torch.sim.flight import stats_from_trace, trace_columns
from consul_tpu_torch.sim.metrics import (blackbox_report, phase_reports,
                                          trace_report)
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.round import run_rounds_flight
from consul_tpu_torch.sim.state import (DEAD, SUSPECT, check_saturation,
                                        init_state)
from consul_tpu_torch.sim.topology import TopologyParams, make_topology
from consul_tpu_torch.utils.platform import DeviceLike, default_device

# ------------------------------------------------------------------ chaos
#
# The detection-quality chaos suite: ≥5 named fault classes, each a
# three-phase FaultPlan (quiet warm-up, fault window, recovery window)
# run through the kernel runner on the flight recorder. The
# per-phase deltas (metrics.phase_reports) are the numbers Lifeguard's
# claims are expressed in: how fast real failures are detected, how
# many live nodes get wrongly declared, and whether refutation wins the
# race once the fault clears.

CHAOS_WARMUP_ROUNDS = 10
CHAOS_FAULT_ROUNDS = 60
CHAOS_RECOVER_ROUNDS = 50


def chaos_plans(n: int) -> dict[str, FaultPlan]:
    """The named chaos classes, sized for an n-node pool.

    The honest classes share one quiescent-recovery plan shape; the
    BYZANTINE classes (forged_acks/spurious_suspicion/eclipse/
    stale_replay — the adversarial tier) carry the extra adversarial
    tensors, so they compile separately (faults.compile_plan ships the
    byzantine leaves only for plans that need them), and the classes
    that kill victims recover them with a rejoin burst so every class
    still ends healed."""
    m = max(1, n // 16)
    # adversaries: the top 1/8th of the pool — disjoint by construction
    # from every victim range below (victims live at the bottom)
    adv = (n - max(1, n // 8), n)

    def tri(name: str, *faults, recover=()) -> FaultPlan:
        return FaultPlan(phases=(
            Phase(rounds=CHAOS_WARMUP_ROUNDS, name="warmup"),
            Phase(rounds=CHAOS_FAULT_ROUNDS, faults=tuple(faults),
                  name=name),
            Phase(rounds=CHAOS_RECOVER_ROUNDS, faults=tuple(recover),
                  name="recover"),
        ))

    return {
        # one-way cut: the minority hears the quorum but cannot answer
        # it — probes of it fail and its refutations never escape, so
        # it must be declared failed (the hack-free version of what
        # partition_heal asserts)
        "asym_partition": tri(
            "asym_partition",
            Partition(a=(0, m), b=(m, n), drop=1.0, symmetric=False)),
        # heavy bidirectional per-node packet loss on a minority:
        # Lifeguard's suspicion scaling should keep FP low while
        # detection stays possible
        "per_node_loss": tri(
            "per_node_loss",
            NodeLoss(nodes=(0, 2 * m), ingress=0.5, egress=0.5)),
        # forced-degraded nodes (GC pause / overload): acks late, the
        # local-health machinery's target failure mode
        "gc_pause": tri("gc_pause", SlowNodes(nodes=(0, 2 * m))),
        # crash/recover cycling faster than the suspicion timeout
        "flapping": tri("flapping",
                        Flap(nodes=(0, m), half_period=5)),
        # seeded mass churn: a quarter of the pool crashing at 2%/round
        # with fast rejoin — join/leave volume, not network damage
        "churn_burst": tri(
            "churn_burst",
            ChurnBurst(nodes=(0, n // 4), crash=0.02, rejoin=0.25)),
        # ---- byzantine tier: lying members, not broken networks ----
        # adversaries vouch for dead peers: victims crash but every
        # indirect probe of them hits a forging relay — detection is
        # SUPPRESSED (the class whose failure the report quantifies;
        # SimParams.corroboration_k is the defense, see
        # run_byzantine_defense). Recovery rejoins the hidden dead.
        "forged_acks": tri(
            "forged_acks",
            ChurnBurst(nodes=(0, m), crash=0.05),
            ForgedAcks(adversaries=adv, victims=(0, m), coverage=0.9),
            recover=(ChurnBurst(nodes=(0, m), rejoin=0.5),)),
        # forged suspect/inc-bump broadcasts about LIVE victims. The
        # measured result: Lifeguard's refutation race WINS against
        # pure rumor forgery (refutes ~= suspicions, FP 0) — the
        # attack's real cost is refutation LOAD: a suspicion storm and
        # the incarnation churn it forces, all adversary-attributed via
        # the attack_* columns. FPs appear only when the victims are
        # also muted, which is the eclipse class (the dangerous combo
        # is forge+eclipse, not forgery alone — compose them to see).
        "spurious_suspicion": tri(
            "spurious_suspicion",
            SpuriousSuspicion(adversaries=adv, victims=(0, 2 * m),
                              rate=2.0)),
        # adversary relays selectively drop the victims' traffic: the
        # victims starve — probes of them fail AND their refutations
        # never escape, so the quorum wrongly declares them (the
        # eclipse timeline: probe_timeout → suspect_start → declare)
        "eclipse": tri(
            "eclipse",
            Eclipse(adversaries=adv, victims=(0, m), coverage=0.95,
                    drop=1.0)),
        # replayed old-incarnation alive rumors: cannot resurrect
        # anyone (incarnation ordering — the defense this class
        # quantifies) but drag rumor dissemination about the victims
        # and force live victims into incarnation-bump churn
        "stale_replay": tri(
            "stale_replay",
            ChurnBurst(nodes=(0, m), crash=0.05),
            StaleReplay(adversaries=adv, victims=(0, 2 * m), rate=0.4),
            recover=(ChurnBurst(nodes=(0, m), rejoin=0.5),)),
    }


#: the byzantine chaos classes (subset of chaos_plans keys)
BYZANTINE_CHAOS = ("forged_acks", "spurious_suspicion", "eclipse",
                   "stale_replay")


def chaos_params(n: int) -> SimParams:
    """The chaos suite's default configuration: memberlist's LAN config,
    TCP fallback off, stats on."""
    return SimParams.from_gossip_config(GossipConfig.lan(), n=n,
                                        tcp_fallback=False)


def run_chaos(name: str, n: int = 4096, seed: int = 0,
              device: DeviceLike = None,
              cp: Optional[CompiledFaultPlan] = None,
              p: Optional[SimParams] = None,
              blackbox: bool = False) -> dict[str, Any]:
    """Run ONE chaos class through the kernel runner and report
    per-phase detection quality.

    The run rides the flight recorder at stride 1: the one trace feeds
    the per-phase counters (``phase_reports`` on ``stats_from_trace``)
    and the per-round curves (``trace_report``). ``blackbox=True``
    tracks ``p.blackbox_k`` evenly spaced agents on the same run and
    adds their decoded event totals (with the exact ring-against-flight
    cross-check when every agent is tracked) under ``"blackbox"``.
    ``p`` defaults to ``chaos_params(n)``; ``cp`` is the class's
    compiled plan if the caller has one (``compile_plan(
    chaos_plans(n)[name], n, device)``), else it is compiled here."""
    plan = chaos_plans(n)[name]
    if p is None:
        p = chaos_params(n)
    dev = default_device(device)
    if cp is None:
        cp = compile_plan(plan, n, dev)
    run = make_run_rounds_cuda(p, plan.total_rounds, plan=cp,
                               flight_every=1, blackbox=blackbox)
    tracked = default_tracked(n, p.blackbox_k, dev) if blackbox else None
    out = run(init_state(n, device=dev), prng.key(seed, device=dev),
              tracked=tracked)
    state, trace = out[:2]
    # a ChurnBurst that saturated an int16 lane must fail here, not
    # publish a silently corrupt report
    check_saturation(state)
    up = state.up
    wrongly = up & ((state.status == DEAD) | (state.status == SUSPECT))
    return {
        "scenario": name, "n": n, "rounds": plan.total_rounds,
        "phases": [r.to_dict() for r in phase_reports(
            stats_from_trace(trace), plan, p)],
        "flight": trace_report(trace, p, plan=plan,
                               rounds=plan.total_rounds),
        **({"blackbox": blackbox_report(out[2], p, trace=trace)}
           if blackbox else {}),
        "final_live_fraction": float(up.to(torch.float32).mean()),
        "final_wrongly_dead": int(wrongly.sum()),
    }


# ------------------------------------------------------------- coords
#
# Network-coordinate convergence: a cold-start population learns Vivaldi
# coordinates from probe RTTs against the synthetic topology, with a
# partition in the middle (partitioned nodes stop acking, their
# coordinates freeze) and the estimate error's recovery after the heal.

COORDS_WARMUP_ROUNDS = 60
COORDS_PARTITION_ROUNDS = 40
COORDS_HEAL_ROUNDS = 40
#: median relative RTT-estimate error a converged run is under
COORDS_CONVERGED_MED_ERR = 0.25


def coords_plan(n: int) -> FaultPlan:
    return FaultPlan(phases=(
        Phase(rounds=COORDS_WARMUP_ROUNDS, name="warmup"),
        Phase(rounds=COORDS_PARTITION_ROUNDS,
              faults=(Partition(a=(0, max(1, n // 8)),
                                b=(max(1, n // 8), n)),),
              name="partition"),
        Phase(rounds=COORDS_HEAL_ROUNDS, name="heal"),
    ))


def run_coords(n: int = 4096, seed: int = 0,
               p: Optional[SimParams] = None,
               topo_params: Optional[TopologyParams] = None,
               device: DeviceLike = None):
    """Run the coordinates scenario on the live engine; returns (report,
    final CoordState). The run rides the flight recorder at stride 1
    with Vivaldi coordinates and RTT-aware probe deadlines
    (``coords_timeout``) on: the report carries the per-phase median
    relative RTT-error curves and the first round under
    ``COORDS_CONVERGED_MED_ERR``."""
    dev = default_device(device)
    plan = coords_plan(n)
    if p is None:
        p = SimParams.from_gossip_config(GossipConfig.lan(), n=n,
                                         tcp_fallback=False,
                                         coords_timeout=True)
    topo = make_topology(topo_params if topo_params is not None
                         else TopologyParams(n=n, seed=seed), dev)
    cp = compile_plan(plan, n, dev)
    state, coords, trace = run_rounds_flight(
        init_state(n, device=dev), prng.key(seed, device=dev), p,
        plan.total_rounds, plan=cp, coords=init_coords(n, device=dev),
        topo=topo)
    cols = trace_columns(trace)
    med = cols["rtt_err_med"]
    below = (med < COORDS_CONVERGED_MED_ERR).nonzero()[0]
    report = {
        "scenario": "coords", "n": n, "rounds": plan.total_rounds,
        "converged_med_err": COORDS_CONVERGED_MED_ERR,
        "convergence_round": int(below[0] + 1) if below.size else -1,
        "med_err_at_60": float(med[COORDS_WARMUP_ROUNDS - 1]),
        "final_med_err": float(med[-1]),
        "final_p99_err": float(cols["rtt_err_p99"][-1]),
        "final_drift": float(cols["coord_drift"][-1]),
        "flight": trace_report(trace, p, plan=plan,
                               rounds=plan.total_rounds),
        "final_live_fraction": float(state.up.to(torch.float32).mean()),
    }
    return report, coords
