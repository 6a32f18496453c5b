"""The BASELINE scenarios, the chaos suite and the coordinates scenario.

Port of the JAX package's ``consul_tpu/sim/scenarios.py``:
``partition_heal`` (BASELINE config 5: a WAN partition of DC 0 and the
heal, on the live engine); ``chaos_plans`` (five honest classes, four
byzantine), ``BYZANTINE_CHAOS``, the phase lengths, and ``run_chaos``,
which runs one class through the kernel runner
(``make_run_rounds_cuda(plan=, flight_every=1)``, or checkpointed
through ``checkpoint.run_resumable(engine="cuda")``) and reports
per-phase detection quality and curves from its flight trace, with the
black box on request; ``run_chaos_suite`` with its ``ProgressManifest``;
``coords_plan``, ``coords_setup`` and ``run_coords``, the cold-start Vivaldi
convergence through a partition and heal on the live engine
(``round.run_rounds_flight``) with RTT-aware probe deadlines;
``run_byzantine_defense``, the corroboration_k sweep against a
ForgedAcks attack; the autotuner (``AUTOTUNE_GRID`` over the
``AUTOTUNE_TOPOLOGIES`` classes, ``run_autotune``,
``run_autotune_suite``) on the sweep engine (``sim/sweep.py``); and
``run_baseline_config``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from consul_tpu_torch.config import GossipConfig
from consul_tpu_torch.faults import (ChurnBurst, CompiledFaultPlan, Eclipse,
                                     FaultPlan, Flap, ForgedAcks, NodeLoss,
                                     Partition, Phase, SlowNodes,
                                     SpuriousSuspicion, StaleReplay,
                                     compile_plan)
from consul_tpu_torch.sim import checkpoint as checkpoint_mod
from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim.blackbox import default_tracked
from consul_tpu_torch.sim.coords import init_coords
from consul_tpu_torch.sim.cuda_round import make_run_rounds_cuda
from consul_tpu_torch.sim.flight import stats_from_trace, trace_columns
from consul_tpu_torch.sim.metrics import (blackbox_report, fd_report,
                                          phase_reports, sweep_report,
                                          trace_report)
from consul_tpu_torch.sim.params import SimParams, SweepAxes, baseline_configs
from consul_tpu_torch.sim.round import run_rounds, run_rounds_flight
from consul_tpu_torch.sim.sweep import run_sweep
from consul_tpu_torch.sim.state import (ALIVE, DEAD, SUSPECT,
                                        check_saturation, init_state)
from consul_tpu_torch.sim.topology import (Topology, TopologyParams,
                                           make_topology)
from consul_tpu_torch.utils.platform import DeviceLike, default_device

# ------------------------------------------------------ partition-heal
#
# BASELINE config 5, the multi-DC federation scenario. Each DC is an
# independent LAN gossip pool and only servers join the cross-DC WAN
# pool, so the massive LAN pools run as per-DC simulations and the WAN
# server mesh is small; the partition is ``faults.Partition`` on it.


@dataclass
class PartitionHealReport:
    n_dcs: int
    servers_per_dc: int
    lan_nodes_per_dc: int
    partition_rounds: int
    detected_cross_dc_failures: int   # WAN members declared dead
    false_positives_during_partition: int
    healed_recovery_rounds: float     # rounds until all WAN members alive
    lan_false_positives: int          # LAN pools must be unaffected

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)


def partition_heal(n_dcs: int = 3, servers_per_dc: int = 3,
                   lan_nodes_per_dc: int = 10_000,
                   partition_rounds: int = 120, seed: int = 0,
                   device: DeviceLike = None) -> PartitionHealReport:
    """BASELINE config 5 on the live engine: a WAN partition between DC
    0 and the rest, then the heal. The quorum side must declare DC 0's
    servers failed during the partition (DC 0 stays up, but its probes
    and refutations cannot cross the cut), they must recover after the
    heal, and the per-DC LAN pools must stay clean."""
    dev = default_device(device)
    n_wan = n_dcs * servers_per_dc
    if n_wan < 6:
        raise ValueError(
            f"WAN pool too small for the mean-field model: {n_wan} < 6")
    p_wan = SimParams.from_gossip_config(GossipConfig.wan(), n=n_wan)
    state = init_state(p_wan.n, device=dev)
    key = prng.key(seed, device=dev)
    dc0 = torch.arange(p_wan.n, device=dev) < servers_per_dc
    # every DC0<->rest leg drops while DC0 stays up; the trailing quiet
    # phase holds for every round past the plan's end (the heal loop)
    plan = FaultPlan(phases=(
        Phase(rounds=partition_rounds,
              faults=(Partition(a=(0, servers_per_dc),
                                b=(servers_per_dc, n_wan)),),
              name="partition"),
        Phase(rounds=10, name="heal"),
    ))
    cp = compile_plan(plan, n_wan, dev)
    state, _ = run_rounds(state, key, p_wan, partition_rounds, plan=cp)
    during = fd_report(state, p_wan)
    dead0 = (state.status == DEAD) & dc0
    detected = int(dead0.sum())
    # the stats count DC0's declarations as false positives (its members
    # ARE up); during a partition those are the correct detections
    fp_during = max(0, during.false_positives
                    - int((dead0 & state.up).sum()))

    # heal: DC0 refutes with bumped incarnations once gossip flows
    recovery = None
    for chunk in range(40):
        state, _ = run_rounds(state, prng.fold_in(key, chunk), p_wan, 10,
                              plan=cp)
        if bool(((state.status == ALIVE) | ~dc0).all()):
            recovery = (chunk + 1) * 10
            break

    lan_fp = 0
    p_lan = SimParams.from_gossip_config(GossipConfig.lan(),
                                         n=lan_nodes_per_dc, loss=0.01)
    for dc in range(n_dcs):
        s, _ = run_rounds(init_state(p_lan.n, device=dev),
                          prng.fold_in(key, 1000 + dc), p_lan,
                          partition_rounds)
        lan_fp += int(s.stats.false_positives)

    return PartitionHealReport(
        n_dcs=n_dcs, servers_per_dc=servers_per_dc,
        lan_nodes_per_dc=lan_nodes_per_dc,
        partition_rounds=partition_rounds,
        detected_cross_dc_failures=detected,
        false_positives_during_partition=fp_during,
        healed_recovery_rounds=float(recovery or -1),
        lan_false_positives=lan_fp)


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


def chaos_outputs(name: str, n: int = 4096, seed: int = 0,
                  device: DeviceLike = None,
                  cp: Optional[CompiledFaultPlan] = None,
                  p: Optional[SimParams] = None, blackbox: bool = False,
                  ckpt_dir: Optional[str] = None, guard=None,
                  resume: bool = False, chunk: Optional[int] = None):
    """The run behind ``run_chaos``: ``(state, trace, BlackboxState or
    None)``, or the preempted stub dict of a checkpointed run that a
    guard cut (the arguments are ``run_chaos``'s)."""
    plan = chaos_plans(n)[name]
    if p is None:
        p = chaos_params(n)
    dev = default_device(device)
    if cp is None:
        cp = compile_plan(plan, n, dev)
    tracked = default_tracked(n, p.blackbox_k, dev) if blackbox else None
    key = prng.key(seed, device=dev)
    if not ckpt_dir and guard is None:
        run = make_run_rounds_cuda(p, plan.total_rounds, plan=cp,
                                   flight_every=1, blackbox=blackbox)
        out = run(init_state(n, device=dev), key, tracked=tracked)
        return out[0], out[1], out[2] if blackbox else None
    rr = checkpoint_mod.run_resumable(
        p, plan.total_rounds, key, engine="cuda", plan=cp, flight_every=1,
        tracked=tracked, chunk=chunk, ckpt_dir=ckpt_dir, guard=guard,
        resume=resume, device=dev)
    if rr.preempted:
        return {"scenario": name, "n": n, "preempted": True,
                "rounds_done": rr.rounds_done, "rounds": plan.total_rounds,
                "checkpoint": rr.checkpoint_path}
    return rr.state, rr.trace, rr.blackbox


def chaos_report(name: str, n: int, outputs,
                 p: Optional[SimParams] = None) -> dict[str, Any]:
    """``run_chaos``'s report of ``chaos_outputs``' ``(state, trace,
    blackbox)``."""
    plan = chaos_plans(n)[name]
    if p is None:
        p = chaos_params(n)
    state, trace, bb = outputs
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
        **({"blackbox": blackbox_report(bb, p, trace=trace)}
           if bb is not None else {}),
        "final_live_fraction": float(up.to(torch.float32).mean()),
        "final_wrongly_dead": int(wrongly.sum()),
    }


def run_chaos(name: str, n: int = 4096, seed: int = 0,
              device: DeviceLike = None,
              cp: Optional[CompiledFaultPlan] = None,
              p: Optional[SimParams] = None,
              blackbox: bool = False,
              ckpt_dir: Optional[str] = None,
              guard=None, resume: bool = False,
              chunk: Optional[int] = None) -> dict[str, Any]:
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
    chaos_plans(n)[name], n, device)``), else it is compiled here.

    With ``ckpt_dir`` or ``guard`` the run goes through
    ``checkpoint.run_resumable(engine="cuda")`` in ``chunk``-round
    pieces — the same kernels and the same run bit for bit — saving a
    rotating checkpoint per chunk. A tripped guard returns a
    ``{"preempted": True, ...}`` stub instead of a report; ``resume``
    restarts from the newest loadable file, and the finished report
    equals an uninterrupted run's."""
    out = chaos_outputs(name, n=n, seed=seed, device=device, cp=cp, p=p,
                        blackbox=blackbox, ckpt_dir=ckpt_dir, guard=guard,
                        resume=resume, chunk=chunk)
    if isinstance(out, dict):
        return out
    return chaos_report(name, n, out, p)


def run_chaos_suite(n: int = 4096, seed: int = 0, device: DeviceLike = None,
                    ckpt_dir: Optional[str] = None, guard=None,
                    resume: bool = False) -> dict[str, Any]:
    """Every chaos class once. With ``ckpt_dir`` the suite survives
    preemption two levels deep: a ``ProgressManifest`` records each
    finished class's report (replayed only under ``resume``: a plain
    run measures again), and the class in flight checkpoints per chunk
    in its own subdirectory. A tripped guard returns the partial suite
    with ``"preempted"`` naming the class it stopped in."""
    dev = default_device(device)
    if not ckpt_dir and guard is None:
        return {name: run_chaos(name, n=n, seed=seed, device=dev)
                for name in chaos_plans(n)}
    manifest = (checkpoint_mod.ProgressManifest(
        ckpt_dir, config={"mode": "chaos", "n": n, "seed": seed})
        if ckpt_dir else None)
    out: dict[str, Any] = {}
    for name in chaos_plans(n):
        if manifest is not None and resume and manifest.done(name):
            out[name] = manifest.result(name)
            continue
        rep = run_chaos(
            name, n=n, seed=seed, device=dev,
            ckpt_dir=os.path.join(ckpt_dir, name) if ckpt_dir else None,
            guard=guard, resume=resume)
        out[name] = rep
        if rep.get("preempted"):
            out["preempted"] = name
            return out
        if manifest is not None:
            manifest.mark(name, rep)
    return out


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


class CoordsSetup(NamedTuple):
    """What a coordinates run is built from (``coords_setup``)."""

    p: SimParams
    plan: FaultPlan
    cp: CompiledFaultPlan
    topo: Topology


def coords_params(n: int) -> SimParams:
    """The coordinates scenario's configuration: memberlist's LAN config,
    TCP fallback off, RTT-aware probe deadlines (``coords_timeout``) on,
    stats on."""
    return SimParams.from_gossip_config(GossipConfig.lan(), n=n,
                                        tcp_fallback=False,
                                        coords_timeout=True)


def coords_setup(n: int, seed: int = 0, p: Optional[SimParams] = None,
                 topo_params: Optional[TopologyParams] = None,
                 device: DeviceLike = None) -> CoordsSetup:
    """The set-up of a coordinates run of ``n`` agents: its parameters
    (``p``, else ``coords_params(n)``), ``coords_plan(n)`` and its
    compiled form on ``device``, and the topology of ``topo_params``
    (else ``TopologyParams``' defaults at ``n``, drawn from ``seed``).
    ``run_coords`` and the benchmark's coordinates driver both build
    from it."""
    dev = default_device(device)
    plan = coords_plan(n)
    topo = make_topology(topo_params if topo_params is not None
                         else TopologyParams(n=n, seed=seed), dev)
    return CoordsSetup(p=coords_params(n) if p is None else p, plan=plan,
                       cp=compile_plan(plan, n, dev), topo=topo)


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
    su = coords_setup(n, seed=seed, p=p, topo_params=topo_params,
                      device=dev)
    p, plan = su.p, su.plan
    state, coords, trace = run_rounds_flight(
        init_state(n, device=dev), prng.key(seed, device=dev), p,
        plan.total_rounds, plan=su.cp, coords=init_coords(n, device=dev),
        topo=su.topo)
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


# ------------------------------------------------- byzantine defense
#
# The corroboration_k defense sweep: one sweep runs every k against a
# ForgedAcks attack hiding a crashing victim set, a second honest sweep
# prices the defense — missed detections under attack against honest
# detection latency, per k.

BYZ_DEFENSE_KS = (0, 1, 2, 3)


def run_byzantine_defense(n: int = 1024, rounds: int = 120, seed: int = 0,
                          ks=BYZ_DEFENSE_KS, engine: str = "xla",
                          device: DeviceLike = None) -> dict[str, Any]:
    """Sweep ``SimParams.corroboration_k`` against a ForgedAcks attack
    (reference ``run_byzantine_defense``): baseline churn kills nodes
    everywhere, and adversaries forge acks for a quarter-pool victim
    set at 0.9 relay coverage. Two sweeps over the k axis — the plan
    armed, then honest — give per k the attack's missed-detection rate,
    the honest detection latency and the FP rates; the report names
    the k with the lowest attack-induced missed rate (ties to the lower
    k), its defense factor against k = 0 and the honest latency ratio
    it costs."""
    dev = default_device(device)
    p = SimParams.from_gossip_config(
        GossipConfig.lan(), n=n, tcp_fallback=False, loss=0.05,
        fail_per_round=0.003)
    vic = (0, n // 4)
    adv = (n - max(1, n // 8), n)
    plan = FaultPlan(phases=(
        Phase(rounds=rounds,
              faults=(ForgedAcks(adversaries=adv, victims=vic,
                                 coverage=0.9),),
              name="forged"),))
    cp = compile_plan(plan, n, dev)
    axes = SweepAxes.of(corroboration_k=[float(k) for k in ks])
    attack = sweep_report(run_sweep(p, axes, rounds, seed=seed, plan=cp,
                                    engine=engine, device=dev))
    honest = sweep_report(run_sweep(p, axes, rounds, seed=seed,
                                    engine=engine, device=dev))

    def col(rep, key):
        return [r[key] for r in rep["points"]]

    a_missed = col(attack, "missed_detection_rate")
    h_missed = col(honest, "missed_detection_rate")
    h_lat = col(honest, "mean_detect_latency_s")
    # the attack-INDUCED missed rate: the honest run misses only the
    # recently crashed tail (suspicions pending at the run's end)
    induced = [max(a - h, 0.0) for a, h in zip(a_missed, h_missed)]
    best = min(range(len(ks)), key=lambda i: (induced[i], ks[i]))
    base = induced[0] if induced[0] > 0 else 1.0
    return {
        "scenario": "byzantine_defense",
        "n": n, "rounds": rounds, "engine": engine,
        "ks": list(ks),
        "victims": list(vic), "adversaries": list(adv),
        "coverage": 0.9,
        "attack_missed_detection_rate": a_missed,
        "attack_induced_missed_rate": induced,
        "attack_mean_detect_latency_s": col(
            attack, "mean_detect_latency_s"),
        "attack_fp_per_node_hour": col(attack, "fp_per_node_hour"),
        "attack_suspicions": col(attack, "attack_suspicions"),
        "honest_missed_detection_rate": h_missed,
        "honest_mean_detect_latency_s": h_lat,
        "honest_fp_per_node_hour": col(honest, "fp_per_node_hour"),
        "best_k": int(ks[best]),
        # None: the defense removed the attack-induced excess entirely
        "defense_factor": (base / induced[best]
                           if induced[best] > 0 else None),
        "induced_eliminated": induced[best] == 0.0,
        "honest_latency_ratio": (h_lat[best] / h_lat[0]
                                 if h_lat[0] else None),
    }


# ----------------------------------------------------------- autotune
#
# The parameter-sweep autotuner: one runner runs a 64-point grid of
# gossip constants per topology class, and the Pareto report picks the
# constants with the lowest detection latency within a false-positive
# budget at the lowest message load.

#: the topology classes the tuner optimizes for
AUTOTUNE_TOPOLOGIES = ("lan", "wan", "lossy")

#: the 4 x 4 x 4 = 64-point grid: dissemination fan-out, suspicion
#: timer multiplier (down to 1, below memberlist's default of 4, where
#: the latency / false-positive trade-off appears), gossip tick period
AUTOTUNE_GRID = {
    "gossip_nodes": (2.0, 3.0, 4.0, 5.0),
    "suspicion_mult": (1.0, 2.0, 4.0, 6.0),
    "gossip_interval": (0.1, 0.2, 0.35, 0.5),
}


def autotune_params(topology: str, n: int) -> SimParams:
    """The base SimParams a topology class is tuned against:
    memberlist's DefaultLANConfig at 1% (lan) or 10% (lossy) loss, its
    DefaultWANConfig at 3% (wan); churn enough to measure detection."""
    crash = 0.002
    common = dict(n=n, tcp_fallback=False, fail_per_round=crash,
                  rejoin_per_round=crash * 10.0)
    if topology == "lan":
        return SimParams.from_gossip_config(GossipConfig.lan(),
                                            loss=0.01, **common)
    if topology == "wan":
        return SimParams.from_gossip_config(GossipConfig.wan(),
                                            loss=0.03, **common)
    if topology == "lossy":
        return SimParams.from_gossip_config(GossipConfig.lan(),
                                            loss=0.10, **common)
    raise ValueError(f"unknown autotune topology {topology!r} "
                     f"(expected one of {AUTOTUNE_TOPOLOGIES})")


def run_autotune(topology: str = "lan", n: int = 1024, rounds: int = 150,
                 seed: int = 0, grid: Optional[dict] = None,
                 fp_budget: float = 1.0, engine: str = "xla",
                 device: DeviceLike = None) -> dict[str, Any]:
    """Sweep the gossip constants for one topology class and pick the
    winner: the sweep report plus the chosen constants under
    ``"chosen"``."""
    p = autotune_params(topology, n)
    axes = SweepAxes.of(**(grid if grid is not None else AUTOTUNE_GRID))
    result = run_sweep(p, axes, rounds, seed=seed, engine=engine,
                       device=device)
    report = sweep_report(result, fp_budget=fp_budget)
    report["scenario"] = "autotune"
    report["topology"] = topology
    report["n"] = n
    report["engine"] = engine
    report["chosen"] = dict(report["winner"]["params"])
    return report


def run_autotune_suite(n: int = 1024, rounds: int = 150, seed: int = 0,
                       device: DeviceLike = None) -> dict[str, Any]:
    """Every topology class once: the per-class constants table."""
    return {t: run_autotune(t, n=n, rounds=rounds, seed=seed,
                            device=device)
            for t in AUTOTUNE_TOPOLOGIES}


def run_baseline_config(name: str, rounds: int = 300, seed: int = 0,
                        device: DeviceLike = None) -> dict[str, Any]:
    """Run one of the named BASELINE configs on the live engine and
    report FD quality."""
    dev = default_device(device)
    p = baseline_configs()[name]
    state, _ = run_rounds(init_state(p.n, device=dev),
                          prng.key(seed, device=dev), p, rounds)
    return {"config": name, "rounds": rounds,
            **fd_report(state, p).to_dict()}
