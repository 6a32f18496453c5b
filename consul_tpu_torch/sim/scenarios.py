"""The chaos suite: named FaultPlan classes run through the kernels.

Port of the chaos part of the JAX package's ``consul_tpu/sim/
scenarios.py``: ``chaos_plans`` (five honest classes, four byzantine),
``BYZANTINE_CHAOS``, the phase lengths, and ``run_chaos``, which runs
one class through the kernel runner (``make_run_rounds_cuda(plan=)``)
and reports per-phase detection quality. The reference's run rides the
flight recorder; the port's cuts the run at each phase start instead
and reads the cumulative counters there, which is all
``phase_reports`` needs. The BASELINE scenarios, the checkpointed and
black-box options and ``run_byzantine_defense`` are not ported yet.
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
from consul_tpu_torch.sim.cuda_round import make_run_rounds_cuda
from consul_tpu_torch.sim.metrics import phase_reports
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import (DEAD, SUSPECT, check_saturation,
                                        init_state)
from consul_tpu_torch.utils.platform import DeviceLike, default_device

# ------------------------------------------------------------------ chaos
#
# The detection-quality chaos suite: ≥5 named fault classes, each a
# three-phase FaultPlan (quiet warm-up, fault window, recovery window)
# run through the kernel runner, cut at each phase start. The
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
              cp: Optional[CompiledFaultPlan] = None) -> dict[str, Any]:
    """Run ONE chaos class on ``chaos_params(n)`` through the kernel
    runner and report per-phase detection quality.

    The run is cut at each phase start (one ``carry=True`` runner call
    per phase, the stale scalars handed on); seeds are keyed by the
    absolute round, so the cut run is the uncut run on every node lane
    and counter. ``cp`` is the class's compiled plan if the caller has
    one (``compile_plan(chaos_plans(n)[name], n, device)``), else it is
    compiled here."""
    plan = chaos_plans(n)[name]
    p = chaos_params(n)
    dev = default_device(device)
    if cp is None:
        cp = compile_plan(plan, n, dev)
    state = init_state(n, device=dev)
    key = prng.key(seed, device=dev)
    ends, scalars = [], None
    for ph in plan.phases:
        run = make_run_rounds_cuda(p, ph.rounds, carry=True, plan=cp)
        state, scalars = run(state, key, scalars0=scalars)
        ends.append(state.stats)
    # a ChurnBurst that saturated an int16 lane must fail here, not
    # publish a silently corrupt report
    check_saturation(state)
    up = state.up
    wrongly = up & ((state.status == DEAD) | (state.status == SUSPECT))
    return {
        "scenario": name, "n": n, "rounds": plan.total_rounds,
        "phases": [r.to_dict() for r in phase_reports(ends, plan, p)],
        "final_live_fraction": float(up.to(torch.float32).mean()),
        "final_wrongly_dead": int(wrongly.sum()),
    }
