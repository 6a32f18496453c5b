"""Simulation parameters — the static knobs every engine is built from.

The port's copy of ``SimParams`` from the JAX package's
``consul_tpu/sim/params.py``: the same fields, the same derived
properties (folded on the host in f64, then cast once to f32 where the
round body consumes them), ``from_gossip_config`` and
``baseline_configs``. The traced sweep view (``TracedParams`` /
``grid_params``) belongs to the sweep slice of the port and is not here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from consul_tpu_torch.config import GossipConfig


@dataclass(frozen=True)
class SimParams:
    """All static knobs for the batched SWIM simulation.

    Times are in seconds; one simulation round advances ``probe_interval``
    (one SWIM protocol period). Rates suffixed ``_per_round`` are per-node
    Bernoulli probabilities per round.
    """

    n: int = 1024

    # SWIM failure detection (mirrors GossipConfig / memberlist fields)
    probe_interval: float = 1.0
    probe_timeout: float = 0.5
    indirect_checks: int = 3
    tcp_fallback: bool = True

    # k-of-m corroboration of suspicion starts (0 = memberlist's classic
    # any-ack-cancels rule; faults.detection_gate applies k >= 1)
    corroboration_k: int = 0

    # Lifeguard suspicion
    suspicion_mult: int = 4
    suspicion_max_timeout_mult: int = 6
    awareness_max: int = 8
    lifeguard: bool = True

    # Dissemination
    gossip_interval: float = 0.2
    gossip_nodes: int = 3
    retransmit_mult: int = 4

    # Network model
    loss: float = 0.0
    tcp_fail: float = 0.0

    # Degraded-node model
    slow_per_round: float = 0.0
    slow_recover_per_round: float = 0.05
    slow_factor: float = 0.1

    # Network-coordinate subsystem knobs
    coords_timeout: bool = False
    coord_timeout_mult: float = 3.0

    # cumulative detector statistics (extra reduction lanes per round)
    collect_stats: bool = True

    # lane-engine reduction cadence (the megakernel's rounds_per_call
    # plays the same role in the kernel runner)
    stale_k: int = 1

    # black-box event tracer sizing
    blackbox_k: int = 64
    blackbox_ring: int = 256

    # Workload model (churn injection)
    fail_per_round: float = 0.0
    rejoin_per_round: float = 0.0
    leave_per_round: float = 0.0

    # FaultPlan intensity multiplier
    fault_gain: float = 1.0

    def __post_init__(self):
        if not 0 <= self.corroboration_k <= self.indirect_checks:
            raise ValueError(
                f"corroboration_k={self.corroboration_k} out of range: "
                f"must satisfy 0 <= corroboration_k <= indirect_checks "
                f"(indirect_checks={self.indirect_checks})")

    # --- derived (all Python floats/ints) ------------------------------

    def _gc(self) -> GossipConfig:
        return GossipConfig(
            probe_interval=self.probe_interval,
            probe_timeout=self.probe_timeout,
            indirect_checks=self.indirect_checks,
            disable_tcp_pings=not self.tcp_fallback,
            suspicion_mult=self.suspicion_mult,
            suspicion_max_timeout_mult=self.suspicion_max_timeout_mult,
            awareness_max_multiplier=self.awareness_max,
            gossip_interval=self.gossip_interval,
            gossip_nodes=self.gossip_nodes,
            retransmit_mult=self.retransmit_mult)

    @property
    def gossip_ticks_per_round(self) -> float:
        return max(1.0, self.probe_interval / self.gossip_interval)

    @property
    def suspicion_min_s(self) -> float:
        return self._gc().suspicion_min_timeout(self.n)

    @property
    def suspicion_max_s(self) -> float:
        if not self.lifeguard:
            return self.suspicion_min_s
        return self._gc().suspicion_max_timeout(self.n)

    @property
    def confirmation_k(self) -> int:
        """Expected independent confirmations that drive the timer to its
        minimum (memberlist uses SuspicionMult-2 as the k of its log-shrink)."""
        return max(1, self.suspicion_mult - 2)

    @property
    def shrink_r(self) -> float:
        """Lifeguard shrink floor: min/max suspicion-timeout ratio."""
        return self.suspicion_min_s / self.suspicion_max_s

    @property
    def shrink_omr(self) -> float:
        return 1.0 - self.shrink_r

    @property
    def fanout_ticks(self) -> float:
        return self.gossip_nodes * self.gossip_ticks_per_round

    @property
    def one_minus_loss(self) -> float:
        return 1.0 - self.loss

    @property
    def retransmit_limit(self) -> int:
        return self._gc().retransmit_limit(self.n)

    @property
    def p_direct(self) -> float:
        """Direct UDP probe round-trip success (2 packet legs)."""
        return (1.0 - self.loss) ** 2

    @property
    def p_relay(self) -> float:
        """One indirect ping-req relay success (4 packet legs)."""
        return (1.0 - self.loss) ** 4

    @property
    def p_tcp(self) -> float:
        return (1.0 - self.tcp_fail) if self.tcp_fallback else 0.0

    @staticmethod
    def from_gossip_config(cfg: GossipConfig, n: int, **kw) -> "SimParams":
        kw.setdefault("tcp_fallback", not cfg.disable_tcp_pings)
        return SimParams(
            n=n,
            probe_interval=cfg.probe_interval,
            probe_timeout=cfg.probe_timeout,
            indirect_checks=cfg.indirect_checks,
            suspicion_mult=cfg.suspicion_mult,
            suspicion_max_timeout_mult=cfg.suspicion_max_timeout_mult,
            awareness_max=cfg.awareness_max_multiplier,
            gossip_interval=cfg.gossip_interval,
            gossip_nodes=cfg.gossip_nodes,
            retransmit_mult=cfg.retransmit_mult,
            **kw,
        )

    def with_(self, **kw) -> "SimParams":
        return replace(self, **kw)

    def enabled(self, *names: str) -> bool:
        """Is any of these features active (plain truthiness)?"""
        return any(bool(getattr(self, n)) for n in names)

    # --- the round kernels' variant switches ---------------------------

    @property
    def has_churn(self) -> bool:
        return self.enabled("fail_per_round", "leave_per_round",
                            "rejoin_per_round")

    @property
    def age_mutable(self) -> bool:
        """Whether a round can change the down_age lane: churn moves the
        crash stamps, the slow model toggles the sentinels, and stats
        need dead rows to age (detection latency). Otherwise the round
        kernels run the STABLE variant, which never writes down_age —
        a dead row's age stays frozen at its entry value, as the TPU
        kernel's does (bookkeeping only: age feeds latency stats and
        rejoin, both off in that variant)."""
        return self.has_churn or self.enabled("slow_per_round",
                                              "collect_stats")


def baseline_configs() -> dict[str, SimParams]:
    """The BASELINE.json benchmark configurations."""
    lan = GossipConfig.lan()
    wan = GossipConfig.wan()
    # "5%/min churn": half crashes (2.5%/min of live nodes), half joins;
    # the per-dead-node rejoin rate is 19x the crash rate so crash and
    # rejoin event volumes match with ~5% of slots dead
    crash_round = 0.025 / 60.0 * wan.probe_interval
    return {
        "1k-lan-nolifeguard": SimParams.from_gossip_config(
            lan, n=1_000, lifeguard=False),
        "100k-lan-lifeguard-loss1": SimParams.from_gossip_config(
            lan, n=100_000, loss=0.01),
        "1m-wan-churn5": SimParams.from_gossip_config(
            wan, n=1_000_000,
            fail_per_round=crash_round,
            rejoin_per_round=crash_round * 19.0,
        ),
        "1m-lan": SimParams.from_gossip_config(lan, n=1_000_000, loss=0.01),
    }
