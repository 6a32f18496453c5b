"""Gossip configuration — the SWIM knobs the simulation is built from.

A copy of ``GossipConfig`` from the JAX package's ``consul_tpu/config.py``
(fields, the LAN/WAN/local presets and the derived timeouts). The presets
mirror memberlist's DefaultLANConfig / DefaultWANConfig as Consul consumes
them (agent/consul/config.go:622-698 in the reference).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class GossipConfig:
    """Every SWIM/gossip knob, in seconds."""

    # Failure detection
    probe_interval: float = 1.0       # one SWIM protocol period
    probe_timeout: float = 0.5        # direct-probe ack deadline
    indirect_checks: int = 3          # k peers asked for indirect probe
    disable_tcp_pings: bool = False   # TCP fallback probe on UDP timeout

    # Suspicion (Lifeguard)
    suspicion_mult: int = 4           # min timeout = mult*log10(n)*probe_interval
    suspicion_max_timeout_mult: int = 6
    awareness_max_multiplier: int = 8  # Local Health Awareness score ceiling

    # Dissemination
    gossip_interval: float = 0.2      # piggyback broadcast tick
    gossip_nodes: int = 3             # fanout per gossip tick
    retransmit_mult: int = 4          # per-rumor transmit budget = mult*ceil(log10(n+1))
    gossip_to_the_dead_time: float = 30.0

    # Full-state sync
    push_pull_interval: float = 30.0

    # serf overlay
    leave_propagate_delay: float = 3.0
    min_queue_depth: int = 4096
    queue_depth_warning: int = 1_000_000
    reconnect_timeout: float = 72 * 3600.0
    tombstone_timeout: float = 24 * 3600.0
    reap_interval: float = 15.0
    dead_node_reclaim_time: float = 30.0

    @staticmethod
    def lan() -> "GossipConfig":
        return GossipConfig()

    @staticmethod
    def wan() -> "GossipConfig":
        """memberlist DefaultWANConfig deltas."""
        return GossipConfig(
            probe_interval=5.0, probe_timeout=3.0,
            suspicion_mult=6, gossip_interval=0.5, gossip_nodes=4,
            push_pull_interval=60.0,
        )

    @staticmethod
    def local() -> "GossipConfig":
        """memberlist DefaultLocalConfig-style fast timing for tests."""
        return GossipConfig(
            probe_interval=0.2, probe_timeout=0.1, gossip_interval=0.05,
            push_pull_interval=5.0, leave_propagate_delay=0.2,
            reap_interval=0.5,
        )

    # --- derived quantities -------------------------------------------

    def suspicion_min_timeout(self, n: int, local_health: int = 0) -> float:
        """Lifeguard min suspicion timeout, scaled by local health score."""
        node_scale = max(1.0, math.log10(max(1.0, float(n))))
        return (self.suspicion_mult * node_scale * self.probe_interval
                * (local_health + 1))

    def suspicion_max_timeout(self, n: int, local_health: int = 0) -> float:
        return self.suspicion_max_timeout_mult * self.suspicion_min_timeout(
            n, local_health)

    def retransmit_limit(self, n: int) -> int:
        return self.retransmit_mult * int(math.ceil(math.log10(float(n) + 1.0)))

    def scaled_probe_timeout(self, local_health: int) -> float:
        return self.probe_timeout * (local_health + 1)
