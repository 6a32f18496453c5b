"""What the drivers share: building the program's parameters from a
configuration file, and reading its state back as plain tensors.

The one module of the benchmark besides the drivers that imports the
program (``consul_tpu_torch``); the reference never does.
"""

from __future__ import annotations

import torch

from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import (STATS_FIELDS, init_state,
                                        stats_vector)

#: the configuration file's keys that are the program's SimParams fields
SIM_FIELDS = ("probe_interval", "probe_timeout", "indirect_checks",
              "tcp_fallback", "corroboration_k", "suspicion_mult",
              "suspicion_max_timeout_mult", "awareness_max", "lifeguard",
              "gossip_interval", "gossip_nodes", "retransmit_mult", "loss",
              "tcp_fail", "slow_per_round", "slow_recover_per_round",
              "slow_factor", "collect_stats", "fail_per_round",
              "rejoin_per_round", "leave_per_round")


class Driver:
    """One way of driving the program: ``start`` a fresh initial state,
    ``call`` one call (returns what the call's caller reads),
    ``fetch`` it to the host, and the state as plain tensors before
    (``snapshot``) and after (``outputs``) a call."""

    def __init__(self, cfg: dict, traffic: dict, dev: torch.device,
                 seed: int, n: int):
        self.traffic = traffic
        self.dev = dev
        self.n = n
        self.rounds = traffic["rounds"]
        self.p = SimParams(n=n, stale_k=traffic.get("stale_k", 1),
                           **{f: cfg[f] for f in SIM_FIELDS})
        self.key = prng.key(seed, device=dev)
        self.state = None
        self.scalars = None
        self.trace = None
        self.calls = 0
        self.build()

    def build(self) -> None:
        raise NotImplementedError

    def start(self) -> None:
        """A fresh initial state for the next calls."""
        self.state = init_state(self.n, device=self.dev)
        self.scalars = None
        self.trace = None
        self.calls = 0

    def call(self) -> torch.Tensor:
        raise NotImplementedError

    def counters(self) -> torch.Tensor:
        """The state's counters, clock and round as one device vector:
        what a call's caller reads."""
        s = self.state
        return torch.cat([stats_vector(s.stats), s.t.reshape(1),
                          s.round_idx.to(torch.float32).reshape(1)])

    @staticmethod
    def fetch(out: torch.Tensor):
        return out.cpu()

    def snapshot(self) -> dict:
        s = self.state
        snap = {"lanes": tuple(a.clone() for a in s.node_arrays()),
                "t": s.t.clone(), "round_idx": s.round_idx.clone(),
                "stats": tuple(getattr(s.stats, f).clone()
                               for f in STATS_FIELDS),
                "call": self.calls}
        if self.scalars is not None:
            snap["scalars"] = self.scalars.clone()
        return snap

    def outputs(self) -> dict:
        out = self.snapshot()
        if self.trace is not None:
            out["trace"] = self.trace.clone()
        return out

    def close(self) -> None:
        self.state = self.scalars = self.trace = self.run = None
