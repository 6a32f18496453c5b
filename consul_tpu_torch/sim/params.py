"""Simulation parameters — the static knobs every engine is built from.

The port's copy of ``SimParams`` from the JAX package's
``consul_tpu/sim/params.py``: the same fields, the same derived
properties (folded on the host in f64, then cast once to f32 where the
round body consumes them), ``from_gossip_config`` and
``baseline_configs``, and the sweep view: ``SweepAxes`` names a grid of
sweepable constants, ``grid_params`` lifts it into a ``TracedParams``
whose swept fields (and the derived properties that depend on them,
folded per point on the host in f64 and cast once) are ``[G, 1]``
tensors. The grid is an explicit leading dimension: a grid state is
``[G, N]``, so every leaf broadcasts against it in the round body.

The round bodies gate Python control flow through ``enabled()`` /
``sweeps()`` (plain truthiness for ``SimParams``; leaf presence for a
``TracedParams``), never through the truth of a leaf.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Mapping, Sequence, Union

import numpy as np
import torch

from consul_tpu_torch.config import GossipConfig
from consul_tpu_torch.sim import registry
from consul_tpu_torch.utils.platform import DeviceLike, default_device


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

    def sweeps(self, *names: str) -> bool:
        """Is any of these fields a sweep leaf? Never, on SimParams."""
        return False

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


# ---------------------------------------------------------------- sweep
#
# SweepAxes -> grid_params -> TracedParams: the parameter grid as data.

#: SimParams fields that may become sweep leaves
SWEEPABLE_FIELDS = registry.SWEEP_AXES

#: derived property -> the sweepable fields it depends on
DERIVED_DEPS: dict = dict(registry.SWEEP_DERIVED)

_INT_LEAVES = frozenset(registry.SWEEP_INT_LEAVES)


class TracedParams:
    """A SimParams view whose sweepable scalars are tensors.

    Attribute reads hit ``leaves`` first (``[G, 1]`` tensors for a grid,
    ``[1, 1]`` for one point of it), then fall through to the static
    dataclass. A derived property whose dependencies are swept must
    arrive as a leaf (``grid_params`` ships them); reading one that is
    missing raises instead of silently using the static value.
    ``point`` marks the one-point view ``point_params`` makes, which
    ``sweep.make_run_point`` takes and ``make_run_sweep`` refuses."""

    __slots__ = ("static", "leaves", "point")

    def __init__(self, static: SimParams, leaves: Mapping[str, Any],
                 point: bool = False) -> None:
        unknown = [k for k in leaves
                   if k not in SWEEPABLE_FIELDS and k not in DERIVED_DEPS]
        if unknown:
            raise ValueError(
                f"not sweepable leaves: {sorted(unknown)} (sweepable "
                f"fields: {', '.join(SWEEPABLE_FIELDS)}; derived: "
                f"{', '.join(DERIVED_DEPS)})")
        self.static = static
        self.leaves = dict(leaves)
        self.point = point

    def __getattr__(self, name: str):
        # only reached when `name` is not a slot, method or property
        leaves = object.__getattribute__(self, "leaves")
        if name in leaves:
            return leaves[name]
        deps = DERIVED_DEPS.get(name)
        if deps and any(d in leaves for d in deps):
            raise AttributeError(
                f"derived SimParams.{name} depends on swept "
                f"{sorted(set(deps) & set(leaves))} but was not "
                "precomputed as a leaf — build TracedParams via "
                "grid_params, which ships host-f64 derived leaves")
        return getattr(object.__getattribute__(self, "static"), name)

    def enabled(self, *names: str) -> bool:
        """True for any swept field whatever its values (every point
        shares one program), else the static field's truth."""
        return any(n in self.leaves or bool(getattr(self.static, n))
                   for n in names)

    def sweeps(self, *names: str) -> bool:
        return any(n in self.leaves for n in names)

    @property
    def has_churn(self) -> bool:
        return self.enabled("fail_per_round", "leave_per_round",
                            "rejoin_per_round")

    @property
    def grid_shape(self) -> tuple:
        """``(G,)`` for a grid, ``()`` for one point or no leaves."""
        if self.point:
            return ()
        for v in self.leaves.values():
            return (int(v.shape[0]),)
        return ()

    def __repr__(self) -> str:
        return (f"TracedParams(n={self.static.n}, "
                f"leaves={sorted(self.leaves)}, point={self.point})")


@dataclass(frozen=True)
class SweepAxes:
    """A named parameter grid: ``axes`` is an ordered (field, values)
    tuple; the grid is their cartesian product, first axis slowest.
    Only ``registry.SWEEP_AXES`` fields are accepted: the others shape
    the program (tensor shapes, Python branches) and must be the same
    across a grid, and are refused with that reason."""

    axes: tuple

    def __post_init__(self):
        axes = tuple((name, tuple(float(v) for v in values))
                     for name, values in self.axes)
        for name, values in axes:
            if name not in SWEEPABLE_FIELDS:
                hint = ("a STATIC field — it affects compiled shapes "
                        "or Python branches, so it cannot vary inside "
                        "one compiled grid"
                        if name in SimParams.__dataclass_fields__
                        else "not a SimParams field")
                raise ValueError(
                    f"cannot sweep {name!r}: {hint}. Sweepable: "
                    f"{', '.join(SWEEPABLE_FIELDS)}")
            if not values:
                raise ValueError(f"sweep axis {name!r} has no values")
        object.__setattr__(self, "axes", axes)

    @staticmethod
    def of(**axes: Sequence[float]) -> "SweepAxes":
        return SweepAxes(tuple(axes.items()))

    @property
    def size(self) -> int:
        out = 1
        for _, values in self.axes:
            out *= len(values)
        return out

    def points(self) -> list:
        """The grid as a list of {field: value} dicts (product order)."""
        out: list = [{}]
        for name, values in self.axes:
            out = [{**pt, name: v} for pt in out for v in values]
        return out


GridSpec = Union[SweepAxes, Sequence[Mapping[str, float]]]

#: int-valued SimParams fields a float sweep value must round-trip to
_INT_FIELDS = frozenset(
    name for name, f in SimParams.__dataclass_fields__.items()
    if f.type in ("int", int))


def _point_param(base: SimParams, pt: Mapping[str, float]) -> SimParams:
    kw = {}
    for name, v in pt.items():
        if name in _INT_FIELDS:
            iv = int(round(v))
            if iv != v:
                raise ValueError(
                    f"sweep axis {name!r} is integer-valued: {v}")
            v = iv
        kw[name] = v
    return base.with_(**kw)


def grid_params(p: SimParams, grid: GridSpec, device: DeviceLike = None
                ) -> tuple:
    """Build the grid on ``device`` (the card unless the caller passes
    ``"cpu"``): (TracedParams with ``[G, 1]`` leaves, the G concrete
    per-point SimParams).

    Every swept field becomes a leaf, and so does every derived
    property whose dependencies are swept, computed per point by the
    concrete SimParams' own property in f64 on the host and cast once:
    to int32 for ``registry.SWEEP_INT_LEAVES`` and int fields, to f32
    otherwise. The point list is the host-side mirror (reports, winner
    selection, per-point runs)."""
    dev = default_device(device)
    if isinstance(grid, SweepAxes):
        pts = grid.points()
    else:
        pts = [dict(pt) for pt in grid]
        if not pts:
            raise ValueError("empty sweep grid")
        keys = set(pts[0])
        for pt in pts:
            if set(pt) != keys:
                raise ValueError(
                    "every sweep grid point must set the same fields: "
                    f"{sorted(keys)} vs {sorted(pt)}")
        # route through SweepAxes validation for the field names
        SweepAxes(tuple((k, (0.0,)) for k in sorted(keys)))
    swept = sorted(set().union(*pts)) if pts else []
    points = [_point_param(p, pt) for pt in pts]
    leaf_names = list(swept) + [
        d for d, deps in DERIVED_DEPS.items()
        if any(dep in swept for dep in deps)]
    leaves = {}
    for name in leaf_names:
        dtype = torch.int32 if name in _INT_LEAVES or name in _INT_FIELDS \
            else torch.float32
        host = np.asarray([getattr(pp, name) for pp in points], np.float64)
        leaves[name] = torch.from_numpy(host).to(dtype).view(-1, 1).to(dev)
    return TracedParams(p, leaves), points


def point_params(tp: TracedParams, i: int) -> TracedParams:
    """Grid point ``i`` as a one-point TracedParams (``[1, 1]`` leaves):
    what ``sweep.make_run_point`` runs, the same code on a grid of
    one."""
    return TracedParams(tp.static,
                        {k: v[i:i + 1] for k, v in tp.leaves.items()},
                        point=True)
