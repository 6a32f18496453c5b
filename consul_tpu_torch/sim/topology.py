"""Synthetic ground-truth RTT topology, as tensors.

The port of the JAX package's ``consul_tpu/sim/topology.py``: nodes sit
in a low-dimensional latency space (per-DC cluster centers, per-node
scatter around them, and a per-node access-link "height"), so a pair's
round trip is

    rtt(i, j) = ||pos_i - pos_j|| + h_i + h_j            (seconds)

computed for any batch of pairs with two gathers, never an N×N matrix.
Observed probe RTTs multiply a unit-median lognormal jitter. The draws
are the reference's (``prng.normal`` / ``exponential`` / ``randint`` on
the same threefry keys), so a topology made from one seed is the
reference's up to the last bits of ``erfinv`` and ``log1p``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, NamedTuple

import numpy as np
import torch

from consul_tpu_torch.sim import prng
from consul_tpu_torch.utils.platform import DeviceLike, default_device


@dataclass(frozen=True)
class TopologyParams:
    """Static knobs of the latency embedding (seconds). Defaults sketch
    a 4-DC WAN: ~50-100 ms cross-DC legs, ~2 ms intra-DC scatter, a few
    ms of access latency, 10% lognormal probe jitter."""

    n: int = 1024
    dims: int = 4
    n_dcs: int = 4
    dc_spread_s: float = 0.025
    intra_spread_s: float = 0.002
    height_min_s: float = 1e-4
    height_mean_s: float = 0.003
    jitter_sigma: float = 0.10
    seed: int = 0

    def with_(self, **kw) -> "TopologyParams":
        return replace(self, **kw)


class Topology(NamedTuple):
    """The drawn embedding."""

    pos: torch.Tensor           # [N, dims] f32
    height: torch.Tensor        # [N] f32 (> 0)
    dc: torch.Tensor            # [N] int32
    jitter_sigma: torch.Tensor  # 0-d f32


def make_topology(tp: TopologyParams,
                  device: DeviceLike = None) -> Topology:
    """Draw the embedding for ``tp`` on ``device`` (deterministic in
    ``tp.seed``). DCs are contiguous node blocks, so a FaultPlan range
    over ``(0, n // n_dcs)`` cuts exactly DC 0."""
    dev = default_device(device)
    k_dc, k_pos, k_h = prng.split(prng.key(tp.seed, device=dev), 3)
    centers = tp.dc_spread_s * prng.normal(k_dc, (tp.n_dcs, tp.dims))
    dc = (torch.arange(tp.n, dtype=torch.int32, device=dev) * tp.n_dcs
          // tp.n).to(torch.int32)
    pos = centers[dc] + tp.intra_spread_s * prng.normal(k_pos,
                                                        (tp.n, tp.dims))
    height = tp.height_min_s + tp.height_mean_s * prng.exponential(
        k_h, (tp.n,))
    return Topology(pos=pos, height=height, dc=dc,
                    jitter_sigma=torch.full((), tp.jitter_sigma,
                                            dtype=torch.float32,
                                            device=dev))


def true_rtt(topo: Topology, i, j) -> torch.Tensor:
    """No-jitter ground-truth RTT (s) for index batches ``i``, ``j``."""
    d = topo.pos[i] - topo.pos[j]
    return torch.sqrt(torch.sum(d * d, dim=-1)) \
        + topo.height[i] + topo.height[j]


def sample_rtt(topo: Topology, i, j, key: torch.Tensor) -> torch.Tensor:
    """One observed RTT per pair: the truth times a unit-median
    lognormal draw."""
    base = true_rtt(topo, i, j)
    z = prng.normal(key, tuple(base.shape))
    return base * torch.exp(topo.jitter_sigma * z)


def sample_pairs(n: int, key: torch.Tensor) -> torch.Tensor:
    """A uniform probe target ``j[i] != i`` for every node."""
    off = prng.randint(key, (n,), 1, n)
    return (torch.arange(n, dtype=torch.int32, device=key.device)
            + off) % n


def topology_from_numpy(topo: Any, device: DeviceLike = None) -> Topology:
    """A port topology from any object carrying Topology's field names
    as numpy arrays (the reference's, after ``jax.device_get``)."""
    dev = default_device(device)
    return Topology(**{f: torch.from_numpy(np.array(getattr(topo, f),
                                                    copy=True)).to(dev)
                       for f in Topology._fields})
