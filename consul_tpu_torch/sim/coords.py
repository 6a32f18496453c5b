"""Batched Vivaldi network coordinates, as tensors.

The port of the JAX package's ``consul_tpu/sim/coords.py``: the scalar
Vivaldi client (serf/coordinate, the reference's
``gossip/coordinate.py``) run over the whole population at once.

  vec        [N, DIMS] f32 — position (distances in seconds)
  error      [N] f32       — confidence (capped at VIVALDI_ERROR_MAX)
  height     [N] f32       — access-link term (floored at HEIGHT_MIN)
  adjustment [N] f32       — mean of the ring of the last W residuals
  adj_samples[N, W] f32      (ADJUSTMENT_WINDOW), cursor adj_idx
  adj_idx    [N] int32

``vivaldi_step`` is the spring relaxation over probe pairs; the
coincident-point branch draws its direction from the step's key
(``prng.uniform``, the reference's threefry words). Everything is
elementwise math and [N]-sized gathers. The eight constants are a copy
of the reference client's. ``coord_metrics`` runs under the span
``sim.coords.metrics`` (``utils.telemetry``, the device-annotated form).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from consul_tpu_torch.faults import ipow
from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim.lanes import tree_sum
from consul_tpu_torch.sim.topology import Topology, true_rtt
from consul_tpu_torch.utils import telemetry
from consul_tpu_torch.utils.platform import DeviceLike, default_device

DIMENSION = 8
VIVALDI_ERROR_MAX = 1.5
VIVALDI_CE = 0.25       # error sensitivity
VIVALDI_CC = 0.25       # position sensitivity
ADJUSTMENT_WINDOW = 20
HEIGHT_MIN = 1e-5
ZERO_THRESHOLD = 1e-6
GRAVITY_RHO = 150.0

_F32 = torch.float32


class CoordState(NamedTuple):
    """Population coordinate tensors."""

    vec: torch.Tensor          # [N, DIMS] f32
    error: torch.Tensor        # [N] f32
    height: torch.Tensor       # [N] f32
    adjustment: torch.Tensor   # [N] f32
    adj_samples: torch.Tensor  # [N, ADJUSTMENT_WINDOW] f32
    adj_idx: torch.Tensor      # [N] int32


def init_coords(n: int, dims: int = DIMENSION,
                device: DeviceLike = None) -> CoordState:
    """Cold start: everyone at the origin with the largest error."""
    dev = default_device(device)
    return CoordState(
        vec=torch.zeros((n, dims), dtype=_F32, device=dev),
        error=torch.full((n,), VIVALDI_ERROR_MAX, dtype=_F32, device=dev),
        height=torch.full((n,), HEIGHT_MIN, dtype=_F32, device=dev),
        adjustment=torch.zeros((n,), dtype=_F32, device=dev),
        adj_samples=torch.zeros((n, ADJUSTMENT_WINDOW), dtype=_F32,
                                device=dev),
        adj_idx=torch.zeros((n,), dtype=torch.int32, device=dev))


def coords_from_numpy(coords: Any, device: DeviceLike = None) -> CoordState:
    """A port CoordState from any object carrying its field names as
    numpy arrays (the reference's, after ``jax.device_get``)."""
    dev = default_device(device)
    return CoordState(**{f: torch.from_numpy(np.array(getattr(coords, f),
                                                      copy=True)).to(dev)
                         for f in CoordState._fields})


def _row_distance(vec_a, h_a, vec_b, h_b) -> torch.Tensor:
    d = vec_a - vec_b
    return torch.sqrt(torch.sum(d * d, dim=-1)) + h_a + h_b


def estimate_rtt(coords: CoordState, i, j) -> torch.Tensor:
    """RTT estimate (s) for index batches i, j: the raw distance plus
    both adjustments, unless that is not positive. A grid's coordinates
    (``[G, N, ...]``) give one estimate per point."""
    dist = _row_distance(coords.vec[..., i, :], coords.height[..., i],
                         coords.vec[..., j, :], coords.height[..., j])
    adjusted = dist + coords.adjustment[..., i] + coords.adjustment[..., j]
    return torch.where(adjusted > 0, adjusted, dist)


def nearest_k(coords: CoordState, q: int, k: int):
    """The k nodes with the lowest estimated RTT to node ``q`` (itself
    excluded): (indices [k], estimates [k]), ascending."""
    n = coords.vec.shape[0]
    dev = coords.vec.device
    d = estimate_rtt(coords, q, torch.arange(n, device=dev))
    d = torch.where(torch.arange(n, device=dev) == q, float("inf"), d)
    neg, idx = torch.topk(-d, k)
    return idx.to(torch.int32), -neg


def vivaldi_step(coords: CoordState, i, j, rtt_s: torch.Tensor,
                 key: torch.Tensor,
                 upd: Optional[torch.Tensor] = None) -> CoordState:
    """One batched update: node ``i[k]`` relaxes toward ``j[k]`` at the
    measured ``rtt_s[k]`` seconds. ``i`` holds unique rows, or is None
    for every row in order (no scatter). Rows with ``upd`` false or a
    non-positive RTT keep their coordinate. With ``i`` None the
    coordinates may be a grid's (``[G, N, ...]``, one set per point):
    every point relaxes over the same pairs and draws."""
    full = i is None
    dev = coords.vec.device
    n, dims = coords.vec.shape[-2:]
    idx = torch.arange(n, device=dev) if full \
        else torch.as_tensor(i, device=dev).to(torch.int64)
    vec_i = coords.vec[..., idx, :]
    h_i, e_i = coords.height[..., idx], coords.error[..., idx]
    vec_j = coords.vec[..., j, :]
    h_j, e_j = coords.height[..., j], coords.error[..., j]
    samples_i = coords.adj_samples[..., idx, :]
    adj_idx_i = coords.adj_idx[..., idx]

    rtt = rtt_s.to(_F32)
    live = rtt > 0
    upd = live if upd is None else (upd & live)
    rtt_safe = torch.clamp_min(rtt, 1e-12)

    diff = vec_i - vec_j
    mag = torch.sqrt(torch.sum(diff * diff, dim=-1))
    dist = mag + h_i + h_j
    err = torch.clamp_min(e_i + e_j, ZERO_THRESHOLD)
    weight = e_i / err
    rel_err = torch.abs(dist - rtt_safe) / rtt_safe
    new_error = torch.clamp_max(
        rel_err * VIVALDI_CE * weight + e_i * (1.0 - VIVALDI_CE * weight),
        VIVALDI_ERROR_MAX)
    force = VIVALDI_CC * weight * (rtt_safe - dist)

    # unit vector away from j; coincident points take a random one
    coincident = mag <= ZERO_THRESHOLD
    safe_mag = torch.where(coincident, 1.0, mag)
    rows = vec_i.shape[-2]
    rv = prng.uniform(key, rows * dims).view(rows, dims) - 0.5
    rmag = torch.sqrt(torch.sum(rv * rv, dim=-1))
    rv = rv / torch.where(rmag > 0, rmag, 1.0)[..., None]
    unit = torch.where(coincident[..., None], rv, diff / safe_mag[..., None])

    new_vec = vec_i + unit * force[..., None]
    new_height = torch.where(
        coincident, h_i,
        torch.clamp_min((h_i + h_j) * force / safe_mag + h_i, HEIGHT_MIN))
    # gravity toward the origin keeps the cloud from drifting
    new_vec = new_vec - ipow(new_vec / GRAVITY_RHO, 3)

    # adjustment ring: residual against the moved coordinate
    sample = rtt_safe - _row_distance(new_vec, new_height, vec_j, h_j)
    lane = torch.arange(ADJUSTMENT_WINDOW, dtype=torch.int32,
                        device=dev)[None, :]
    write = upd[..., None] & (lane == adj_idx_i[..., None])
    new_samples = torch.where(write, sample[..., None], samples_i)
    new_adj = torch.sum(new_samples, dim=-1) / (2.0 * ADJUSTMENT_WINDOW)
    new_adj_idx = torch.where(upd, (adj_idx_i + 1) % ADJUSTMENT_WINDOW,
                              adj_idx_i)

    def merge(new, old):
        return torch.where(upd if new.dim() == upd.dim() else upd[..., None],
                           new, old)

    vec = merge(new_vec, vec_i)
    error = merge(new_error, e_i)
    height = merge(new_height, h_i)
    if full:
        return CoordState(vec=vec, error=error, height=height,
                          adjustment=new_adj, adj_samples=new_samples,
                          adj_idx=new_adj_idx)

    def put(whole, rows):
        out = whole.clone()
        out[idx] = rows
        return out

    return CoordState(
        vec=put(coords.vec, vec), error=put(coords.error, error),
        height=put(coords.height, height),
        adjustment=put(coords.adjustment, new_adj),
        adj_samples=put(coords.adj_samples, new_samples),
        adj_idx=put(coords.adj_idx, new_adj_idx))


#: flight-recorder coordinate columns, in ``flight.COORD_COLUMNS`` order
N_COORD_METRICS = 3


class CoordRoundAux(NamedTuple):
    """The cheap per-round byproducts ``coord_metrics`` needs, so the
    percentiles run only on recorded rounds, and the masks a runner's
    coordinate counters sum (None where the round does not make them)."""

    pair_j: torch.Tensor  # [N] int32 — this round's probe targets
    drift: torch.Tensor   # 0-d f32 — mean position moved this round (s)
    relaxed: Optional[torch.Tensor] = None  # [N] bool — acked, relaxed
    late: Optional[torch.Tensor] = None     # [N] bool — ack past deadline


def round_drift(prev: CoordState, cur: CoordState) -> torch.Tensor:
    """Mean position moved between two states (seconds); ``[G]`` for a
    grid's coordinates, each mean a ``lanes.tree_sum`` so a grid row is
    its one-point run bit for bit."""
    d = cur.vec - prev.vec
    moved = torch.sqrt(torch.sum(d * d, dim=-1))
    if moved.dim() == 1:
        return torch.mean(moved)
    return tree_sum(moved) / float(moved.shape[-1])


def _percentiles(x: torch.Tensor, qs: Sequence[float]) -> list:
    """``jnp.percentile(x, q)`` (linear interpolation) for each q, from
    one sort: the positions and weights are the reference's f32 values,
    folded on the host, so only the two gathers and the blend run on
    the device (and nothing makes the host wait)."""
    s = torch.sort(x, dim=-1).values
    n = np.float32(s.shape[-1])
    one = np.float32(1.0)
    out = []
    for q in qs:
        pos = np.float32(np.float32(q) / np.float32(100.0)) * (n - one)
        lo, hi = np.floor(pos), np.ceil(pos)
        w_hi = np.float32(pos - lo)
        w_lo = np.float32(one - w_hi)
        lo_i = int(min(max(lo, 0), n - 1))
        hi_i = int(min(max(hi, 0), n - 1))
        out.append(s[..., lo_i] * float(w_lo) + s[..., hi_i] * float(w_hi))
    return out


def coord_metrics(cur: CoordState, topo: Topology,
                  aux: CoordRoundAux) -> torch.Tensor:
    """[3] f32 quality row of one round's pairs (i = arange(N), targets
    ``aux.pair_j``; ``[G, 3]`` for a grid's coordinates): median and p99
    relative RTT-estimate error against the no-jitter truth, and the
    round's mean drift. One sort serves both percentiles
    (``torch.quantile`` would sort twice and refuses inputs above 2^24
    elements; 1,048,576 nodes is 2^20)."""
    with telemetry.span("sim.coords.metrics", device=True):
        n = cur.vec.shape[-2]
        i = torch.arange(n, device=cur.vec.device)
        est = estimate_rtt(cur, i, aux.pair_j)
        truth = true_rtt(topo, i, aux.pair_j)
        rel = torch.abs(est - truth) / torch.clamp_min(truth, 1e-9)
        med, p99 = _percentiles(rel, (50.0, 99.0))
        return torch.stack([med, p99, aux.drift.to(_F32)], dim=-1)


def coordinate_updates(coords: CoordState, count: Optional[int] = None,
                       names: Optional[Sequence[str]] = None,
                       prefix: str = "sim-") -> list:
    """``Coordinate.Update``-shaped dicts for the first ``count`` rows
    (or one per ``names`` entry)."""
    vec = coords.vec.detach().cpu().double().numpy()
    err = coords.error.detach().cpu().double().numpy()
    adj = coords.adjustment.detach().cpu().double().numpy()
    hgt = coords.height.detach().cpu().double().numpy()
    if names is None:
        k = vec.shape[0] if count is None else min(count, vec.shape[0])
        names = [f"{prefix}{i}" for i in range(k)]
    return [{"Node": name,
             "Coord": {"Vec": [float(x) for x in vec[i]],
                       "Error": float(err[i]),
                       "Adjustment": float(adj[i]),
                       "Height": float(hgt[i])}}
            for i, name in enumerate(names)]
