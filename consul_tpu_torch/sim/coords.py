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

A period's coordinate round is three steps, each routed by the tensors'
device: ``probe`` (the probe pairs' observed round trips and, with
RTT-aware deadlines, ``timely`` and ``late_in``), ``relax``
(``vivaldi_step``'s full form, the gate and the drift) and
``coord_metrics``' per-agent error (``quality``). On the card each is
one launch of ``sim/coord_kernel.py`` (``csrc/coord_kernels.cu``), as is
every full-form ``vivaldi_step``; on the CPU their plain versions here
run (``probe_plain``, ``relax_plain`` / ``vivaldi_step_plain``,
``quality_plain``), which the kernels follow op for op.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from consul_tpu_torch.faults import ipow
from consul_tpu_torch.sim import coord_kernel, prng
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


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def vivaldi_step(coords: CoordState, i, j, rtt_s: torch.Tensor,
                 key: torch.Tensor,
                 upd: Optional[torch.Tensor] = None) -> CoordState:
    """One batched update: node ``i[k]`` relaxes toward ``j[k]`` at the
    measured ``rtt_s[k]`` seconds. ``i`` holds unique rows, or is None
    for every row in order (no scatter). Rows with ``upd`` false or a
    non-positive RTT keep their coordinate. With ``i`` None the
    coordinates may be a grid's (``[G, N, ...]``, one set per point):
    every point relaxes over the same pairs and draws. The full form on
    the card is one ``vivaldi_relax`` launch; the scatter form and CPU
    tensors run ``vivaldi_step_plain``."""
    if i is None and _on_card(coords.vec):
        dev = coords.vec.device
        return _relax_launch(coords, torch.as_tensor(j, device=dev),
                             rtt_s, key, upd, None)[0]
    return vivaldi_step_plain(coords, i, j, rtt_s, key, upd)


def _relax_launch(coords: CoordState, pair_j: torch.Tensor,
                  rtt_s: torch.Tensor, key: torch.Tensor, ack, up) -> tuple:
    rows, dims = coords.vec.shape[-2:]
    return coord_kernel.relax(
        coords, pair_j.to(torch.int32).contiguous(),
        rtt_s.to(_F32).contiguous(), prng.uniform(key, rows * dims), ack,
        up)


def vivaldi_step_plain(coords: CoordState, i, j, rtt_s: torch.Tensor,
                       key: torch.Tensor,
                       upd: Optional[torch.Tensor] = None) -> CoordState:
    """``vivaldi_step`` in plain PyTorch, on any device."""
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


def probe(coords: Optional[CoordState], topo: Topology,
          pair_j: torch.Tensor, key: torch.Tensor,
          q_in: Optional[torch.Tensor] = None,
          lh: Optional[torch.Tensor] = None,
          deadline: Optional[tuple] = None) -> tuple:
    """A period's probes: each agent's observed round trip to its target
    ``pair_j`` (the truth times the unit-median lognormal jitter drawn
    from ``key``, as ``topology.sample_rtt``), and with RTT-aware
    deadlines (``q_in``, the random prober of each agent; ``lh``, the
    local health; ``deadline`` = (multiplier, probe interval, probe
    timeout), floats or a grid's ``[G, 1]`` leaves) whether the ack beat
    ``max(timeout, min(mult x estimate, interval)) x (lh + 1)``
    (``timely``) and the chance that a random prober's deadline loses to
    this agent's jittered round trip (``late_in``, 1 - Phi(ln(d / rtt) /
    sigma)). Returns (rtt_obs ``[N]``, timely, late_in), the last two
    None without deadlines. On the card one ``coord_probe`` launch."""
    z = prng.normal(key, tuple(pair_j.shape))
    if _on_card(pair_j):
        return coord_kernel.probe(coords, topo, pair_j, z, q_in, lh,
                                  deadline)
    return probe_plain(coords, topo, pair_j, z, q_in, lh, deadline)


def probe_plain(coords: Optional[CoordState], topo: Topology,
                pair_j: torch.Tensor, z: torch.Tensor,
                q_in: Optional[torch.Tensor] = None,
                lh: Optional[torch.Tensor] = None,
                deadline: Optional[tuple] = None) -> tuple:
    """``probe`` in plain PyTorch on the jitter normal ``z``."""
    i_all = torch.arange(pair_j.shape[-1], device=pair_j.device)
    rtt_obs = true_rtt(topo, i_all, pair_j) \
        * torch.exp(topo.jitter_sigma * z)
    if q_in is None:
        return rtt_obs, None, None
    mult, interval, timeout = deadline

    def dl(est, health):
        return torch.clamp_min(torch.clamp_max(mult * est, interval),
                               timeout) * (health.to(_F32) + 1.0)

    timely = rtt_obs <= dl(estimate_rtt(coords, i_all, pair_j), lh)
    rtt_in = true_rtt(topo, q_in, i_all)
    dl_in = dl(estimate_rtt(coords, q_in, i_all), lh[..., q_in])
    sig = torch.clamp_min(topo.jitter_sigma, 1e-6)
    z_in = torch.log(torch.clamp_min(dl_in, 1e-9)
                     / torch.clamp_min(rtt_in, 1e-9)) / sig
    return rtt_obs, timely, 1.0 - torch.special.ndtr(z_in)


def relax(coords: CoordState, pair_j: torch.Tensor, rtt_obs: torch.Tensor,
          key: torch.Tensor, ack: torch.Tensor,
          up: Optional[torch.Tensor] = None) -> tuple:
    """A period's relaxation: every agent whose probe was acked and
    whose target is up (``ack & up[..., pair_j]``; ``up`` None gates no
    target) relaxes toward ``pair_j`` at ``rtt_obs`` (``vivaldi_step``'s
    full form, its direction drawn from ``key``). Returns (coords', the
    gate, the round's drift as ``round_drift``). On the card one
    ``vivaldi_relax`` launch and the drift's mean."""
    if _on_card(coords.vec):
        c2, relaxed, moved = _relax_launch(coords, pair_j, rtt_obs, key,
                                           ack, up)
        return c2, relaxed, _mean_moved(moved)
    return relax_plain(coords, pair_j, rtt_obs, key, ack, up)


def relax_plain(coords: CoordState, pair_j: torch.Tensor,
                rtt_obs: torch.Tensor, key: torch.Tensor, ack: torch.Tensor,
                up: Optional[torch.Tensor] = None) -> tuple:
    """``relax`` in plain PyTorch."""
    relaxed = ack if up is None else ack & up[..., pair_j]
    c2 = vivaldi_step_plain(coords, None, pair_j, rtt_obs, key, relaxed)
    return c2, relaxed, round_drift(coords, c2)


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
    return _mean_moved(torch.sqrt(torch.sum(d * d, dim=-1)))


def _mean_moved(moved: torch.Tensor) -> torch.Tensor:
    if moved.dim() == 1:
        return torch.mean(moved)
    return tree_sum(moved) / float(moved.shape[-1])


def _percentiles(x: torch.Tensor, qs: Sequence[float]) -> list:
    """``jnp.percentile(x, q)`` (linear interpolation) for each q, from
    one sort: the positions and weights are the reference's f32 values,
    folded on the host, so only the two gathers and the blend run on
    the device (and nothing makes the host wait)."""
    s = torch.sort(x, dim=-1).values
    return [s[..., lo_i] * w_lo + s[..., hi_i] * w_hi
            for lo_i, hi_i, w_lo, w_hi in _blend(s.shape[-1], tuple(qs))]


@functools.lru_cache(maxsize=None)
def _blend(length: int, qs: tuple) -> tuple:
    """Each percentile's (low index, high index, low weight, high
    weight) in a sorted row of ``length``: the reference's f32 folds,
    made once a length."""
    n = np.float32(length)
    one = np.float32(1.0)
    out = []
    for q in qs:
        pos = np.float32(np.float32(q) / np.float32(100.0)) * (n - one)
        lo, hi = np.floor(pos), np.ceil(pos)
        w_hi = np.float32(pos - lo)
        w_lo = np.float32(one - w_hi)
        out.append((int(min(max(lo, 0), n - 1)), int(min(max(hi, 0), n - 1)),
                    float(w_lo), float(w_hi)))
    return tuple(out)


def coord_metrics(cur: CoordState, topo: Topology,
                  aux: CoordRoundAux) -> torch.Tensor:
    """[3] f32 quality row of one round's pairs (i = arange(N), targets
    ``aux.pair_j``; ``[G, 3]`` for a grid's coordinates): median and p99
    relative RTT-estimate error against the no-jitter truth, and the
    round's mean drift. One sort serves both percentiles
    (``torch.quantile`` would sort twice and refuses inputs above 2^24
    elements; 1,048,576 nodes is 2^20)."""
    with telemetry.span("sim.coords.metrics", device=True):
        med, p99 = _percentiles(quality(cur, topo, aux.pair_j),
                                (50.0, 99.0))
        return torch.stack([med, p99, aux.drift.to(_F32)], dim=-1)


def quality(cur: CoordState, topo: Topology,
            pair_j: torch.Tensor) -> torch.Tensor:
    """Each agent's relative RTT-estimate error to its target ``pair_j``
    against the no-jitter truth, ``[..., N]``: on the card one
    ``coord_quality`` launch."""
    if _on_card(cur.vec):
        return coord_kernel.quality(cur, topo, pair_j)
    return quality_plain(cur, topo, pair_j)


def quality_plain(cur: CoordState, topo: Topology,
                  pair_j: torch.Tensor) -> torch.Tensor:
    """``quality`` in plain PyTorch."""
    i = torch.arange(cur.vec.shape[-2], device=cur.vec.device)
    est = estimate_rtt(cur, i, pair_j)
    truth = true_rtt(topo, i, pair_j)
    return torch.abs(est - truth) / torch.clamp_min(truth, 1e-9)


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
