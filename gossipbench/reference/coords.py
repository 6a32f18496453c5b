"""The coordinates trial's calls: the live engine's period (population
scalars of the period itself, threefry draws keyed by the round's key)
under a partition plan, with every agent's Vivaldi network coordinate
riding it, and a flight row a period whose last three columns are the
coordinates' quality row.

What a period adds to ``model.period``:

* the plan's frame (``partition_lanes``, the fold of ``reference/plan.py``
  with the partition's blocked links): churn is drawn at the frame's
  rates, the direct, relay and TCP legs and the target's failures scale
  by the frame (``chaos.miss_probs``), refutation by ``hear_w``,
  epidemic growth by ``mid``;
* the probe pairs: each agent probes ``j = (i + randint(1, n)) % n``,
  observes the latency map's round trip times a unit-median lognormal
  jitter, and the ack counts only if that beats the deadline
  ``max(timeout, min(mult x estimate, interval)) x (lh + 1)`` from the
  coordinates' estimate; the target's side adds the chance that a random
  prober's deadline loses to its own jittered round trip, ``1 -
  Phi(ln(deadline / rtt) / sigma)``, as an independent failing leg;
* the Vivaldi relaxation of every prober whose probe was acked by a live
  target (serf's client, below), then the quality row over all N pairs:
  the median and 99th percentile of |estimate - truth| / truth from one
  sort, and the mean distance the coordinates moved.

Serf's client (hashicorp/serf coordinate/client.go), and where the
program departs from it (the reference follows the program):

* ``updateVivaldi``: total error ``e_i + e_j`` (at least zeroThreshold),
  ``weight = e_i / total``, ``wrongness = |dist - rtt| / rtt``, the new
  error ``CE x weight x wrongness + e_i x (1 - CE x weight)`` capped at
  VivaldiErrorMax, the force ``CC x weight x (rtt - dist)`` along the
  unit vector from j to i (a random one where the two coincide), and the
  height ``(h_i + h_j) x force / |x_i - x_j| + h_i`` floored at
  HeightMin. The program floors the round trip at 1e-12 s, not at
  zeroThreshold, and its ``dist`` is the raw distance, the norm plus
  both heights, without serf's adjustment terms;
* ``updateAdjustment``: the residual ``rtt - raw distance`` into a ring
  of AdjustmentWindowSize samples, the adjustment their sum over twice
  the window. The program takes the residual against the coordinate
  after gravity;
* ``updateGravity``: serf pulls the vector toward the origin by
  ``(|x| / GravityRho)^2`` along its unit vector; the program subtracts
  ``(x / GravityRho)^3`` component by component;
* serf first passes each peer's round trips through a median filter of
  the last LatencyFilterSize (3); the program relaxes on each round trip
  as drawn.

The estimate ``estimate_rtt`` is the raw distance plus both adjustments
where that is positive, else the raw distance.

Every expression is written in the program's order of operations (its
``sim/coords.py``, ``sim/topology.py`` and ``sim/round.py``): the
deadline's comparison decides lanes at a near tie, and the quality row's
order statistics are compared absolutely.

Plain PyTorch: nothing of the program. ``F`` is the floating type of the
per-node arithmetic, the coordinates' too: float32, or bfloat16 for the
check's control (population sums in f32 either way).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gossipbench.reference import chaos, model, plan, prng
from gossipbench.reference.model import (ALIVE, ALIVE_AGE, CONF_MAX, DEAD,
                                         LAT, LEFT, N_SCALARS, N_STATS,
                                         SLOW_AGE, SUSPECT, TICK_MAX,
                                         TTL_NEVER, U_ACK, U_CHURN, U_HEAR,
                                         U_POIS, U_SLOW, ipow, shrink,
                                         trunc_poisson)

_F32 = torch.float32
_I32 = torch.int32
_F64 = torch.float64
#: the coordinate draws fold this word into the round's key, off the
#: round's own five
COORD_FOLD = 0x5EED
#: ``normal``'s uniform runs on [nextafter(-1, 0), 1)
_NORMAL_LO = -1.0 + 2.0 ** -24
_SQRT2_F32 = float(torch.tensor(2.0 ** 0.5, dtype=torch.float32))


# ---------------------------------------------------------- the draws


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit words of ``k``: the xor of threefry's two words of
    counter ``(0, i)``."""
    y0, y1 = prng.threefry(k[0], k[1], 0,
                           torch.arange(n, dtype=torch.int64,
                                        device=k.device))
    return y0 ^ y1


def normal(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """A standard normal per element: sqrt(2) erfinv(u), u uniform on
    [nextafter(-1, 0), 1) from the word's [0, 1) float f as
    ``max(lo, 2 f + lo)``."""
    f = prng.uniform(k, math.prod(shape)).view(shape)
    u = torch.clamp_min(f * 2.0 + _NORMAL_LO, _NORMAL_LO)
    return _SQRT2_F32 * torch.special.erfinv(u)


def exponential(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    return -torch.log1p(-prng.uniform(k, math.prod(shape)).view(shape))


def randint(k: torch.Tensor, count: int, lo: int, hi: int) -> torch.Tensor:
    """Integers in [lo, hi): two words an element from ``split(k, 2)``,
    folded by wrapping uint32 remainders, ((a % span) m + b % span) %
    span with m = (2^16 % span)^2 mod 2^32 % span."""
    span = hi - lo if hi > lo else 1
    mult = ((((2 ** 16) % span) ** 2) & prng.MASK) % span
    k1, k2 = prng.split(k, 2)
    a, b = bits(k1, count), bits(k2, count)
    off = (((a % span) * mult) & prng.MASK) + b % span
    return ((off & prng.MASK) % span + lo).to(_I32)


def pairs(n: int, k: torch.Tensor) -> torch.Tensor:
    """A probe target ``j != i`` for every agent."""
    return (torch.arange(n, dtype=_I32, device=k.device)
            + randint(k, n, 1, n)) % n


# ------------------------------------------------------- the topology


class Topology(NamedTuple):
    pos: torch.Tensor      # [N, dims]
    height: torch.Tensor   # [N]
    sigma: torch.Tensor    # 0-d: the probe jitter's lognormal sigma


def topology(spec: dict, n: int, device=None) -> Topology:
    """The latency map: ``n_dcs`` contiguous blocks of agents, each
    around a centre drawn ``dc_spread_s`` x N(0, 1) per dimension, each
    agent ``intra_spread_s`` x N(0, 1) from its centre, with an access
    height ``height_min_s`` + ``height_mean_s`` x Exp(1); keys
    ``split(key(seed), 3)``."""
    k_dc, k_pos, k_h = prng.split(prng.key(spec["seed"], device=device), 3)
    dims, n_dcs = spec["dims"], spec["n_dcs"]
    centers = spec["dc_spread_s"] * normal(k_dc, (n_dcs, dims))
    dc = (torch.arange(n, dtype=_I32, device=device) * n_dcs
          // n).to(_I32)
    pos = centers[dc] + spec["intra_spread_s"] * normal(k_pos, (n, dims))
    height = spec["height_min_s"] + spec["height_mean_s"] * exponential(
        k_h, (n,))
    return Topology(pos, height, torch.full((), spec["jitter_sigma"],
                                            dtype=_F32, device=device))


def true_rtt(topo: Topology, i, j) -> torch.Tensor:
    d = topo.pos[i] - topo.pos[j]
    return torch.sqrt(torch.sum(d * d, dim=-1)) \
        + topo.height[i] + topo.height[j]


# ---------------------------------------------------- the partition plan


def partition_lanes(phase: dict, n: int) -> dict:
    """``plan.phase_lanes`` for a phase of ``Partition`` cuts, in f64 on
    the host: group ``a`` drops what it sends to ``b`` with probability
    ``drop`` (and ``b`` to ``a`` when ``symmetric``). A node's horizon
    (``open_frac``) loses the blocked peers' share; the fixed points and
    the legs are ``plan.py``'s. Nothing here lies: the frame is honest.
    On the cut side the weights end as the difference of two near-equal
    sums, a residue under 1e-12 whose last bits depend on the order of
    the sum (the program's is numpy's); every decision reads it as 0."""
    links = []
    for f in phase["faults"]:
        if f.get("primitive") != "Partition":
            raise ValueError(f"the coordinates reference cuts with "
                             f"Partition only, not {f.get('primitive')!r}")
        a, b = plan._mask(f["a"], n), plan._mask(f["b"], n)
        drop = float(f.get("drop", 1.0))
        links.append((a, b, drop))
        if f.get("symmetric", True):
            links.append((b, a, drop))
    e = torch.zeros(n, dtype=_F64)
    g = torch.zeros(n, dtype=_F64)

    def open_frac(loss_other, weights, incoming):
        wq = weights * (1.0 - loss_other)
        total_w = weights.sum() - weights
        num = wq.sum() - wq
        for src, dst, drop in links:
            if incoming:
                src, dst = dst, src
            blocked = (wq * dst).sum() - torch.where(src & dst, wq, 0.0)
            num = num - torch.where(src, drop * blocked, 0.0)
        return torch.clamp_min(num, 0.0) / torch.clamp_min(total_w, 1e-12)

    def fixed_point(loss_other, w0, incoming):
        base = 1.0 - (g if incoming else e)
        w = w0
        for _ in range(plan.FIXED_POINT_STEPS):
            w_next = base * open_frac(loss_other,
                                      torch.clamp_min(w, 1e-12), incoming)
            done = torch.allclose(w_next, w, rtol=1e-5, atol=1e-7)
            w = w_next
            if done:
                break
        return w

    ones = torch.ones(n, dtype=_F64)
    psend = (1.0 - e) * open_frac(g, ones, False)
    precv = (1.0 - g) * open_frac(e, ones, True)
    reach = torch.clamp_min(psend * precv, 1e-9)
    in_w = fixed_point(e, reach, True)
    out_w = fixed_point(g, reach, False)
    hear_in = (1.0 - g) * open_frac(e, torch.clamp_min(in_w, 1e-9), True)
    speak_out = (1.0 - e) * open_frac(g, torch.clamp_min(out_w, 1e-9),
                                      False)
    zeros = torch.zeros(n, dtype=_F64)
    return {"psend": psend, "precv": precv, "suspw": in_w * out_w,
            "hear_w": hear_in * speak_out, "mid": (psend * precv).mean(),
            "crash_p": zeros, "rejoin_p": zeros, "leave_p": zeros,
            "slow_f": torch.zeros(n, dtype=torch.bool)}


class Plan:
    """A partition plan folded for ``n`` agents: ``starts`` and, per
    phase, its lanes in float32 (``lanes[i]``; ``mid`` 0-d)."""

    def __init__(self, spec: dict, n: int, device=None):
        self.starts, acc = [], 0
        for ph in spec["phases"]:
            self.starts.append(acc)
            acc += ph["rounds"]
        self.lanes = [{k: v.to(device=device, dtype=torch.bool
                               if k == "slow_f" else _F32)
                       for k, v in partition_lanes(ph, n).items()}
                      for ph in spec["phases"]]

    def phase(self, round_idx: int) -> int:
        return max(sum(s <= int(round_idx) for s in self.starts) - 1, 0)


# --------------------------------------------------------- coordinates


class Coords(NamedTuple):
    vec: torch.Tensor          # [N, Dimensionality]
    error: torch.Tensor        # [N]
    height: torch.Tensor       # [N]
    adjustment: torch.Tensor   # [N]
    samples: torch.Tensor      # [N, AdjustmentWindowSize]
    cursor: torch.Tensor       # [N] int32


def init_coords(n: int, c: dict, device=None, F=_F32) -> Coords:
    """Serf's ``NewCoordinate``: the origin, the largest error, the
    least height, no adjustment."""
    dims, window = c["Dimensionality"], c["AdjustmentWindowSize"]
    return Coords(
        torch.zeros((n, dims), dtype=F, device=device),
        torch.full((n,), c["VivaldiErrorMax"], dtype=F, device=device),
        torch.full((n,), c["HeightMin"], dtype=F, device=device),
        torch.zeros((n,), dtype=F, device=device),
        torch.zeros((n, window), dtype=F, device=device),
        torch.zeros((n,), dtype=_I32, device=device))


def raw_distance(vec_a, h_a, vec_b, h_b) -> torch.Tensor:
    d = vec_a - vec_b
    return torch.sqrt(torch.sum(d * d, dim=-1)) + h_a + h_b


def estimate_rtt(co: Coords, i, j) -> torch.Tensor:
    """Serf's ``DistanceTo``: the raw distance plus both adjustments
    where that is positive."""
    dist = raw_distance(co.vec[i], co.height[i], co.vec[j], co.height[j])
    adjusted = dist + co.adjustment[i] + co.adjustment[j]
    return torch.where(adjusted > 0, adjusted, dist)


def vivaldi(co: Coords, j, rtt_s, key, relax, c: dict) -> Coords:
    """Every agent i relaxes toward its target ``j[i]`` at the observed
    ``rtt_s[i]`` where ``relax[i]`` (and the round trip is positive)."""
    n, dims = co.vec.shape
    window = c["AdjustmentWindowSize"]
    ce, cc = c["VivaldiCE"], c["VivaldiCC"]
    zero = c["zeroThreshold"]
    vec_i, h_i, e_i = co.vec, co.height, co.error
    vec_j, h_j, e_j = co.vec[j], co.height[j], co.error[j]
    relax = relax & (rtt_s > 0)
    rtt = torch.clamp_min(rtt_s, 1e-12)

    # updateVivaldi
    diff = vec_i - vec_j
    mag = torch.sqrt(torch.sum(diff * diff, dim=-1))
    dist = mag + h_i + h_j
    total = torch.clamp_min(e_i + e_j, zero)
    weight = e_i / total
    wrongness = torch.abs(dist - rtt) / rtt
    error = torch.clamp_max(wrongness * ce * weight
                            + e_i * (1.0 - ce * weight),
                            c["VivaldiErrorMax"])
    force = cc * weight * (rtt - dist)
    # ApplyForce along the unit vector from j (a random one where the
    # two coincide: the step key's uniforms, centred and normalised)
    coincident = mag <= zero
    safe_mag = torch.where(coincident, 1.0, mag)
    rv = prng.uniform(key, n * dims).view(n, dims).to(vec_i.dtype) - 0.5
    rmag = torch.sqrt(torch.sum(rv * rv, dim=-1))
    rv = rv / torch.where(rmag > 0, rmag, 1.0)[:, None]
    unit = torch.where(coincident[:, None], rv, diff / safe_mag[:, None])
    vec = vec_i + unit * force[:, None]
    height = torch.where(
        coincident, h_i,
        torch.clamp_min((h_i + h_j) * force / safe_mag + h_i,
                        c["HeightMin"]))
    # updateGravity, the program's form
    vec = vec - ipow(vec / c["GravityRho"], 3)
    # updateAdjustment: the residual into the ring at the cursor
    sample = rtt - raw_distance(vec, height, vec_j, h_j)
    ring = torch.arange(window, dtype=_I32, device=vec.device)[None, :]
    write = relax[:, None] & (ring == co.cursor[:, None])
    samples = torch.where(write, sample[:, None], co.samples)
    adjustment = torch.sum(samples, dim=-1) / (2.0 * window)
    cursor = torch.where(relax, (co.cursor + 1) % window, co.cursor)
    return Coords(torch.where(relax[:, None], vec, vec_i),
                  torch.where(relax, error, e_i),
                  torch.where(relax, height, h_i), adjustment, samples,
                  cursor)


def percentiles(x: torch.Tensor, qs) -> list:
    """Linear-interpolation percentiles from one sort, the positions and
    weights folded in f32 on the host."""
    s = torch.sort(x).values
    f32 = torch.float32
    n = torch.tensor(float(s.shape[-1]), dtype=f32)
    one = torch.tensor(1.0, dtype=f32)
    out = []
    for q in qs:
        pos = (torch.tensor(q, dtype=f32) / torch.tensor(100.0, dtype=f32)) \
            * (n - one)
        lo, hi = torch.floor(pos), torch.ceil(pos)
        w_hi = pos - lo
        w_lo = one - w_hi
        lo_i = int(min(max(float(lo), 0.0), float(n) - 1))
        hi_i = int(min(max(float(hi), 0.0), float(n) - 1))
        out.append(s[lo_i] * float(w_lo) + s[hi_i] * float(w_hi))
    return out


def quality(co: Coords, topo: Topology, j, drift) -> torch.Tensor:
    """The period's quality row: median and p99 relative error of the
    estimates of all N probe pairs, and the mean drift."""
    i = torch.arange(co.vec.shape[0], device=co.vec.device)
    est = estimate_rtt(co, i, j)
    truth = true_rtt(topo, i, j)
    rel = torch.abs(est - truth) / torch.clamp_min(truth, 1e-9)
    med, p99 = percentiles(rel, (50.0, 99.0))
    return torch.stack([med, p99, drift]).to(_F32)


# ------------------------------------------------------------ the period


def period(vals, P, u01, fx: dict, co: Coords, topo: Topology, key,
           traffic: dict, F=_F32):
    """One live period with the frame ``fx`` and the coordinates ``co``.
    Returns the 8 new lanes (widened), the 18 contribution lanes (None
    where zero), the relaxed coordinates, the probe targets and the mean
    drift."""
    c = traffic["coordinates"]
    status_in, inc_in, informed, age_in, slen_in, sttl_in, conf_in, lh_in \
        = vals
    n = P.n

    def lane(name):
        return fx[name].to(F)

    informed = informed.to(F)
    age = age_in.to(_I32)
    up = age < 0
    slow = age == SLOW_AGE
    status = status_in.to(_I32)
    inc = inc_in.to(_I32)
    slen = slen_in.to(_I32)
    sttl = sttl_in.to(_I32)
    s_conf = conf_in.to(_I32)
    lh = lh_in.to(_I32)

    age = torch.where(age >= 0, torch.clamp_max(age + 1, TICK_MAX), age)

    # churn: the configuration's rates plus the frame's
    u = u01(U_CHURN).to(F)
    fail_p = P.fail_per_round + lane("crash_p")
    leave_p = P.leave_per_round + lane("leave_p")
    rejoin_p = P.rejoin_per_round + lane("rejoin_p")
    crash = up & (u < fail_p)
    leave = up & (u >= fail_p) & (u < fail_p + leave_p)
    rejoin = (~up) & (u < rejoin_p)
    up = (up & ~(crash | leave)) | rejoin
    age = torch.where(crash | leave, 0, age)
    age = torch.where(rejoin, ALIVE_AGE, age)
    slow = slow & up
    status = torch.where(leave, LEFT, status)
    status = torch.where(rejoin, ALIVE, status)
    inc = torch.where(rejoin, torch.clamp_max(inc + 1, TICK_MAX), inc)
    lh = torch.where(rejoin, 0, lh)
    started = leave | rejoin
    informed = torch.where(started, 1.0 / n, informed)
    sttl = torch.where(started, TTL_NEVER, sttl)
    new_rumor = started

    if P.slow_on:
        u_s = u01(U_SLOW).to(F)
        slow = torch.where(slow, u_s >= P.slow_recover_per_round,
                           u_s < P.slow_per_round) & up
    slow_eff = (slow | fx["slow_f"]) & up

    # the mean field: this period's population scalars
    upf = up.to(F)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(F)
    n_live, s_elig, s_up_elig, s_slow = (
        model._sum(x) for x in (upf, eligf, upf * eligf,
                                (slow_eff & up & elig).to(F)))
    n_elig = torch.clamp_min(s_elig, 1.0)
    n_up_elig = torch.clamp_min(s_up_elig, 1e-9)
    n_live, n_elig, n_up_elig = (x.to(F) for x in (n_live, n_elig,
                                                   n_up_elig))
    sbar = s_slow.to(F) / n_up_elig
    frac_up_elig = n_up_elig / n_elig
    g, pf_fast, pf_slow = chaos.miss_probs(slow_eff, lh, sbar, n_live / n,
                                           P, fx, F)

    # the probe pairs, their round trips and the deadlines
    k_pair, k_jit, k_dir, k_q = prng.split(prng.fold_in(key, COORD_FOLD), 4)
    i_all = torch.arange(n, device=status.device)
    j = pairs(n, k_pair)
    rtt_obs = true_rtt(topo, i_all, j)
    rtt_obs = rtt_obs * torch.exp(topo.sigma * normal(k_jit, (n,)).to(F))
    timely = late_in = None
    if traffic["coords_timeout"]:
        mult = traffic["coord_timeout_mult"]

        def deadline(est, health):
            return torch.clamp_min(torch.clamp_max(
                mult * est, P.probe_interval), P.probe_timeout) \
                * (health.to(F) + 1.0)

        timely = rtt_obs <= deadline(estimate_rtt(co, i_all, j), lh)
        q = pairs(n, k_q)
        rtt_in = true_rtt(topo, q, i_all)
        dl_in = deadline(estimate_rtt(co, q, i_all), lh[q])
        sig = torch.clamp_min(topo.sigma, 1e-6)
        z = torch.log(torch.clamp_min(dl_in, 1e-9)
                      / torch.clamp_min(rtt_in, 1e-9)) / sig
        late_in = 1.0 - torch.special.ndtr(z)

    # the prober's probe: an ack past its deadline is a miss
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = frac_up_elig * (1.0 - mix)
    ack = up & (u01(U_ACK).to(F) < p_ack)
    if timely is not None:
        ack = ack & timely
    failed = up & ~ack
    relax = ack & up[j]
    co2 = vivaldi(co, j, rtt_obs, k_dir, relax, c)
    d = co2.vec - co.vec
    drift = torch.mean(torch.sqrt(torch.sum(d * d, dim=-1)))
    if P.lifeguard:
        lh = torch.clamp(lh + failed.to(_I32) - ack.to(_I32), 0,
                         P.awareness_max)

    # the target's side: failed probes, through the frame and the
    # deadlines, as a Poisson count
    e_pf_fast = model._sum(upf * pf_fast).to(F) \
        / torch.clamp_min(n_live, 1e-9)
    e_pf_slow = model._sum(upf * pf_slow).to(F) \
        / torch.clamp_min(n_live, 1e-9)
    probe_rate = n_live / torch.clamp_min(n_elig - 1.0, 1.0)
    base_fail = torch.where(slow_eff, e_pf_slow, e_pf_fast)
    base_fail = 1.0 - (1.0 - base_fail) * lane("suspw")
    if late_in is not None:
        base_fail = 1.0 - (1.0 - base_fail) * (1.0 - late_in)
    p_fail_j = torch.where(up, base_fail, 1.0)
    lam_fail = probe_rate * p_fail_j * eligf
    n_fail = trunc_poisson(u01(U_POIS).to(F), lam_fail)

    # Lifeguard's mean (LH + 1) of failing probers
    w_fail = upf * (1.0 - p_ack)
    lfail_num = model._sum(w_fail * (lh.to(F) + 1.0))
    lfail_den = torch.clamp_min(model._sum(w_fail), 1e-9)
    if P.lifeguard:
        scale = lfail_num.to(F) / lfail_den.to(F)
    else:
        scale = torch.ones((), dtype=F, device=up.device)

    sttl = torch.where(status == SUSPECT, sttl - 1, sttl)
    starts = (n_fail > 0) & (status == ALIVE)
    confirms = (n_fail > 0) & (status == SUSPECT)
    c0 = torch.clamp_min(n_fail - 1, 0)
    timeout0 = scale * P.suspicion_max_s * shrink(c0, P, F)
    ticks0 = torch.ceil(timeout0 / P.probe_interval)
    len0 = torch.clamp_max(ticks0, float(TICK_MAX)).to(_I32)
    status = torch.where(starts, SUSPECT, status)
    slen = torch.where(starts, len0, slen)
    sttl = torch.where(starts, len0, sttl)
    s_conf = torch.where(starts, c0, s_conf)
    informed = torch.where(starts, 1.0 / n, informed)
    new_rumor = new_rumor | starts

    c_new = torch.clamp_max(s_conf + n_fail, CONF_MAX)
    ratio = shrink(c_new, P, F) / shrink(s_conf, P, F)
    len2 = torch.ceil(slen.to(F) * ratio).to(_I32)
    sttl = torch.where(confirms, sttl - (slen - len2), sttl)
    slen = torch.where(confirms, len2, slen)
    s_conf = torch.where(confirms, c_new, s_conf)

    # refutation, heard and answered through the frame
    lam_hear = P.fanout_ticks * informed * P.one_minus_loss * g
    lam_hear = lam_hear * lane("hear_w")
    p_hear = 1.0 - torch.exp(-lam_hear)
    wrongly = up & ((status == SUSPECT) | (status == DEAD)) & ~new_rumor
    refute = wrongly & (u01(U_HEAR).to(F) < p_hear)
    status = torch.where(refute, ALIVE, status)
    inc = torch.where(refute, torch.clamp_max(inc + 1, TICK_MAX), inc)
    informed = torch.where(refute, 1.0 / n, informed)
    sttl = torch.where(refute, TTL_NEVER, sttl)
    slen = torch.where(refute, 0, slen)
    s_conf = torch.where(refute, 0, s_conf)
    new_rumor = new_rumor | refute
    if P.lifeguard:
        lh = torch.clamp(lh + refute.to(_I32), 0, P.awareness_max)

    declare = (status == SUSPECT) & (sttl <= 0)
    status = torch.where(declare, DEAD, status)
    informed = torch.where(declare, 1.0 / n, informed)
    sttl = torch.where(declare, TTL_NEVER, sttl)
    new_rumor = new_rumor | declare
    lat = (age + 1).to(F) * P.probe_interval

    grow = (~new_rumor) & (informed < 1.0)
    lam_g = P.fanout_ticks * informed * P.one_minus_loss * lane("mid")
    informed = torch.where(
        grow, informed + (1.0 - informed) * (1.0 - torch.exp(-lam_g)),
        informed)

    age_out = torch.where(up, torch.where(slow, SLOW_AGE, ALIVE_AGE), age)
    outs = (status, inc, informed.to(_F32), age_out, slen, sttl, s_conf,
            lh)
    lanes = [None] * N_SCALARS
    if P.collect_stats:
        tp = declare & ~up
        lanes += [starts, refute, declare & up, tp,
                  torch.where(tp, lat, 0.0), crash, rejoin, leave,
                  None, None]
    else:
        lanes += [None] * N_STATS
    lanes = [None if x is None else x.to(_F32) for x in lanes]
    return outs, lanes, co2, j, drift


def call(s, key, P, traffic, scalars0=None, F=_F32):
    """One call: a cold start of every coordinate, then
    ``traffic["rounds"]`` live periods from the state's round, each on
    the plan's frame for its absolute round, a flight row a period with
    the phase and the quality row in it. Returns (state', the flight
    trace, None)."""
    if traffic.get("flight_every") != 1:
        raise ValueError("the reference records a flight row every period")
    # no product here runs in TF32 (it has no matmul; the switch says so)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = s.lanes[0].shape[0]
    dev = s.lanes[0].device
    pl = Plan(traffic["plan"], rows, dev)
    topo = topology(traffic["topology"], rows, dev)
    topo = Topology(topo.pos.to(F), topo.height.to(F), topo.sigma.to(F))
    co = init_coords(rows, traffic["coordinates"], dev, F)
    rounds = traffic["rounds"]
    r0 = int(s.round_idx)
    keys = prng.round_keys(key, s.round_idx, rounds)
    lanes8, t, stats = s.lanes, s.t, list(s.stats)
    trace = []
    for i in range(rounds):
        ph = pl.phase(r0 + i)
        outs, lanes, co, j, drift = period(
            lanes8, P, prng.threefry_slots(keys[i], rows), pl.lanes[ph], co,
            topo, keys[i], traffic, F)
        lanes8 = model._narrow(outs, lanes8)
        before = list(stats)
        if P.collect_stats:
            for k in range(N_STATS):
                lane = lanes[N_SCALARS + k]
                if lane is None:
                    continue
                stats[k] = stats[k] + (torch.sum(lane) if k == LAT else
                                       torch.sum(lane.to(_I32)).to(_I32))
        t = t + P.probe_interval
        delta = torch.stack([(a - b).to(_F32)
                             for a, b in zip(stats, before)])
        row = model._row(lanes8, t, delta)
        row[8] = float(ph)
        row[-3:] = quality(co, topo, j, drift)
        trace.append(row)
    out = model.State(lanes8, t, s.round_idx + rounds, tuple(stats))
    return out, torch.stack(trace), None
