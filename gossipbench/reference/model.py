"""The plain reference: one SWIM/Lifeguard protocol period over every
node, and the three ways the benchmark's cells run periods.

A straightforward PyTorch statement of the batch-synchronous,
Poissonized protocol period that the program simulates (memberlist's
probe, indirect probe and TCP fallback; Lifeguard's local health,
suspicion timeout shrinking and refutation; epidemic dissemination of
rumors; crash and rejoin churn), on the packed per-node layout the
configuration states: status int8, incarnation int16, informed f32,
down_age int16 (-1 live, -2 live and slow, >= 0 dead that many periods),
susp_len / susp_ttl int16, susp_conf / local_health int8, a f32 clock,
an int32 round index and ten counters (int32, the latency sum f32).

Each f32 step is written once, in the order of the protocol's equations
(constants folded on the host in f64 and cast once, integer powers as
repeated products), so on the same draws and population scalars the int
lanes are exact and ``informed`` agrees to the platform's exp. ``F`` is
the floating type the per-node arithmetic runs in: float32 as the
configuration states, bfloat16 for the check's control. Population sums
accumulate in f32 either way.

The engines:

* ``kernel_runner_call``: stale population scalars, refreshed every R
  periods from the per-block partial sums of a 512-node tile walk
  (``TILE``, ``GRID_BLOCKS``), Philox draws keyed by per-round seeds;
  with ``flight_every`` a trace row after every period, with
  ``scalars0`` the carried scalars of a chunked run;
* ``live_call``: population scalars of the period itself, threefry
  draws keyed by the round's key;
* ``lanes_call``: scalars frozen for ``stale_k`` periods, refreshed by
  one fixed-order (pairwise halving) reduction of the window's
  contribution stack in ``LANE_BLOCKS`` contiguous blocks, global-index
  threefry draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gossipbench.reference import prng

ALIVE, SUSPECT, DEAD, LEFT = 1, 2, 3, 5
ALIVE_AGE, SLOW_AGE = -1, -2
TICK_MAX = 32767
TTL_NEVER = TICK_MAX
CONF_MAX = 127

NODE_FIELDS = ("status", "incarnation", "informed", "down_age", "susp_len",
               "susp_ttl", "susp_conf", "local_health")
NODE_DTYPES = (torch.int8, torch.int16, torch.float32, torch.int16,
               torch.int16, torch.int16, torch.int8, torch.int8)
STATS_FIELDS = ("suspicions", "refutes", "false_positives",
                "true_deaths_declared", "detect_latency_sum", "crashes",
                "rejoins", "leaves", "attack_suspicions",
                "attack_false_positives")
N_SCALARS = 8
N_STATS = len(STATS_FIELDS)
LAT = STATS_FIELDS.index("detect_latency_sum")
U_CHURN, U_SLOW, U_ACK, U_POIS, U_HEAR = range(5)
SCALAR_FLOORS = (float("-inf"), 1.0, 1e-9, float("-inf"), float("-inf"),
                 float("-inf"), float("-inf"), 1e-9)
#: the kernel runner's partial-sum table: tiles of TILE nodes, tile t
#: summed into row t % min(GRID_BLOCKS, tiles)
TILE = 512
GRID_BLOCKS = 528
#: the lane engine's lanes: scalars, counters, flight gauges, the local
#: health exceedance histogram (lh >= 1..8)
N_GAUGES = 6
N_HIST = 8
N_LANE_ROWS = N_SCALARS + N_STATS + N_GAUGES + N_HIST
LANE_BLOCKS = 64

_F32 = torch.float32
_I32 = torch.int32


class Params:
    """A configuration's constants, folded on the host in f64: the
    memberlist timing (suspicion timeout min = mult * max(1, log10 n) *
    interval, max = max_mult * min with Lifeguard), packet loss and TCP
    fallback, churn rates, the slow-node model."""

    def __init__(self, cfg: dict, **over):
        c = dict(cfg, **over)
        self.n = int(c["n"])
        for f in ("probe_interval", "probe_timeout", "gossip_interval",
                  "loss", "tcp_fail", "slow_per_round",
                  "slow_recover_per_round", "slow_factor",
                  "fail_per_round", "rejoin_per_round",
                  "leave_per_round"):
            setattr(self, f, float(c[f]))
        for f in ("indirect_checks", "corroboration_k", "suspicion_mult",
                  "suspicion_max_timeout_mult", "awareness_max",
                  "gossip_nodes"):
            setattr(self, f, int(c[f]))
        self.tcp_fallback = bool(c["tcp_fallback"])
        self.lifeguard = bool(c["lifeguard"])
        self.collect_stats = bool(c["collect_stats"])
        self.stale_k = int(c.get("stale_k", 1))
        if self.corroboration_k:
            raise ValueError("the reference states the classic any-ack "
                             "rule (corroboration_k = 0) only")
        scale = max(1.0, math.log10(max(1.0, float(self.n))))
        self.suspicion_min_s = (self.suspicion_mult * scale
                                * self.probe_interval)
        self.suspicion_max_s = (self.suspicion_max_timeout_mult
                                * self.suspicion_min_s
                                if self.lifeguard else self.suspicion_min_s)
        self.confirmation_k = max(1, self.suspicion_mult - 2)
        self.shrink_r = self.suspicion_min_s / self.suspicion_max_s
        self.shrink_omr = 1.0 - self.shrink_r
        ticks = max(1.0, self.probe_interval / self.gossip_interval)
        self.fanout_ticks = self.gossip_nodes * ticks
        self.one_minus_loss = 1.0 - self.loss
        self.p_direct = (1.0 - self.loss) ** 2
        self.p_relay = (1.0 - self.loss) ** 4
        self.p_tcp = (1.0 - self.tcp_fail) if self.tcp_fallback else 0.0
        self.churn = bool(self.fail_per_round or self.leave_per_round
                          or self.rejoin_per_round)
        self.slow_on = bool(self.slow_per_round)
        self.age_mutable = self.churn or self.slow_on or self.collect_stats


class State(NamedTuple):
    """8 per-node lanes (packed dtypes), clock, round index, counters."""

    lanes: tuple
    t: torch.Tensor
    round_idx: torch.Tensor
    stats: tuple


def init_state(n: int, device=None) -> State:
    """Every node alive, fully informed, healthy, no timers."""
    values = (ALIVE, 0, 1.0, ALIVE_AGE, 0, TTL_NEVER, 0, 0)
    lanes = tuple(torch.full((n,), v, dtype=dt, device=device)
                  for v, dt in zip(values, NODE_DTYPES))
    stats = tuple(torch.zeros((), dtype=_F32 if i == LAT else _I32,
                              device=device) for i in range(N_STATS))
    return State(lanes, torch.zeros((), dtype=_F32, device=device),
                 torch.zeros((), dtype=_I32, device=device), stats)


# ------------------------------------------------------------ the period


def _sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x if x.dtype == _F32 else x.to(_F32))


def ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y by binary exponentiation (y >= 1)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def shrink(c: torch.Tensor, P: Params, F) -> torch.Tensor:
    """Lifeguard's timeout factor after c independent confirmations:
    max(r, 1 - (1 - r) log(c + 1) / log(k + 1))."""
    if not P.lifeguard or P.suspicion_max_s <= P.suspicion_min_s:
        return torch.ones_like(c, dtype=F)
    den = torch.log(torch.full((), float(P.confirmation_k), dtype=F,
                               device=c.device) + 1.0)
    frac = torch.log(c.to(F) + 1.0) / den
    return torch.clamp_min(1.0 - P.shrink_omr * frac, P.shrink_r)


def trunc_poisson(u: torch.Tensor, lam: torch.Tensor,
                  kmax: int = 4) -> torch.Tensor:
    """A Poisson(lam) count by its inverse CDF, truncated at kmax."""
    nf = torch.zeros_like(lam, dtype=_I32)
    term = torch.exp(-lam)
    c = term
    for k in range(1, kmax + 1):
        nf = nf + (u > c).to(_I32)
        term = term * lam / k
        c = c + term
    return nf


def miss_probs(slow, lh, sbar, live_frac, P: Params, F):
    """A prober's chance that a probe of a fast / slow target gets no
    ack: direct probe, then ``indirect_checks`` relays, then TCP, each
    leg through the loss model; a slow node answers at ``slow_factor``,
    and Lifeguard's patience (1 - 2^-lh) waits for it."""
    g = torch.where(slow, P.slow_factor, 1.0).to(F)
    if P.lifeguard and P.slow_on:
        patience = 1.0 - torch.exp2(-lh.to(F))
    else:
        patience = torch.zeros_like(g)

    def noack(gj_val):
        gj = torch.tensor(gj_val, dtype=F)
        ge_i = g + (1.0 - g) * patience
        ge_j = gj + (1.0 - gj) * patience
        pair2 = ipow(ge_i * ge_j, 2)
        p_d = P.p_direct * pair2
        ge_p_slow = P.slow_factor + (1.0 - P.slow_factor) * patience
        e_gp4 = (1.0 - sbar) * 1.0 + sbar * ipow(ge_p_slow, 4)
        p_relay1 = live_frac * P.p_relay * pair2 * e_gp4
        p_tcp = P.p_tcp * ge_i * ge_j
        p_no_relay = ipow(1.0 - p_relay1, P.indirect_checks)
        return (1.0 - p_d) * p_no_relay * (1.0 - p_tcp)

    return g, noack(1.0), noack(P.slow_factor)


def period(vals, scal: Optional[torch.Tensor], P: Params, u01, F=_F32,
           lane_mode: bool = False):
    """One protocol period over the 8 lanes ``vals``. ``scal`` is None
    (population scalars from this period's post-churn lanes) or the
    stale [8] vector (n_live, n_elig, n_up_elig, n_slow_up_elig, the two
    miss-rate sums, the Lifeguard failing-prober numerator and
    denominator). Returns the 8 new lanes (widened) and the per-node
    contribution lanes (None where zero): the 8 scalar lanes on the new
    state, the 10 counters, and in ``lane_mode`` the 6 gauge numerators
    and the 8 exceedance counts."""
    status_in, inc_in, informed, age_in, slen_in, sttl_in, conf_in, lh_in \
        = vals
    n = P.n
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
    new_rumor = torch.zeros_like(up)
    crash = leave = rejoin = None

    # the dead age one period (saturating)
    age = torch.where(age >= 0, torch.clamp_max(age + 1, TICK_MAX), age)

    if P.churn:
        u = u01(U_CHURN).to(F)
        fail_p, leave_p = P.fail_per_round, P.leave_per_round
        crash = up & (u < fail_p)
        leave = up & (u >= fail_p) & (u < fail_p + leave_p)
        rejoin = (~up) & (u < P.rejoin_per_round)
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
        new_rumor = new_rumor | started

    if P.slow_on:
        u_s = u01(U_SLOW).to(F)
        slow = torch.where(slow, u_s >= P.slow_recover_per_round,
                           u_s < P.slow_per_round) & up

    # the mean field: population scalars
    upf = up.to(F)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(F)
    if scal is None:
        n_live, s_elig, s_up_elig, s_slow = (
            _sum(x) for x in (upf, eligf, upf * eligf,
                              (slow & up & elig).to(F)))
        n_elig = torch.clamp_min(s_elig, 1.0)
        n_up_elig = torch.clamp_min(s_up_elig, 1e-9)
    else:
        n_live, n_elig, n_up_elig = scal[0], scal[1], scal[2]
        s_slow = scal[3]
    n_live, n_elig, n_up_elig = (x.to(F) for x in (n_live, n_elig,
                                                   n_up_elig))
    sbar = s_slow.to(F) / n_up_elig
    frac_up_elig = n_up_elig / n_elig
    g, pf_fast, pf_slow = miss_probs(slow, lh, sbar, n_live / n, P, F)

    # the prober's probe
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = frac_up_elig * (1.0 - mix)
    ack = up & (u01(U_ACK).to(F) < p_ack)
    failed = up & ~ack
    if P.lifeguard:
        lh = torch.clamp(lh + failed.to(_I32) - ack.to(_I32), 0,
                         P.awareness_max)

    # the target's side: failed probes of it arrive as a Poisson count
    if scal is None:
        e_pf_fast = _sum(upf * pf_fast) / torch.clamp_min(n_live, 1e-9)
        e_pf_slow = _sum(upf * pf_slow) / torch.clamp_min(n_live, 1e-9)
    else:
        e_pf_fast = scal[4].to(F) / torch.clamp_min(n_live, 1e-9)
        e_pf_slow = scal[5].to(F) / torch.clamp_min(n_live, 1e-9)
    e_pf_fast, e_pf_slow = e_pf_fast.to(F), e_pf_slow.to(F)
    probe_rate = n_live / torch.clamp_min(n_elig - 1.0, 1.0)
    base_fail = torch.where(slow, e_pf_slow, e_pf_fast)
    p_fail_j = torch.where(up, base_fail, 1.0)
    lam_fail = probe_rate * p_fail_j * eligf
    n_fail = trunc_poisson(u01(U_POIS).to(F), lam_fail)

    # Lifeguard's mean (LH + 1) of failing probers
    if scal is None:
        w_fail = upf * (1.0 - p_ack)
        lfail_num = _sum(w_fail * (lh.to(F) + 1.0))
        lfail_den = torch.clamp_min(_sum(w_fail), 1e-9)
    else:
        lfail_num, lfail_den = scal[6], scal[7]
    if P.lifeguard:
        scale = lfail_num.to(F) / lfail_den.to(F)
    else:
        scale = torch.ones((), dtype=F, device=informed.device)

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

    # independent confirmations shrink a running timer
    c_new = torch.clamp_max(s_conf + n_fail, CONF_MAX)
    ratio = shrink(c_new, P, F) / shrink(s_conf, P, F)
    len2 = torch.ceil(slen.to(F) * ratio).to(_I32)
    sttl = torch.where(confirms, sttl - (slen - len2), sttl)
    slen = torch.where(confirms, len2, slen)
    s_conf = torch.where(confirms, c_new, s_conf)

    # refutation: a wrongly suspected live node hears and answers
    lam_hear = P.fanout_ticks * informed * P.one_minus_loss * g
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

    # an expired timer declares the node dead
    declare = (status == SUSPECT) & (sttl <= 0)
    status = torch.where(declare, DEAD, status)
    informed = torch.where(declare, 1.0 / n, informed)
    sttl = torch.where(declare, TTL_NEVER, sttl)
    new_rumor = new_rumor | declare
    lat = (age + 1).to(F) * P.probe_interval

    # older rumors spread epidemically
    grow = (~new_rumor) & (informed < 1.0)
    lam_g = P.fanout_ticks * informed * P.one_minus_loss
    informed = torch.where(
        grow, informed + (1.0 - informed) * (1.0 - torch.exp(-lam_g)),
        informed)

    age_out = torch.where(up, torch.where(slow, SLOW_AGE, ALIVE_AGE), age)
    outs = (status, inc, informed.to(_F32), age_out, slen, sttl, s_conf,
            lh)

    upf2 = up.to(F)
    elig2 = (status == ALIVE) | (status == SUSPECT)
    elig2f = elig2.to(F)
    w_fail2 = upf2 * (1.0 - p_ack)
    lanes = [upf2, elig2f, upf2 * elig2f, (slow & up & elig2).to(F),
             upf2 * pf_fast, upf2 * pf_slow, w_fail2 * (lh.to(F) + 1.0),
             w_fail2]
    if P.collect_stats or lane_mode:
        tp = declare & ~up

        def f(m):
            return None if m is None else m.to(F)

        lanes += [f(starts), f(refute), f(declare & up), f(tp),
                  torch.where(tp, lat, 0.0), f(crash), f(rejoin), f(leave),
                  None, None]
    else:
        lanes += [None] * N_STATS
    if lane_mode:
        lanes += [upf2, informed, (status == SUSPECT).to(F),
                  (up & ((status == SUSPECT) | (status == DEAD))).to(F),
                  lh.to(F), inc.to(F)]
        lanes += [(lh >= k).to(F) for k in range(1, N_HIST + 1)]
    lanes = [None if x is None else x.to(_F32) for x in lanes]
    return outs, lanes


def _narrow(outs, like) -> tuple:
    return tuple(o.to(v.dtype) for o, v in zip(outs, like))


def clamp_scalars(sums: torch.Tensor) -> torch.Tensor:
    return torch.maximum(sums, torch.tensor(SCALAR_FLOORS, dtype=_F32,
                                            device=sums.device))


def init_scalars(s: State, P: Params, F=_F32) -> torch.Tensor:
    """Exact population scalars of a state, for a first stale period."""
    status, age, lh = s.lanes[0], s.lanes[3], s.lanes[7]
    up, slow = age < 0, age == SLOW_AGE
    upf = up.to(F)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(F)
    n_live = _sum(upf)
    n_elig = torch.clamp_min(_sum(eligf), 1.0)
    n_up_elig = torch.clamp_min(_sum(upf * eligf), 1e-9)
    n_slow = _sum((slow & up & elig).to(F))
    sbar = (n_slow / n_up_elig).to(F)
    _, pf_fast, pf_slow = miss_probs(slow, lh, sbar, (n_live / P.n).to(F),
                                     P, F)
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = (n_up_elig / n_elig).to(F) * (1.0 - mix)
    w_fail = upf * (1.0 - p_ack)
    return torch.stack([
        n_live, n_elig, n_up_elig, n_slow, _sum(upf * pf_fast),
        _sum(upf * pf_slow), _sum(w_fail * (lh.to(F) + 1.0)),
        torch.clamp_min(_sum(w_fail), 1e-9)])


# ------------------------------------------------------- kernel runner


def _partials_rows(rows: int) -> int:
    return max(1, min(GRID_BLOCKS, -(-rows // TILE)))


def block_sums(lanes, rows: int) -> torch.Tensor:
    """Contribution lanes -> the [blocks, 18] partial-sum table: tile t
    of TILE nodes adds to row t % blocks."""
    blocks = _partials_rows(rows)
    walks = -(-rows // (TILE * blocks))
    stack = torch.zeros((N_SCALARS + N_STATS, walks * blocks * TILE),
                        dtype=_F32, device=lanes[0].device)
    for i, lane in enumerate(lanes[:N_SCALARS + N_STATS]):
        if lane is not None:
            stack[i, :rows] = lane
    return stack.view(N_SCALARS + N_STATS, walks, blocks, TILE) \
        .sum((1, 3)).t().contiguous()


def _row(lanes8, t, delta: torch.Tensor) -> torch.Tensor:
    """One flight row from a period's new lanes: the clock, the live,
    informed, suspect and wrongly-suspected-or-dead shares and the mean
    local health, its maximum, the sum of incarnations, the phase (-1:
    no plan), the window's counter deltas, three zero coordinate
    columns."""
    status, inc, informed, age, lh = (lanes8[0], lanes8[1], lanes8[2],
                                      lanes8[3], lanes8[7])
    up = age < 0
    suspect = status == SUSPECT
    wrong = up & (suspect | (status == DEAD))
    lhf = lh.to(_F32)
    means = torch.stack([up.to(_F32), informed, suspect.to(_F32),
                         wrong.to(_F32), lhf]).mean(1)
    dev = status.device
    return torch.cat([t.to(_F32).reshape(1), means, torch.max(lhf).reshape(1),
                      torch.sum(inc, dtype=_F32).reshape(1),
                      torch.full((1,), -1.0, device=dev), delta,
                      torch.zeros(3, dtype=_F32, device=dev)])


def kernel_runner_call(s: State, key: torch.Tensor, P: Params, rounds: int,
                       R: int, scalars0: Optional[torch.Tensor] = None,
                       flight_every: Optional[int] = None, F=_F32):
    """One call of the kernel runner: ``rounds`` periods in launches of
    R on stale scalars (``scalars0``, else the state's exact ones).
    Returns (state', trace or None, scalars')."""
    rows = s.lanes[0].shape[0]
    dev = s.lanes[0].device
    seeds = prng.round_seeds(key, s.round_idx, rounds)
    scalars = init_scalars(s, P, F) if scalars0 is None \
        else scalars0.clone()
    keep = torch.ones(N_STATS, device=dev)
    keep[LAT] = 0.0
    acc_i = torch.stack([torch.zeros((), dtype=_I32, device=dev)
                         if i == LAT else s.stats[i].to(_I32)
                         for i in range(N_STATS)])
    acc_lat = s.stats[LAT].to(_F32).clone()
    step = float(torch.tensor(float(R), dtype=_F32)
                 * torch.tensor(P.probe_interval, dtype=_F32))
    arrays, t = s.lanes, s.t
    trace = None
    if flight_every is not None:
        if R != 1 or flight_every != 1:
            raise ValueError("the reference records every period of the "
                             "per-period runner only")
        trace = []
        prev = (acc_i.clone(), acc_lat.clone())
    for c in range(rounds // R):
        vals, acc = arrays, [None] * (N_SCALARS + N_STATS)
        for r in range(c * R, (c + 1) * R):
            outs, lanes = period(vals, scalars, P,
                                 prng.philox_slots(seeds[r], rows), F)
            vals = _narrow(outs, arrays)
            if not P.age_mutable:
                vals = vals[:3] + (arrays[3],) + vals[4:]
            for i in range(N_SCALARS, N_SCALARS + N_STATS):
                if lanes[i] is not None:
                    acc[i] = lanes[i] if acc[i] is None else acc[i] + lanes[i]
        acc[:N_SCALARS] = lanes[:N_SCALARS]
        arrays = vals
        sums = block_sums(acc, rows).sum(0)
        scalars = clamp_scalars(sums[:N_SCALARS])
        t = t + (P.probe_interval if R == 1 else step)
        if P.collect_stats:
            stat = sums[N_SCALARS:]
            acc_i = acc_i + (stat * keep).to(_I32)
            acc_lat = acc_lat + stat[LAT]
        if trace is not None:
            delta = (acc_i - prev[0]).to(_F32)
            delta[LAT] = acc_lat - prev[1]
            trace.append(_row(arrays, t, delta))
            prev = (acc_i.clone(), acc_lat.clone())
    stats = s.stats
    if P.collect_stats:
        stats = tuple(acc_lat if i == LAT else acc_i[i]
                      for i in range(N_STATS))
    out = State(arrays, t, s.round_idx + rounds, stats)
    return out, (None if trace is None else torch.stack(trace)), scalars


# --------------------------------------------------------- live engine


def live_call(s: State, key: torch.Tensor, P: Params, rounds: int,
              F=_F32) -> State:
    """``rounds`` periods on live population scalars."""
    keys = prng.round_keys(key, s.round_idx, rounds)
    rows = s.lanes[0].shape[0]
    lanes8, t, r, stats = s.lanes, s.t, s.round_idx, list(s.stats)
    for i in range(rounds):
        outs, lanes = period(lanes8, None, P,
                             prng.threefry_slots(keys[i], rows), F)
        lanes8 = _narrow(outs, lanes8)
        if P.collect_stats:
            for j in range(N_STATS):
                lane = lanes[N_SCALARS + j]
                if lane is None:
                    continue
                stats[j] = stats[j] + (torch.sum(lane) if j == LAT else
                                       torch.sum(lane.to(_I32)).to(_I32))
        t = t + P.probe_interval
        r = r + 1
    return State(lanes8, t, r, tuple(stats))


# --------------------------------------------------------- lane engine


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by pairwise halving: element i adds element
    i + h, an odd length carries its last element on."""
    while x.shape[-1] > 1:
        length = x.shape[-1]
        h = length // 2
        y = x[..., :h] + x[..., h:2 * h]
        if length % 2:
            y = torch.cat([y, x[..., 2 * h:]], dim=-1)
        x = y
    return x[..., 0]


def reduce_lanes(stack: torch.Tensor) -> torch.Tensor:
    """[K, N] -> [K]: LANE_BLOCKS contiguous blocks, each a tree sum
    (+0.0), then a tree sum of the blocks."""
    rows = stack.reshape(stack.shape[0], LANE_BLOCKS,
                         stack.shape[-1] // LANE_BLOCKS)
    return tree_sum(tree_sum(rows) + 0.0)


def init_lanes(s: State, P: Params, F=_F32) -> torch.Tensor:
    status, age, lh = s.lanes[0], s.lanes[3], s.lanes[7]
    up, slow = age < 0, age == SLOW_AGE
    upf = up.to(F)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(F)
    a = reduce_lanes(torch.stack([upf, eligf, upf * eligf,
                                  (slow & up & elig).to(F)]).to(_F32))
    n_live = a[0]
    n_elig = torch.clamp_min(a[1], 1.0)
    n_up_elig = torch.clamp_min(a[2], 1e-9)
    sbar = (a[3] / n_up_elig).to(F)
    _, pf_fast, pf_slow = miss_probs(slow, lh, sbar, (n_live / P.n).to(F),
                                     P, F)
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = (n_up_elig / n_elig).to(F) * (1.0 - mix)
    w_fail = upf * (1.0 - p_ack)
    b = reduce_lanes(torch.stack([upf * pf_fast, upf * pf_slow,
                                  w_fail * (lh.to(F) + 1.0),
                                  w_fail]).to(_F32))
    lanes = torch.zeros(N_LANE_ROWS, dtype=_F32, device=a.device)
    lanes[0:4] = a
    lanes[4:8] = b
    return lanes


def lanes_call(s: State, key: torch.Tensor, P: Params, rounds: int,
               F=_F32) -> State:
    """``rounds`` periods in windows of ``P.stale_k`` on scalars frozen
    from the last window's reduction (the first from the state's exact
    sums)."""
    keys = prng.round_keys(key, s.round_idx, rounds)
    rows = s.lanes[0].shape[0]
    k = P.stale_k
    lv = init_lanes(s, P, F)
    lanes8, t, r, stats = s.lanes, s.t, s.round_idx, list(s.stats)
    floors = torch.tensor(SCALAR_FLOORS, dtype=_F32, device=lv.device)
    for i0 in range(0, rounds, k):
        count = min(k, rounds - i0)
        scalars = torch.maximum(lv[:N_SCALARS], floors)
        pend = None
        for j in range(count):
            outs, lanes = period(lanes8, scalars, P,
                                 prng.global_slots(keys[i0 + j], rows), F,
                                 lane_mode=True)
            lanes8 = _narrow(outs, lanes8)
            t = t + P.probe_interval
            r = r + 1
            zeros = torch.zeros(rows, dtype=_F32, device=lv.device)
            stack = torch.stack([zeros if x is None else x.expand(rows)
                                 for x in lanes])
            if P.collect_stats:
                cnt = stack[N_SCALARS:N_SCALARS + N_STATS]
                pend = cnt if j == 0 else pend + cnt
        if P.collect_stats and count > 1:
            stack[N_SCALARS:N_SCALARS + N_STATS] = pend
        lv = reduce_lanes(stack)
        if P.collect_stats:
            d = lv[N_SCALARS:N_SCALARS + N_STATS]
            for j in range(N_STATS):
                stats[j] = stats[j] + (d[j] if j == LAT
                                       else d[j].to(_I32))
    return State(lanes8, t, r, tuple(stats))
