"""The autotuner's sweep: every point of the traffic's grid run from the
same start on the same key stream as the lane engine's call
(``model.lanes_call``) on that point's constants, the points batched
along a leading dimension.

A point's constants are ``model.Params`` built from the harness's
``P`` with the point's values of the swept keys and a pool of ``P.n /
G`` agents, folded on the host in f64 as ever. The batched period below
is ``model.period`` in lane mode on stale scalars with each constant a
swept key moves (``fanout_ticks``; ``suspicion_max_s``,
``confirmation_k``, ``shrink_r``, ``shrink_omr``) a ``[G, 1]`` column
cast once to ``F``, and the stale scalars ``[8, G, 1]``; every other
step is the same elementwise operation on ``[G, pool]`` rows, and each
point's reduction the same fixed tree (``reduce_grid``), so a point's
row is its own ``lanes_call`` bit for bit (a CPU test holds them
equal). The draws are the pool's: each period's ``[pool]`` words are
shared by every point, as the program shares its key stream.

``call`` takes and returns the check's form (``gossipbench/grid.py``):
a start of ``G * pool`` agents, flattened point-major, whose clocks and
counters are zero (a sweep starts every point at round 0), and returns
the final state so folded with the ``[12, G]`` report inputs as its
scalars.
"""

from __future__ import annotations

import torch

from gossipbench import grid
from gossipbench.reference import model, prng
from gossipbench.reference.model import (ALIVE, CONF_MAX, DEAD, LAT,
                                         LEFT, N_HIST, N_SCALARS, N_STATS,
                                         SCALAR_FLOORS, SLOW_AGE, SUSPECT,
                                         TICK_MAX, TTL_NEVER, U_ACK,
                                         U_CHURN, U_HEAR, U_POIS, U_SLOW)

_F32 = torch.float32
_I32 = torch.int32
#: the constants a point's swept keys move, as ``[G, 1]`` columns
COLUMNS = ("fanout_ticks", "suspicion_max_s", "confirmation_k",
           "shrink_r", "shrink_omr")


def grid_points(axes: dict) -> list:
    """The grid's points as {key: value}, first axis slowest."""
    out = [{}]
    for name, values in axes.items():
        out = [{**pt, name: v} for pt in out for v in values]
    return out


class Grid:
    """Each point's ``model.Params`` (``points``), the first as the
    constants every point shares (``base``), and the swept ones'
    ``[G, 1]`` f64 columns (``column(name, F)`` casts one once)."""

    def __init__(self, P: model.Params, axes: dict):
        pts = grid_points(axes)
        if P.n % len(pts):
            raise ValueError(f"{P.n} agent-rows do not split into "
                             f"{len(pts)} pools")
        # ``model.Params`` reads its raw keys from P's attributes of the
        # same names and folds the derived constants anew
        self.points = [model.Params(vars(P), n=P.n // len(pts), **pt)
                       for pt in pts]
        self.base = self.points[0]
        if not (self.base.lifeguard and self.base.collect_stats):
            raise ValueError("the sweep's reference states Lifeguard "
                             "with its counters on")
        self._cols = {c: torch.tensor([[float(getattr(q, c))]
                                       for q in self.points],
                                      dtype=torch.float64)
                      for c in COLUMNS}

    def column(self, name: str, F, device) -> torch.Tensor:
        return self._cols[name].to(device=device, dtype=F)


def shrink(c: torch.Tensor, Q: Grid, F) -> torch.Tensor:
    """``model.shrink`` with each point's suspicion constants (Lifeguard
    on, max > min at every point of the grid)."""
    dev = c.device
    den = torch.log(Q.column("confirmation_k", F, dev) + 1.0)
    frac = torch.log(c.to(F) + 1.0) / den
    return torch.maximum(1.0 - Q.column("shrink_omr", F, dev) * frac,
                         Q.column("shrink_r", F, dev))


def period(vals, scal: torch.Tensor, Q: Grid, u01, F=_F32):
    """``model.period(vals, scal, P, u01, F, lane_mode=True)`` over
    ``[G, pool]`` lanes, ``scal`` the ``[8, G, 1]`` stale scalars."""
    P = Q.base
    status_in, inc_in, informed, age_in, slen_in, sttl_in, conf_in, lh_in \
        = vals
    n = P.n
    dev = informed.device
    fanout = Q.column("fanout_ticks", F, dev)
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

    age = torch.where(age >= 0, torch.clamp_max(age + 1, TICK_MAX), age)

    if P.churn:
        u = u01(U_CHURN).to(F)
        fail_p, leave_p = P.fail_per_round, P.leave_per_round
        crash = up & (u < fail_p)
        leave = up & (u >= fail_p) & (u < fail_p + leave_p)
        rejoin = (~up) & (u < P.rejoin_per_round)
        up = (up & ~(crash | leave)) | rejoin
        age = torch.where(crash | leave, 0, age)
        age = torch.where(rejoin, model.ALIVE_AGE, age)
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

    upf = up.to(F)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(F)
    n_live, n_elig, n_up_elig = (x.to(F) for x in (scal[0], scal[1],
                                                   scal[2]))
    sbar = scal[3].to(F) / n_up_elig
    frac_up_elig = n_up_elig / n_elig
    g, pf_fast, pf_slow = model.miss_probs(slow, lh, sbar, n_live / n, P, F)

    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = frac_up_elig * (1.0 - mix)
    ack = up & (u01(U_ACK).to(F) < p_ack)
    failed = up & ~ack
    lh = torch.clamp(lh + failed.to(_I32) - ack.to(_I32), 0,
                     P.awareness_max)

    e_pf_fast = (scal[4].to(F) / torch.clamp_min(n_live, 1e-9)).to(F)
    e_pf_slow = (scal[5].to(F) / torch.clamp_min(n_live, 1e-9)).to(F)
    probe_rate = n_live / torch.clamp_min(n_elig - 1.0, 1.0)
    base_fail = torch.where(slow, e_pf_slow, e_pf_fast)
    p_fail_j = torch.where(up, base_fail, 1.0)
    lam_fail = probe_rate * p_fail_j * eligf
    n_fail = model.trunc_poisson(u01(U_POIS).to(F), lam_fail)

    scale = scal[6].to(F) / scal[7].to(F)

    sttl = torch.where(status == SUSPECT, sttl - 1, sttl)
    starts = (n_fail > 0) & (status == ALIVE)
    confirms = (n_fail > 0) & (status == SUSPECT)
    c0 = torch.clamp_min(n_fail - 1, 0)
    timeout0 = scale * Q.column("suspicion_max_s", F, dev) * shrink(c0, Q, F)
    ticks0 = torch.ceil(timeout0 / P.probe_interval)
    len0 = torch.clamp_max(ticks0, float(TICK_MAX)).to(_I32)
    status = torch.where(starts, SUSPECT, status)
    slen = torch.where(starts, len0, slen)
    sttl = torch.where(starts, len0, sttl)
    s_conf = torch.where(starts, c0, s_conf)
    informed = torch.where(starts, 1.0 / n, informed)
    new_rumor = new_rumor | starts

    c_new = torch.clamp_max(s_conf + n_fail, CONF_MAX)
    ratio = shrink(c_new, Q, F) / shrink(s_conf, Q, F)
    len2 = torch.ceil(slen.to(F) * ratio).to(_I32)
    sttl = torch.where(confirms, sttl - (slen - len2), sttl)
    slen = torch.where(confirms, len2, slen)
    s_conf = torch.where(confirms, c_new, s_conf)

    lam_hear = fanout * informed * P.one_minus_loss * g
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
    lh = torch.clamp(lh + refute.to(_I32), 0, P.awareness_max)

    declare = (status == SUSPECT) & (sttl <= 0)
    status = torch.where(declare, DEAD, status)
    informed = torch.where(declare, 1.0 / n, informed)
    sttl = torch.where(declare, TTL_NEVER, sttl)
    new_rumor = new_rumor | declare
    lat = (age + 1).to(F) * P.probe_interval

    grow = (~new_rumor) & (informed < 1.0)
    lam_g = fanout * informed * P.one_minus_loss
    informed = torch.where(
        grow, informed + (1.0 - informed) * (1.0 - torch.exp(-lam_g)),
        informed)

    age_out = torch.where(up, torch.where(slow, SLOW_AGE, model.ALIVE_AGE),
                          age)
    outs = (status, inc, informed.to(_F32), age_out, slen, sttl, s_conf,
            lh)

    upf2 = up.to(F)
    elig2 = (status == ALIVE) | (status == SUSPECT)
    elig2f = elig2.to(F)
    w_fail2 = upf2 * (1.0 - p_ack)
    tp = declare & ~up

    def f(m):
        return None if m is None else m.to(F)

    lanes = [upf2, elig2f, upf2 * elig2f, (slow & up & elig2).to(F),
             upf2 * pf_fast, upf2 * pf_slow, w_fail2 * (lh.to(F) + 1.0),
             w_fail2,
             f(starts), f(refute), f(declare & up), f(tp),
             torch.where(tp, lat, 0.0), f(crash), f(rejoin), f(leave),
             None, None,
             upf2, informed, (status == SUSPECT).to(F),
             (up & ((status == SUSPECT) | (status == DEAD))).to(F),
             lh.to(F), inc.to(F)]
    lanes += [(lh >= k).to(F) for k in range(1, N_HIST + 1)]
    return outs, [None if x is None else x.to(_F32) for x in lanes]


def reduce_grid(stack: torch.Tensor) -> torch.Tensor:
    """``model.reduce_lanes`` of each point: ``[K, G, pool]`` ->
    ``[K, G]``."""
    k, g, rows = stack.shape
    blocks = stack.reshape(k, g, model.LANE_BLOCKS,
                           rows // model.LANE_BLOCKS)
    return model.tree_sum(model.tree_sum(blocks) + 0.0)


def init_lanes(lanes8, Q: Grid, F=_F32) -> torch.Tensor:
    """``model.init_lanes`` of each point: ``[N_LANE_ROWS, G]``."""
    P = Q.base
    status, age, lh = lanes8[0], lanes8[3], lanes8[7]
    up, slow = age < 0, age == SLOW_AGE
    upf = up.to(F)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(F)
    a = reduce_grid(torch.stack([upf, eligf, upf * eligf,
                                 (slow & up & elig).to(F)]).to(_F32))
    n_live = a[0, :, None]
    n_elig = torch.clamp_min(a[1, :, None], 1.0)
    n_up_elig = torch.clamp_min(a[2, :, None], 1e-9)
    sbar = (a[3, :, None] / n_up_elig).to(F)
    _, pf_fast, pf_slow = model.miss_probs(slow, lh, sbar,
                                           (n_live / P.n).to(F), P, F)
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = (n_up_elig / n_elig).to(F) * (1.0 - mix)
    w_fail = upf * (1.0 - p_ack)
    b = reduce_grid(torch.stack([upf * pf_fast, upf * pf_slow,
                                 w_fail * (lh.to(F) + 1.0),
                                 w_fail]).to(_F32))
    lanes = torch.zeros((model.N_LANE_ROWS, a.shape[1]), dtype=_F32,
                        device=a.device)
    lanes[0:4] = a
    lanes[4:8] = b
    return lanes


def sweep_call(lanes8, key: torch.Tensor, Q: Grid, rounds: int, F=_F32):
    """``rounds`` periods of every point from ``[G, pool]`` lanes at
    round 0 with no counts: ``model.lanes_call``'s windows, each point
    on its constants. Returns (lanes, t, round_idx, stats), each
    ``[G]``-leading."""
    P = Q.base
    g, rows = lanes8[0].shape
    dev = lanes8[0].device
    keys = prng.round_keys(key, 0, rounds)
    k = P.stale_k
    lv = init_lanes(lanes8, Q, F)
    t = torch.zeros(g, dtype=_F32, device=dev)
    r = torch.zeros(g, dtype=_I32, device=dev)
    stats = [torch.zeros(g, dtype=_F32 if j == LAT else _I32, device=dev)
             for j in range(N_STATS)]
    floors = torch.tensor(SCALAR_FLOORS, dtype=_F32, device=dev)[:, None]
    zeros = torch.zeros((g, rows), dtype=_F32, device=dev)
    for i0 in range(0, rounds, k):
        count = min(k, rounds - i0)
        scal = torch.maximum(lv[:N_SCALARS], floors)[:, :, None]
        pend = None
        for j in range(count):
            outs, lanes = period(lanes8, scal, Q,
                                 prng.global_slots(keys[i0 + j], rows), F)
            lanes8 = model._narrow(outs, lanes8)
            t = t + P.probe_interval
            r = r + 1
            stack = torch.stack([zeros if x is None else x.expand(g, rows)
                                 for x in lanes])
            cnt = stack[N_SCALARS:N_SCALARS + N_STATS]
            pend = cnt if j == 0 else pend + cnt
        if count > 1:
            stack[N_SCALARS:N_SCALARS + N_STATS] = pend
        lv = reduce_grid(stack)
        d = lv[N_SCALARS:N_SCALARS + N_STATS]
        for j in range(N_STATS):
            stats[j] = stats[j] + (d[j] if j == LAT else d[j].to(_I32))
    return lanes8, t, r, stats


def call(s, key, P, traffic, scalars0=None, F=_F32):
    Q = Grid(P, traffic["grid"])
    g = len(Q.points)
    if any(float(x) != 0.0 for x in (s.t, s.round_idx, *s.stats)):
        raise ValueError("a sweep starts every point at round 0 with no "
                         "counts")
    lanes8 = tuple(a.reshape(g, -1) for a in s.lanes)
    lanes8, t, r, stats = sweep_call(lanes8, key, Q, traffic["rounds"], F)
    out = grid.fold(lanes8, t, r, stats)
    return (model.State(out["lanes"], out["t"], out["round_idx"],
                        out["stats"]), None,
            grid.report_inputs(lanes8, t, stats))
