"""The kernel runner's calls under a fault plan: the per-period runner
(R = 1) on stale scalars, each period shaped by its phase's frame
(``reference/plan.py``), a flight row a period with the phase in it.

A faulted period is ``model.period`` with the frame's terms:

* churn is drawn on every period, the frame's crash, rejoin and leave
  rates added to the configuration's;
* a forced-slow node (``slow_f``) counts as slow in this period's probe
  terms; the stored slow state, and the slow scalar lane, stay the
  stochastic ones;
* a prober's direct probe and TCP fallback succeed in proportion to its
  round trip ``psend * precv``, each relay leg to that times ``mid``,
  and Lifeguard's patience (``1 - 2^-lh``) enters whenever it is on;
* a target's probes fail as ``1 - (1 - miss) * suspw``; on a byzantine
  frame forged acks gate the failures of down agents (``(1 -
  forge_ack)^indirect_checks``), forged suspicions arrive at
  ``spur_susp`` on top of them, and the Lifeguard scale is at least 1;
* refutation is heard at ``hear_w`` and, on a byzantine frame, crowded
  out by stale replays (``1 - replay``), which also bump live victims'
  incarnations (the sixth draw: Philox call 1, word 1);
* epidemic growth runs at ``mid`` (and ``1 - replay``);
* a byzantine frame counts the suspicions started against, and the live
  agents declared among, the attacked agents (the two attack counters).

The next period's stale scalars are the sum of the period's per-block
partial sums. On the card a block's sum is taken in the order of the
round kernel's threads (``kernel_block_sums``): the scalars feed
decisions that round a scaled quantity up, such as a new suspicion's
length, ceil(scale x timeout), and a few ulps there flip a whole period's
class of new suspects. On the CPU, where the program's round is its plain
version, the partials are ``model.block_sums``.

Where this departs from the program's order of operations: the program
draws Philox call 1 (hear, replay) only for the agents that take one of
those draws, and folds the frame's phase on the device; here every
agent's call 1 is computed and the phase is looked up on the host. The
draws taken, and so every result, are the same.
"""

from __future__ import annotations

import torch

from gossipbench.reference import model, prng
from gossipbench.reference.model import (ALIVE, ALIVE_AGE, CONF_MAX, DEAD,
                                         LAT, LEFT, N_SCALARS, N_STATS,
                                         SLOW_AGE, SUSPECT, TICK_MAX,
                                         TTL_NEVER, U_ACK, U_CHURN, U_HEAR,
                                         U_POIS, U_SLOW, ipow, shrink,
                                         trunc_poisson)
from gossipbench.reference.plan import Plan

U_REPLAY = 5
#: agents a thread of the round kernel takes from each tile it walks: 2
#: in the byzantine variant, 4 in the honest-frame one; threads a warp
BYZ_NPT, FAULT_NPT = 2, 4
WARP = 32
_F32 = torch.float32
_I32 = torch.int32


def kernel_block_sums(lanes, rows: int, npt: int) -> torch.Tensor:
    """The ``[blocks, 18]`` partial sums as the round kernel adds them.
    Block b walks tiles b, b + blocks, ... of ``model.TILE`` agents;
    thread t of a block takes agents ``t * npt`` to ``t * npt + npt - 1``
    of each tile and adds its values in turn, tile by tile, from 0; each
    warp of 32 threads folds its sums by halves (thread k adds thread k +
    16, then k + 8, ..., 1), and the block adds its warps' sums in turn,
    from 0. Agents past ``rows`` add nothing."""
    blocks = max(1, min(model.GRID_BLOCKS, -(-rows // model.TILE)))
    walks = -(-rows // (model.TILE * blocks))
    threads = model.TILE // npt
    n_lanes = N_SCALARS + N_STATS
    stack = torch.zeros((n_lanes, walks * blocks * model.TILE), dtype=_F32,
                        device=lanes[0].device)
    for i, lane in enumerate(lanes[:n_lanes]):
        if lane is not None:
            stack[i, :rows] = lane
    # a thread's values in the order it adds them: tile by tile, agent
    # by agent
    seq = stack.view(n_lanes, walks, blocks, threads, npt) \
        .permute(0, 2, 3, 1, 4).reshape(n_lanes, blocks, threads, -1)
    acc = torch.zeros(seq.shape[:-1], dtype=_F32, device=stack.device)
    for s in range(seq.shape[-1]):
        acc = acc + seq[..., s]
    warp = acc.view(n_lanes, blocks, threads // WARP, WARP)
    off = WARP // 2
    while off:
        warp = warp[..., :off] + warp[..., off:2 * off]
        off //= 2
    out = torch.zeros((n_lanes, blocks), dtype=_F32, device=stack.device)
    for w in range(threads // WARP):
        out = out + warp[..., w, 0]
    return out.t().contiguous()


def miss_probs(slow, lh, sbar, live_frac, P, fx, F):
    """``model.miss_probs`` under a frame: patience whenever Lifeguard
    is on, the direct and TCP legs scaled by the round trip, each relay
    by the round trip times ``mid``."""
    g = torch.where(slow, P.slow_factor, 1.0).to(F)
    if P.lifeguard:
        patience = 1.0 - torch.exp2(-lh.to(F))
    else:
        patience = torch.zeros_like(g)
    rt = fx["psend"].to(F) * fx["precv"].to(F)
    relay_m = rt * fx["mid"].to(F)

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
        p_d = p_d * rt
        p_relay1 = p_relay1 * relay_m
        p_tcp = p_tcp * rt
        p_no_relay = ipow(1.0 - p_relay1, P.indirect_checks)
        return (1.0 - p_d) * p_no_relay * (1.0 - p_tcp)

    return g, noack(1.0), noack(P.slow_factor)


def period(vals, scal, P, u01, fx: dict, byz: bool, F=_F32):
    """One faulted period over the 8 lanes ``vals`` on the stale [8]
    scalars ``scal``; returns the 8 new lanes (widened) and the 18
    contribution lanes (None where zero), the attack counters last."""
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

    # the stale population scalars
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(F)
    n_live, n_elig, n_up_elig = (x.to(F) for x in scal[:3])
    sbar = scal[3].to(F) / n_up_elig
    frac_up_elig = n_up_elig / n_elig
    g, pf_fast, pf_slow = miss_probs(slow_eff, lh, sbar, n_live / n, P, fx,
                                     F)

    # the prober's probe
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = frac_up_elig * (1.0 - mix)
    ack = up & (u01(U_ACK).to(F) < p_ack)
    failed = up & ~ack
    if P.lifeguard:
        lh = torch.clamp(lh + failed.to(_I32) - ack.to(_I32), 0,
                         P.awareness_max)

    # the target's side: failed (and forged) probes as a Poisson count
    e_pf_fast = scal[4].to(F) / torch.clamp_min(n_live, 1e-9)
    e_pf_slow = scal[5].to(F) / torch.clamp_min(n_live, 1e-9)
    probe_rate = n_live / torch.clamp_min(n_elig - 1.0, 1.0)
    base_fail = torch.where(slow_eff, e_pf_slow, e_pf_fast)
    base_fail = 1.0 - (1.0 - base_fail) * lane("suspw")
    p_fail_j = torch.where(up, base_fail, 1.0)
    if byz:
        one = torch.ones((), dtype=F, device=up.device)
        p_fail_j = p_fail_j * torch.where(
            up, one, ipow(one - lane("forge_ack"), P.indirect_checks)
            if P.indirect_checks else one)
    lam_fail = probe_rate * p_fail_j * eligf
    if byz:
        lam_fail = lam_fail + lane("spur_susp") * eligf
    n_fail = trunc_poisson(u01(U_POIS).to(F), lam_fail)

    if P.lifeguard:
        scale = scal[6].to(F) / scal[7].to(F)
        if byz:
            scale = torch.clamp_min(scale, 1.0)
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

    # refutation: heard and answered through the frame
    lam_hear = P.fanout_ticks * informed * P.one_minus_loss * g
    lam_hear = lam_hear * lane("hear_w")
    if byz:
        lam_hear = lam_hear * (1.0 - lane("replay"))
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

    if byz:
        # stale replays bump live victims' incarnations
        bump = up & (status == ALIVE) & ~new_rumor \
            & (u01(U_REPLAY).to(F) < lane("replay"))
        inc = torch.where(bump, torch.clamp_max(inc + 1, TICK_MAX), inc)
        informed = torch.where(bump, 1.0 / n, informed)
        new_rumor = new_rumor | bump

    declare = (status == SUSPECT) & (sttl <= 0)
    status = torch.where(declare, DEAD, status)
    informed = torch.where(declare, 1.0 / n, informed)
    sttl = torch.where(declare, TTL_NEVER, sttl)
    new_rumor = new_rumor | declare
    lat = (age + 1).to(F) * P.probe_interval

    grow = (~new_rumor) & (informed < 1.0)
    lam_g = P.fanout_ticks * informed * P.one_minus_loss * lane("mid")
    if byz:
        lam_g = lam_g * (1.0 - lane("replay"))
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
    if P.collect_stats:
        tp = declare & ~up
        hit = fx["attacked"]
        lanes += [starts, refute, declare & up, tp,
                  torch.where(tp, lat, 0.0), crash, rejoin, leave]
        lanes += [starts & hit, declare & up & hit] if byz else [None] * 2
    else:
        lanes += [None] * N_STATS
    lanes = [None if x is None else x.to(_F32) for x in lanes]
    return outs, lanes


def call(s, key, P, traffic, scalars0=None, F=_F32):
    """One call: ``traffic["rounds"]`` periods from the state's round,
    each on the plan's frame for its absolute round, on stale scalars
    (``scalars0``, else the state's exact ones). Returns (state', the
    flight trace, None)."""
    if traffic["R"] != 1 or traffic.get("flight_every") != 1:
        raise ValueError("the reference runs the per-period runner with a "
                         "flight row every period")
    rows = s.lanes[0].shape[0]
    dev = s.lanes[0].device
    plan = Plan(traffic["plan"], rows, dev)
    rounds = traffic["rounds"]
    r0 = int(s.round_idx)
    seeds = prng.round_seeds(key, s.round_idx, rounds)
    scalars = model.init_scalars(s, P, F) if scalars0 is None \
        else scalars0.clone()
    keep = torch.ones(N_STATS, device=dev)
    keep[LAT] = 0.0
    acc_i = torch.stack([torch.zeros((), dtype=_I32, device=dev)
                         if i == LAT else s.stats[i].to(_I32)
                         for i in range(N_STATS)])
    acc_lat = s.stats[LAT].to(_F32).clone()
    arrays, t = s.lanes, s.t
    trace = []
    prev = (acc_i.clone(), acc_lat.clone())
    for r in range(rounds):
        fx = plan.frame(r0 + r)
        outs, lanes = period(arrays, scalars, P,
                             prng.philox_slots(seeds[r], rows), fx,
                             plan.byzantine, F)
        arrays = tuple(o.to(v.dtype) for o, v in zip(outs, arrays))
        if dev.type == "cuda":
            table = kernel_block_sums(
                lanes, rows, BYZ_NPT if plan.byzantine else FAULT_NPT)
        else:
            table = model.block_sums(lanes, rows)
        sums = table.sum(0)
        scalars = model.clamp_scalars(sums[:N_SCALARS])
        t = t + P.probe_interval
        if P.collect_stats:
            stat = sums[N_SCALARS:]
            acc_i = acc_i + (stat * keep).to(_I32)
            acc_lat = acc_lat + stat[LAT]
        delta = (acc_i - prev[0]).to(_F32)
        delta[LAT] = acc_lat - prev[1]
        row = model._row(arrays, t, delta)
        row[8] = float(plan.phase(r0 + r))
        trace.append(row)
        prev = (acc_i.clone(), acc_lat.clone())
    stats = s.stats
    if P.collect_stats:
        stats = tuple(acc_lat if i == LAT else acc_i[i]
                      for i in range(N_STATS))
    out = model.State(arrays, t, s.round_idx + rounds, stats)
    return out, torch.stack(trace), None
