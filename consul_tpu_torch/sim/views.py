"""The per-viewer tier: dense O(N²) SWIM with real membership views.

The port of the JAX package's ``consul_tpu/sim/views.py``. The mean-field
tier (``sim/round.py``) keeps O(N) rumor aggregates; this tier keeps, for
each of n viewers i, a full view of every subject j:

* ``status[i, j]``  what i believes about j (ALIVE/SUSPECT/DEAD), int8
* ``inc[i, j]``     the incarnation that belief carries, int32
* suspicion timer   start, deadline, independent-confirmation count
* ``budget[i, j]``  piggyback retransmissions left for the entry, int8
* ``reach[i, j]``   whether packets i -> j are delivered (partitions)

One round is one protocol period of dense ``[n, n]`` ops: a probe with
indirect relays and TCP fallback, suspicion with the Lifeguard timer
shrinking on independent confirmations, ``gossip_ticks_per_round``
piggyback ticks of ``gossip_nodes`` Gumbel-max picks each, push/pull
anti-entropy with serf's reconnector every ~30 s, expiry and
self-refutation, and cumulative ``ViewStats``. Every belief merge is a
max over one total-order key, ``inc * 4 + precedence`` (alive 0,
suspect 1, dead 2): the reference's ``segment_max`` over sender rows is
``scatter_reduce_(..., "amax")`` into a tensor filled with -1 (empty
segments stay -1, as the reference clamps them). The int8 lanes wrap
and saturate as jnp's do, and ``torch.argmax`` returns the first
maximum (0 on an all ``-inf`` row), as ``jnp.argmax`` does.

The draws are the reference's keys bit for bit (``prng``: ``split``,
``fold_in``, ``uniform`` with bounds); ``_pick``'s Gumbel is
``-log(-log(u))``, and PyTorch's and XLA's ``log`` differ in the last
bits, so a pick whose top two candidates lie within a few ulp can flip.
Where every pick agrees, a round's int lanes equal the reference's.

``make_sharded_views_round`` runs the same round over a viewer-sharded
mesh (``sim/mesh.py``): rows of the ``[n, n]`` views are split across
the ranks, the ``[n]`` ground truth is replicated. Gossip deliveries are
a per-rank partial max of its senders' transmissions to all receivers,
then an ``all_to_all`` max-reduce-scatter (each rank receives only its
receiver rows), or an all-reduce MAX (``exchange="pmax"``); push/pull
gathers the keys (``all_gather``); the self-incarnation deltas and the
stats' sums are all-reduce SUMs. Its keys are the reference's sharded
keys (``fold_in(key, shard)``), not the single-device tier's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from consul_tpu_torch.faults import ipow
from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim.mesh import Mesh, make_mesh
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import ALIVE, DEAD, SUSPECT
from consul_tpu_torch.utils.platform import DeviceLike, default_device

NO_DEADLINE = 2**31 - 1
_I8, _I32, _F32 = torch.int8, torch.int32, torch.float32


class ViewStats(NamedTuple):
    """Cumulative detector counters (0-d int32 tensors), commensurate
    with the mean-field tier's SimStats. Subject-level incidents: a
    column of the views going from "no live viewer holds X about j" to
    "some live viewer does". Pair-level events: each viewer's own
    suspicion adoption or timer expiry."""

    susp_incidents: torch.Tensor    # columns newly SUSPECT
    fp_incidents: torch.Tensor      # up subject newly seen DEAD
    deaths_declared: torch.Tensor   # down subject newly seen DEAD
    detect_latency_rounds: torch.Tensor  # sum of (seen - crash) rounds
    refutes: torch.Tensor           # self-refutation events
    pair_susp_starts: torch.Tensor  # (viewer, subject) -> SUSPECT
    pair_fp_declares: torch.Tensor  # local expiry on an up subject

    @staticmethod
    def zeros(device: DeviceLike = None) -> "ViewStats":
        dev = default_device(device)
        return ViewStats(*[torch.zeros((), dtype=_I32, device=dev)
                           for _ in ViewStats._fields])


class ViewState(NamedTuple):
    """Dense per-viewer cluster state: ``[n]`` ground truth, ``[n, n]``
    views (``[n/d, n]`` rows on a rank of a d-rank mesh)."""

    up: torch.Tensor          # [n] bool — process liveness
    down_round: torch.Tensor  # [n] int32 — round of crash (MAX while up)
    self_inc: torch.Tensor    # [n] int32 — each node's own incarnation
    slow: torch.Tensor        # [n] bool — degraded (late processing)
    lh: torch.Tensor          # [rows] int8 — Lifeguard local health
    status: torch.Tensor      # int8 — viewer i's belief about subject j
    inc: torch.Tensor         # int32 — incarnation of that belief
    susp_start: torch.Tensor     # int32 — round suspicion began
    susp_deadline: torch.Tensor  # int32 — declare-dead round
    susp_conf: torch.Tensor   # int8 — independent confirmations seen
    budget: torch.Tensor      # int8 — piggyback retransmissions left
    reach: torch.Tensor       # bool — packets i -> j deliverable
    round: torch.Tensor       # 0-d int32
    stats: ViewStats


#: the row-sharded fields of a ViewState on a viewer mesh
ROW_FIELDS = ("lh", "status", "inc", "susp_start", "susp_deadline",
              "susp_conf", "budget", "reach")


def _init_rows(n: int, rows: int, dev: torch.device) -> ViewState:
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return ViewState(
        up=full((n,), True, torch.bool),
        down_round=full((n,), NO_DEADLINE, _I32),
        self_inc=full((n,), 0, _I32),
        slow=full((n,), False, torch.bool),
        lh=full((rows,), 0, _I8),
        status=full((rows, n), ALIVE, _I8),
        inc=full((rows, n), 0, _I32),
        susp_start=full((rows, n), 0, _I32),
        susp_deadline=full((rows, n), NO_DEADLINE, _I32),
        susp_conf=full((rows, n), 0, _I8),
        budget=full((rows, n), 0, _I8),
        reach=full((rows, n), True, torch.bool),
        round=full((), 0, _I32),
        stats=ViewStats.zeros(dev))


def init_views(n: int, device: DeviceLike = None) -> ViewState:
    """Everyone up and ALIVE in every view."""
    return _init_rows(n, n, default_device(device))


def _key(status: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """Total-order merge key: (incarnation, status precedence)."""
    prec = (status == DEAD).to(_I32) * 2 + (status == SUSPECT).to(_I32)
    return inc * 4 + prec


def _unkey(key: torch.Tensor) -> tuple:
    """(status int8, incarnation) of a merge key: precedence 0, 1, 2 is
    ALIVE, SUSPECT, DEAD (status codes 1, 2, 3); 3 reads as ALIVE."""
    prec = (key % 4).to(_I8)
    status = torch.where(prec == 3, ALIVE, prec + 1)
    return status, key // 4


def _timeout_rounds(p: SimParams) -> tuple:
    """(min, max) suspicion timeout in rounds (the Lifeguard window)."""
    min_r = max(1, round(p.suspicion_min_s / p.probe_interval))
    max_r = max(min_r, round(p.suspicion_max_s / p.probe_interval))
    return min_r, max_r


def _pick(key: prng.Key, mask: torch.Tensor) -> torch.Tensor:
    """Per-row Gumbel-max categorical draw over ``mask`` [r, n] -> [r];
    a ``[F, 2]`` key stack draws F picks over the one mask: [F, r]."""
    u = prng.uniform(key, tuple(mask.shape), minval=1e-9, maxval=1.0)
    g = -torch.log(-torch.log(u))
    return torch.argmax(torch.where(mask, g, -math.inf), dim=-1)


def _gossip_draws(k_gossip: prng.Key, p: SimParams, rows: int):
    """A round's gossip keys and uniforms, derived at once from the
    reference's chain ``split(k_gossip, ticks)`` -> ``split(., fanout)``
    -> ``split(., 3)`` (pick, loss, processing): the pick keys ``[T, F,
    2]`` (a ``prng.SubKey`` stack) and the loss and processing uniforms
    ``[T, F, rows]``. None depends on the state, so a tick draws its F
    picks in one call. The chain's last level is derived by the draws
    that take its keys, so it is no launch of its own."""
    sub = prng.split(prng.split(k_gossip, int(p.gossip_ticks_per_round)),
                     int(p.gossip_nodes))
    return (prng.SubKey(sub, 0), prng.uniform(prng.SubKey(sub, 1), rows),
            prng.uniform(prng.SubKey(sub, 2), rows))


def _p_noack_pair(g_i: torch.Tensor, g_t: torch.Tensor, pi_i: torch.Tensor,
                  sbar: torch.Tensor, live_frac: torch.Tensor,
                  p: SimParams) -> torch.Tensor:
    """Per-(prober, target) probe-miss probability: the mean-field tier's
    channel composition (direct, any of ``indirect_checks`` relays, TCP)
    at the pair's timeliness ``g``; ``pi_i`` is the prober's Lifeguard
    patience (1 - 2^-LH), which rescues a slow endpoint's lateness."""
    ge_i = g_i + (1.0 - g_i) * pi_i
    ge_t = g_t + (1.0 - g_t) * pi_i
    pair2 = ipow(ge_i * ge_t, 2)
    p_d = p.p_direct * pair2
    ge_p_slow = p.slow_factor + (1.0 - p.slow_factor) * pi_i
    e_gp4 = (1.0 - sbar) + sbar * ipow(ge_p_slow, 4)
    p_relay1 = live_frac * p.p_relay * pair2 * e_gp4
    p_no_relay = ipow(1.0 - p_relay1, p.indirect_checks)
    p_tcp = p.p_tcp * ge_i * ge_t
    return (1.0 - p_d) * p_no_relay * (1.0 - p_tcp)


def _col_flags(st: ViewState, eye: torch.Tensor) -> tuple:
    """[n] bool per subject: does ANY live viewer hold SUSPECT / DEAD
    about it."""
    live_v = st.up[:, None] & ~eye
    return ((live_v & (st.status == SUSPECT)).any(0),
            (live_v & (st.status == DEAD)).any(0))


def _merge(st: ViewState, inc_key: torch.Tensor, confirm_src: torch.Tensor,
           p: SimParams, lh_rows=None) -> ViewState:
    """Merge incoming belief keys into every receiver's view.

    ``inc_key`` [r, n]: the best key about subject j that reached
    receiver i this step (-1 where nothing arrived); ``confirm_src``: the
    arrival came from another node (a suspicion arriving again counts as
    an independent confirmation); ``lh_rows``: the receivers' local
    health, which stretches a new suspicion timer by (LH + 1)."""
    own_key = _key(st.status, st.inc)
    new_key = torch.maximum(own_key, inc_key)
    changed = new_key > own_key
    status, inc = _unkey(new_key)
    min_r, max_r = _timeout_rounds(p)
    k = p.confirmation_k
    if p.lifeguard and lh_rows is not None:
        lh_scale = (lh_rows.to(_F32) + 1.0)[:, None]
    else:
        lh_scale = torch.ones((), dtype=_F32, device=own_key.device)
    min_rs = min_r * lh_scale
    max_rs = max_r * lh_scale

    became_suspect = changed & (status == SUSPECT)
    confirmed = (~changed) & confirm_src & (inc_key == own_key) & \
        (st.status == SUSPECT)
    conf = torch.where(became_suspect, 0, torch.minimum(
        st.susp_conf + confirmed.to(_I8),
        torch.full((), k, dtype=_I8, device=own_key.device)))
    start = torch.where(became_suspect, st.round, st.susp_start)
    frac = torch.log1p(conf.to(_F32)) / torch.log1p(
        torch.full((), float(k), dtype=_F32, device=own_key.device))
    shrunk = (start.to(_F32) + max_rs - frac * (max_rs - min_rs)).to(_I32)
    floor = (start.to(_F32) + min_rs).to(_I32)
    if p.lifeguard:
        deadline = torch.where(status == SUSPECT, torch.where(
            became_suspect | confirmed, torch.maximum(shrunk, floor),
            st.susp_deadline), NO_DEADLINE)
    else:  # fixed timer, no confirmation shrink
        deadline = torch.where(status == SUSPECT, torch.where(
            became_suspect, st.round + min_r, st.susp_deadline),
            NO_DEADLINE)
    # changed entries are re-broadcast (memberlist re-queues updates)
    budget = torch.where(changed, p.retransmit_limit, st.budget)
    return st._replace(status=status, inc=inc, susp_conf=conf,
                       susp_start=start, susp_deadline=deadline,
                       budget=budget)


def _segment_max(src: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Row r of the result: the elementwise max of the rows ``src[i]``
    with ``idx[i] == r``, -1 where none is (keys are >= -1)."""
    out = torch.full((n,) + tuple(src.shape[1:]), -1, dtype=src.dtype,
                     device=src.device)
    return out.scatter_reduce_(0, idx[:, None].expand_as(src), src, "amax")


def _clip_lh(lh: torch.Tensor, delta: torch.Tensor, p: SimParams):
    return torch.clamp(lh.to(_I32) + delta, 0, p.awareness_max).to(_I8)


def _pp_every(p: SimParams) -> int:
    """Push/pull period in rounds (~30 s, as memberlist's)."""
    return max(1, int(30.0 / p.probe_interval))


def _expire_and_refute(st: ViewState, up_rows: torch.Tensor,
                       rows: torch.Tensor, cols: torch.Tensor,
                       p: SimParams):
    """Suspicion expiry (SUSPECT past its deadline -> DEAD, on live
    viewers), then refutation: a live node that sees itself suspected
    or dead bumps its incarnation and views itself ALIVE. ``rows`` /
    ``cols`` index each viewer's own entry. Returns (state, expired,
    refute, the viewers' new incarnations)."""
    limit = p.retransmit_limit
    expired = (st.status == SUSPECT) & (st.round >= st.susp_deadline) \
        & up_rows[:, None]
    status = torch.where(expired, DEAD, st.status).to(_I8)
    budget = torch.where(expired, limit, st.budget).to(_I8)
    deadline = torch.where(expired, NO_DEADLINE, st.susp_deadline)
    self_view = status[rows, cols]
    self_known_inc = st.inc[rows, cols]
    refute = up_rows & (self_view != ALIVE)
    new_inc = torch.where(refute, self_known_inc + 1, st.self_inc[cols])
    status[rows, cols] = torch.where(up_rows, ALIVE, self_view).to(_I8)
    inc = st.inc.clone()
    inc[rows, cols] = torch.where(up_rows, new_inc, self_known_inc)
    budget[rows, cols] = torch.where(refute, limit, budget[rows, cols]).to(_I8)
    st = st._replace(status=status, inc=inc, budget=budget,
                     susp_deadline=deadline)
    if p.lifeguard:  # refuting own suspicion is a health ding (+1)
        st = st._replace(lh=_clip_lh(st.lh, refute.to(_I32), p))
    return st, expired, refute, new_inc


def _isum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=_I32)


def views_round(st: ViewState, key: torch.Tensor, p: SimParams) -> ViewState:
    """One SWIM protocol period over the dense per-viewer state."""
    n = p.n
    dev = st.status.device
    rnd = int(st.round)
    ar = torch.arange(n, device=dev)
    eye = ar[:, None] == ar[None, :]
    # each consumer of split(key, 6) derives its key in its own launch
    k_crash, k_slow, k_pick, k_ack, k_gossip, k_pp = prng.subkeys(key, 6)
    if p.collect_stats:
        pre_susp, pre_dead = _col_flags(st, eye)
        pre_status = st.status

    # -- churn: crash injection, degraded-node churn ----------------------
    if p.fail_per_round > 0.0:
        crash = st.up & (prng.uniform(k_crash, n) < p.fail_per_round)
        st = st._replace(up=st.up & ~crash, down_round=torch.where(
            crash, st.round, st.down_round))
    if p.slow_per_round > 0.0:
        u_s = prng.uniform(k_slow, n)
        st = st._replace(slow=torch.where(
            st.slow, u_s >= p.slow_recover_per_round,
            u_s < p.slow_per_round) & st.up)

    # -- probe: every up node probes one alive-view member ----------------
    view_alive = (st.status == ALIVE) & ~eye
    has_target = view_alive.any(1)
    target = _pick(k_pick, view_alive)
    g = torch.where(st.slow, p.slow_factor, 1.0).to(_F32)
    live_frac = st.up.to(_F32).mean()
    sbar = _isum(st.slow & st.up).to(_F32) / \
        torch.clamp_min(_isum(st.up), 1).to(_F32)
    if p.lifeguard and p.slow_per_round:
        pi = 1.0 - torch.exp2(-st.lh.to(_F32))
    else:
        pi = torch.zeros((n,), dtype=_F32, device=dev)
    p_noack = _p_noack_pair(g, g[target], pi, sbar, live_frac, p)
    acked = st.up[target] & st.reach[ar, target] & \
        (prng.uniform(k_ack, n) > p_noack)
    suspect_it = st.up & has_target & ~acked
    if p.lifeguard:  # awareness: ack -1, missed ack +1
        delta = torch.where(st.up & has_target,
                            torch.where(acked, -1, 1), 0)
        st = st._replace(lh=_clip_lh(st.lh, delta, p))
    sus_key = torch.full((n, n), -1, dtype=_I32, device=dev)
    sus_key[ar, target] = torch.where(suspect_it,
                                      st.inc[ar, target] * 4 + 1, -1)
    st = _merge(st, sus_key, torch.zeros_like(eye), p, st.lh)

    # -- gossip: fanout piggyback transmissions ---------------------------
    fanout = int(p.gossip_nodes)
    pick_keys, u_loss, u_recv = _gossip_draws(k_gossip, p, n)
    for tick in range(u_loss.shape[0]):
        gmask = (st.status != DEAD) & ~eye
        sendable = st.up & gmask.any(1)
        full_key = _key(st.status, st.inc)
        recvs = _pick(pick_keys[tick], gmask)
        sents = []
        for k, recv in enumerate(recvs):
            # the k-th send needs more than k credits left
            hot = st.budget > k
            g_recv = torch.where(st.slow[recv], p.slow_factor, 1.0)
            delivered = sendable & st.up[recv] & st.reach[ar, recv] & \
                (u_loss[tick, k] > p.loss) & (u_recv[tick, k] < g_recv)
            sents.append(torch.where(hot & delivered[:, None], full_key, -1))
        inc_key = _segment_max(torch.cat(sents), recvs.reshape(-1), n)
        del sents, full_key
        # the budget is charged on send, delivered or not
        st = st._replace(budget=torch.where(
            sendable[:, None], torch.clamp_min(st.budget - fanout, 0),
            st.budget))
        st = _merge(st, inc_key, inc_key >= 0, p, st.lh)
        del inc_key

    # -- push/pull anti-entropy, then serf's reconnector ------------------
    pp = _pp_every(p)
    if rnd % pp == pp - 1:
        k_alive, k_dead = prng.split(k_pp, 2)

        def sync(st, partner, ok):
            full_key = _key(st.status, st.inc)
            pulled = torch.where(ok[:, None], full_key[partner], -1)
            pushed = _segment_max(torch.where(ok[:, None], full_key, -1),
                                  partner, n)
            return _merge(st, torch.maximum(pulled, pushed),
                          torch.zeros_like(eye), p, st.lh)

        partner = _pick(k_alive, (st.status != DEAD) & ~eye)
        ok = st.up & st.up[partner] & st.reach[ar, partner]
        st = sync(st, partner, ok)
        dead_view = (st.status == DEAD) & ~eye
        partner2 = _pick(k_dead, dead_view)
        ok2 = st.up & dead_view.any(1) & st.up[partner2] & \
            st.reach[ar, partner2]
        st = sync(st, partner2, ok2)

    # -- suspicion expiry and refutation ----------------------------------
    st, expired, refute, new_inc = _expire_and_refute(st, st.up, ar, ar, p)
    st = st._replace(self_inc=new_inc)

    # -- cumulative detector statistics -----------------------------------
    if p.collect_stats:
        post_susp, post_dead = _col_flags(st, eye)
        st = _add_stats(st, pre_susp, pre_dead, post_susp, post_dead,
                        _isum(refute),
                        _isum((st.status == SUSPECT)
                              & (pre_status != SUSPECT) & st.up[:, None]),
                        _isum(expired & st.up[None, :]))
    return st._replace(round=st.round + 1)


def _add_stats(st: ViewState, pre_susp, pre_dead, post_susp, post_dead,
               refutes, pair_susp, pair_fp) -> ViewState:
    """Fold one round's incidents into the cumulative ViewStats."""
    new_dead = post_dead & ~pre_dead
    tp_new = new_dead & ~st.up
    s = st.stats
    return st._replace(stats=ViewStats(
        susp_incidents=s.susp_incidents + _isum(post_susp & ~pre_susp),
        fp_incidents=s.fp_incidents + _isum(new_dead & st.up),
        deaths_declared=s.deaths_declared + _isum(tp_new),
        detect_latency_rounds=s.detect_latency_rounds + _isum(torch.where(
            tp_new, st.round + 1 - st.down_round, 0)),
        refutes=s.refutes + refutes,
        pair_susp_starts=s.pair_susp_starts + pair_susp,
        pair_fp_declares=s.pair_fp_declares + pair_fp))


def run_views(st: ViewState, key: torch.Tensor, p: SimParams,
              rounds: int) -> ViewState:
    """``rounds`` × ``views_round`` on the keys ``split(key, rounds)``."""
    for k in prng.split(key.to(st.status.device), rounds):
        st = views_round(st, k, p)
    return st


# ------------------------------------------------------------- metrics


def view_metrics(st: ViewState) -> dict:
    """Aggregate view-divergence and detector statistics (host values;
    the rates are f32 quotients, as the reference's)."""
    n = st.status.shape[0]
    ar = torch.arange(n, device=st.status.device)
    up_i = st.up[:, None] & (ar[:, None] != ar[None, :])
    live_pair = up_i & st.up[None, :]
    dead_pair = up_i & ~st.up[None, :]
    live_total = torch.clamp_min(_isum(live_pair), 1).to(_F32)
    dead_total = torch.clamp_min(_isum(dead_pair), 1).to(_F32)
    fp = _isum(live_pair & (st.status == DEAD))
    detected = _isum(dead_pair & (st.status == DEAD))
    wrong = (live_pair & (st.status != ALIVE)) | \
        (dead_pair & (st.status != DEAD))
    return {
        "round": int(st.round),
        "up": int(_isum(st.up)),
        "false_positive_pairs": int(fp),
        "fp_rate": float(fp.to(_F32) / live_total),
        "suspect_pairs": int(_isum(live_pair & (st.status == SUSPECT))),
        "detected_frac": float(detected.to(_F32) / dead_total),
        "view_divergence": float(_isum(wrong).to(_F32) / torch.clamp_min(
            _isum(up_i), 1).to(_F32)),
        "max_incarnation": int(st.self_inc.max()),
    }


def view_rates(st: ViewState, p: SimParams, rounds: int) -> dict:
    """Cumulative counters as per-node-round rates and latency, in the
    units of the mean-field tier's ``fd_report``."""
    s = ViewStats(*[int(x) for x in st.stats])
    nr = p.n * rounds
    return {
        "susp_rate": s.susp_incidents / nr,
        "fp_rate": s.fp_incidents / nr,
        "deaths_declared": s.deaths_declared,
        "mean_detect_latency_s": s.detect_latency_rounds
        / max(s.deaths_declared, 1) * p.probe_interval,
        "refute_rate": s.refutes / nr,
        "pair_susp_rate": s.pair_susp_starts / nr,
        "pair_fp_rate": s.pair_fp_declares / nr,
    }


def partition_reach(n: int, split: int, device: DeviceLike = None
                    ) -> torch.Tensor:
    """The reach matrix of a clean partition: [0, split) ⇹ [split, n)."""
    left = torch.arange(n, device=default_device(device)) < split
    return left[:, None] == left[None, :]


# --------------------------------------------------- sharded views tier


def make_views_mesh(device: DeviceLike = None) -> Mesh:
    """The 1-D viewer mesh over the initialized default group: the
    viewer axis of the ``[n, n]`` views is split across the ranks."""
    return make_mesh(dc=1, device=device)


def make_sharded_views_round(p: SimParams, mesh: Mesh,
                             exchange: str = "all_to_all"):
    """The dense round over the viewer-sharded mesh: returns
    ``(round_fn, init_fn)``; ``round_fn(state, key)`` takes and returns
    this rank's state (views rows ``[n/d, n]``, ground truth ``[n]``
    replicated), ``init_fn()`` builds it.

    Probe and suspicion timers are row-local. A gossip tick's
    deliveries are this rank's partial max of its senders'
    transmissions to all receivers, exchanged by one grouped
    ``all_to_all`` (a max-reduce-scatter: each rank receives only its
    receiver rows; ``(d-1)/d · n² · 4`` bytes per tick) or, with
    ``exchange="pmax"``, an all-reduce MAX and a slice. Push/pull
    gathers the merge keys (``all_gather``) and combines the pushed
    beliefs by the same exchange. The self-incarnation deltas and the
    stats' sums are all-reduce SUMs."""
    if exchange not in ("all_to_all", "pmax"):
        raise ValueError(f"unknown exchange {exchange!r}")
    n, d = p.n, mesh.world
    if n % d:
        raise ValueError(f"n={n} not divisible by {d} ranks")
    nl = n // d
    shard = mesh.rank
    coll, group, dev = mesh.coll, mesh.group, mesh.device
    lidx = torch.arange(nl, device=dev)
    gidx = shard * nl + lidx
    cols = torch.arange(n, device=dev)
    local_eye = gidx[:, None] == cols[None, :]

    def max_scatter(partial: torch.Tensor) -> torch.Tensor:
        """[n, n] partials -> [nl, n]: the max over ranks of MY rows."""
        if exchange == "pmax":
            return coll.all_reduce_max(partial, group)[shard * nl:
                                                       (shard + 1) * nl]
        return coll.all_to_all(partial, group).view(d, nl, n).amax(0)

    def col_flags(st: ViewState) -> tuple:
        live_v = st.up[gidx][:, None] & ~local_eye
        both = torch.stack([(live_v & (st.status == SUSPECT)).sum(0, dtype=_I32),
                            (live_v & (st.status == DEAD)).sum(0, dtype=_I32)])
        both = coll.all_reduce_sum(both, group)
        return both[0] > 0, both[1] > 0

    def round_fn(st: ViewState, key: torch.Tensor) -> ViewState:
        rnd = int(st.round)
        # crash/slow draws use the unfolded keys: the ground truth is
        # replicated, so every rank draws the same churn
        k_crash, k_slow, key = prng.split(key.to(dev), 3)
        k_pick, k_ack, k_gossip, k_pp = prng.subkeys(
            prng.fold_in(key, shard), 4)
        if p.collect_stats:
            pre_susp, pre_dead = col_flags(st)
            pre_status = st.status
        if p.fail_per_round > 0.0:
            crash = st.up & (prng.uniform(k_crash, n) < p.fail_per_round)
            st = st._replace(up=st.up & ~crash, down_round=torch.where(
                crash, st.round, st.down_round))
        if p.slow_per_round > 0.0:
            u_s = prng.uniform(k_slow, n)
            st = st._replace(slow=torch.where(
                st.slow, u_s >= p.slow_recover_per_round,
                u_s < p.slow_per_round) & st.up)
        up_l = st.up[gidx]

        # -- probe (viewer-local) -----------------------------------------
        view_alive = (st.status == ALIVE) & ~local_eye
        has_target = view_alive.any(1)
        target = _pick(k_pick, view_alive)
        g = torch.where(st.slow, p.slow_factor, 1.0).to(_F32)
        live_frac = st.up.to(_F32).mean()
        sbar = _isum(st.slow & st.up).to(_F32) / \
            torch.clamp_min(_isum(st.up), 1).to(_F32)
        if p.lifeguard and p.slow_per_round:
            pi = 1.0 - torch.exp2(-st.lh.to(_F32))
        else:
            pi = torch.zeros((nl,), dtype=_F32, device=dev)
        p_noack = _p_noack_pair(g[gidx], g[target], pi, sbar, live_frac, p)
        acked = st.up[target] & st.reach[lidx, target] & \
            (prng.uniform(k_ack, nl) > p_noack)
        suspect_it = up_l & has_target & ~acked
        if p.lifeguard:
            delta = torch.where(up_l & has_target,
                                torch.where(acked, -1, 1), 0)
            st = st._replace(lh=_clip_lh(st.lh, delta, p))
        sus_key = torch.full((nl, n), -1, dtype=_I32, device=dev)
        sus_key[lidx, target] = torch.where(
            suspect_it, st.inc[lidx, target] * 4 + 1, -1)
        st = _merge(st, sus_key, torch.zeros_like(local_eye), p, st.lh)

        # -- gossip: partial max, then the exchange -----------------------
        fanout = int(p.gossip_nodes)
        pick_keys, u_loss, u_recv = _gossip_draws(k_gossip, p, nl)
        for tick in range(u_loss.shape[0]):
            gmask = (st.status != DEAD) & ~local_eye
            sendable = up_l & gmask.any(1)
            full_key = _key(st.status, st.inc)
            recvs = _pick(pick_keys[tick], gmask)  # global receiver ids
            sents = []
            for k, recv in enumerate(recvs):
                hot = st.budget > k
                g_recv = torch.where(st.slow[recv], p.slow_factor, 1.0)
                delivered = sendable & st.up[recv] & \
                    st.reach[lidx, recv] & \
                    (u_loss[tick, k] > p.loss) & (u_recv[tick, k] < g_recv)
                sents.append(torch.where(hot & delivered[:, None],
                                         full_key, -1))
            partial = _segment_max(torch.cat(sents), recvs.reshape(-1), n)
            del sents, full_key
            inc_key = max_scatter(partial)
            del partial
            st = st._replace(budget=torch.where(
                sendable[:, None], torch.clamp_min(st.budget - fanout, 0),
                st.budget))
            st = _merge(st, inc_key, inc_key >= 0, p, st.lh)
            del inc_key

        # -- push/pull + reconnect ----------------------------------------
        pp = _pp_every(p)
        if rnd % pp == pp - 1:
            k_alive, k_dead = prng.split(k_pp, 2)

            def sync(st, partner, ok):
                full_key_l = _key(st.status, st.inc)
                full_key = coll.all_gather(full_key_l, group).view(n, n)
                pulled = torch.where(ok[:, None], full_key[partner], -1)
                del full_key
                pushed = max_scatter(_segment_max(
                    torch.where(ok[:, None], full_key_l, -1), partner, n))
                return _merge(st, torch.maximum(pulled, pushed),
                              torch.zeros_like(local_eye), p, st.lh)

            partner = _pick(k_alive, (st.status != DEAD) & ~local_eye)
            ok = up_l & st.up[partner] & st.reach[lidx, partner]
            st = sync(st, partner, ok)
            dead_view = (st.status == DEAD) & ~local_eye
            partner2 = _pick(k_dead, dead_view)
            ok2 = up_l & dead_view.any(1) & st.up[partner2] & \
                st.reach[lidx, partner2]
            st = sync(st, partner2, ok2)

        # -- expiry and refutation (own diagonal entry lives here) --------
        st, expired, refute, new_inc_l = _expire_and_refute(
            st, up_l, lidx, gidx, p)
        # replicated self_inc: every rank adds its viewers' deltas
        delta = torch.zeros((n,), dtype=_I32, device=dev)
        delta[gidx] = new_inc_l - st.self_inc[gidx]
        st = st._replace(self_inc=st.self_inc
                         + coll.all_reduce_sum(delta, group))

        if p.collect_stats:
            post_susp, post_dead = col_flags(st)
            local3 = torch.stack([
                _isum(refute),
                _isum((st.status == SUSPECT) & (pre_status != SUSPECT)
                      & up_l[:, None]),
                _isum(expired & st.up[None, :])])
            ref_n, pss_n, pfd_n = coll.all_reduce_sum(local3, group)
            st = _add_stats(st, pre_susp, pre_dead, post_susp, post_dead,
                            ref_n, pss_n, pfd_n)
        return st._replace(round=st.round + 1)

    def init_fn() -> ViewState:
        return _init_rows(n, nl, dev)

    return round_fn, init_fn
