"""One SWIM protocol period as plain PyTorch tensor code.

The port of the JAX package's ``consul_tpu/sim/round.py`` main path: the
batch-synchronous, Poissonized protocol period over every node at once
(the module docstring there derives the mean-field model). One body,
``_round_body``, serves every engine here and the round kernels' plain
versions in ``cuda_round.py``, so they cannot drift:

* ``round_core(state, scalars, p, u01)`` — live mode (``scalars=None``:
  population scalars from this round's post-churn arrays) or stale mode
  (last round's scalars in, next round's out of the same pass);
* ``gossip_round`` / ``gossip_round_fast`` — one period on threefry
  draws keyed exactly as the JAX engines key theirs;
* ``run_rounds`` / ``make_run_rounds_fast`` / ``make_run_rounds`` /
  ``run_rounds_stats`` — the multi-round loops;
* ``run_rounds_flight`` / ``run_rounds_coords`` — the live engine with
  the flight recorder, the black box and Vivaldi coordinates riding it;
* ``make_run_rounds_lanes`` — the exact lane engine: the body in lane
  mode on global-index draws, one fixed-order reduction per staleness-k
  window (``sim/lanes.py``), bit for bit resumable from its carry. On
  the card its round is one launch of the lane kernel
  (``sim/lane_kernel.py``), whose plain version is this body.

On the card an honest live period of one run (no fault frame, no
coordinates, no probe events, no grid) is three launches of the live
stages around its population sums (``sim/live_kernel.py``), whose plain
version is this body too.

The live engine and the lane engine also run a grid of constants
(``sim/sweep.py``): ``[G, N]`` lanes and a ``params.TracedParams`` whose
swept leaves are ``[G, 1]``.

Each takes an optional fault view (``fx=``, a ``faults.FaultFrame``) or
plan (``plan=``, a ``faults.CompiledFaultPlan``), as its JAX twin does:
the frame's per-node delivery multipliers, forced-slow mask and churn
rates shape the round, and a byzantine frame adds forged acks, spurious
suspicions and stale replays.

With a ``coords``/``topo`` pair (``sim/coords.py``, ``sim/topology.py``)
a round also draws explicit probe targets and their observed RTTs from
``fold_in(key, prng.COORD_FOLD)`` (off the round's own five keys, so a
run without coordinates draws exactly what it did before), relaxes the
acked probers' coordinates and, with ``SimParams.coords_timeout``, makes
each ack race an RTT-aware deadline; on the card the probes, the
relaxation and the quality row are one launch each
(``coords.probe`` / ``relax`` / ``coord_metrics``, ``sim/coord_kernel.py``).
``events=True`` surfaces the
round's probe lifecycle (``blackbox.ProbeEvents``) for the black box.

Per-node randomness comes from a caller-supplied source ``u01(slot)``
(six slots: churn, slow, ack, pois, hear, and replay on byzantine
rounds only — ``prng.threefry_u01``, ``prng.philox_u01``, or injected
arrays in the tests). That seam is what holds the port bit for bit
against the reference when both draw the same uniforms.

Arithmetic follows the reference op for op in f32 (constants fold on the
host in f64 and are cast once, integer powers are repeated products in
the same order), so the int lanes agree exactly and the f32 lanes within
a few ulp of the platform's ``exp``/``log``.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Iterator, NamedTuple, Optional

import torch

from consul_tpu_torch.faults import (CompiledFaultPlan, FaultFrame,
                                     detection_gate, frame_at,
                                     frames_at, ipow,
                                     phase_at, scale_frame)
from consul_tpu_torch.sim import (blackbox, coord_kernel, flight, fused,
                                  graphs, lane_kernel, live_kernel, prng,
                                  topology)
from consul_tpu_torch.sim import lanes as lanes_mod
from consul_tpu_torch.sim import coords as coords_mod
from consul_tpu_torch.sim.params import SimParams, TracedParams
from consul_tpu_torch.sim.state import (ALIVE, ALIVE_AGE, CONF_MAX, DEAD,
                                        LEFT, SLOW_AGE, STATS_FIELDS,
                                        SUSPECT, TICK_MAX, TTL_NEVER,
                                        SimState, SimStats)
from consul_tpu_torch.utils import telemetry

#: scalar vector layout for the stale-scalar fast path
#: [n_live, n_elig, n_up_elig, n_slow_up_elig,
#:  sum(up*pf_fast), sum(up*pf_slow), lfail_num, lfail_den]
N_SCALARS = 8
N_STATS = len(STATS_FIELDS)
#: per-node contribution lanes: the 8 scalar lanes, then the counters
N_LANES = N_SCALARS + N_STATS
LAT = STATS_FIELDS.index("detect_latency_sum")

#: draw slots, in the reference's draw order; U_REPLAY only on
#: byzantine rounds
U_CHURN, U_SLOW, U_ACK, U_POIS, U_HEAR, U_REPLAY = range(6)
N_DRAWS = 6


def draw_slots(p, fx: Optional[FaultFrame] = None) -> tuple:
    """The slots ``_round_body`` reads under ``p`` and ``fx``, known
    before it runs: churn with a churn model or a fault frame, slow with
    the slow model (a grid that sweeps either takes the union: every
    point runs one body), ack, Poisson and hear always, the replay draw
    on a byzantine frame. A round's threefry draws are these slots'
    rows, one launch (``prng.threefry_u01``, ``prng.global_u01``)."""
    slots = []
    if p.has_churn or fx is not None:
        slots.append(U_CHURN)
    if p.enabled("slow_per_round"):
        slots.append(U_SLOW)
    slots += [U_ACK, U_POIS, U_HEAR]
    if fx is not None and fx.attacked is not None:
        slots.append(U_REPLAY)
    return tuple(slots)


#: floors applied to a reduced scalar vector (n_elig >= 1,
#: n_up_elig >= 1e-9, lfail_den >= 1e-9); the other lanes are unclamped
SCALAR_FLOORS = (float("-inf"), 1.0, 1e-9, float("-inf"), float("-inf"),
                 float("-inf"), float("-inf"), 1e-9)

_F32 = torch.float32
_I32 = torch.int32


def _shrink(c: torch.Tensor, p: SimParams) -> torch.Tensor:
    """Normalized Lifeguard timeout shrink factor for c confirmations.
    With swept suspicion constants the degenerate max <= min case folds
    into the formula (shrink_r >= 1 makes it return ones), so no Python
    comparison touches a leaf."""
    if not p.lifeguard:
        return torch.ones_like(c, dtype=_F32)
    if not p.sweeps("suspicion_mult", "suspicion_max_timeout_mult",
                    "probe_interval") \
            and p.suspicion_max_s <= p.suspicion_min_s:
        return torch.ones_like(c, dtype=_F32)
    ck = p.confirmation_k
    if isinstance(ck, torch.Tensor):
        den = torch.log(ck.to(_F32) + 1.0)
    else:
        # a fill, not a copy from host memory (which syncs the host
        # and cannot be captured in a CUDA graph)
        den = torch.log(torch.full((), float(ck), dtype=_F32,
                                   device=c.device) + 1.0)
    frac = torch.log(c.to(_F32) + 1.0) / den
    x = 1.0 - p.shrink_omr * frac
    if isinstance(p.shrink_r, torch.Tensor):
        return torch.maximum(x, p.shrink_r)
    return torch.clamp_min(x, p.shrink_r)


def _clamp_lh(x: torch.Tensor, p: SimParams) -> torch.Tensor:
    """Local health clipped to [0, awareness_max] (a swept ceiling is an
    int32 leaf)."""
    if isinstance(p.awareness_max, torch.Tensor):
        return torch.minimum(torch.clamp_min(x, 0), p.awareness_max)
    return torch.clamp(x, 0, p.awareness_max)


def _sums(reduce, *xs: torch.Tensor) -> list:
    """Population sums: ``torch.sum`` of each (0-d results) without a
    reducer, else ``reduce(*xs)`` (the grid engine's per-row sums)."""
    if reduce is None:
        return [torch.sum(x) for x in xs]
    return reduce(*xs)


def _per_point(v, like: torch.Tensor):
    """A swept ``[G, 1]`` leaf shaped as the grid's per-point scalars
    (``like``: ``[G]``); a float as it is."""
    return v.reshape(like.shape) if isinstance(v, torch.Tensor) else v


def _trunc_poisson(u: torch.Tensor, lam: torch.Tensor, kmax: int = 4,
                   cdf: Optional[list] = None) -> torch.Tensor:
    """Poisson sample via inverse CDF truncated at kmax (elementwise).
    ``cdf`` (a list) collects the compared CDF terms."""
    nf = torch.zeros_like(lam, dtype=_I32)
    term = torch.exp(-lam)
    c = term
    for k in range(1, kmax + 1):
        if cdf is not None:
            cdf.append(c)
        nf = nf + (u > c).to(_I32)
        term = term * lam / k
        c = c + term
    return nf


def pf_arrays(slow: torch.Tensor, lh: torch.Tensor, sbar, live_frac,
              p: SimParams, fx: Optional[FaultFrame] = None):
    """Per-prober miss probabilities for fast/slow targets given the
    population scalars: (g, pf_fast, pf_slow). With a frame, direct
    probes and the TCP fallback scale by the prober's round trip
    (psend·precv), relay legs by that times the plan's mean link
    quality ``mid``."""
    g = torch.where(slow, p.slow_factor, 1.0).to(_F32)
    if p.lifeguard and (p.enabled("slow_per_round") or fx is not None):
        patience = 1.0 - torch.exp2(-lh.to(_F32))
    else:
        patience = torch.zeros_like(g)
    if fx is not None:
        rt = fx.psend * fx.precv
        relay_m = rt * fx.mid

    def noack_given(gj_val):
        # a 0-d CPU tensor enters a CUDA op as a scalar: no host-to-device
        # copy, which would make the host wait
        gj = gj_val.to(_F32) if isinstance(gj_val, torch.Tensor) \
            else torch.tensor(gj_val, dtype=_F32)
        ge_i = g + (1.0 - g) * patience
        ge_j = gj + (1.0 - gj) * patience
        pair2 = ipow(ge_i * ge_j, 2)
        p_d = p.p_direct * pair2
        ge_p_slow = p.slow_factor + (1.0 - p.slow_factor) * patience
        e_gp4 = (1.0 - sbar) * 1.0 + sbar * ipow(ge_p_slow, 4)
        p_relay1 = live_frac * p.p_relay * pair2 * e_gp4
        p_tcp = p.p_tcp * ge_i * ge_j
        if fx is not None:
            p_d = p_d * rt
            p_relay1 = p_relay1 * relay_m
            p_tcp = p_tcp * rt
        p_no_relay = ipow(1.0 - p_relay1, p.indirect_checks)
        return (1.0 - p_d) * p_no_relay * (1.0 - p_tcp)

    return g, noack_given(1.0), noack_given(p.slow_factor)


def _ulps(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|x - ref| in units of ref's f32 spacing (approximately)."""
    spacing = torch.clamp_min(ref.abs() * 2.0 ** -23, 2.0 ** -149)
    return (x - ref).abs() / spacing


def _round_body(vals, scal, p: SimParams, u01: prng.U01,
                margin: Optional[list] = None,
                fx: Optional[FaultFrame] = None,
                kernel_sums: bool = False, co=None,
                sink: Optional[dict] = None, reduce=None,
                lane_mode: bool = False):
    """ONE protocol period over per-node tensors — the single copy of
    the protocol body.

    ``vals``: the 8 per-node tensors in ``state.NODE_FIELDS`` order, any
    integer width (widened to int32 here). ``scal``: None (live mode) or
    the stale scalar vector. Returns ``(outs, lanes)``: the 8 updated
    lanes widened (int32, f32 informed) and the ``N_LANES`` per-node
    contribution tensors (None where identically zero) — the 8 scalar
    lanes on the post-round state, then the ``STATS_FIELDS`` counters.

    ``margin`` (a list) receives, per node, the smallest distance in ulps
    between a uniform and the computed threshold it was compared with,
    or between a ceil argument and the nearest integer: the decisions a
    last-bit difference in exp/log could flip.

    ``fx`` is this round's fault view, consumed as given (callers apply
    ``scale_frame``). The XLA engines count forced-slow nodes in the
    n_slow scalar lane; the TPU kernel counts the stochastic slow mask
    only (pallas_round.py:389) — ``kernel_sums=True`` selects the
    kernel's rule for the round kernels' plain versions.

    ``co`` is ``(coords, topo, key)``: the coordinate state, the
    topology and the round's threefry key (module docstring). ``sink``
    (a dict) receives the round's ``"events"`` (``ProbeEvents``) and,
    with ``co``, the relaxed ``"coords"`` and the ``"aux"``
    (``coords.CoordRoundAux``).

    A grid (``p`` a ``params.TracedParams``) runs ``[G, N]`` lanes with
    ``[G, 1]`` leaves and stale scalars ``[8, G, 1]``; live-mode
    population sums then go through ``reduce(*xs)`` (per-row sums kept
    ``[G, 1]``, ``lanes.row_sums``) instead of ``torch.sum``.

    ``lane_mode`` (the lane engine) writes the counter lanes whatever
    ``collect_stats``, and appends the flight gauges' numerators and the
    local-health exceedance histogram: the ``registry.REDUCE_LANES``
    rows."""
    (status_in, inc_in, informed, age_in, slen_in, sttl_in, conf_in,
     lh_in) = vals
    n = p.n
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
    byz = fx is not None and fx.attacked is not None

    # dead nodes age one tick per round (saturating)
    age = torch.where(age >= 0, torch.clamp_max(age + 1, TICK_MAX), age)

    # ------------------------------------------------------------- churn
    if p.has_churn or fx is not None:
        u = u01(U_CHURN)
        fail_p, leave_p = p.fail_per_round, p.leave_per_round
        rejoin_p = p.rejoin_per_round
        if fx is not None:
            # plan churn bursts and flap schedules add to the rates
            fail_p = fail_p + fx.crash_p
            leave_p = leave_p + fx.leave_p
            rejoin_p = rejoin_p + fx.rejoin_p
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
        new_rumor = new_rumor | started

    # ------------------------------------------------ degraded-node churn
    if p.enabled("slow_per_round"):
        u_s = u01(U_SLOW)
        slow = torch.where(slow, u_s >= p.slow_recover_per_round,
                           u_s < p.slow_per_round) & up
    # forced slow (the GC-pause primitive) shapes this round only; the
    # stored slow state stays stochastic
    slow_eff = (slow | fx.slow_f) & up if fx is not None else slow

    # ---------------------------------------------- mean-field population
    upf = up.to(_F32)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(_F32)
    if scal is None:
        n_live, s_elig, s_up_elig, s_slow = _sums(
            reduce, upf, eligf, upf * eligf,
            (slow_eff & up & elig).to(_F32))
        n_elig = torch.clamp_min(s_elig, 1.0)
        n_up_elig = torch.clamp_min(s_up_elig, 1e-9)
        sbar = s_slow / n_up_elig
    else:
        n_live, n_elig, n_up_elig = scal[0], scal[1], scal[2]
        sbar = scal[3] / n_up_elig
    frac_up_elig = n_up_elig / n_elig

    g, pf_fast, pf_slow = pf_arrays(slow_eff, lh, sbar, n_live / n, p, fx)

    # --------------------------------------------- Vivaldi probe pairs
    timely = late_in = pair_j = rtt_obs = None
    if co is not None:
        coords, topo, key = co
        with telemetry.span("sim.coords.step", device=True):
            k_pair, k_jit, k_dir, k_q = prng.split(
                prng.SubKey(key, prng.COORD_FOLD), 4)
            rows = status.shape[-1]
            pair_j = topology.sample_pairs(rows, k_pair)
            if p.coords_timeout:
                # the ack must beat max(timeout, min(mult·estimate,
                # interval))·(LH+1); the target side folds the chance
                # that a random prober's deadline loses to this node's
                # jittered RTT into its miss rate (1 - Phi(ln(d/rtt)/
                # sigma))
                rtt_obs, timely, late_in = coords_mod.probe(
                    coords, topo, pair_j, k_jit,
                    q_in=topology.sample_pairs(rows, k_q), lh=lh,
                    deadline=(p.coord_timeout_mult, p.probe_interval,
                              p.probe_timeout))
            else:
                rtt_obs, _, _ = coords_mod.probe(coords, topo, pair_j,
                                                 k_jit)

    # ------------------------------------------------- prober-side probe
    mix_i = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = frac_up_elig * (1.0 - mix_i)
    u_ack = u01(U_ACK)
    ack = up & (u_ack < p_ack)
    late = None
    if timely is not None:
        # a late ack is a missed deadline: the prober escalates
        late = ack & ~timely
        ack = ack & timely
    failed = up & ~ack
    if co is not None:
        with telemetry.span("sim.coords.step", device=True):
            # coordinates relax where the probe round trip completed
            c2, relaxed, drift = coords_mod.relax(coords, pair_j, rtt_obs,
                                                  k_dir, ack, up)
            sink["coords"] = c2
            sink["aux"] = coords_mod.CoordRoundAux(
                pair_j=pair_j, drift=drift, relaxed=relaxed, late=late)
    if p.lifeguard:
        lh = _clamp_lh(lh + failed.to(_I32) - ack.to(_I32), p)

    # --------------------------------------------- target-side suspicion
    if scal is None:
        s_fast, s_slow = _sums(reduce, upf * pf_fast, upf * pf_slow)
        e_pf_fast = s_fast / torch.clamp_min(n_live, 1e-9)
        e_pf_slow = s_slow / torch.clamp_min(n_live, 1e-9)
    else:
        e_pf_fast = scal[4] / torch.clamp_min(n_live, 1e-9)
        e_pf_slow = scal[5] / torch.clamp_min(n_live, 1e-9)
    probe_rate = n_live / torch.clamp_min(n_elig - 1.0, 1.0)
    base_fail = torch.where(slow_eff, e_pf_slow, e_pf_fast)
    if fx is not None:
        # suspicion-weighted round-trip success
        base_fail = 1.0 - (1.0 - base_fail) * fx.suspw
    if late_in is not None:
        # RTT-timeout misses compose with loss as an independent leg
        base_fail = 1.0 - (1.0 - base_fail) * (1.0 - late_in)
    p_fail_j = torch.where(up, base_fail, 1.0)
    if byz or p.sweeps("corroboration_k") or p.corroboration_k > 0:
        # forged acks and k-of-m corroboration gate suspicion starts
        p_fail_j = p_fail_j * detection_gate(up, fx, p)
    lam_fail = probe_rate * p_fail_j * eligf
    if byz:
        # forged suspicions arrive like failed probes
        lam_fail = lam_fail + fx.spur_susp * eligf
    cdf = [] if margin is not None else None
    u_pois = u01(U_POIS)
    n_fail = _trunc_poisson(u_pois, lam_fail, cdf=cdf)

    # mean Lifeguard (LH+1) scale of failing probers
    if scal is None:
        w_fail = upf * (1.0 - p_ack)
        lfail_num, s_den = _sums(reduce, w_fail * (lh.to(_F32) + 1.0),
                                 w_fail)
        lfail_den = torch.clamp_min(s_den, 1e-9)
    else:
        lfail_num, lfail_den = scal[6], scal[7]
    if p.lifeguard:
        scale = lfail_num / lfail_den
        if byz:
            # a forged suspicion in a cluster where no probe fails must
            # race the full Lifeguard timer, not a 0/epsilon one
            scale = torch.clamp_min(scale, 1.0)
    else:
        scale = torch.ones((), dtype=_F32, device=informed.device)

    # carried suspicion timers advance one tick
    sttl = torch.where(status == SUSPECT, sttl - 1, sttl)

    starts = (n_fail > 0) & (status == ALIVE)
    confirms = (n_fail > 0) & (status == SUSPECT)
    c0 = torch.clamp_min(n_fail - 1, 0)
    timeout0 = scale * p.suspicion_max_s * _shrink(c0, p)
    ticks0 = torch.ceil(timeout0 / p.probe_interval)
    len0 = torch.clamp_max(ticks0, float(TICK_MAX)).to(_I32)
    status = torch.where(starts, SUSPECT, status)
    slen = torch.where(starts, len0, slen)
    sttl = torch.where(starts, len0, sttl)
    s_conf = torch.where(starts, c0, s_conf)
    informed = torch.where(starts, 1.0 / n, informed)
    new_rumor = new_rumor | starts

    # existing suspicions: independent confirmations shrink the timer
    c_new = torch.clamp_max(s_conf + n_fail, CONF_MAX)
    ratio = _shrink(c_new, p) / _shrink(s_conf, p)
    len2_f = slen.to(_F32) * ratio
    len2 = torch.ceil(len2_f).to(_I32)
    sttl = torch.where(confirms, sttl - (slen - len2), sttl)
    slen = torch.where(confirms, len2, slen)
    s_conf = torch.where(confirms, c_new, s_conf)

    # ------------------------------------------- refutation (the race)
    lam_hear = p.fanout_ticks * informed * p.one_minus_loss * g
    if fx is not None:
        # both legs of a refutation: hear the suspicion, answer it
        lam_hear = lam_hear * fx.hear_w
    if byz:
        # replayed stale rumors crowd out the current one
        lam_hear = lam_hear * (1.0 - fx.replay)
    p_hear = 1.0 - torch.exp(-lam_hear)
    wrongly = up & ((status == SUSPECT) | (status == DEAD)) & ~new_rumor
    u_hear = u01(U_HEAR)
    refute = wrongly & (u_hear < p_hear)
    status = torch.where(refute, ALIVE, status)
    inc = torch.where(refute, torch.clamp_max(inc + 1, TICK_MAX), inc)
    informed = torch.where(refute, 1.0 / n, informed)
    sttl = torch.where(refute, TTL_NEVER, sttl)
    slen = torch.where(refute, 0, slen)
    s_conf = torch.where(refute, 0, s_conf)
    new_rumor = new_rumor | refute
    if p.lifeguard:
        lh = _clamp_lh(lh + refute.to(_I32), p)

    if byz:
        # stale replays force live victims into incarnation bumps
        u_rep = u01(U_REPLAY)
        bump = up & (status == ALIVE) & ~new_rumor & (u_rep < fx.replay)
        inc = torch.where(bump, torch.clamp_max(inc + 1, TICK_MAX), inc)
        informed = torch.where(bump, 1.0 / n, informed)
        new_rumor = new_rumor | bump

    # ------------------------------------------------- dead declaration
    declare = (status == SUSPECT) & (sttl <= 0)
    status = torch.where(declare, DEAD, status)
    informed = torch.where(declare, 1.0 / n, informed)
    sttl = torch.where(declare, TTL_NEVER, sttl)
    new_rumor = new_rumor | declare
    # a node crashing in round r ends it at age 0: (age + 1) periods
    lat = (age + 1).to(_F32) * p.probe_interval

    # ----------------------------------------------- epidemic growth
    grow = (~new_rumor) & (informed < 1.0)
    lam_g = p.fanout_ticks * informed * p.one_minus_loss
    if fx is not None:
        lam_g = lam_g * fx.mid
    if byz:
        lam_g = lam_g * (1.0 - fx.replay)
    informed = torch.where(
        grow, informed + (1.0 - informed) * (1.0 - torch.exp(-lam_g)),
        informed)

    age_out = torch.where(up, torch.where(slow, SLOW_AGE, ALIVE_AGE), age)
    outs = (status, inc, informed, age_out, slen, sttl, s_conf, lh)
    if sink is not None:
        sink["events"] = blackbox.ProbeEvents(
            ack=ack, failed=failed, late=late, pair_j=pair_j,
            rtt_us=None if rtt_obs is None
            else (rtt_obs * 1e6).to(_I32))

    # ------------------------------------- per-node contribution lanes
    upf2 = up.to(_F32)
    elig2 = (status == ALIVE) | (status == SUSPECT)
    elig2f = elig2.to(_F32)
    w_fail2 = upf2 * (1.0 - p_ack)
    slow_sum = slow if kernel_sums else slow_eff
    lanes = [upf2, elig2f, upf2 * elig2f, (slow_sum & up & elig2).to(_F32),
             upf2 * pf_fast, upf2 * pf_slow,
             w_fail2 * (lh.to(_F32) + 1.0), w_fail2]
    if p.collect_stats or lane_mode:
        tp = declare & ~up

        def f(m):
            return None if m is None else m.to(_F32)

        lanes += [f(starts), f(refute), f(declare & up), f(tp),
                  torch.where(tp, lat, 0.0), f(crash), f(rejoin),
                  f(leave)]
        lanes += ([f(starts & fx.attacked), f(declare & up & fx.attacked)]
                  if byz else [None, None])
    else:
        lanes += [None] * N_STATS
    if lane_mode:
        # the flight gauges' numerators and the lh exceedance histogram
        # (registry.LANE_GAUGES, LANE_LH_HIST), post-round
        lanes += [upf2, informed, (status == SUSPECT).to(_F32),
                  (up & ((status == SUSPECT) | (status == DEAD))).to(_F32),
                  lh.to(_F32), inc.to(_F32)]
        lanes += [(lh >= k).to(_F32) for k in range(1, 9)]

    if margin is not None:
        inf = torch.full_like(informed, float("inf"))
        m = torch.where(up, _ulps(u_ack, p_ack.expand_as(u_ack)), inf)
        for c in cdf:
            m = torch.minimum(m, torch.where(eligf > 0, _ulps(u_pois, c),
                                             inf))
        m = torch.minimum(m, torch.where(wrongly, _ulps(u_hear, p_hear),
                                         inf))
        m = torch.minimum(m, torch.where(
            starts, _ulps(timeout0 / p.probe_interval,
                          torch.round(timeout0 / p.probe_interval)), inf))
        m = torch.minimum(m, torch.where(
            confirms, _ulps(len2_f, torch.round(len2_f)), inf))
        margin.append(m)
    return outs, lanes


def _cast_like(outs, vals):
    """Narrow each widened lane back to its input tensor's dtype."""
    return tuple(o.to(v.dtype) for o, v in zip(outs, vals))


def _stats_add(st: SimStats, lanes, reduce=None) -> SimStats:
    """Fold one round's counter lanes into the cumulative SimStats; with
    a grid reducer, per point (``[G]`` leaves) from one stacked sum."""
    live = [(f, lanes[N_SCALARS + i]) for i, f in enumerate(STATS_FIELDS)
            if lanes[N_SCALARS + i] is not None]
    if reduce is not None:
        sums = reduce(*[lane for _, lane in live]) if live else []
        deltas = {f: d[..., 0] if f == STATS_FIELDS[LAT]
                  else d[..., 0].to(_I32) for (f, _), d in zip(live, sums)}
        return st._replace(**{f: getattr(st, f) + d
                              for f, d in deltas.items()})
    deltas = {}
    for f, lane in live:
        if f == STATS_FIELDS[LAT]:
            deltas[f] = torch.sum(lane)
        else:
            deltas[f] = torch.sum(lane.to(_I32)).to(_I32)
    return st._replace(**{f: getattr(st, f) + d for f, d in deltas.items()})


def clamp_scalars(sums: torch.Tensor,
                  floors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply ``SCALAR_FLOORS`` to a reduced [8] scalar vector. The floors
    are copied to each device once (a copy from host memory makes the
    host wait, and a CUDA graph cannot hold it)."""
    if floors is None:
        floors = _scalar_floors.get(sums.device)
        if floors is None:
            floors = _scalar_floors[sums.device] = torch.tensor(
                SCALAR_FLOORS, dtype=_F32, device=sums.device)
    return torch.maximum(sums, floors)


_scalar_floors: dict = {}


def round_core(state: SimState, scalars: Optional[torch.Tensor],
               p: SimParams, u01: prng.U01,
               fx: Optional[FaultFrame] = None, coords=None, topo=None,
               key: Optional[torch.Tensor] = None, events: bool = False,
               reduce=None, into: Optional[tuple] = None):
    """ONE protocol period; returns ``(state', scalars')``.

    ``scalars=None`` is live mode (``scalars'`` is None);
    a stale [8] vector is stale mode, producing next round's scalars in
    the same pass. ``u01(slot)`` supplies each slot's [N] uniforms.
    ``fx`` is the round's fault view, blended by ``p.fault_gain`` here
    as the reference's ``_round_core`` does.

    With ``coords`` (and ``topo`` and the round's threefry ``key``) or
    ``events=True`` the return is the reference ``_round_core``'s
    ``(state', scalars', coords', coords.CoordRoundAux, ProbeEvents)``,
    None where an option is off.

    A grid state (``[G, N]`` lanes, ``[G]`` clock and counters) runs in
    live mode with ``p`` a ``params.TracedParams`` and ``reduce`` the
    per-row reducer (``lanes.row_sums``).

    ``into`` (8 tensors of the state's lanes, or the lanes themselves: a
    runner's donated carry) receives the new lanes, and the returned
    state holds them there.

    An honest live period of one run (no frame, coordinates, events or
    grid) on packed lanes takes the kernels' route where
    ``fused.routed`` says so: three ``live_kernel`` stages around its
    sums, bit for bit this body; every other period runs the body."""
    if reduce is not None and scalars is not None:
        raise ValueError("a grid reducer runs the live engine only")
    vals = state.node_arrays()
    if scalars is None and fx is None and coords is None and not events \
            and reduce is None and fused.routed(vals[0]) \
            and live_kernel.takes(vals, p):
        outs, counters = live_kernel.live_round(vals, u01, draw_slots(p),
                                                p, into)
        st = _stats_add(state.stats, [None] * N_SCALARS + counters) \
            if p.collect_stats else state.stats
        return SimState(*outs,
                        t=state.t + _per_point(p.probe_interval, state.t),
                        round_idx=state.round_idx + 1, stats=st), None
    if fx is not None and (p.sweeps("fault_gain") or p.fault_gain != 1.0):
        fx = scale_frame(fx, p.fault_gain)
    co = None
    if coords is not None:
        if topo is None or key is None:
            raise ValueError("coords need a topology and the round key")
        co = (coords, topo, key)
    sink = {} if co is not None or events else None
    outs, lanes = _round_body(vals, scalars, p, u01, fx=fx, co=co,
                              sink=sink, reduce=reduce)
    st = _stats_add(state.stats, lanes, reduce) \
        if p.collect_stats else state.stats
    outs = _cast_like(outs, vals)
    if into is not None:
        graphs.assign(into, outs)
        outs = into
    out = SimState(*outs, t=state.t + _per_point(p.probe_interval, state.t),
                   round_idx=state.round_idx + 1, stats=st)
    sc = None
    if scalars is not None:
        sc = clamp_scalars(torch.stack([torch.sum(lane)
                                        for lane in lanes[:N_SCALARS]]))
    if sink is None:
        return out, sc
    return (out, sc, sink.get("coords"), sink.get("aux"),
            sink["events"] if events else None)


def gossip_round(state: SimState, key: torch.Tensor, p: SimParams,
                 fx: Optional[FaultFrame] = None, coords=None, topo=None,
                 events: bool = False, into: Optional[tuple] = None):
    """One period with LIVE population scalars, drawing from ``key``
    exactly as the JAX engines draw (``prng.threefry_u01``). Returns the
    state; with ``coords``/``topo``, ``(state, coords',
    CoordRoundAux)``; ``events=True`` appends the round's
    ``ProbeEvents``. ``into`` as in ``round_core``."""
    res = round_core(state, None, p,
                     prng.threefry_u01(key, state.status.shape[0],
                                       draw_slots(p, fx)), fx,
                     coords=coords, topo=topo, key=key, events=events,
                     into=into)
    if len(res) == 2:
        return res[0]
    out, _, c2, aux, ev = res
    ret = (out,) if coords is None else (out, c2, aux)
    if events:
        ret = ret + (ev,)
    return ret[0] if len(ret) == 1 else ret


def gossip_round_fast(state: SimState, scalars: torch.Tensor,
                      key: torch.Tensor, p: SimParams,
                      fx: Optional[FaultFrame] = None):
    """One period on LAST round's scalars: returns (state', scalars')."""
    return round_core(state, scalars, p,
                      prng.threefry_u01(key, state.status.shape[0],
                                        draw_slots(p, fx)), fx)


def plan_frames(plan: Optional[CompiledFaultPlan], state: SimState,
                rounds: int, gain: float = 1.0
                ) -> Iterator[Optional[FaultFrame]]:
    """An iterator over the fault view of each of the next ``rounds``
    rounds of ``state``, keyed by the absolute round (all None without a
    plan). Frames are built as they are taken, so a flapping phase's
    rewritten lanes never pile up; the phase lookup runs on the device
    from ``state.round_idx`` (``faults.frames_at``: no host read, so a
    CUDA graph can hold it). ``gain`` is that of a plan blended by
    ``scale_plan`` (see ``fault_frame``)."""
    if plan is None:
        return itertools.repeat(None, rounds)
    return frames_at(plan, state.round_idx, rounds, gain)


def init_scalars(state: SimState, p: SimParams) -> torch.Tensor:
    """Exact population scalars for the stale path's first round."""
    up, status, slow, lh = (state.up, state.status, state.slow,
                            state.local_health)
    upf = up.to(_F32)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(_F32)
    n_live = torch.sum(upf)
    n_elig = torch.clamp_min(torch.sum(eligf), 1.0)
    n_up_elig = torch.clamp_min(torch.sum(upf * eligf), 1e-9)
    n_slow = torch.sum((slow & up & elig).to(_F32))
    sbar = n_slow / n_up_elig
    _, pf_fast, pf_slow = pf_arrays(slow, lh, sbar, n_live / p.n, p)
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = (n_up_elig / n_elig) * (1.0 - mix)
    w_fail = upf * (1.0 - p_ack)
    return torch.stack([
        n_live, n_elig, n_up_elig, n_slow,
        torch.sum(upf * pf_fast), torch.sum(upf * pf_slow),
        torch.sum(w_fail * (lh.to(_F32) + 1.0)),
        torch.clamp_min(torch.sum(w_fail), 1e-9)])


def run_rounds(state: SimState, key: torch.Tensor, p: SimParams,
               rounds: int, trace_node: Optional[int] = None,
               plan: Optional[CompiledFaultPlan] = None):
    """Run ``rounds`` live-scalar periods; returns (final, trace) where
    trace is the per-round informed fraction of ``trace_node`` (or
    None). Round keys are ``round_keys(key, state.round_idx, rounds)``,
    so a run cut anywhere and resumed from its state is the same run.
    ``plan`` shapes each round with its ``fault_frame``."""
    keys = prng.round_keys(key, state.round_idx, rounds)
    trace = []
    for r, fx in enumerate(plan_frames(plan, state, rounds)):
        state = gossip_round(state, keys[r], p, fx)
        if trace_node is not None:
            trace.append(state.informed[trace_node])
    return state, (torch.stack(trace) if trace_node is not None else None)


def _param_inputs(p) -> tuple:
    """(key part, leaf tensors) of a body's params: a grid's
    TracedParams leaves are graph inputs (``_params_from`` rebuilds the
    view on the static copies); SimParams are constants."""
    if not isinstance(p, TracedParams):
        return (p,), ()
    names = tuple(sorted(p.leaves))
    return ((p.static, names, p.point),
            tuple(p.leaves[nm] for nm in names))


def _params_from(p, leaves: tuple):
    if not isinstance(p, TracedParams):
        return p
    return TracedParams(p.static, dict(zip(sorted(p.leaves), leaves)),
                        p.point)


def own_scalars(state: SimState) -> SimState:
    """``state`` as a runner's carry holds it: the caller's per-node
    tensors (donated, updated in place) and private copies of its clock,
    round and counters (see ``graphs``' module doc)."""
    return state._replace(t=state.t.clone(),
                          round_idx=state.round_idx.clone(),
                          stats=SimStats(*[x.clone() for x in state.stats]))


class FastCarry(NamedTuple):
    """The stale-scalar runner's carry: the state and the scalars the
    next round reads."""

    state: SimState
    scalars: torch.Tensor


def make_run_rounds_fast(p: SimParams, rounds: int, carry: bool = False):
    """Stale-scalar loop on threefry draws: ``run(state, key, plan=None,
    scalars0=None)`` -> state (``(state, scalars)`` with ``carry``).
    ``carry=True`` is the checkpoint seam: the returned scalars, passed
    back as ``scalars0``, resume the run bit for bit (``init_scalars``
    would recompute live sums instead). ``plan`` shapes each round with
    its ``fault_frame``. On the card each round is one replay of a
    captured round (``graphs.GraphCache``), its key an input and its
    frame looked up on the device from the carried round. The state is
    donated (``graphs``' module doc)."""
    cache = graphs.GraphCache()

    def run(state: SimState, key: torch.Tensor,
            plan: Optional[CompiledFaultPlan] = None, scalars0=None):
        if scalars0 is not None and not carry:
            raise ValueError("scalars0 needs a carry=True runner")

        def one_round(c, key_r):
            fx = frame_at(plan, c.state.round_idx) if plan is not None \
                else None
            graphs.assign(c, FastCarry(*gossip_round_fast(
                c.state, c.scalars, key_r, p, fx)))

        with telemetry.span("sim.runner.call"):
            with telemetry.span("sim.runner.prologue"):
                c = FastCarry(own_scalars(state),
                              init_scalars(state, p) if scalars0 is None
                              else scalars0.clone())
                keys = prng.round_keys(key, state.round_idx, rounds)
                plan_key = graphs.pinned(plan) if plan is not None \
                    else None
            for r in range(rounds):
                cache(("round", plan_key), one_round, c, keys[r])
            with telemetry.span("sim.runner.epilogue"):
                return tuple(c) if carry else c.state

    run.graphs = cache
    return run


#: periods in one replay of the live runner's captured body: a call of
#: twice as many or more captures in its first call (its first body runs
#: eagerly, its second is the capture), and the graph cache's copies in
#: and out of a replay, host work a replay, are shared by its periods
LIVE_REPLAY_ROUNDS = 8


def make_run_rounds(p: SimParams, rounds: int):
    """A pre-bound live-engine runner: ``run(state, key)`` -> state, the
    rounds of ``run_rounds``. On the card a call replays a captured body
    of ``LIVE_REPLAY_ROUNDS`` periods (``graphs.GraphCache``; the last
    body of a call holds what is left), its round keys an input. The
    state is donated (``graphs``' module doc): each period writes its
    lanes into the state's own (``round_core(into=)``)."""
    cache = graphs.GraphCache()

    def periods(s, keys_k):
        for r in range(keys_k.shape[0]):
            graphs.assign(s, gossip_round(s, keys_k[r], p,
                                          into=s.node_arrays()))

    def run(state: SimState, key: torch.Tensor) -> SimState:
        with telemetry.span("sim.runner.call"):
            with telemetry.span("sim.runner.prologue"):
                keys = prng.round_keys(key, state.round_idx, rounds)
                s = own_scalars(state)
            for i0 in range(0, rounds, LIVE_REPLAY_ROUNDS):
                cache("periods", periods, s,
                      keys[i0:i0 + LIVE_REPLAY_ROUNDS])
            with telemetry.span("sim.runner.epilogue"):
                return s

    run.graphs = cache
    return run


def run_rounds_stats(state: SimState, key: torch.Tensor, p: SimParams,
                     rounds: int,
                     plan: Optional[CompiledFaultPlan] = None):
    """``run_rounds`` that also stacks the cumulative SimStats after
    every round: returns (final, SimStats of [rounds] tensors) — what
    ``metrics.phase_reports`` reads."""
    keys = prng.round_keys(key, state.round_idx, rounds)
    trace = []
    for r, fx in enumerate(plan_frames(plan, state, rounds)):
        state = gossip_round(state, keys[r], p, fx)
        trace.append(state.stats)
    return state, SimStats(*[torch.stack(leaf) for leaf in zip(*trace)])


def run_rounds_coords(state: SimState, coords, topo, key: torch.Tensor,
                      p: SimParams, rounds: int,
                      plan: Optional[CompiledFaultPlan] = None):
    """``rounds`` periods with Vivaldi coordinates riding the live
    engine: returns (final, final coords, [rounds, 3] f32 trace of
    ``coords.coord_metrics`` in ``flight.COORD_COLUMNS`` order)."""
    keys = prng.round_keys(key, state.round_idx, rounds)
    trace = []
    for r, fx in enumerate(plan_frames(plan, state, rounds)):
        state, coords, aux = gossip_round(state, keys[r], p, fx,
                                          coords=coords, topo=topo)
        trace.append(coords_mod.coord_metrics(coords, topo, aux))
    return state, coords, torch.stack(trace)


class FlightCarry(NamedTuple):
    """The flight runner's carry: the state and coordinates, the trace
    buffer, the stats at the last recorded row, the black box (None
    unless armed) and the ``[2]`` int64 device sums of the first two
    ``COORD_COUNTERS`` (None unless coordinates ride a run while a
    registry is armed)."""

    state: SimState
    coords: Optional[coords_mod.CoordState]
    trace: torch.Tensor
    prev: SimStats
    bb: Optional[blackbox.BlackboxState]
    counts: Optional[torch.Tensor]


#: the flight runner's captured bodies, shared by its calls: a caller
#: calls the free function each time, so the cache outlives a call
FLIGHT_GRAPHS = graphs.GraphCache()


def _flight_periods(c: FlightCarry, keys_k: torch.Tensor, r0: torch.Tensor,
                    p: SimParams, plan, topo, record_every: int,
                    records: tuple) -> None:
    """``len(records)`` periods of ``run_rounds_flight`` on the carry
    ``c``, period r drawing from ``keys_k[r]`` and recording iff
    ``records[r]``: a row into the trace slot of its run-local round
    (its round less the call's first, ``r0``) and the black box's
    events. The frame and the phase are looked up on the device from
    the carried round."""
    s, co, prev, bb, counts = c.state, c.coords, c.prev, c.bb, c.counts
    for r, rec in enumerate(records):
        rnd = s.round_idx
        fx = frame_at(plan, rnd) if plan is not None else None
        ph = phase_at(plan, rnd) if plan is not None else -1
        # events=True: the five-field return whatever the options
        u01 = prng.threefry_u01(keys_k[r], s.status.shape[0],
                                draw_slots(p, fx))
        s2, _, c2, aux, ev = round_core(s, None, p, u01, fx, coords=co,
                                        topo=topo, key=keys_k[r],
                                        events=True)
        if rec:
            crow = coords_mod.coord_metrics(c2, topo, aux) \
                if co is not None else None
            row = flight.flight_row(
                up=s2.up, status=s2.status, informed=s2.informed,
                local_health=s2.local_health,
                incarnation=s2.incarnation, t=s2.t,
                stats_delta=flight.stats_delta(s2.stats, prev),
                phase=ph, coord_row=crow)
            # flight.record_row's slot, from the device round
            slot = torch.div(rnd - r0, record_every, rounding_mode="floor")
            slot = slot.clamp_max(c.trace.shape[0] - 1).to(torch.int64)
            c.trace.index_copy_(0, slot.reshape(1), row.unsqueeze(0))
            if bb is not None:
                # the attack mask disarms with a zero gain, as the stats do
                atk = None
                if fx is not None and fx.attacked is not None:
                    atk = fx.attacked if p.fault_gain > 0.0 \
                        else torch.zeros_like(fx.attacked)
                bb = blackbox.record(
                    bb, round_idx=rnd, phase=ph, status=s2.status,
                    incarnation=s2.incarnation, susp_conf=s2.susp_conf,
                    up=s2.up, probe=ev, indirect_checks=p.indirect_checks,
                    attacked=atk)
            prev = s2.stats
        if counts is not None:
            late = aux.late if aux.late is not None \
                else torch.zeros_like(aux.relaxed)
            counts = counts + torch.stack([aux.relaxed.sum(), late.sum()])
        s, co = s2, c2
    graphs.assign(c, FlightCarry(s, co, c.trace, prev, bb, counts))


def run_rounds_flight(state: SimState, key: torch.Tensor, p: SimParams,
                      rounds: int, record_every: int = 1,
                      plan: Optional[CompiledFaultPlan] = None,
                      coords=None, topo=None,
                      tracked: Optional[torch.Tensor] = None,
                      ring_len: Optional[int] = None, bb0=None):
    """``rounds`` live-engine periods with the flight recorder: returns
    (final, trace), the trace ``[n_trace_rows(rounds, record_every),
    flight.N_COLS]`` f32 (gauges at each window's end, counters the
    window's SimStats delta). The draws are ``run_rounds``'s, so a key
    gives the same run with or without the recorder.

    A ``coords``/``topo`` pair rides the run and fills the coordinate
    columns: the return becomes (final, final coords, trace).
    ``tracked`` (a [K] int32 id tensor, e.g. ``blackbox.default_tracked``)
    arms the black box — rings written on recorded rounds with the
    live engine's probe events — and appends the final BlackboxState;
    ``ring_len`` defaults to ``p.blackbox_ring``, and ``bb0`` resumes
    from a captured ring set (its rings written in place).

    On the card a call replays captured bodies of
    ``LIVE_REPLAY_ROUNDS`` periods (``FLIGHT_GRAPHS``; the last body of
    a call holds what is left). The round keys and the call's first
    round are a body's inputs; the plan, the topology and which of its
    periods record are parts of its key. The state and coordinates are
    not donated: the returned ones are fresh.

    The call runs under the span ``sim.runner.call`` (with its
    ``.prologue`` and ``.epilogue``); with coordinates and a registry
    armed (``utils.telemetry.armed``) it sums ``COORD_COUNTERS`` on the
    device (the kernel launches on the host) and publishes them there
    once, in the epilogue."""
    if not p.collect_stats:
        raise ValueError(
            "the flight recorder's counter columns ride the SimStats "
            "counters; build SimParams with collect_stats=True")
    with telemetry.span("sim.runner.call"):
        with telemetry.span("sim.runner.prologue"):
            with_bb = tracked is not None or bb0 is not None
            if bb0 is None and with_bb:
                bb0 = blackbox.init_blackbox(state, tracked,
                                             ring_len or p.blackbox_ring)
            elif bb0 is not None:
                bb0 = graphs.fresh(bb0)._replace(ring=bb0.ring)
            keys = prng.round_keys(key, state.round_idx, rounds)
            r0 = state.round_idx.clone()
            # the coordinate counters, summed only for an armed registry
            counts = torch.zeros(2, dtype=torch.int64, device=r0.device) \
                if coords is not None and telemetry.listening() else None
            c = FlightCarry(graphs.fresh(state), graphs.fresh(coords),
                            flight.empty_trace(rounds, record_every,
                                               state.status.device),
                            graphs.fresh(state.stats), bb0, counts)
            launched = coord_kernel.launches()
            body = functools.partial(_flight_periods, p=p, plan=plan,
                                     topo=topo, record_every=record_every)
            consts = (p, record_every,
                      graphs.pinned(plan) if plan is not None else None,
                      graphs.pinned(topo) if topo is not None else None)
        for i0 in range(0, rounds, LIVE_REPLAY_ROUNDS):
            i1 = min(i0 + LIVE_REPLAY_ROUNDS, rounds)
            records = tuple(flight.maybe_record(
                False, i, rounds, record_every, lambda _: True)
                for i in range(i0, i1))
            FLIGHT_GRAPHS(("flight", records) + consts,
                          functools.partial(body, records=records), c,
                          keys[i0:i1], r0)
        with telemetry.span("sim.runner.epilogue"):
            if counts is not None and rounds:
                telemetry.count(dict(zip(
                    COORD_COUNTERS, c.counts.tolist()
                    + [coord_kernel.launches() - launched])))
            out = (c.state,) if coords is None else (c.state, c.coords)
            out = out + (c.trace,)
            return out + (c.bb,) if with_bb else out


#: the coordinate counters a flight run publishes, once a call, to the
#: armed registries (``utils.telemetry.count``): acked probe pairs
#: relaxed, direct probes whose ack came past their deadline, and the
#: coordinate kernels' launches (``coord_kernel.LAUNCHES``; 0 on the
#: CPU, where the plain versions run)
COORD_COUNTERS = ("sim.coords.updates", "sim.coords.deadline_misses",
                  "sim.coords.kernel_launches")


def make_run_rounds_flight(p: SimParams, rounds: int,
                           record_every: int = 1):
    """A pre-bound ``run_rounds_flight``: ``run(state, key, ...)``."""
    return functools.partial(run_rounds_flight, p=p, rounds=rounds,
                             record_every=record_every)


# ----------------------------------------------------- fused lane engine
#
# The reference's exact lane engine (its round.py:766-1152): the round
# body in lane mode on the global-index draws (prng.u01_global), one
# fixed-order reduction of the [N_REDUCE_LANES, ..., L] contribution
# stack per staleness-k window (sim/lanes.py), stats and flight rows
# from the reduced lane vector. Windows are Python loops here, each
# writing its state into the carry's tensors (``LaneCarry``). Every
# function takes one run ([N] lanes, SimParams) or a grid ([G, N] lanes,
# params.TracedParams) alike.


def _grid_scalars(sc: torch.Tensor) -> torch.Tensor:
    """Stale scalars as the body indexes them: ``[8]``, or ``[8, G, 1]``
    for a grid's ``[8, G]``."""
    return sc if sc.dim() == 1 else sc.unsqueeze(-1)


def _lane_contributions(state: SimState, scalars: torch.Tensor,
                        key: torch.Tensor, p: SimParams,
                        fx: Optional[FaultFrame] = None,
                        shard_offset: int = 0, *,
                        stack: Optional[torch.Tensor] = None,
                        stats: str = "write", inst: bool = True,
                        tab: Optional[torch.Tensor] = None):
    """One period in lane mode without the reduction: (state', the
    round's ``[N_REDUCE_LANES, ..., L]`` contribution stack). Stats stay
    on the state untouched; the caller applies the reduced deltas.
    ``shard_offset`` is the global index of the state's first row (a
    mesh rank's slice): node i draws the same word on any sharding.

    On the kernel's route (``fused.routed``) the period is one
    ``lane_round`` launch on the round's one draw launch; ``stack``,
    ``stats`` and ``inst`` are its window mode and ``tab`` its constant
    table (``_lane_window``). The plain body writes a whole new
    stack."""
    rows = state.status.shape[-1]
    if fx is not None and (p.sweeps("fault_gain") or p.fault_gain != 1.0):
        fx = scale_frame(fx, p.fault_gain)
    vals = state.node_arrays()
    if fused.routed(vals[0]):
        slots = draw_slots(p, fx)
        outs, stack = lane_kernel.lane_round(
            vals, scalars, prng.global_rows(key, shard_offset, rows, slots),
            slots, p, fx, stack=stack, stats=stats, inst=inst, tab=tab)
        return SimState(*outs,
                        t=state.t + _per_point(p.probe_interval, state.t),
                        round_idx=state.round_idx + 1,
                        stats=state.stats), stack
    if stack is not None:
        raise ValueError("the plain body writes a new stack a round")
    outs, lanes = _round_body(vals, _grid_scalars(scalars), p,
                              prng.global_u01(key, shard_offset, rows,
                                              draw_slots(p, fx)),
                              fx=fx, lane_mode=True)
    out = SimState(*_cast_like(outs, vals),
                   t=state.t + _per_point(p.probe_interval, state.t),
                   round_idx=state.round_idx + 1, stats=state.stats)
    shape = outs[2].shape
    zeros = torch.zeros(shape, dtype=_F32, device=outs[2].device)
    stack = torch.stack([zeros if lane is None else lane.expand(shape)
                         for lane in lanes])
    return out, stack


def _add_stats(st: SimStats, delta: SimStats) -> SimStats:
    return SimStats(*[a + b for a, b in zip(st, delta)])


def gossip_round_lanes(state: SimState, lanes_prev: torch.Tensor,
                       key: torch.Tensor, p: SimParams, *, lane_reducer,
                       fx: Optional[FaultFrame] = None):
    """One period on the fused lane plan (the stale_k = 1 schedule):
    stale scalars from ``lanes_prev``, one ``lane_reducer`` call on the
    round's stack. Returns (state', lanes'): the reduced lane vector
    feeds the next round's scalars and carries this round's stats delta
    and flight gauge numerators."""
    out, stack = _lane_contributions(
        state, lanes_mod.scalars_from_lanes(lanes_prev), key, p, fx)
    lanes = lane_reducer(stack)
    if p.collect_stats:
        out = out._replace(stats=_add_stats(
            out.stats, lanes_mod.stats_delta_from_lanes(lanes)))
    return out, lanes


def _lane_window(state: SimState, lanes_prev: torch.Tensor, keys_k,
                 frames, p: SimParams, k: int, shard_offset: int = 0):
    """A staleness-k window: k periods on scalars frozen from
    ``lanes_prev``, no reduction inside. Returns (state', stack): the
    stack's instantaneous rows (scalars, gauges, histogram) are the last
    round's, its SimStats rows the per-node sum over the k rounds (so
    the reduced counters are the window's exact totals). ``frames`` is
    each round's fault view (or None)."""
    scalars = lanes_mod.scalars_from_lanes(lanes_prev)
    if fused.routed(state.status):
        # one launch a round into one stack: its counter rows summed in
        # place (pend + rows), the other rows the last round's
        tab = lane_kernel.table(p, math.prod(state.status.shape[:-1]),
                                state.status.device)
        s, stack = state, None
        for j in range(k):
            stats = "add" if p.collect_stats and j else \
                "write" if p.collect_stats or j == k - 1 else "skip"
            s, stack = _lane_contributions(
                s, scalars, keys_k[j], p, frames[j], shard_offset,
                stack=stack, stats=stats, inst=j == k - 1, tab=tab)
        return s, stack
    s, pend, stack = state, None, None
    for j in range(k):
        s, stack = _lane_contributions(s, scalars, keys_k[j], p,
                                       frames[j], shard_offset)
        if p.collect_stats:
            rows = stack[lanes_mod.STATS_SLICE]
            pend = rows if j == 0 else pend + rows
    if p.collect_stats and k > 1:
        stack[lanes_mod.STATS_SLICE] = pend
    return s, stack


def init_lanes(state: SimState, p: SimParams, lane_reducer) -> torch.Tensor:
    """The exact first-round lane vector (``init_scalars``' math through
    the lane reducer): population counts first, then the pf / Lifeguard
    sums that need sbar; every other lane zero."""
    up, status, slow, lh = (state.up, state.status, state.slow,
                            state.local_health)
    upf = up.to(_F32)
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(_F32)
    a = lane_reducer(torch.stack([upf, eligf, upf * eligf,
                                  (slow & up & elig).to(_F32)]))
    ag = _grid_scalars(a)
    n_live = ag[0]
    n_elig = torch.clamp_min(ag[1], 1.0)
    n_up_elig = torch.clamp_min(ag[2], 1e-9)
    sbar = ag[3] / n_up_elig
    _, pf_fast, pf_slow = pf_arrays(slow, lh, sbar, n_live / p.n, p)
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = (n_up_elig / n_elig) * (1.0 - mix)
    w_fail = upf * (1.0 - p_ack)
    b = lane_reducer(torch.stack([
        upf * pf_fast, upf * pf_slow,
        w_fail * (lh.to(_F32) + 1.0), w_fail]))
    lanes = torch.zeros((lanes_mod.N_LANES,) + tuple(a.shape[1:]),
                        dtype=_F32, device=a.device)
    lanes[0:4] = a
    lanes[4:8] = b
    return lanes


def _apply_lane_stats(s: SimState, lv: torch.Tensor,
                      p: SimParams) -> SimState:
    """Fold a reduced lane vector's stats delta into the carried
    SimStats."""
    if not p.collect_stats:
        return s
    return s._replace(stats=_add_stats(
        s.stats, lanes_mod.stats_delta_from_lanes(lv)))


class LaneCarry(NamedTuple):
    """The lane engine's carry: the state, the last window's reduced
    lane vector, and the counters at the last flight row (with a
    recorder) or the pre-fold block table (under overlap)."""

    state: SimState
    lanes: torch.Tensor
    prev: Optional[SimStats] = None
    table: Optional[torch.Tensor] = None


def _lane_scan(state: SimState, keys: torch.Tensor, cp, p: SimParams,
               rounds: int, flight_every: Optional[int], lane_reducer, *,
               shard_offset: int = 0, overlap: bool = False, lanes0=None,
               table0=None, return_carry: bool = False, cache=None):
    """The lane engine's loop: ceil(rounds / stale_k) windows, each
    ending in one reduction (a partial final window ends in its own).
    Flight rows come from the reduced lane vector
    (``flight.row_from_lanes``) on window ends that close a stride and
    at the run's end.

    Each window is one call of ``cache`` (a ``graphs.GraphCache``: one
    captured window, replayed ``rounds // stale_k`` times, its keys an
    input and its frames and phase looked up on the device from the
    carried round; ``graphs.direct`` runs it as it stands). The window
    updates a ``LaneCarry`` in place, whose state is ``state``: every
    tensor of it, the clock, round and counters too (a runner passes
    ``own_scalars(state)``; the sweep, whose reference does not donate,
    a copy). The returned state is that carry's.

    ``overlap=True`` carries the pre-fold block table and folds it one
    window late (window m consumes window m-2's reduction); the first
    fold consumes ``lanes.seed_table(lanes0)``, and a drain fold after
    the loop lands the last window's stats. Each fold starts before the
    window's rounds and finishes after them (``fold_start`` /
    ``fold_finish``: on a mesh the all-reduce is in flight meanwhile);
    its stats land after the window, which leaves them as they were
    (a window does not touch the stats).

    ``shard_offset`` is the global index of the state's first row: one
    device is the shard at offset 0; a mesh rank passes its slice's.

    The checkpoint seam: ``return_carry`` appends the lane vector (and
    under overlap the undrained global table, the drain skipped — a
    resumed chain ends with ``drain_overlap``); ``lanes0`` / ``table0``
    resume from them, bit for bit."""
    k = p.stale_k
    with_flight = flight_every is not None
    call = cache if cache is not None else graphs.direct
    pkey, pleaves = _param_inputs(p)
    plan_key = graphs.pinned(cp) if cp is not None else None

    def window(c, keys_k, leaves, count, record):
        pp = _params_from(p, leaves)
        frames = [None] * count if cp is None else \
            list(frames_at(cp, c.state.round_idx, count))
        if overlap:
            pending = lane_reducer.fold_start(c.table)
        s2, stack = _lane_window(c.state, c.lanes, keys_k, frames, pp,
                                 count, shard_offset)
        lv = lane_reducer.fold_finish(pending) if overlap \
            else lane_reducer(stack)
        s2 = _apply_lane_stats(s2, lv, pp)
        row = None
        if record:
            ph = phase_at(cp, s2.round_idx - 1) if cp is not None else -1
            row = flight.row_from_lanes(lv, pp.n, s2.t, ph,
                                        flight.stats_delta(s2.stats, c.prev))
        graphs.assign(c, LaneCarry(
            s2, lv, s2.stats if record else c.prev,
            lane_reducer.partials(stack) if overlap else None))
        return row

    with telemetry.span("sim.runner.prologue"):
        lanes = init_lanes(state, p, lane_reducer) if lanes0 is None \
            else lanes0.clone()
        if overlap:
            c = LaneCarry(state, lanes, table=(
                lanes_mod.seed_table(lanes, shard_offset) if table0 is None
                else lanes_mod.carry_table(table0, shard_offset)))
        else:
            c = LaneCarry(state, lanes, prev=SimStats(
                *[x.clone() for x in state.stats]) if with_flight else None)
            buf = flight.empty_trace(
                rounds, flight_every, state.status.device,
                lead=tuple(state.status.shape[:-1])) if with_flight else None
    if overlap:
        for m in range(rounds // k):
            call(("overlap", pkey, plan_key), window, c,
                 keys[m * k:(m + 1) * k], pleaves, k, False)
        with telemetry.span("sim.runner.epilogue"):
            if return_carry:
                return c.state, c.lanes, lane_reducer.gather_table(c.table)
            return _apply_lane_stats(c.state, lane_reducer.fold(c.table), p)
    for i0 in range(0, rounds, k):
        count = min(k, rounds - i0)
        i = i0 + count - 1
        record = with_flight and ((i + 1) % flight_every == 0
                                  or i + 1 >= rounds)
        row = call(("window", pkey, plan_key, count, record), window, c,
                   keys[i0:i0 + count], pleaves, count, record)
        if record:
            flight.record_row(buf, row, i, flight_every)
    with telemetry.span("sim.runner.epilogue"):
        out = (c.state, buf) if with_flight else (c.state,)
        if return_carry:
            out = out + (c.lanes,)
        return out[0] if len(out) == 1 else out


def drain_overlap(state: SimState, table: torch.Tensor, p: SimParams,
                  lane_reducer=None) -> SimState:
    """Finish a checkpoint-cut overlap chain: fold the captured global
    in-flight table into the state's stats (the straight runner's drain
    after its loop)."""
    if lane_reducer is None:
        lane_reducer = lanes_mod.reduce_lanes_single
    return _apply_lane_stats(state, lane_reducer.fold(table), p)


def make_run_rounds_lanes(p: SimParams, rounds: int,
                          flight_every: Optional[int] = None,
                          plan: Optional[CompiledFaultPlan] = None,
                          overlap: bool = False, carry: bool = False,
                          lane_blocks: Optional[int] = None):
    """The single-device lane engine: ``run(state, key, cp=None,
    lanes0=None, table0=None)`` -> state, or ``(state, trace)`` with
    ``flight_every``, with the carry appended under ``carry=True`` (the
    lane vector; under overlap the undrained table too). The exact
    engine the mesh will wrap, at every ``p.stale_k`` and under the
    ``overlap`` (one-reduction-late) schedule.

    Round keys are ``round_keys(key, state.round_idx, rounds)``, draws
    ``prng.global_u01``: a run cut at a window boundary and resumed
    with the returned carry (``lanes0=``, ``table0=``, then
    ``drain_overlap``) is bit for bit the uncut run. ``plan`` (or a
    per-call ``cp``) shapes each round with its ``fault_frame``. The
    state is donated (``graphs``' module doc). The reference's
    ``unroll`` (an HLO-audit knob) is left out: a Python loop has
    nothing to unroll."""
    if lane_blocks is not None and lane_blocks != lanes_mod.LANE_BLOCKS:
        if overlap:
            raise ValueError(
                "lane_blocks overrides are single-device synchronous "
                "only (seed_table/carry_table are keyed to the pinned "
                f"LANE_BLOCKS={lanes_mod.LANE_BLOCKS}); run overlap "
                "at the default width")
        reducer = lanes_mod._SingleDeviceReducer(lane_blocks)
    else:
        reducer = lanes_mod.reduce_lanes_single
    lanes_mod.check_pool(p.n, reducer.blocks)
    lanes_mod.check_schedule(p, rounds, flight_every, overlap)
    cache = graphs.GraphCache()

    def run(state: SimState, key: torch.Tensor,
            cp: Optional[CompiledFaultPlan] = None, lanes0=None,
            table0=None):
        if cp is not None and plan is None:
            raise ValueError("this runner was built without a fault "
                             "plan; rebuild with plan= to inject one")
        if (lanes0 is not None or table0 is not None) and not carry:
            raise ValueError("resume carries need a carry=True runner "
                             "(the checkpoint seam is symmetric: what "
                             "it returns is what it accepts)")
        if table0 is not None and not overlap:
            raise ValueError("table0 is the overlap schedule's "
                             "in-flight carry; this runner is "
                             "synchronous")
        with telemetry.span("sim.runner.call"):
            with telemetry.span("sim.runner.prologue"):
                keys = prng.round_keys(key.to(state.status.device),
                                       state.round_idx, rounds)
                state = own_scalars(state)
            return _lane_scan(state, keys, cp if cp is not None else plan,
                              p, rounds, flight_every, reducer,
                              overlap=overlap, lanes0=lanes0, table0=table0,
                              return_carry=carry, cache=cache)

    run.graphs = cache
    return run
