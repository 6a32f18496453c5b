"""consul_tpu_torch's black-box event tracer against the JAX reference.

* The decoder tables and ``default_tracked`` equal the reference's.
* A sequence of ``record`` calls on the same post-round states as the
  reference's — state transitions only, with the live engine's probe
  events (coordinate mode: peers, RTTs, late acks), with a byzantine
  frame's attack mask, and on a ring short enough to wrap: ``ring``,
  ``count`` and the diff baselines exact after every call (the one
  scatter writes what the reference's per-code writes do, order within
  a round included).
* ``decode_timeline``, ``event_totals``, ``suspicion_episodes``,
  ``to_perfetto`` and ``blackbox_report`` on the reference's own rings
  and trace: equal.
* The kernel runner's rings on its CPU plain path equal ``record`` of
  the same run cut at the recorded rounds, on the per-round and the R=4
  runner; tracking every node at stride 1 through ``run_chaos`` on an
  honest and a byzantine class gives ``crosscheck_agree``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from consul_tpu_torch import faults as tf
from consul_tpu_torch.config import GossipConfig as TGossip
from consul_tpu_torch.sim import blackbox as tbb
from consul_tpu_torch.sim import cuda_round, prng
from consul_tpu_torch.sim import metrics as tmetrics
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.scenarios import chaos_params, chaos_plans, run_chaos
from test_torch_faults import _ref_plan
from test_torch_harness import ref  # noqa: F401  (fixture)


def _port_bb(bb) -> tbb.BlackboxState:
    import jax

    return tbb.BlackboxState(*[torch.from_numpy(np.array(x)) for x in
                               jax.device_get(bb)])


def _assert_bb_equal(a: tbb.BlackboxState, b) -> None:
    for f in tbb.BlackboxState._fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)), err_msg=f)


def _ref_params(n, **kw):
    from consul_tpu.config import GossipConfig as RGossip
    from consul_tpu.sim.params import SimParams as RParams

    return RParams.from_gossip_config(RGossip.lan(), n=n,
                                      tcp_fallback=False, **kw)


def test_tables_and_default_tracked_match_reference(ref):
    from consul_tpu.sim import blackbox as rbb

    assert tbb.EVENT_NAMES == rbb.EVENT_NAMES and tbb.EV == rbb.EV
    assert tbb.RECORD_FIELDS == rbb.RECORD_FIELDS and tbb.N_REC == 4
    assert tbb.TRANSITION_EVENTS == rbb.TRANSITION_EVENTS
    assert (tbb.DEFAULT_TRACKED_K, tbb.DEFAULT_RING_LEN) == \
        (rbb.DEFAULT_TRACKED_K, rbb.DEFAULT_RING_LEN)
    for n, k in ((4096, 64), (100, 64), (10, 64), (1_048_576, 64)):
        got = tbb.default_tracked(n, k, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(rbb.default_tracked(n, k)))
    # even spacing meets every contiguous fault range of the chaos plans
    t = set(tbb.default_tracked(4096, 64, "cpu").tolist())
    m = 4096 // 16
    for lo, hi in ((0, m), (0, 2 * m), (4096 - 512, 4096)):
        assert t & set(range(lo, hi))


CASES = {
    # name: (plan class or None, coords, ring_len)
    "transitions": (None, False, 256),
    "probe_coords": (None, True, 256),
    "attacked": ("eclipse", False, 256),
    "wrap": ("flapping", False, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_record_sequence_matches_reference(ref, case):
    import jax
    import jax.numpy as jnp

    from consul_tpu import faults as rf
    from consul_tpu.sim import blackbox as rbb
    from consul_tpu.sim import coords as rcoords
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate
    from consul_tpu.sim import topology as rtopo

    cls, coords, ring_len = CASES[case]
    n = 512
    rp = _ref_params(n, loss=0.1, fail_per_round=0.01,
                     rejoin_per_round=0.1, leave_per_round=0.002,
                     coords_timeout=coords).with_(probe_timeout=0.05)
    cp = None
    if cls is not None:
        cp = rf.compile_plan(_ref_plan(chaos_plans(n)[cls]), n)
    s = rstate.init_state(n)
    c = rcoords.init_coords(n) if coords else None
    topo = rtopo.make_topology(rtopo.TopologyParams(n=n)) if coords \
        else None
    tracked = np.arange(0, n, 5, dtype=np.int32)
    rbb_s = rbb.init_blackbox(s, jnp.asarray(tracked), ring_len)
    tbb_s = tbb.init_blackbox(tstate.from_numpy(jax.device_get(s), "cpu"),
                              torch.from_numpy(tracked), ring_len)
    _assert_bb_equal(tbb_s, jax.device_get(rbb_s))
    key = jax.random.key(7)
    total = 0
    for r in range(30):
        fx = rf.fault_frame(cp, jnp.int32(r)) if cp is not None else None
        ph = int(rf.active_phase(cp, jnp.int32(r))) if cp is not None \
            else -1
        out = rround.gossip_round(s, jax.random.fold_in(key, r), rp, fx=fx,
                                  coords=c, topo=topo, events=True)
        if coords:
            s, c, _, ev = out
        else:
            s, ev = out
        atk = None if fx is None else fx.attacked
        rbb_s = rbb.record(rbb_s, round_idx=jnp.int32(r), phase=jnp.int32(ph),
                           status=s.status, incarnation=s.incarnation,
                           susp_conf=s.susp_conf, up=s.up,
                           probe=ev if coords or r % 2 else None,
                           indirect_checks=rp.indirect_checks, attacked=atk)
        hs, hev = jax.device_get((s, ev))
        ts = tstate.from_numpy(hs, "cpu")
        tev = tbb.ProbeEvents(*[None if x is None else
                                torch.from_numpy(np.array(x)) for x in hev])
        tbb_s = tbb.record(tbb_s, round_idx=r, phase=ph, status=ts.status,
                           incarnation=ts.incarnation,
                           susp_conf=ts.susp_conf, up=ts.up,
                           probe=tev if coords or r % 2 else None,
                           indirect_checks=rp.indirect_checks,
                           attacked=None if atk is None
                           else torch.from_numpy(np.array(atk)))
        want = jax.device_get(rbb_s)
        _assert_bb_equal(tbb_s, want)
        total = int(want.count.sum())
    assert total > 100
    codes = set(np.asarray(want.ring)[..., 1].ravel().tolist())
    if coords:
        assert tbb.EV["coord_late"] in codes and tbb.EV["probe_ack"] in codes
    if case == "attacked":
        assert tbb.EV["attack_suspect_start"] in codes
    if case == "wrap":
        assert int(np.asarray(want.count).max()) > ring_len


def test_host_decoders_and_report_match_reference(ref):
    """On the reference's own rings (every agent tracked, stride 1, a
    byzantine class; and a short ring that wraps) and trace."""
    import jax

    from consul_tpu import faults as rf
    from consul_tpu.sim import blackbox as rbb
    from consul_tpu.sim import metrics as rmetrics
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate

    n = 256
    plan = chaos_plans(n)["eclipse"]
    rp, tp = _ref_params(n), chaos_params(n)
    cp = rf.compile_plan(_ref_plan(plan), n)
    for ring_len, k in ((256, n), (6, 32)):
        _, tr, bb = rround.run_rounds_flight(
            rstate.init_state(n), jax.random.key(3), rp, plan.total_rounds,
            plan=cp, tracked=rbb.default_tracked(n, k), ring_len=ring_len)
        bb, tr = jax.device_get((bb, tr))
        tb = _port_bb(bb)
        got = tbb.decode_timeline(tb, tp.probe_interval)
        want = rbb.decode_timeline(bb, rp.probe_interval)
        assert got == want
        assert tbb.event_totals(got) == rbb.event_totals(want)
        for node in got:
            assert tbb.suspicion_episodes(got[node]) == \
                rbb.suspicion_episodes(want[node])
        assert tbb.to_perfetto(got) == rbb.to_perfetto(want)
        rep = tmetrics.blackbox_report(tb, tp, trace=np.array(tr))
        assert rep == rmetrics.blackbox_report(bb, rp, trace=tr)
        if k == n:
            assert rep["crosscheck_agree"] is True
            assert rep["events"]["attack_suspect_start"] > 0
        else:
            assert rep["dropped_events"] > 0 and "crosscheck" not in rep


def _kp(n):
    return SimParams.from_gossip_config(
        TGossip.lan(), n=n, loss=0.1, tcp_fallback=False,
        fail_per_round=0.01, rejoin_per_round=0.1, leave_per_round=0.002)


@pytest.mark.parametrize("rpc,stride", [(1, 2), (4, 4)])
def test_kernel_runner_rings_equal_record_of_cut_run(rpc, stride):
    n, rounds = 1024, 24
    p = _kp(n)
    key = prng.key(5)
    tracked = tbb.default_tracked(n, 128, "cpu")
    s0 = tstate.init_state(n, device="cpu")
    _, _, bb = cuda_round.make_run_rounds_cuda(
        p, rounds, rounds_per_call=rpc, flight_every=stride,
        blackbox=True)(tstate.init_state(n, device="cpu"), key,
                       tracked=tracked)
    want = tbb.init_blackbox(s0, tracked, p.blackbox_ring)
    s, sc = s0, None
    for done in range(0, rounds, stride):
        s, sc = cuda_round.make_run_rounds_cuda(
            p, stride, rounds_per_call=rpc, carry=True)(s, key, scalars0=sc)
        want = tbb.record(want, round_idx=done + stride - 1, phase=-1,
                          status=s.status, incarnation=s.incarnation,
                          susp_conf=s.susp_conf, up=s.up)
    _assert_bb_equal(bb, want)
    assert int(bb.count.sum()) > 50


@pytest.mark.parametrize("cls", ["flapping", "eclipse"])
def test_exhaustive_tracking_crosscheck_agrees(cls):
    """Every node tracked at stride 1 through ``run_chaos``: ring totals
    equal the flight counters exactly. The chaos config runs at 1% loss
    here: see the next test for what a loss-free cluster does."""
    n = 1024
    p = chaos_params(n).with_(loss=0.01)
    rep = run_chaos(cls, n=n, seed=1, device="cpu", blackbox=True,
                    p=p.with_(blackbox_k=n))
    bb = rep["blackbox"]
    assert bb["tracked"] == n and bb["dropped_events"] == 0
    assert bb["crosscheck_agree"] is True, bb["crosscheck"]
    key = "crash" if cls == "flapping" else "attack_suspect_start"
    assert bb["events"][key] > 0
    # the default sample tracks p.blackbox_k agents and cannot cross-check
    part = run_chaos(cls, n=n, seed=1, device="cpu", blackbox=True, p=p)
    assert part["blackbox"]["tracked"] == 64
    assert "crosscheck" not in part["blackbox"]
    assert part["phases"] == rep["phases"]


def test_same_round_declares_escape_the_state_diff():
    """In a loss-free cluster no probe fails, so the stale scalars'
    Lifeguard scale (lfail_num / lfail_den) is 0 and a crashed node is
    suspected AND declared in the round it is first probed: the flight
    counters count both, the state diff sees ALIVE -> DEAD and records
    neither. The same shortfall therefore opens on both columns, and
    the honest classes' exhaustive check needs some loss (the byzantine
    plans clamp the scale at 1, as the reference's body does)."""
    n = 1024
    rep = run_chaos("flapping", n=n, seed=1, device="cpu", blackbox=True,
                    p=chaos_params(n).with_(blackbox_k=n))
    cc = rep["blackbox"]["crosscheck"]
    gap = cc["suspect_start"]["flight"] - cc["suspect_start"]["ring"]
    assert gap > 0
    assert cc["declare_dead"]["flight"] - cc["declare_dead"]["ring"] == gap
    assert all(c["agree"] for k, c in cc.items()
               if k not in ("suspect_start", "declare_dead"))


def test_kernel_runner_rings_stamp_plan_phases():
    """The per-round kernel runner stamps rings with the plan's phases:
    one phase_enter per tracked agent and phase."""
    n = 512
    plan = chaos_plans(n)["flapping"]
    cp = tf.compile_plan(plan, n, "cpu")
    _, _, bb = cuda_round.make_run_rounds_cuda(
        chaos_params(n), plan.total_rounds, plan=cp, flight_every=5,
        blackbox=True)(tstate.init_state(n, device="cpu"), prng.key(0),
                       tracked=tbb.default_tracked(n, 16, "cpu"))
    tl = tbb.decode_timeline(bb)
    for node, t in tl.items():
        enters = [e for e in t["events"] if e["event"] == "phase_enter"]
        assert [e["detail"] for e in enters] == [0, 1, 2]
        assert [e["round"] for e in enters] == [4, 14, 74]
