"""consul_tpu_torch's flight recorder against the JAX reference.

* ``flight_row`` on the same warmed state as the reference's: counter
  columns exact, gauge columns within ``GAUGE_RTOL`` relative (PyTorch
  and XLA sum ``informed`` in different orders; every other gauge is an
  integer-valued sum, exact in f32).
* The window rule of ``record_row``/``maybe_record`` (the reference's
  ``lax.cond``, here a Python branch) over strides 1, 7 and 10 and a
  truncated final window: the same rows land in the same slots.
* ``stats_from_trace``, ``trace_report`` and ``phase_reports`` on the
  reference's own trace: equal.
* The live engine's ``run_rounds_flight`` against the reference's at
  4,096 nodes over 60 rounds of an honest and a byzantine chaos plan,
  with 64 tracked agents, at strides 1 and 7: every int lane, the
  counter columns and the rings exact, ``informed`` within
  ``ENGINE_ULPS`` (test_torch_faults's drift bound), the
  ``mean_informed`` gauge within ``GAUGE_RTOL``.
* The kernel runner's recorder on its CPU plain path: a stride-k trace
  equals ``flight_row`` of the same run cut at each window end, column
  sums equal the stats delta, megakernel rows equal a run cut at call
  boundaries, every refusal of the JAX runner is raised, the options
  leave the run's state bit for bit as it is, and ``run_chaos`` on the
  recorder reports the per-phase counts of the run cut at the phase
  starts that it replaced.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from consul_tpu_torch import faults as tf
from consul_tpu_torch.config import GossipConfig as TGossip
from consul_tpu_torch.sim import blackbox as tbb
from consul_tpu_torch.sim import cuda_round, flight, prng
from consul_tpu_torch.sim import coords as tcoords
from consul_tpu_torch.sim import metrics as tmetrics
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim import topology as ttopo
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.scenarios import chaos_params, chaos_plans, run_chaos
from test_torch_faults import ENGINE_ULPS, _ref_plan
from test_torch_harness import ref  # noqa: F401  (fixture)

#: relative bound on gauge columns that sum f32 ``informed`` values
GAUGE_RTOL = 1e-6
GAUGES = list(flight.GAUGE_COLUMNS)
COUNTERS = [f for f in tstate.STATS_FIELDS if f != "detect_latency_sum"]


def _ref_params(n, **kw):
    from consul_tpu.config import GossipConfig as RGossip
    from consul_tpu.sim.params import SimParams as RParams

    return RParams.from_gossip_config(RGossip.lan(), n=n,
                                      tcp_fallback=False, **kw)


def _assert_rows(a, b, gauge_rtol=GAUGE_RTOL):
    """Trace rows: counters exact, latency and gauges within bounds."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    for name, i in flight.COL.items():
        if name in COUNTERS:
            np.testing.assert_array_equal(a[:, i], b[:, i], err_msg=name)
        else:
            np.testing.assert_allclose(a[:, i], b[:, i], rtol=gauge_rtol,
                                       atol=0, err_msg=name)


def test_layout_and_sizes_match_reference(ref):
    from consul_tpu.sim import flight as rflight

    assert flight.FLIGHT_COLUMNS == rflight.FLIGHT_COLUMNS
    assert flight.COL == rflight.COL and flight.N_COLS == rflight.N_COLS
    assert flight.DEFAULT_RECORD_EVERY == rflight.DEFAULT_RECORD_EVERY
    for rounds, k in ((24, 5), (10, 10), (1, 3), (1000, 7)):
        assert flight.n_trace_rows(rounds, k) == \
            rflight.n_trace_rows(rounds, k)
        assert flight.trace_bytes(rounds, k) == rflight.trace_bytes(rounds,
                                                                   k)
    with pytest.raises(ValueError, match="record_every must be positive"):
        flight.n_trace_rows(5, 0)


@pytest.mark.parametrize("coords", [False, True])
def test_flight_row_matches_reference(ref, coords):
    import jax
    import jax.numpy as jnp

    from consul_tpu.sim import flight as rflight
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate

    n = 2048
    rp = _ref_params(n, loss=0.2, fail_per_round=0.01,
                     rejoin_per_round=0.05, slow_per_round=0.01)
    s0 = rstate.with_crashed(rstate.init_state(n), jnp.arange(0, n, 31))
    s1 = jax.device_get(rround.run_rounds(s0, jax.random.key(5), rp, 9)[0])
    assert (np.asarray(s1.status) == tstate.SUSPECT).any()
    rng = np.random.default_rng(0)
    delta = {f: np.asarray(rng.integers(0, 50), np.int32)
             for f in tstate.STATS_FIELDS}
    delta["detect_latency_sum"] = np.float32(123.5)
    crow = rng.random(3).astype(np.float32) if coords else None
    want = rflight.flight_row(
        up=s1.up, status=s1.status, informed=s1.informed,
        local_health=s1.local_health, incarnation=s1.incarnation, t=s1.t,
        stats_delta=rstate.SimStats(**delta), phase=jnp.int32(2),
        coord_row=None if crow is None else jnp.asarray(crow))
    ts = tstate.from_numpy(s1, "cpu")
    got = flight.flight_row(
        up=ts.up, status=ts.status, informed=ts.informed,
        local_health=ts.local_health, incarnation=ts.incarnation, t=ts.t,
        stats_delta=tstate.SimStats(**{f: torch.from_numpy(np.array(v))
                                       for f, v in delta.items()}),
        phase=2, coord_row=None if crow is None else torch.from_numpy(crow))
    assert got.dtype == torch.float32 and got.shape == (flight.N_COLS,)
    _assert_rows(got.numpy()[None], np.asarray(want)[None])
    # integer-valued gauges are exact; only mean_informed may differ
    exact = [flight.COL[c] for c in GAUGES if c != "mean_informed"]
    np.testing.assert_array_equal(got.numpy()[exact],
                                  np.asarray(want)[exact])


@pytest.mark.parametrize("stride", [1, 7, 10])
def test_window_rule_matches_reference(ref, stride):
    """Rows land where the reference's cond puts them, the truncated
    final window included (23 rounds: a short last window at 7 and
    10)."""
    import jax.numpy as jnp

    from consul_tpu.sim import flight as rflight

    rounds = 23
    rbuf = rflight.empty_trace(rounds, stride)
    tbuf = flight.empty_trace(rounds, stride, "cpu")
    recorded = []
    for i in range(rounds):
        row = np.full((flight.N_COLS,), float(i + 1), np.float32)

        def rrec(buf, row=row, i=i):
            return rflight.record_row(buf, jnp.asarray(row), jnp.int32(i),
                                      stride)

        def trec(buf, row=row, i=i):
            recorded.append(i)
            return flight.record_row(buf, torch.from_numpy(row), i, stride)

        rbuf = rflight.maybe_record(rbuf, jnp.int32(i), rounds, stride, rrec)
        tbuf = flight.maybe_record(tbuf, i, rounds, stride, trec)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(rbuf))
    ends = [i for i in range(rounds)
            if (i + 1) % stride == 0 or i == rounds - 1]
    assert recorded == ends
    assert len(ends) == flight.n_trace_rows(rounds, stride)


def test_trace_readers_and_reports_match_reference(ref):
    """``stats_from_trace``, ``trace_report`` and ``phase_reports`` on
    the reference's own stride-1 and stride-3 traces of a byzantine
    chaos plan: equal."""
    import jax

    from consul_tpu import faults as rf
    from consul_tpu.sim import flight as rflight
    from consul_tpu.sim import metrics as rmetrics
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate

    n = 512
    plan = chaos_plans(n)["eclipse"]
    rplan = _ref_plan(plan)
    rp, tp = _ref_params(n), chaos_params(n)
    cp = rf.compile_plan(rplan, n)
    for stride in (1, 3):
        _, tr = rround.run_rounds_flight(rstate.init_state(n),
                                         jax.random.key(1), rp, 120,
                                         record_every=stride, plan=cp)
        tr = np.array(jax.device_get(tr))
        for arg in (tr, torch.from_numpy(tr)):
            cols = flight.trace_columns(arg)
            want = rflight.trace_columns(tr)
            assert list(cols) == list(want)
            for c in cols:
                np.testing.assert_array_equal(cols[c], want[c])
            for k, plan_arg in ((None, None), (120, plan)):
                assert tmetrics.trace_report(
                    arg, tp, plan=plan_arg, record_every=stride,
                    rounds=k) == rmetrics.trace_report(
                    tr, rp, plan=None if plan_arg is None else rplan,
                    record_every=stride, rounds=k)
        if stride == 1:
            got = flight.stats_from_trace(tr)
            want = rflight.stats_from_trace(tr)
            for f in tstate.STATS_FIELDS:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            assert [r.to_dict() for r in tmetrics.phase_reports(
                got, plan, tp)] == [r.to_dict() for r in
                                    rmetrics.phase_reports(want, rplan, rp)]
    sweep = np.stack([tr, tr * 2])
    got = flight.sweep_trace_columns(sweep)
    want = rflight.sweep_trace_columns(sweep)
    assert len(got) == 2
    for g, w in zip(got, want):
        for c in g:
            np.testing.assert_array_equal(g[c], w[c])
    with pytest.raises(ValueError, match="not a flight trace"):
        flight.trace_columns(np.zeros((3, 4)))
    with pytest.raises(ValueError, match="not a sweep trace"):
        flight.sweep_trace_columns(tr)


@pytest.mark.parametrize("cls,stride,gain", [
    ("flapping", 1, 1.0), ("flapping", 7, 1.0), ("eclipse", 1, 1.0),
    ("eclipse", 7, 1.0), ("eclipse", 1, 0.0)])
def test_live_flight_run_matches_reference(ref, cls, stride, gain):
    """``fault_gain=0`` blends the plan away and disarms the attack mask
    of the rings, as the reference's runner does."""
    import jax

    from consul_tpu import faults as rf
    from consul_tpu.sim import blackbox as rbb
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate
    from test_torch_faults import _assert_states_equal

    n, rounds = 4096, 60
    plan = chaos_plans(n)[cls]
    tp = chaos_params(n).with_(fault_gain=gain)
    rp = _ref_params(n, fault_gain=gain)
    got = tround.run_rounds_flight(
        tstate.init_state(n, device="cpu"), prng.key(3), tp, rounds,
        record_every=stride, plan=tf.compile_plan(plan, n, "cpu"),
        tracked=tbb.default_tracked(n, 64, "cpu"))
    want = jax.device_get(rround.run_rounds_flight(
        rstate.init_state(n), jax.random.key(3), rp, rounds,
        record_every=stride, plan=rf.compile_plan(_ref_plan(plan), n),
        tracked=rbb.default_tracked(n, 64)))
    _assert_states_equal(tstate.to_numpy(got[0]), want[0], ENGINE_ULPS)
    _assert_rows(got[1].numpy(), want[1])
    assert got[1].shape[0] == flight.n_trace_rows(rounds, stride)
    for f in ("ring", "count", "prev_status", "prev_inc", "prev_conf",
              "prev_up", "tracked", "last_phase"):
        np.testing.assert_array_equal(getattr(got[2], f).numpy(),
                                      np.asarray(getattr(want[2], f)),
                                      err_msg=f)
    assert int(got[2].count.sum()) > 100
    cols = flight.trace_columns(got[1])
    if gain:
        assert cols["suspicions"].sum() > 0
    if cls == "eclipse":
        assert (cols["attack_suspicions"].sum() > 0) == (gain > 0)
        codes = set(got[2].ring[..., 1].reshape(-1).tolist())
        assert (tbb.EV["attack_suspect_start"] in codes) == (gain > 0)


def test_live_stats_runner_and_make_run_rounds(ref):
    """``run_rounds_stats`` stacks the reference's per-round stats;
    ``make_run_rounds`` is ``run_rounds``; the stride-1 flight counter
    columns are the per-round deltas of that stack."""
    import jax

    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate

    n, rounds = 1024, 25
    kw = dict(loss=0.2, fail_per_round=0.002, rejoin_per_round=0.02)
    tp = SimParams.from_gossip_config(TGossip.lan(), n=n,
                                      tcp_fallback=False, **kw)
    rp = _ref_params(n, **kw)
    fin, st = tround.run_rounds_stats(tstate.init_state(n, device="cpu"),
                                      prng.key(1), tp, rounds)
    rfin, rst = jax.device_get(rround.run_rounds_stats(
        rstate.init_state(n), jax.random.key(1), rp, rounds))
    for f in tstate.STATS_FIELDS:
        assert getattr(st, f).shape == (rounds,)
        if f == "detect_latency_sum":
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       np.asarray(getattr(rst, f)),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(rst, f)))
    assert int(st.crashes[-1]) > 0
    again = tround.make_run_rounds(tp, rounds)(
        tstate.init_state(n, device="cpu"), prng.key(1))
    for x, y in zip(tstate.to_numpy(again)[:8], tstate.to_numpy(fin)[:8]):
        np.testing.assert_array_equal(x, y)
    _, tr = tround.run_rounds_flight(tstate.init_state(n, device="cpu"),
                                     prng.key(1), tp, rounds)
    for f in COUNTERS:
        np.testing.assert_array_equal(
            flight.stats_from_trace(tr).__getattribute__(f),
            getattr(st, f).numpy().astype(np.float64))


# ------------------------------------------------ the kernel runner


def _kp(n, **kw):
    return SimParams.from_gossip_config(
        TGossip.lan(), n=n, loss=0.05, tcp_fallback=False,
        slow_per_round=0.01, fail_per_round=0.003, rejoin_per_round=0.03,
        **kw)


def _row_of(s, delta, phase=-1):
    return flight.flight_row(up=s.up, status=s.status, informed=s.informed,
                             local_health=s.local_health,
                             incarnation=s.incarnation, t=s.t,
                             stats_delta=delta, phase=phase)


def _assert_same_state(a, b):
    for f in tstate.NODE_FIELDS + ("t", "round_idx"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
    for f in tstate.SimStats._fields:
        np.testing.assert_array_equal(getattr(a.stats, f).numpy(),
                                      getattr(b.stats, f).numpy(),
                                      err_msg=f)


def _clone(s):
    return tstate.SimState(*[x.clone() for x in s[:-1]],
                           stats=tstate.SimStats(*[x.clone()
                                                   for x in s.stats]))


@pytest.mark.parametrize("rpc,stride", [(1, 7), (4, 8)])
def test_kernel_runner_trace_equals_rows_of_cut_run(rpc, stride):
    """A stride-k trace equals ``flight_row`` of the same run cut at each
    window end (``carry=True``); on the megakernel the cuts are call
    boundaries. Column sums equal the run's stats delta exactly."""
    n, rounds = 2048, 24 if rpc > 1 else 30
    p = _kp(n)
    key = prng.key(4)
    s0 = tstate.with_crashed(tstate.init_state(n, device="cpu"),
                             torch.arange(0, n, 97))
    fin, trace = cuda_round.make_run_rounds_cuda(
        p, rounds, rounds_per_call=rpc, flight_every=stride)(_clone(s0), key)
    rows, s, sc, done = [], _clone(s0), None, 0
    while done < rounds:
        step = min(stride, rounds - done)
        prev = s.stats
        s, sc = cuda_round.make_run_rounds_cuda(
            p, step, rounds_per_call=rpc, carry=True)(s, key, scalars0=sc)
        rows.append(_row_of(s, flight.stats_delta(s.stats, prev)))
        done += step
    np.testing.assert_array_equal(trace.numpy(), torch.stack(rows).numpy())
    _assert_same_state(fin, s)
    cols = flight.trace_columns(trace)
    for f in COUNTERS:
        assert int(cols[f].sum()) == int(getattr(fin.stats, f)) \
            - int(getattr(s0.stats, f)), f
    np.testing.assert_allclose(cols["detect_latency_sum"].sum(),
                               float(fin.stats.detect_latency_sum),
                               rtol=1e-6)
    assert cols["crashes"].sum() > 0 and cols["suspicions"].sum() > 0
    # the last row is the final state's
    np.testing.assert_array_equal(trace[-1, :len(GAUGES) - 1].numpy(),
                                  _row_of(fin, fin.stats)[:len(GAUGES) - 1]
                                  .numpy())


REFUSALS = {
    "plan_with_megakernel": (dict(rounds_per_call=4, plan=True),
                             "megakernel freezes its inputs"),
    "coords_with_megakernel": (dict(rounds_per_call=4, coords=True),
                               "coords updates run between kernel"),
    "rounds_not_multiple": (dict(rounds_per_call=3), "must be a multiple"),
    "flight_without_stats": (dict(flight_every=4, stats=False),
                             "rides the kernel's stats lanes"),
    "mega_flight_without_stats": (dict(rounds_per_call=4, flight_every=4,
                                       stats=False),
                                  "rides the kernel's stats lanes"),
    "mega_stride_not_multiple": (dict(rounds_per_call=4, flight_every=6),
                                 "must be a multiple of it"),
    "blackbox_without_flight": (dict(blackbox=True),
                                "pass flight_every"),
    "mega_blackbox_without_flight": (dict(rounds_per_call=4, blackbox=True),
                                     "pass flight_every"),
    "coords_with_coords_timeout": (dict(coords=True, coords_timeout=True),
                                   "coords_timeout gates each probe"),
    "rounds_per_call_zero": (dict(rounds_per_call=0),
                             "rounds_per_call must be >= 1"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_kernel_runner_refuses_what_the_reference_refuses(case):
    kw, msg = dict(REFUSALS[case][0]), REFUSALS[case][1]
    n = 256
    p = _kp(n).with_(collect_stats=kw.pop("stats", True),
                     coords_timeout=kw.pop("coords_timeout", False))
    if kw.pop("plan", False):
        kw["plan"] = tf.compile_plan(chaos_plans(n)["flapping"], n, "cpu")
    with pytest.raises(ValueError, match=msg):
        cuda_round.make_run_rounds_cuda(p, 10 if case ==
                                        "rounds_not_multiple" else 8, **kw)


def test_kernel_runner_refuses_missing_call_arguments():
    n = 256
    p = _kp(n)
    s = tstate.init_state(n, device="cpu")
    with pytest.raises(ValueError, match="needs a tracked id tensor"):
        cuda_round.make_run_rounds_cuda(p, 4, flight_every=2,
                                        blackbox=True)(s, prng.key(0))
    with pytest.raises(ValueError, match="needs coo="):
        cuda_round.make_run_rounds_cuda(p, 4, coords=True)(s, prng.key(0))
    with pytest.raises(ValueError, match="scalars0 needs a carry=True"):
        cuda_round.make_run_rounds_cuda(p, 4)(s, prng.key(0),
                                              scalars0=torch.ones(8))


def test_kernel_runner_options_leave_the_run_unchanged():
    """With every option off the runner is the loop of ``round_kernel``
    launches it always was; the recorder, the black box and the
    coordinates leave the state bit for bit as it is, on the per-round
    and on the R=4 runner, with a plan and without."""
    n, rounds = 2048, 16
    p = _kp(n)
    key = prng.key(9)
    s0 = tstate.with_crashed(tstate.init_state(n, device="cpu"),
                             torch.arange(0, n, 61))
    bare = cuda_round.make_run_rounds_cuda(p, rounds, carry=True)(
        _clone(s0), key)
    # the same launches by hand
    arrays = tuple(a.clone() for a in s0.node_arrays())
    sc = tround.init_scalars(s0, p)
    seeds = prng.round_seeds(key, 0, rounds)
    for r in range(rounds):
        part = cuda_round.round_kernel(arrays, sc, seeds, r, p)
        sc = tround.clamp_scalars(part.sum(0)[:tround.N_SCALARS])
    for x, y in zip(arrays, bare[0].node_arrays()):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(sc.numpy(), bare[1].numpy())

    topo = ttopo.make_topology(ttopo.TopologyParams(n=n), "cpu")
    armed = cuda_round.make_run_rounds_cuda(
        p, rounds, carry=True, flight_every=3, blackbox=True, coords=True)(
        _clone(s0), key, coo=tcoords.init_coords(n, device="cpu"),
        topo=topo, tracked=tbb.default_tracked(n, 16, "cpu"))
    assert len(armed) == 5
    _assert_same_state(armed[0], bare[0])
    np.testing.assert_array_equal(armed[-1].numpy(), bare[1].numpy())

    for rpc, plan in ((4, None),
                      (1, tf.compile_plan(chaos_plans(n)["eclipse"], n,
                                          "cpu"))):
        a = cuda_round.make_run_rounds_cuda(p, rounds, rounds_per_call=rpc,
                                            plan=plan)(_clone(s0), key)
        b = cuda_round.make_run_rounds_cuda(
            p, rounds, rounds_per_call=rpc, plan=plan, flight_every=4,
            blackbox=True)(_clone(s0), key,
                           tracked=tbb.default_tracked(n, 16, "cpu"))
        _assert_same_state(b[0], a)


def test_run_chaos_on_the_recorder_matches_the_cut_run():
    """The per-phase counts of ``run_chaos`` (one run on the recorder)
    equal those of the run cut at each phase start that it replaced,
    and its ``flight`` report sums to them."""
    n = 2048
    for name in ("flapping", "eclipse"):
        plan = chaos_plans(n)[name]
        p = chaos_params(n)
        cp = tf.compile_plan(plan, n, "cpu")
        rep = run_chaos(name, n=n, seed=2, device="cpu", cp=cp)
        s, sc, prev = tstate.init_state(n, device="cpu"), None, None
        for ph, got in zip(plan.phases, rep["phases"]):
            s, sc = cuda_round.make_run_rounds_cuda(
                p, ph.rounds, carry=True, plan=cp)(
                s, prng.key(2), scalars0=sc)
            for f in ("suspicions", "refutes", "false_positives",
                      "true_deaths_declared", "crashes", "rejoins",
                      "leaves", "attack_suspicions",
                      "attack_false_positives"):
                d = int(getattr(s.stats, f)) - (0 if prev is None
                                                else int(getattr(prev, f)))
                assert got[f] == d, (name, ph.name, f)
            prev = s.stats
        for got, fl in zip(rep["phases"], rep["flight"]["phases"]):
            assert got["suspicions"] == fl["suspicions"]
            assert len(fl["curve"]["round"]) == got["rounds"]
        assert "blackbox" not in rep


def test_chip_smoke_observe_phase_on_the_plain_path():
    """``chip_smoke.py``'s observe phase, rehearsed on the CPU at small
    sizes: the recorders' checks, exhaustive tracking, the coordinates'
    convergence and the coordinates cell's path against its plain route
    all pass (the launch counts and the device timings need the
    card)."""
    import chip_smoke

    m = chip_smoke.modules()
    rec, bad, _ = chip_smoke.observe_recorders(
        torch, m, "cpu", n=4096, rounds=20, stride=10, mega_rounds=16,
        mega_stride=8)
    assert bad == [] and rec["per_round"]["rows"] == 2
    assert rec["mega"]["rows"] == 2 and rec["per_round"]["suspicions"] > 0
    assert rec["per_round"]["blackbox"]["tracked"] == 64
    track, bad, _ = chip_smoke.observe_tracking(m, "cpu", n=1024)
    assert bad == [] and set(track) == set(chip_smoke.TRACK_CLASSES)
    assert all(t["crosscheck_agree"] for t in track.values())
    coords, bad, _, coo, _ = chip_smoke.observe_coords(torch, m, "cpu",
                                                       n=4096)
    assert bad == [], coords["rtt_err_med"]
    assert len(coords["rtt_err_med"]) == chip_smoke.COORD_ROUNDS // \
        chip_smoke.COORD_STRIDE
    assert coo.vec.shape == (4096, tcoords.DIMENSION)
    live, bad, launches = chip_smoke.observe_coords_flight(
        torch, m, "cpu", n=1024, rounds=8, stride=4)
    assert bad == [] and launches == {}, live
    assert live["trace_gap"] == 0.0 and live["coords_max_abs_err"] == 0.0
    # a broken recorder is caught: a trace whose counters miss a round
    s0 = tstate.init_state(512, device="cpu")
    p = m.bench.diag_params(512)
    fin, tr = cuda_round.make_run_rounds_cuda(p, 10, flight_every=5)(
        _clone(s0), prng.key(0))
    assert chip_smoke.recorder_failures(m, s0, fin, tr, "x") == []
    tr[0, flight.COL["suspicions"]] += 1
    tr[-1, flight.COL["mean_informed"]] += 0.5
    assert len(chip_smoke.recorder_failures(m, s0, fin, tr, "x")) == 2
