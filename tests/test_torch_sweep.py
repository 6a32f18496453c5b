"""consul_tpu_torch's sweep engine against the JAX reference.

* ``grid_params`` ships the reference's leaves (names, values, dtypes:
  int32 for the int leaves, f32 otherwise, folded on the host in f64),
  ``TracedParams`` / ``SweepAxes`` refuse what the reference refuses.
* The swept-k detection gate equals the static gate of each point
  exactly (and the reference's traced gate); ``scale_frame`` with a
  ``[G, 1]`` gain equals the scalar blend of each point exactly.
* Every grid point is bit for bit its one-point run (``make_run_point``)
  on the xla and lanes engines, over the 64-point autotune grid, with
  the flight recorder; the cuda engine's plain path is bit for bit the
  per-point ``make_run_rounds_cuda``.
* A grid against the reference's ``run_sweep`` (xla and lanes, with a
  fault plan and a swept ``fault_gain``): every int lane and counter
  exact, ``informed`` within ``ENGINE_ULPS``, traces within
  ``GAUGE_ATOL``; ``sweep_report`` / ``pareto_front`` equal on the same
  numbers; ``run_autotune`` and ``run_byzantine_defense`` at 1,024
  nodes pick the reference's constants and k.
* No sweep leaf reaches Python control flow: every engine runs with
  every sweepable field swept (a two-row leaf has no truth value, so a
  Python branch on one raises).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from consul_tpu_torch import faults as tf
from consul_tpu_torch.sim import cuda_round, flight, prng, sweep
from consul_tpu_torch.sim import params as tparams
from consul_tpu_torch.sim import scenarios as tscen
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.metrics import pareto_front, sweep_report
from test_torch_faults import _byz_plan, _honest_plan, _ref_plan
from test_torch_harness import ref  # noqa: F401  (fixture)

KW = dict(n=256, loss=0.01, tcp_fallback=False, fail_per_round=0.002,
          rejoin_per_round=0.02, slow_per_round=0.001)
P = tparams.SimParams(**KW)
GRID = {"gossip_nodes": [2, 3, 4, 5], "suspicion_mult": [1, 2, 4, 6],
        "gossip_interval": [0.1, 0.2, 0.35, 0.5]}
AXES = tparams.SweepAxes.of(**GRID)
ROUNDS = 10
ENGINE_ULPS = 64
GAUGE_ATOL = 1e-6


def _rparams(**kw):
    from consul_tpu.sim.params import SimParams

    return SimParams(**{**KW, **kw})


def _all_sweep_points():
    """Two points sweeping EVERY sweepable field (the reference test's
    maximal surface)."""
    base = {
        "probe_interval": (1.0, 1.2), "probe_timeout": (0.5, 0.6),
        "gossip_interval": (0.2, 0.25), "gossip_nodes": (3, 4),
        "suspicion_mult": (4, 5), "suspicion_max_timeout_mult": (6, 5),
        "awareness_max": (8, 6), "loss": (0.01, 0.05),
        "tcp_fail": (0.0, 0.1), "slow_per_round": (0.001, 0.002),
        "slow_recover_per_round": (0.05, 0.1),
        "slow_factor": (0.1, 0.2), "coord_timeout_mult": (3.0, 2.0),
        "fail_per_round": (0.002, 0.004),
        "rejoin_per_round": (0.02, 0.04),
        "leave_per_round": (0.0, 0.001), "fault_gain": (1.0, 0.5),
        "corroboration_k": (0, 2),
    }
    assert set(base) == set(tparams.SWEEPABLE_FIELDS)
    return [{k: v[i] for k, v in base.items()} for i in range(2)]


@pytest.mark.parametrize("which", ["autotune", "all_fields"])
def test_grid_params_leaves_match_reference(ref, which):
    from consul_tpu.sim import params as rparams

    spec_t = AXES if which == "autotune" else _all_sweep_points()
    spec_r = rparams.SweepAxes.of(**GRID) if which == "autotune" \
        else _all_sweep_points()
    tp, points = tparams.grid_params(P, spec_t, "cpu")
    rtp, rpoints = rparams.grid_params(_rparams(), spec_r)
    assert sorted(tp.leaves) == sorted(rtp.leaves)
    for k, v in tp.leaves.items():
        want = np.asarray(rtp.leaves[k])
        assert v.shape == (len(points), 1)
        assert v.numpy().dtype == want.dtype, k
        assert np.array_equal(v.numpy().reshape(-1), want), k
    assert [pp.__dict__ for pp in points] == [pp.__dict__ for pp in rpoints]
    assert tp.grid_shape == (len(points),)
    pt = tparams.point_params(tp, 1)
    assert pt.point and pt.grid_shape == ()
    assert all(torch.equal(pt.leaves[k], v[1:2]) for k, v in tp.leaves.items())


def test_sweep_axes_and_traced_params_refuse_as_the_reference(ref):
    for fn, match in (
            (lambda: tparams.SweepAxes.of(n=[256, 512]), "STATIC"),
            (lambda: tparams.SweepAxes.of(bogus=[1.0]),
             "not a SimParams field"),
            (lambda: tparams.SweepAxes.of(loss=[]), "no values"),
            (lambda: tparams.grid_params(
                P, tparams.SweepAxes.of(gossip_nodes=[2.5]), "cpu"),
             "integer-valued"),
            (lambda: tparams.grid_params(P, [{"loss": 0.1}, {}], "cpu"),
             "same fields"),
            (lambda: tparams.grid_params(P, [], "cpu"), "empty"),
            (lambda: tparams.TracedParams(P, {"n": torch.ones(1)}),
             "not sweepable")):
        with pytest.raises(ValueError, match=match):
            fn()
    tp = tparams.TracedParams(P, {"suspicion_mult": torch.tensor([[5.0]])})
    with pytest.raises(AttributeError, match="derived"):
        _ = tp.suspicion_min_s
    assert tp.loss == P.loss
    assert tp.enabled("fail_per_round") and tp.sweeps("suspicion_mult")
    assert not tp.sweeps("loss") and not P.sweeps("loss")
    assert tparams.TracedParams(P, {"slow_per_round": torch.zeros(2, 1)}
                                ).enabled("slow_per_round")
    assert tp.has_churn
    assert AXES.size == 64 and len(AXES.points()) == 64


@pytest.mark.parametrize("forge", [False, True])
def test_swept_k_gate_equals_the_static_gate_per_point(ref, forge):
    import jax.numpy as jnp

    from consul_tpu import faults as rf
    from consul_tpu.sim import params as rparams

    n = 512
    plan = _byz_plan(n)
    tcp = tf.compile_plan(plan, n, "cpu")
    rcp = rf.compile_plan(_ref_plan(plan), n)
    fx = tf.fault_frame(tcp, 3) if forge else None
    rfx = rf.fault_frame(rcp, 3) if forge else None
    up = torch.from_numpy(np.random.default_rng(1).random(n) < 0.8)
    tp, points = tparams.grid_params(
        P.with_(n=n), [{"corroboration_k": k, "loss": loss}
                       for k in (0, 1, 2, 3) for loss in (0.0, 0.2)],
        "cpu")
    gate = tf.detection_gate(up, fx, tp)
    rtp, _ = rparams.grid_params(_rparams(n=n),
                                 [{"corroboration_k": k, "loss": loss}
                                  for k in (0, 1, 2, 3)
                                  for loss in (0.0, 0.2)])
    for i, pp in enumerate(points):
        # the static gate of a point is 0-d where no lane enters it
        static = tf.detection_gate(up, fx, pp)
        assert torch.equal(gate[i], static.expand(n)), i
        rpt = type(rtp)(rtp.static, {k: v[i] for k, v in
                                     rtp.leaves.items()})
        want = np.asarray(rf.detection_gate(jnp.asarray(up.numpy()), rfx,
                                            rpt))
        assert np.array_equal(gate[i].numpy(),
                              np.broadcast_to(want, (n,))), i


def test_scale_frame_with_a_grid_gain_equals_each_scalar_blend():
    n = 256
    cp = tf.compile_plan(_byz_plan(n), n, "cpu")
    fx = tf.fault_frame(cp, 3)
    gains = [0.0, 0.25, 1.0]
    g = torch.tensor(gains, dtype=torch.float32).view(-1, 1)
    grid = tf.scale_frame(fx, g)
    for i, gain in enumerate(gains):
        one = tf.scale_frame(fx, gain)
        for name in tf.FaultFrame._fields:
            a, b = getattr(grid, name), getattr(one, name)
            assert torch.equal(a[i].reshape(b.shape), b), (name, gain)


def _assert_points_equal(a: tstate.SimState, b: tstate.SimState):
    for f in tstate.NODE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.stats, b.stats):
        assert torch.equal(x, y)
    assert torch.equal(a.t, b.t) and torch.equal(a.round_idx, b.round_idx)


@pytest.mark.parametrize("engine", ["xla", "lanes"])
def test_every_grid_point_is_its_one_point_run(engine):
    key = prng.key(7)
    res = sweep.run_sweep(P, AXES, ROUNDS, key=key, engine=engine,
                          flight_every=2, device="cpu")
    assert res.states.status.shape == (64, P.n)
    assert res.trace.shape == (64, ROUNDS // 2, flight.N_COLS)
    for i in range(64):
        st, tr = sweep.solo_reference(res, i, P, key, engine=engine,
                                      device="cpu")
        _assert_points_equal(sweep.take_point(res.states, i), st)
        assert torch.equal(sweep.point_trace(res, i), tr), i


@pytest.mark.parametrize("rpc", [1, 8])
def test_cuda_engine_plain_path_is_the_per_point_runner(rpc):
    n, rounds = 1024, 16
    p = tscen.autotune_params("lan", n)
    axes = tparams.SweepAxes.of(gossip_nodes=[2, 3, 4, 5])
    key = prng.key(9)
    cuda_round.reset_launches()
    res = sweep.run_sweep(p, axes, rounds, key=key, engine="cuda",
                          rounds_per_call=rpc, flight_every=8,
                          device="cpu")
    assert dict(cuda_round.LAUNCHES) == {}   # the plain versions
    for i, pp in enumerate(res.points):
        st, tr = cuda_round.make_run_rounds_cuda(
            pp, rounds, rounds_per_call=rpc, flight_every=8)(
            tstate.init_state(n, device="cpu"), key)
        _assert_points_equal(sweep.take_point(res.states, i), st)
        assert torch.equal(res.trace[i], tr)
    # the points are rebuilt from the leaves when no list is given
    tp, points = tparams.grid_params(p, axes, "cpu")
    run = sweep.make_run_sweep(p, rounds, engine="cuda",
                               rounds_per_call=rpc, device="cpu")
    states, _ = run(tp, key)
    _assert_points_equal(sweep.take_point(states, 2),
                         sweep.take_point(res.states, 2))


def test_sweep_maker_refusals():
    tp, _ = tparams.grid_params(P, tparams.SweepAxes.of(loss=[0.0, 0.1]),
                                "cpu")
    for fn, match in (
            (lambda: sweep.make_run_sweep(P.with_(collect_stats=False), 4,
                                          flight_every=1, device="cpu"),
             "collect_stats"),
            (lambda: sweep.make_run_sweep(P, 4, engine="lanes", coords=True,
                                          device="cpu"), "XLA engine"),
            (lambda: sweep.make_run_sweep(P, 4, engine="bogus",
                                          device="cpu"),
             "unknown sweep engine"),
            (lambda: sweep.make_run_sweep(P, 4, engine="cuda", coords=True,
                                          device="cpu"), "XLA engine"),
            (lambda: sweep.make_run_sweep(
                P, 4, engine="cuda", plan=tf.compile_plan(
                    _honest_plan(256), 256, "cpu"), device="cpu"),
             "freezes its inputs"),
            (lambda: sweep.make_run_sweep(P, 6, engine="cuda",
                                          rounds_per_call=4, device="cpu"),
             "multiple of"),
            (lambda: sweep.make_run_sweep(P, 4, engine="lanes",
                                          rounds_per_call=8, device="cpu"),
             "engine='cuda'"),
            (lambda: sweep.make_run_sweep(P.with_(n=100), 4,
                                          engine="lanes", device="cpu"),
             "block table"),
            (lambda: sweep.make_run_sweep(P, 4, device="cpu")(
                tparams.point_params(tp, 0), prng.key(0)), "grid"),
            (lambda: sweep.make_run_point(P, 4, device="cpu")(
                tp, prng.key(0)), "point"),
            (lambda: sweep.make_run_point(P, 4, engine="cuda",
                                          device="cpu"), "oracle"),
            (lambda: sweep.run_sweep(
                P, tparams.SweepAxes.of(awareness_max=[8, 9]), 4,
                engine="lanes", flight_every=2, device="cpu"),
             "awareness_max")):
        with pytest.raises(ValueError, match=match):
            fn()


def test_no_sweep_leaf_reaches_python_control_flow():
    """Every engine runs with EVERY sweepable field swept over two
    points: a ``[2, 1]`` leaf has no truth value, so an ``if`` on one
    anywhere in the round body, the gate or the frame raises here."""
    p = tparams.SimParams(n=256, tcp_fallback=True, coords_timeout=True)
    plan = tf.compile_plan(tf.FaultPlan(phases=(
        tf.Phase(rounds=2, name="a"),
        tf.Phase(rounds=4, faults=(tf.Partition(a=(0, 32), b=(32, 256)),),
                 name="b"))), 256, "cpu")
    tp, _ = tparams.grid_params(p, _all_sweep_points(), "cpu")
    key = prng.key(3)
    s, tr = sweep.make_run_sweep(p, 6, flight_every=2, plan=plan,
                                 device="cpu")(tp, key)
    assert tr.shape == (2, 3, flight.N_COLS) and s.status.shape == (2, 256)
    s, _ = sweep.make_run_sweep(p, 6, engine="lanes", plan=plan,
                                device="cpu")(tp, key)
    assert int(s.round_idx[1]) == 6
    s, _ = sweep.make_run_point(p, 6, flight_every=2, plan=plan,
                                device="cpu")(tparams.point_params(tp, 1),
                                              key)
    assert s.status.shape == (256,)
    with pytest.raises(RuntimeError, match="ambiguous"):
        bool(tp.loss)


def _ref_sweep(engine, plan=None, grid=None, flight_every=2):
    import jax

    from consul_tpu import faults as rf
    from consul_tpu.sim import params as rparams
    from consul_tpu.sim import sweep as rsweep

    rcp = rf.compile_plan(_ref_plan(plan), P.n) if plan else None
    return rsweep.run_sweep(_rparams(), rparams.SweepAxes.of(**grid),
                            ROUNDS, key=jax.random.key(7), engine=engine,
                            flight_every=flight_every, plan=rcp)


CASES = {"xla": ("xla", None, GRID), "lanes": ("lanes", None, GRID),
         "xla_plan_gain": ("xla", "honest",
                           {"fault_gain": [0.0, 0.5, 1.0],
                            "corroboration_k": [0, 2]}),
         "lanes_byz_gain": ("lanes", "byz",
                            {"fault_gain": [0.0, 1.0],
                             "loss": [0.0, 0.05]})}


@pytest.mark.parametrize("case", list(CASES))
def test_grid_matches_the_reference_run_sweep(ref, case):
    """The reference's vmapped sweep on jax 0.9 (through the harness's
    shim) against the port's grid on the same key."""
    import jax

    from consul_tpu.sim import metrics as rmetrics

    engine, plan_name, grid = CASES[case]
    plan = {"honest": _honest_plan, "byz": _byz_plan}[plan_name](P.n) \
        if plan_name else None
    want = _ref_sweep(engine, plan, grid)
    got = sweep.run_sweep(
        P, tparams.SweepAxes.of(**grid), ROUNDS, key=prng.key(7),
        engine=engine, flight_every=2, device="cpu",
        plan=tf.compile_plan(plan, P.n, "cpu") if plan else None)
    ws = jax.device_get(want.states)
    for f in tstate.NODE_FIELDS:
        x, y = getattr(got.states, f).numpy(), np.asarray(getattr(ws, f))
        assert x.dtype == y.dtype, f
        if f == "informed":
            spacing = np.maximum(np.abs(y) * 2.0 ** -23, 2.0 ** -149)
            assert (np.abs(x.astype(np.float64) - y) / spacing).max() \
                <= ENGINE_ULPS
        else:
            assert np.array_equal(x, y), f
    for f in tstate.SimStats._fields:
        x, y = getattr(got.states.stats, f).numpy(), \
            np.asarray(getattr(ws.stats, f))
        if f == "detect_latency_sum":
            np.testing.assert_allclose(x, y, rtol=1e-6)
        else:
            assert np.array_equal(x, y), f
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace),
                               rtol=1e-6, atol=GAUGE_ATOL)
    # the report on the same numbers
    a, b = sweep_report(got), rmetrics.sweep_report(want)
    assert a["pareto"] == b["pareto"] and a["swept"] == b["swept"]
    for x, y in zip(a["points"], b["points"]):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], float):
                assert x[k] == pytest.approx(y[k], rel=1e-6), k
            else:
                assert x[k] == y[k], k
    assert a["winner"]["point"] == b["winner"]["point"]


def test_pareto_front_and_message_load_match_reference(ref):
    from consul_tpu.sim import metrics as rmetrics

    rows = [{"lat": 1.0, "fp": 1.0, "load": 5.0},
            {"lat": 2.0, "fp": 0.5, "load": 5.0},
            {"lat": 2.0, "fp": 1.0, "load": 6.0},
            {"lat": None, "fp": 0.0, "load": 4.0},
            {"lat": None, "fp": 0.0, "load": 4.5}]
    keys = ("lat", "fp", "load")
    assert pareto_front(rows, keys) == rmetrics.pareto_front(rows, keys) \
        == [0, 1, 3]
    from consul_tpu_torch.sim.metrics import message_load

    for kw in ({}, {"loss": 0.1, "tcp_fallback": True},
               {"gossip_nodes": 5, "gossip_interval": 0.1}):
        assert message_load(P.with_(**kw)) == \
            rmetrics.message_load(_rparams(**kw))


@pytest.mark.parametrize("scenario", ["autotune", "defense"])
def test_scenarios_pick_the_references_constants(ref, scenario):
    from consul_tpu.sim import scenarios as rscen

    if scenario == "autotune":
        want = rscen.run_autotune("lan", n=1024, rounds=100)
        got = tscen.run_autotune("lan", n=1024, rounds=100, device="cpu")
        assert got["chosen"] == want["chosen"]
        assert got["pareto"] == want["pareto"]
        assert got["grid_size"] == 64 and got["topology"] == "lan"
        with pytest.raises(ValueError, match="unknown autotune topology"):
            tscen.run_autotune("underwater", n=256, rounds=4, device="cpu")
    else:
        want = rscen.run_byzantine_defense(n=1024, rounds=100)
        got = tscen.run_byzantine_defense(n=1024, rounds=100, device="cpu")
        assert got["best_k"] == want["best_k"] >= 1
        for k in ("attack_induced_missed_rate",
                  "honest_mean_detect_latency_s"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        ind = got["attack_induced_missed_rate"]
        assert ind[got["ks"].index(got["best_k"])] < ind[0]


def test_autotune_params_and_baseline_config():
    for t in tscen.AUTOTUNE_TOPOLOGIES:
        p = tscen.autotune_params(t, 512)
        assert p.n == 512 and p.fail_per_round == 0.002
    assert tscen.autotune_params("wan", 512).probe_interval == 5.0
    rep = tscen.run_baseline_config("1k-lan-nolifeguard", rounds=20,
                                    device="cpu")
    assert rep["config"] == "1k-lan-nolifeguard" and rep["rounds"] == 20
    assert rep["false_positives"] == 0 and rep["live_fraction"] == 1.0


def test_bench_sweep_class_and_defense_on_the_plain_path():
    from consul_tpu_torch import bench

    rep, result, key = bench.run_sweep_class("lossy", 256, 12, "cpu")
    assert rep["grid_size"] == 64 and rep["engine"] == "xla"
    assert rep["steady_s"] > 0 and rep["scenario_rounds_per_sec"] > 0
    assert rep["pareto"] and set(rep["chosen"]) == set(
        tscen.AUTOTUNE_GRID)
    assert result.states.status.shape == (64, 256)
    assert bench.SWEEP_SIZE == (65_536, 300)
    assert bench.DEFENSE_SIZE == (4_096, 200)


def test_chip_smoke_sweep_phase_on_the_plain_path():
    """``chip_smoke.py``'s sweep phase, rehearsed on the CPU at small
    sizes: grid rows bit for bit their one-point runs, the cuda engine
    bit for bit its per-point runner, the lane engine's column sums the
    stats delta (its FD band needs the full pool and warm-up)."""
    m = chip_smoke.modules()
    grid, bad = chip_smoke.sweep_grid(torch, m, "cpu", n=512, rounds=12)
    assert bad == []
    assert all(s["bitwise"] for e in grid.values()
               for s in e["solo"].values())
    cuda, bad, launches = chip_smoke.sweep_cuda(torch, m, "cpu", n=1024,
                                                rounds=16)
    assert bad == [] and launches == {}
    assert cuda["R=8"]["bitwise"] and cuda["R=1"]["bitwise"]
    lanes, bad = chip_smoke.sweep_lanes(torch, m, "cpu", n=1024,
                                        warm_rounds=8, rounds=8, stride=4)
    assert all("FD band" in b for b in bad), bad
    assert lanes["stale_k=4"]["rows"] == 2


def test_chip_smoke_sweep_grid_fails_on_any_solo_difference(monkeypatch):
    """A grid row that is not bit for bit its one-point run fails the
    phase, however small the difference."""
    solo = sweep.solo_reference

    def off_by_one(*a, **kw):
        st, trace = solo(*a, **kw)
        return st._replace(t=st.t + 1), trace

    monkeypatch.setattr(sweep, "solo_reference", off_by_one)
    grid, bad = chip_smoke.sweep_grid(torch, chip_smoke.modules(), "cpu",
                                      n=256, rounds=4)
    assert len(bad) == 2 * len(chip_smoke.SWEEP_SOLO_POINTS), bad
    assert all(s["diffs"] == {"t": 1} for e in grid.values()
               for s in e["solo"].values())
