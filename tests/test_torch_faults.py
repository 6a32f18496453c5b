"""consul_tpu_torch's fault plans against the JAX reference.

* The plan fold and the tensor half: ``_phase_arrays``, every
  ``compile_plan`` leaf, ``plan_digest`` and ``fault_frame`` for every
  round of a plan and five past its end equal ``consul_tpu.faults``
  exactly, for plans covering all ten primitives; the validation
  refusals of the reference's tests are ported.
* ``detection_gate`` for corroboration_k 0..3, with and without forged
  acks, equals the reference's exactly.
* One round of ``round_core`` with a fault frame against the reference
  ``_round_core(fx=..., u01=...)`` on the same injected uniforms (the
  sixth slot is the reference's ``fold_in(key, 0xB12A)`` replay draw),
  live and stale: every int lane, ``informed`` and the counters exact,
  the stale scalars within 1e-5 relative.
* The threefry engines with a plan reproduce the reference's states
  over several rounds: int lanes and counters exact, ``informed``
  within ``ENGINE_ULPS`` — PyTorch's and XLA's CPU ``exp`` differ in
  the last bit for about one argument in ten, and a fault plan keeps
  many more nodes' rumors growing than the honest runs do, so last-bit
  differences enter and compound over the rounds.
* The kernel runner's plain path with a plan is held statistically
  against the reference fast path, ``run_chaos`` shows each chaos
  class's detection signature, and ``phase_reports`` equals the
  reference's on the same per-round stats trace.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from consul_tpu_torch import bench
from consul_tpu_torch import faults as tf
from consul_tpu_torch.config import GossipConfig as TGossip
from consul_tpu_torch.sim import cuda_round, prng
from consul_tpu_torch.sim import params as tparams
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.metrics import phase_reports
from consul_tpu_torch.sim.scenarios import (BYZANTINE_CHAOS, chaos_plans,
                                            run_chaos)
from test_torch_harness import ref  # noqa: F401  (fixture)

N = 16_384
#: ulps of f32 spacing that ``informed`` may drift over a multi-round
#: engine run (measured: up to 16 after 6-8 rounds at 16,384 nodes)
ENGINE_ULPS = 64


def _ref_plan(plan):
    """The same plan built from the reference's primitive classes."""
    from consul_tpu import faults as rf

    return rf.FaultPlan(phases=tuple(
        rf.Phase(rounds=ph.rounds, name=ph.name, faults=tuple(
            getattr(rf, type(f).__name__)(**f.__dict__)
            for f in ph.faults))
        for ph in plan.phases))


def _honest_plan(n):
    """Overlapping partitions (one one-way), loss, slow, a flap that a
    phase flip releases, duplication, a churn burst."""
    m = n // 16
    return tf.FaultPlan(phases=(
        tf.Phase(rounds=3, name="warm"),
        tf.Phase(rounds=6, name="fault", faults=(
            tf.Partition(a=(0, 2 * m), b=(2 * m, 6 * m), drop=0.7),
            tf.Partition(a=(m, 3 * m), b=(8 * m, n), symmetric=False),
            tf.NodeLoss(nodes=(m, 5 * m), ingress=0.3, egress=0.2),
            tf.NodeLoss(nodes=(4 * m, 6 * m), egress=0.5),
            tf.SlowNodes(nodes=(6 * m, 7 * m)),
            tf.Flap(nodes=(7 * m, 8 * m), half_period=2),
            tf.Duplicate(nodes=(0, m), copies=3),
            tf.ChurnBurst(nodes=(8 * m, 10 * m), crash=0.05, rejoin=0.3,
                          leave=0.01))),
        tf.Phase(rounds=4, name="recover",
                 faults=(tf.NodeLoss(nodes=0.25, ingress=0.1),))))


def _byz_plan(n):
    m = n // 16
    adv = (n - 2 * m, n)
    return tf.FaultPlan(phases=(
        tf.Phase(rounds=2, name="warm"),
        tf.Phase(rounds=5, name="attack", faults=(
            tf.ForgedAcks(adversaries=adv, victims=(0, 2 * m),
                          coverage=0.9),
            tf.SpuriousSuspicion(adversaries=adv, victims=(2 * m, 4 * m),
                                 rate=2.0),
            tf.Eclipse(adversaries=adv, victims=(4 * m, 5 * m),
                       coverage=0.95),
            tf.StaleReplay(adversaries=adv, victims=(5 * m, 8 * m),
                           rate=0.4),
            tf.ChurnBurst(nodes=(0, 2 * m), crash=0.05),
            tf.Flap(nodes=(9 * m, 10 * m), half_period=1))),
        tf.Phase(rounds=3, name="after", faults=(
            tf.ForgedAcks(adversaries=adv),))))


PLANS = {"honest": _honest_plan, "byz": _byz_plan}


# ------------------------------------------------------------ the fold


@pytest.mark.parametrize("plan", list(PLANS))
def test_phase_arrays_match_reference(ref, plan):
    from consul_tpu import faults as rf

    n = 1024
    tplan = PLANS[plan](n)
    for tph, rph in zip(tplan.phases, _ref_plan(tplan).phases):
        a, b = tf._phase_arrays(tph, n), rf._phase_arrays(rph, n)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("plan", list(PLANS))
def test_compile_plan_digest_and_frames_match_reference(ref, plan):
    import jax.numpy as jnp

    from consul_tpu import faults as rf

    n = 4096
    tplan = PLANS[plan](n)
    cp_t = tf.compile_plan(tplan, n, "cpu")
    cp_r = rf.compile_plan(_ref_plan(tplan), n)
    assert (cp_t.attacked is None) == (plan == "honest")
    for name, a, b in zip(tf.CompiledFaultPlan._fields, cp_t, cp_r):
        if b is None:
            assert a is None, name
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tf.plan_digest(cp_t) == rf.plan_digest(cp_r)
    assert tf.plan_digest(None) is None
    sched = tf.plan_schedule(cp_t)
    # a runner blends its plan once (scale_plan): its frames must be the
    # reference's per-round scale_frame too, flap levels included
    gains = (1.0, 0.5, 0.3, 0.0)
    scaled = {g: tf.scale_plan(cp_t, g) for g in gains[1:]}
    for r in range(tplan.total_rounds + 5):
        assert tf.active_phase(cp_t, r) == int(rf.active_phase(
            cp_r, jnp.int32(r)))
        ft = tf.fault_frame(cp_t, r, sched)
        fr = rf.fault_frame(cp_r, jnp.int32(r))
        for gain in gains:
            if gain != 1.0:
                fr2 = rf.scale_frame(fr, gain)
                ports = (tf.scale_frame(ft, gain),
                         tf.fault_frame(scaled[gain], r, sched, gain))
            else:
                fr2, ports = fr, (ft,)
            for ft2 in ports:
                for name, a, b in zip(tf.FaultFrame._fields, ft2, fr2):
                    if b is None:
                        assert a is None, name
                        continue
                    np.testing.assert_array_equal(
                        a.numpy(), np.asarray(b),
                        err_msg=f"{r} {gain} {name}")


def test_node_mask_selectors_and_validation():
    assert tf.node_mask(None, 4).all()
    assert list(tf.node_mask(0.5, 4)) == [True, True, False, False]
    assert tf.node_mask(0.01, 4).sum() == 1
    assert list(tf.node_mask((1, 3), 4)) == [False, True, True, False]
    assert list(tf.node_mask([0, 3], 4)) == [True, False, False, True]
    for spec in (1.5, (2, 9), [4]):
        with pytest.raises(ValueError):
            tf.node_mask(spec, 4)


def test_plan_validation():
    with pytest.raises(ValueError):
        tf.FaultPlan(phases=())
    with pytest.raises(ValueError):
        tf.Phase(rounds=0)
    plan = tf.FaultPlan(phases=(tf.Phase(rounds=3, name="a"),
                                tf.Phase(rounds=7)))
    assert plan.total_rounds == 10
    assert plan.starts == [0, 3]
    assert plan.phase_names() == ["a", "phase1"]
    with pytest.raises(TypeError):
        tf._phase_arrays(tf.Phase(rounds=1, faults=("not-a-fault",)), 8)
    with pytest.raises(ValueError, match="half_period"):
        tf._phase_arrays(tf.Phase(rounds=1, faults=(
            tf.Flap(nodes=[0], half_period=0),)), 8)


def test_partition_and_loss_folds():
    pa = tf._phase_arrays(tf.Phase(rounds=1, faults=(
        tf.Partition(a=(0, 3), b=(3, 9)),)), 9)
    assert pa["suspw"][:3].max() < 1e-4 and pa["hear_w"][:3].max() < 1e-4
    assert pa["suspw"][3:].min() > 0.95 and pa["hear_w"][3:].min() > 0.95
    np.testing.assert_allclose(pa["psend"][:3], 0.25, atol=1e-6)
    pa = tf._phase_arrays(tf.Phase(rounds=1, faults=(
        tf.Partition(a=(0, 2), b=(2, 16), symmetric=False),)), 16)
    assert pa["precv"][:2].min() > 0.9 and pa["psend"][:2].max() < 0.1
    assert pa["hear_w"][:2].max() < 1e-3 and pa["hear_w"][2:].min() > 0.8
    lossy = tf._phase_arrays(tf.Phase(rounds=1, faults=(
        tf.NodeLoss(nodes=[0], egress=0.5),
        tf.NodeLoss(nodes=[0], egress=0.5))), 8)
    assert lossy["psend"][0] == pytest.approx(0.25, abs=1e-6)
    dup = tf._phase_arrays(tf.Phase(rounds=1, faults=(
        tf.NodeLoss(nodes=[0], egress=0.5),
        tf.Duplicate(nodes=[0], copies=3))), 8)
    assert dup["psend"][0] > 0.5


def test_byzantine_refusals_by_name():
    def compile_one(prim, n=16):
        return tf.compile_plan(tf.FaultPlan(phases=(tf.Phase(
            rounds=1, faults=(prim,)),)), n, "cpu")

    for prim in (tf.ForgedAcks, tf.SpuriousSuspicion, tf.StaleReplay,
                 tf.Eclipse):
        with pytest.raises(ValueError, match=f"{prim.__name__}: adversary "
                                             "and victim selectors overlap"):
            compile_one(prim(adversaries=(0, 8), victims=(4, 12)))
    with pytest.raises(ValueError, match="empty adversary"):
        compile_one(tf.SpuriousSuspicion(adversaries=[], victims=[1]))
    with pytest.raises(ValueError, match="empty victim"):
        compile_one(tf.ForgedAcks(adversaries=(0, 8), victims=[]))
    with pytest.raises(ValueError, match="coverage must be in"):
        compile_one(tf.ForgedAcks(adversaries=[0], victims=[1],
                                  coverage=1.5), 8)
    with pytest.raises(ValueError, match="StaleReplay: rate"):
        compile_one(tf.StaleReplay(adversaries=[0], victims=[1],
                                   rate=1.0), 8)
    with pytest.raises(ValueError, match="Eclipse: drop"):
        compile_one(tf.Eclipse(adversaries=[0], victims=[1], drop=2.0), 8)
    honest = compile_one(tf.ChurnBurst(nodes=(0, 8), crash=0.1), 64)
    assert honest.forge_ack is None and honest.attacked is None
    assert not tf.plan_is_byzantine(tf.FaultPlan(phases=(tf.Phase(1),)))
    fx = tf.fault_frame(honest, 0)
    assert fx.attacked is None and tf.scale_frame(fx, 0.5).attacked is None


def test_flap_schedule_and_release():
    plan = tf.FaultPlan(phases=(
        tf.Phase(rounds=4, name="quiet"),
        tf.Phase(rounds=6, name="fault", faults=(
            tf.NodeLoss(nodes=[0], egress=1.0),
            tf.Flap(nodes=[1], half_period=2))),
        tf.Phase(rounds=5, name="recover")))
    cp = tf.compile_plan(plan, 4, "cpu")

    def frame(r):
        return tf.fault_frame(cp, r)

    assert float(frame(3).psend[0]) == pytest.approx(1.0)
    assert float(frame(4).psend[0]) == pytest.approx(0.0)
    assert float(frame(99).psend[0]) == pytest.approx(1.0)
    assert float(frame(4).rejoin_p[1]) == 1.0
    assert float(frame(6).crash_p[1]) == 1.0
    assert float(frame(8).rejoin_p[1]) == 1.0
    assert float(frame(10).rejoin_p[1]) == 1.0       # released
    assert float(frame(11).rejoin_p[1]) == 0.0
    # lanes a round does not rewrite are views of the phase rows
    assert frame(5).psend.data_ptr() == cp.psend[1].data_ptr()


# --------------------------------------------------- detection gate


@pytest.mark.parametrize("forge", [False, True])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_detection_gate_matches_reference(ref, k, forge):
    import jax.numpy as jnp

    from consul_tpu import faults as rf
    from consul_tpu.sim.params import SimParams as RParams

    n = 2048
    rng = np.random.default_rng(k)
    up = rng.random(n) < 0.8
    tp = tparams.SimParams(n=n, loss=0.07, corroboration_k=k)
    rp = RParams(n=n, loss=0.07, corroboration_k=k)
    plan = _byz_plan(n) if forge else _honest_plan(n)
    cp_t = tf.compile_plan(plan, n, "cpu")
    cp_r = rf.compile_plan(_ref_plan(plan), n)
    for fx_t, fx_r in ((None, None),
                       (tf.fault_frame(cp_t, 3),
                        rf.fault_frame(cp_r, jnp.int32(3)))):
        a = tf.detection_gate(torch.from_numpy(up), fx_t, tp)
        b = rf.detection_gate(jnp.asarray(up), fx_r, rp)
        a = np.broadcast_to(a.numpy(), (n,))
        np.testing.assert_array_equal(a, np.broadcast_to(np.asarray(b),
                                                         (n,)))
    if forge and k == 0:
        assert float(a.min()) < 1.0


# ------------------------------------------------- one round vs _round_core


CASES = {
    "honest": (dict(), "honest", 5),
    "byz": (dict(corroboration_k=1), "byz", 3),
    "gain_half": (dict(fault_gain=0.5), "byz", 2),
    "ck2_no_plan": (dict(corroboration_k=2), None, 0),
}


def _params(n, **kw):
    from consul_tpu.config import GossipConfig as RGossip
    from consul_tpu.sim.params import SimParams as RParams

    kw = dict(loss=0.05, tcp_fallback=False, slow_per_round=0.002,
              collect_stats=True, **kw)
    return (tparams.SimParams.from_gossip_config(TGossip.lan(), n=n, **kw),
            RParams.from_gossip_config(RGossip.lan(), n=n, **kw))


def _warm_ref_state(n):
    import jax.numpy as jnp

    from consul_tpu.sim import state as rstate

    s = rstate.init_state(n)
    s = rstate.with_crashed(s, jnp.arange(0, n, 97), age=3)
    return rstate.with_slow(s, jnp.arange(1, n, 131))


def _assert_states_equal(a, b, informed_ulps=0):
    for f in tstate.NODE_FIELDS:
        x, y = getattr(a, f), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        if f == "informed" and informed_ulps:
            spacing = np.maximum(np.abs(y) * 2.0 ** -23, 2.0 ** -149)
            ulps = np.abs(x.astype(np.float64) - y) / spacing
            assert ulps.max() <= informed_ulps, ulps.max()
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    for f in tstate.SimStats._fields:
        x, y = getattr(a.stats, f), np.asarray(getattr(b.stats, f))
        if f == "detect_latency_sum":
            np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=f)
        else:
            assert x == y, (f, x, y)


@pytest.mark.parametrize("mode", ["live", "stale"])
@pytest.mark.parametrize("case", list(CASES))
def test_round_core_with_frame_matches_reference(ref, case, mode):
    import jax
    import jax.numpy as jnp

    from consul_tpu import faults as rf
    from consul_tpu.sim import round as rround

    kw, plan_name, r0 = CASES[case]
    tp, rp = _params(N, **kw)
    cp_t = cp_r = None
    if plan_name is not None:
        plan = PLANS[plan_name](N)
        cp_t = tf.compile_plan(plan, N, "cpu")
        cp_r = rf.compile_plan(_ref_plan(plan), N)
    rs = _warm_ref_state(N)
    rsc = rround.init_scalars(rs, rp) if mode == "stale" else None
    rng = np.random.default_rng(11)
    key = jax.random.key(9)
    replay_drawn = False
    for r in range(r0, r0 + 3):
        k = jax.random.fold_in(key, r)
        u = rng.random((tround.N_DRAWS, N), dtype=np.float32)
        kd = [tuple(np.asarray(jax.random.key_data(kk)).tolist())
              for kk in jax.random.split(k, 5)]
        kd.append(tuple(np.asarray(jax.random.key_data(
            jax.random.fold_in(k, prng.REPLAY_FOLD))).tolist()))
        slot = {d: i for i, d in enumerate(kd)}

        def u_ref(kk):
            nonlocal replay_drawn
            i = slot[tuple(np.asarray(jax.random.key_data(kk)).tolist())]
            replay_drawn |= i == tround.U_REPLAY
            return jnp.asarray(u[i])

        fr = None if cp_r is None else rf.fault_frame(cp_r, jnp.int32(r))
        ft = None if cp_t is None else tf.fault_frame(cp_t, r)
        ts = tstate.from_numpy(jax.device_get(rs), "cpu")
        tsc = None if rsc is None else torch.from_numpy(np.array(rsc))
        out = rround._round_core(rs, rsc, k, rp, fx=fr, u01=u_ref)
        ts2, tsc2 = tround.round_core(ts, tsc, tp,
                                      lambda s: torch.from_numpy(u[s]),
                                      fx=ft)
        _assert_states_equal(tstate.to_numpy(ts2), jax.device_get(out[0]))
        if mode == "stale":
            np.testing.assert_allclose(tsc2.numpy(), np.asarray(out[1]),
                                       rtol=1e-5, atol=1e-6)
        rs, rsc = out[0], out[1]
    assert replay_drawn == (plan_name == "byz")
    if plan_name == "byz":
        assert int(rs.stats.attack_suspicions) > 0


def test_threefry_engines_with_plan_reproduce_reference_states(ref):
    import jax
    import jax.numpy as jnp

    from consul_tpu import faults as rf
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate

    tp, rp = _params(N, corroboration_k=1)
    plan = _byz_plan(N)
    cp_t = tf.compile_plan(plan, N, "cpu")
    cp_r = rf.compile_plan(_ref_plan(plan), N)
    key, tkey = jax.random.key(4), prng.key(4)
    a, _ = tround.run_rounds(tstate.init_state(N, device="cpu"), tkey, tp,
                             6, plan=cp_t)
    b, _ = rround.run_rounds(rstate.init_state(N), key, rp, 6, plan=cp_r)
    _assert_states_equal(tstate.to_numpy(a), jax.device_get(b),
                         ENGINE_ULPS)
    a = tround.make_run_rounds_fast(tp, 8)(
        tstate.init_state(N, device="cpu"), tkey, plan=cp_t)
    b = rround.make_run_rounds_fast(rp, 8)(rstate.init_state(N), key,
                                           plan=cp_r)
    _assert_states_equal(tstate.to_numpy(a), jax.device_get(b),
                         ENGINE_ULPS)
    assert int(b.stats.attack_suspicions) > 0
    # why informed is bounded, not exact: the two libraries' exp
    x = np.linspace(-20.0, 0.0, 100_001, dtype=np.float32)
    assert (torch.exp(torch.from_numpy(x)).numpy()
            != np.asarray(jnp.exp(jnp.asarray(x)))).any()


# ------------------------------------------- the runner and the chaos suite


def test_runner_plain_path_with_plan_matches_reference_fast_path(ref):
    """Statistics of the kernel runner's plain path (its own Philox
    stream) against the reference fast path on the same byzantine
    plan, at the tolerances the reference holds its TPU kernel to."""
    import jax

    from consul_tpu import faults as rf
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate

    n, rounds = 65_536, 40
    tp, rp = _params(n)
    plan = tf.FaultPlan(phases=(
        tf.Phase(rounds=5),
        tf.Phase(rounds=35, faults=(
            tf.SpuriousSuspicion(adversaries=(n - 4096, n),
                                 victims=(0, 4096), rate=1.0),
            tf.Eclipse(adversaries=(n - 4096, n), victims=(4096, 6144),
                       coverage=0.95),
            tf.ChurnBurst(nodes=(8192, 16384), crash=0.02, rejoin=0.2),
            tf.NodeLoss(nodes=(16384, 24576), ingress=0.4, egress=0.4)))))
    port = cuda_round.make_run_rounds_cuda(
        tp, rounds, plan=tf.compile_plan(plan, n, "cpu"))(
        tstate.init_state(n, device="cpu"), prng.key(0))
    r = jax.device_get(rround.make_run_rounds_fast(rp, rounds)(
        rstate.init_state(n), jax.random.key(1),
        plan=rf.compile_plan(_ref_plan(plan), n)))
    ps = int((port.status == tstate.SUSPECT).sum())
    rs = int((np.asarray(r.status) == tstate.SUSPECT).sum())
    assert rs > 0 and 0.85 < ps / rs < 1.15, (ps, rs)
    for f in ("suspicions", "refutes", "false_positives", "crashes",
              "rejoins", "true_deaths_declared", "attack_suspicions",
              "attack_false_positives"):
        pv, rv = int(getattr(port.stats, f)), int(getattr(r.stats, f))
        assert rv > 0, f
        assert 0.8 < pv / rv < 1.25, (f, pv, rv)


def test_run_chaos_class_signatures():
    """``bench --chaos --smoke``: every class through ``run_chaos`` at
    4,096 nodes on the CPU plain path."""
    res = bench.run_chaos_suite(smoke=True)
    assert res["device"] == "cpu" and res["n"] == 4096
    suite = res["classes"]
    assert list(suite) == list(chaos_plans(4096))
    assert set(BYZANTINE_CHAOS) < set(suite) and len(suite) == 9
    # the report is run_chaos's, plus the bench's timings
    again = run_chaos("eclipse", n=4096, seed=0, device="cpu")
    assert {k: suite["eclipse"][k] for k in again} == again
    # the seed keys the draws: another seed is another run of the class
    other = run_chaos("eclipse", n=4096, seed=1, device="cpu")
    assert other["phases"] != again["phases"]
    ec = other["phases"][1]
    assert ec["false_positives"] > 0
    assert ec["attack_false_positives"] == ec["false_positives"]
    assert suite["eclipse"]["rounds_per_sec"] > 0
    assert chip_smoke.chaos_failures(suite) == []
    for rep in suite.values():
        assert rep["rounds"] == 120
        for ph in rep["phases"]:
            for f in ("suspicions", "refutes", "false_positives",
                      "true_deaths_declared", "mean_detect_latency_s",
                      "fp_per_node_hour", "honest_fp_per_node_hour"):
                assert f in ph


def test_gc_pause_false_positives_are_a_stale_scalar_property(ref):
    """The reference's live engine declares no gc_pause node
    (tests/test_faults.py:292); its stale-scalar fast path — the
    kernels' schedule — does, at 256 nodes as at 4,096. So the port's
    kernel runner is not held to zero there."""
    import jax

    from consul_tpu.sim import round as rround
    from consul_tpu.sim import scenarios as rscen
    from consul_tpu.sim import state as rstate
    from consul_tpu.faults import compile_plan as r_compile

    n = 256
    _, rp = _params(n)
    rp = rp.with_(loss=0.0, slow_per_round=0.0)
    plan = rscen.chaos_plans(n)["gc_pause"]
    cp = r_compile(plan, n)
    live, _ = rround.run_rounds(rstate.init_state(n), jax.random.key(0),
                                rp, plan.total_rounds, plan=cp)
    fast = rround.make_run_rounds_fast(rp, plan.total_rounds)(
        rstate.init_state(n), jax.random.key(0), plan=cp)
    assert int(live.stats.false_positives) == 0
    assert int(fast.stats.false_positives) > 0


def test_phase_reports_match_reference_given_phase_end_rows(ref):
    """``phase_reports`` takes the reference's per-round stats trace (the
    rows at the phase ends are the ones it reads): the port's
    ``run_rounds_stats`` trace and the reference's give the reference's
    reports."""
    import jax

    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate
    from consul_tpu.sim.metrics import phase_reports as r_phase_reports
    from consul_tpu.faults import compile_plan as r_compile

    n = 256
    tp, rp = _params(n)
    plan = chaos_plans(n)["eclipse"]
    rplan = _ref_plan(plan)
    _, trace = rround.run_rounds_stats(rstate.init_state(n),
                                       jax.random.key(2), rp,
                                       plan.total_rounds,
                                       plan=r_compile(rplan, n))
    trace = jax.device_get(trace)
    want = [r.to_dict() for r in r_phase_reports(trace, rplan, rp)]
    got = [r.to_dict() for r in phase_reports(trace, plan, tp)]
    assert got == want
    _, ttrace = tround.run_rounds_stats(
        tstate.init_state(n, device="cpu"), prng.key(2), tp,
        plan.total_rounds, plan=tf.compile_plan(plan, n, "cpu"))
    assert [r.to_dict() for r in phase_reports(ttrace, plan, tp)] == want
    assert want[1]["attack_false_positives"] > 0
    assert [r["phase"] for r in got] == ["warmup", "eclipse", "recover"]
    # a shorter trace reports only the phases it covers
    short = tstate.SimStats(*[np.asarray(x)[:plan.starts[2]]
                              for x in trace])
    assert len(phase_reports(short, plan, tp)) == 2


# ------------------------------------------------------ the in-place frame


def _no_flap(plan):
    """``plan`` without its flaps: no phase rewrites a lane."""
    return tf.FaultPlan(phases=tuple(
        tf.Phase(rounds=ph.rounds, name=ph.name, faults=tuple(
            f for f in ph.faults if not isinstance(f, tf.Flap)))
        for ph in plan.phases))


def _port_params(n, **kw):
    """``_params``' port half, without the reference."""
    return tparams.SimParams.from_gossip_config(
        TGossip.lan(), n=n, loss=0.05, tcp_fallback=False,
        slow_per_round=0.002, collect_stats=True, **kw)


#: plans of three phases each: flaps and a release (``honest``, ``byz``),
#: neither (``loss``, an honest plan; ``eclipse``, the chaos class)
IN_PLACE_PLANS = {"honest": _honest_plan, "byz": _byz_plan,
                  "loss": lambda n: _no_flap(_honest_plan(n)),
                  "eclipse": lambda n: chaos_plans(n)["eclipse"]}


@pytest.mark.parametrize("gain", [1.0, 0.5])
@pytest.mark.parametrize("plan", list(IN_PLACE_PLANS))
def test_in_place_frames_resolve_to_frames_at(plan, gain):
    """Each in-place frame's phase-0 rows, strides and device phase,
    laid over the plan's storage by ``as_strided``, are ``frames_at``'s
    lanes bit for bit on every round of the plan and three past its
    end, from a start inside a phase too; every lane but a rewritten
    ``crash_p`` / ``rejoin_p`` is a view of the plan's packed tensors at
    the stride between phases, never a gathered lane."""
    n = 1024
    fp = IN_PLACE_PLANS[plan](n)
    cp = tf.compile_plan(fp, n, "cpu")
    if gain != 1.0:
        cp = tf.scale_plan(cp, gain)
    rewrites = cp.any_flap or cp.any_release
    assert rewrites == (plan in ("honest", "byz"))
    total = fp.total_rounds + 3
    for r0 in (0, fp.starts[1] - 1):
        start = torch.tensor(r0, dtype=torch.int32)
        _, phs = tf.plan_phases(cp, start, total - r0)
        gathered = list(tf.frames_at(cp, start, total - r0, gain))
        in_place = list(tf.frames_in_place(cp, start, total - r0, gain))
        assert len(in_place) == len(gathered) == total - r0
        for i, (want, fx) in enumerate(zip(gathered, in_place)):
            r = r0 + i
            assert int(fx.phase) == tf.active_phase(cp, r) == int(phs[i])
            assert fx.phases == len(fp.phases)
            tf.check_in_place(fx, torch.device("cpu"), n)
            got = fx.resolve()
            for f in tf.FaultFrame._fields:
                a, b = getattr(want, f), getattr(got, f)
                assert (a is None) == (b is None), (r, f)
                if a is not None:
                    assert a.dtype == b.dtype and a.shape == b.shape, (r, f)
                    assert torch.equal(a, b), (r, f)
            for f in tf.frame_lanes(fx.lanes):
                lane, s = getattr(fx.lanes, f), fx.strides[f]
                if rewrites and f in ("crash_p", "rejoin_p"):
                    assert s == 0
                    continue
                packed = cp.mid if f == "mid" else cp.masks \
                    if f in tf.FRAME_MASKS else cp.rows
                assert lane.untyped_storage().data_ptr() == \
                    packed.untyped_storage().data_ptr(), f
                assert s == packed.stride(0) > 0, f
                # the phase row the kernel reads: base + phase * stride
                row = lane.as_strided(lane.shape, lane.stride(),
                                      lane.storage_offset() + int(fx.phase)
                                      * s)
                assert torch.equal(row, getattr(got, f)), (r, f)


def _in_place_frame(n=1024, name="byz"):
    cp = tf.compile_plan(IN_PLACE_PLANS[name](n), n, "cpu")
    return cp, next(tf.frames_in_place(cp, torch.tensor(4), 1))


IN_PLACE_REFUSALS = {
    "psend": lambda fx: fx._replace(lanes=fx.lanes._replace(
        psend=fx.lanes.psend.double())),
    "slow_f": lambda fx: fx._replace(lanes=fx.lanes._replace(
        slow_f=fx.lanes.slow_f.to(torch.int8))),
    "replay": lambda fx: fx._replace(lanes=fx.lanes._replace(replay=None)),
    "hear_w": lambda fx: fx._replace(strides={**fx.strides,
                                              "hear_w": 1023}),
    "suspw": lambda fx: fx._replace(strides={**fx.strides, "suspw": -4}),
    "attacked": lambda fx: fx._replace(strides={
        **fx.strides, "attacked": 2 * fx.strides["attacked"]}),
    "mid": lambda fx: fx._replace(strides={**fx.strides, "mid": 3}),
    "phase": lambda fx: fx._replace(phase=fx.phase.to(torch.int32)),
    "phases": lambda fx: fx._replace(phases=0),
}


@pytest.mark.parametrize("case", list(IN_PLACE_REFUSALS))
def test_in_place_frame_refusals_name_the_lane(case):
    """A lane of the wrong dtype or missing, a stride inside a row or
    negative, a stride that puts the last phase's row past the lane's
    storage, and a phase that is not one int64 are refused by name, by
    ``check_in_place`` and so by ``round_kernel`` before any launch."""
    _, fx = _in_place_frame()
    bad = IN_PLACE_REFUSALS[case](fx)
    match = {"phases": "phases", "phase": "phase"}.get(case, case)
    with pytest.raises(ValueError, match=match):
        tf.check_in_place(bad, torch.device("cpu"), 1024)
    p = _port_params(1024)
    s = tstate.init_state(1024, device="cpu")
    seeds = prng.round_seeds(prng.key(0), 0, 1)
    with pytest.raises(ValueError, match=match):
        cuda_round.round_kernel(s.node_arrays(), tround.init_scalars(s, p),
                                seeds, 0, p, fx=bad)


@pytest.mark.parametrize("name", ["loss", "byz"])
def test_wrapper_takes_an_in_place_frame_as_its_gathered_frame(name):
    """``round_kernel`` on the CPU resolves an in-place frame and runs
    the plain version on it: the same arrays and partials as the
    gathered frame of the same round, its variant the frame's, and no
    launch counted."""
    n = 1024
    cp = tf.compile_plan(IN_PLACE_PLANS[name](n), n, "cpu")
    p = _port_params(n, corroboration_k=2 if name == "byz" else 0)
    s = tstate.with_crashed(tstate.init_state(n, device="cpu"),
                            torch.arange(0, n, 37))
    scal = tround.init_scalars(s, p)
    seeds = prng.round_seeds(prng.key(3), 0, 1)
    start = torch.tensor(4, dtype=torch.int32)
    want_fx = next(tf.frames_at(cp, start, 1))
    fx = next(tf.frames_in_place(cp, start, 1))
    assert cuda_round.variant(p, fx) == cuda_round.variant(p, want_fx) \
        == ("byz" if name == "byz" else "fault")
    cuda_round.reset_launches()
    got = tuple(a.clone() for a in s.node_arrays())
    want = tuple(a.clone() for a in s.node_arrays())
    part = cuda_round.round_kernel(got, scal, seeds, 0, p, fx=fx)
    want_part = cuda_round.round_kernel(want, scal, seeds, 0, p, fx=want_fx)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(part, want_part)
    assert dict(cuda_round.LAUNCHES) == {}


def test_kernel_runner_routes_frames_by_device(monkeypatch):
    """The kernel runner looks the call's phases up once and hands them
    to the frames and the recorder: on the CPU it takes
    ``frames_at``'s gathered frames (never ``frames_in_place``, the
    card's route), once a call, and counts no launch; its flight rows'
    phase column is each period's phase."""
    n = 1024
    fp = IN_PLACE_PLANS["eclipse"](n)
    cp = tf.compile_plan(fp, n, "cpu")
    calls = {"frames_at": 0, "frames_in_place": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            assert kw["phases"][1].shape == (a[2],)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(cuda_round, "frames_at",
                        counted("frames_at", tf.frames_at))
    monkeypatch.setattr(cuda_round, "frames_in_place",
                        counted("frames_in_place", tf.frames_in_place))
    p = _port_params(n)
    run = cuda_round.make_run_rounds_cuda(p, fp.total_rounds, plan=cp,
                                          flight_every=1)
    cuda_round.reset_launches()
    _, trace = run(tstate.init_state(n, device="cpu"), prng.key(1))
    assert calls == {"frames_at": 1, "frames_in_place": 0}
    assert dict(cuda_round.LAUNCHES) == {}
    from consul_tpu_torch.sim import flight
    want = [float(tf.active_phase(cp, r)) for r in range(fp.total_rounds)]
    assert trace[:, flight.COL["fault_phase"]].tolist() == want
