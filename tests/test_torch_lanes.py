"""consul_tpu_torch's lane engine against the JAX reference.

* ``prng.u01_global`` (the lane engine's global-index stream) equals the
  reference's ``lanes.u01_global`` bit for bit.
* The two-stage reduction: block partials and their fold are one fixed
  tree of f32 adds (``lanes.tree_sum``), the same for any leading shape;
  on count data they equal the reference's sums exactly, on f32 data
  within ``LANE_RTOL`` (XLA adds inside a block in another order).
* ``init_lanes``, ``scalars_from_lanes``, ``stats_delta_from_lanes``,
  ``max_lh_from_lanes``, ``seed_table``/``carry_table`` and
  ``flight.row_from_lanes`` against the reference's on the same inputs;
  every ``check_*`` refusal, with the reference's reason.
* ``gossip_round_lanes`` and ``make_run_rounds_lanes`` (stale_k 1/2/4,
  synchronous and overlap, with a fault plan, with the flight recorder)
  reproduce the reference lane engine on the same key: every int lane
  and every counter exact, ``informed`` within ``ENGINE_ULPS`` (CPU
  ``exp`` differs in the last bit between the libraries), trace
  counters exact and gauges within ``GAUGE_ATOL``.
* A run cut at a window boundary and resumed with the carry
  (``lanes0``/``table0``, ``drain_overlap``) is bit for bit the uncut
  run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from consul_tpu_torch import faults as tf
from consul_tpu_torch.sim import flight, prng, registry
from consul_tpu_torch.sim import lanes as tlanes
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from test_torch_faults import (_assert_states_equal, _byz_plan,
                               _honest_plan, _params, _ref_plan,
                               _warm_ref_state)
from test_torch_harness import ref  # noqa: F401  (fixture)

#: ulps of f32 spacing ``informed`` may drift over a multi-round run
#: (the reference's and PyTorch's CPU exp differ in the last bit)
ENGINE_ULPS = 64
#: relative tolerance of a reduced f32 lane against the reference's
LANE_RTOL = 2e-6
#: absolute tolerance of a trace gauge (means of f32 sums over a pool)
GAUGE_ATOL = 1e-6
ROUNDS = 48


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x.numpy())


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("offset,length", [(0, 1000), (77, 4096),
                                           (2**32 - 5, 16)])
def test_u01_global_is_bit_exact(ref, offset, length):
    import jax

    from consul_tpu.sim import lanes as rlanes

    for seed in (0, 3, 123456789):
        want = np.asarray(rlanes.u01_global(jax.random.key(seed), offset,
                                            length))
        got = prng.u01_global(prng.key(seed), offset, length).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_global_u01_slots_follow_the_reference_keys(ref):
    import jax

    from consul_tpu.sim import lanes as rlanes

    k = jax.random.key(11)
    keys = list(jax.random.split(k, 5)) + [jax.random.fold_in(k, 0xB12A)]
    u = prng.global_u01(prng.key(11), 64, 512, prng.SLOTS)
    for slot, kk in enumerate(keys):
        assert np.array_equal(u(slot).numpy(),
                              np.asarray(rlanes.u01_global(kk, 64, 512)))


@pytest.mark.parametrize("length", [1, 2, 5, 64, 100, 1024, 4095])
def test_tree_sum_is_one_fixed_tree_whatever_the_leading_shape(length):
    rng = np.random.default_rng(length)
    x = torch.from_numpy(rng.random((3, 7, length), dtype=np.float32))
    whole = tlanes.tree_sum(x)
    for i in range(3):
        for j in range(7):
            assert torch.equal(tlanes.tree_sum(x[i, j]), whole[i, j])
            assert torch.equal(tlanes.tree_sum(x[i:i + 1, j:j + 1]),
                               whole[i:i + 1, j:j + 1])
    np.testing.assert_allclose(whole.numpy(),
                               x.double().sum(-1).numpy(), rtol=1e-5)


@pytest.mark.parametrize("data", ["counts", "f32"])
def test_block_partials_and_fold_match_reference(ref, data):
    from consul_tpu.sim import lanes as rlanes

    rng = np.random.default_rng(5)
    if data == "counts":
        stack = (rng.random((32, 4096)) < 0.3).astype(np.float32)
    else:
        stack = rng.random((32, 4096), dtype=np.float32)
    part = tlanes._block_partials(_t(stack), tlanes.LANE_BLOCKS)
    want_part = np.asarray(rlanes._block_partials(_jnp(_t(stack)),
                                                  rlanes.LANE_BLOCKS))
    got = tlanes.reduce_lanes_single(_t(stack))
    want = np.asarray(rlanes.reduce_lanes_single(_jnp(_t(stack))))
    assert part.shape == want_part.shape and got.shape == want.shape
    if data == "counts":
        assert np.array_equal(part.numpy(), want_part)
        assert np.array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(part.numpy(), want_part, rtol=LANE_RTOL)
        np.testing.assert_allclose(got.numpy(), want, rtol=LANE_RTOL)
    # the reducer is its two stages; a grid's rows are its one-run rows
    assert torch.equal(got, tlanes.reduce_lanes_single.fold(part))
    grid = _t(np.stack([stack, stack[::-1].copy()], axis=1))
    g = tlanes.reduce_lanes_single(grid)
    assert torch.equal(g[:, 0], got)
    assert torch.equal(g[:, 1], tlanes.reduce_lanes_single(
        _t(stack[::-1].copy())))


def _warm_pair(n, **kw):
    import jax

    tp, rp = _params(n, **kw)
    rs = _warm_ref_state(n)
    return tp, rp, rs, tstate.from_numpy(jax.device_get(rs), "cpu")


def test_init_lanes_and_consumers_match_reference(ref):
    from consul_tpu.sim import flight as rflight
    from consul_tpu.sim import lanes as rlanes
    from consul_tpu.sim import round as rround

    tp, rp, rs, ts = _warm_pair(4096)
    want = np.asarray(rround.init_lanes(rs, rp, rlanes.reduce_lanes_single))
    got = tround.init_lanes(ts, tp, tlanes.reduce_lanes_single).numpy()
    assert got.shape == want.shape == (registry.N_REDUCE_LANES,)
    counts = [0, 1, 2, 3]
    assert np.array_equal(got[counts], want[counts])
    np.testing.assert_allclose(got, want, rtol=LANE_RTOL)
    # the consumers, on one lane vector (the reference's, with stats,
    # gauges and histogram lanes filled in)
    rng = np.random.default_rng(2)
    lv = want.copy()
    lv[8:] = rng.integers(0, 50, size=lv.size - 8).astype(np.float32)
    lv[registry.LANE["detect_latency_sum"]] = 123.25
    lv[-3:] = 0.0   # lh_ge_6..8 empty: max local health 5
    np.testing.assert_array_equal(
        tlanes.scalars_from_lanes(_t(lv)).numpy(),
        np.asarray(rlanes.scalars_from_lanes(_jnp(_t(lv)))))
    zero = lv.copy()
    zero[:8] = 0.0   # the floors bind
    np.testing.assert_array_equal(
        tlanes.scalars_from_lanes(_t(zero)).numpy(),
        np.asarray(rlanes.scalars_from_lanes(_jnp(_t(zero)))))
    d, rd = tlanes.stats_delta_from_lanes(_t(lv)), \
        rlanes.stats_delta_from_lanes(_jnp(_t(lv)))
    for f in tstate.SimStats._fields:
        x, y = getattr(d, f).numpy(), np.asarray(getattr(rd, f))
        assert x.dtype == y.dtype and x == y, f
    assert float(tlanes.max_lh_from_lanes(_t(lv))) == \
        float(rlanes.max_lh_from_lanes(_jnp(_t(lv)))) == 5.0
    row = flight.row_from_lanes(_t(lv), 4096, torch.tensor(12.0), 2, d)
    want_row = np.asarray(rflight.row_from_lanes(_jnp(_t(lv)), 4096,
                                                 12.0, 2, rd))
    np.testing.assert_array_equal(row.numpy(), want_row)
    # a grid's lanes give one row per point
    grid = _t(np.stack([lv, lv], axis=1))
    gd = tlanes.stats_delta_from_lanes(grid)
    rows = flight.row_from_lanes(grid, 4096, torch.tensor([12.0, 12.0]),
                                 2, gd)
    assert rows.shape == (2, flight.N_COLS)
    assert torch.equal(rows[0], row) and torch.equal(rows[1], row)


def test_seed_and_carry_tables_match_reference(ref):
    from consul_tpu.sim import lanes as rlanes

    rng = np.random.default_rng(4)
    lv = rng.random(registry.N_REDUCE_LANES, dtype=np.float32)
    # one device is the reference's shard at global offset 0
    seed = tlanes.seed_table(_t(lv))
    assert np.array_equal(seed.numpy(),
                          np.asarray(rlanes.seed_table(_jnp(_t(lv)), 0)))
    assert torch.equal(tlanes.reduce_lanes_single.fold(seed), _t(lv))
    table = rng.random((registry.N_REDUCE_LANES, 64), dtype=np.float32)
    carried = tlanes.carry_table(_t(table))
    assert np.array_equal(carried.numpy(), np.asarray(
        rlanes.carry_table(_jnp(_t(table)), 0)))
    assert carried.data_ptr() != _t(table).data_ptr()
    assert torch.equal(tlanes.reduce_lanes_single.gather_table(_t(table)),
                       _t(table))


REFUSALS = {
    "pool": (lambda L, P: L.check_pool(1000), "block table"),
    "stats": (lambda L, P: L.check_flight_config(
        P(n=1024, collect_stats=False), 4), "collect_stats"),
    "awareness": (lambda L, P: L.check_flight_config(
        P(n=1024, awareness_max=9), 4), "awareness_max"),
    "stride": (lambda L, P: L.check_flight_config(
        P(n=1024, stale_k=4), 6), "multiple of"),
    "stale_k": (lambda L, P: L.check_schedule(
        P(n=1024, stale_k=0), 8, None, False), "positive int"),
    "overlap_rounds": (lambda L, P: L.check_schedule(
        P(n=1024, stale_k=4), 10, None, True), "uniform reduction"),
    "overlap_flight": (lambda L, P: L.check_schedule(
        P(n=1024, stale_k=2), 8, 2, True), "one window late"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_checks_refuse_as_the_reference_does(ref, case):
    from consul_tpu.sim import lanes as rlanes
    from consul_tpu.sim.params import SimParams as RParams

    from consul_tpu_torch.sim.params import SimParams as TParams

    fn, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match) as got:
        fn(tlanes, TParams)
    with pytest.raises(ValueError, match=match) as want:
        fn(rlanes, RParams)
    assert str(got.value) == str(want.value)


def test_lane_runner_refusals():
    p = tround.SimParams(n=256)
    with pytest.raises(ValueError, match="single-device synchronous"):
        tround.make_run_rounds_lanes(p, 4, overlap=True, lane_blocks=32)
    run = tround.make_run_rounds_lanes(p, 4)
    s = tstate.init_state(256, device="cpu")
    cp = tf.compile_plan(_honest_plan(256), 256, "cpu")
    with pytest.raises(ValueError, match="without a fault plan"):
        run(s, prng.key(0), cp=cp)
    with pytest.raises(ValueError, match="carry=True"):
        run(s, prng.key(0), lanes0=torch.zeros(registry.N_REDUCE_LANES))
    with pytest.raises(ValueError, match="synchronous"):
        tround.make_run_rounds_lanes(p, 4, carry=True)(
            s, prng.key(0), table0=torch.zeros(registry.N_REDUCE_LANES, 64))


def test_gossip_round_lanes_one_round_matches_reference(ref):
    import jax

    from consul_tpu.sim import lanes as rlanes
    from consul_tpu.sim import round as rround

    tp, rp, rs, ts = _warm_pair(4096, fail_per_round=0.003,
                                rejoin_per_round=0.02)
    rlv = rround.init_lanes(rs, rp, rlanes.reduce_lanes_single)
    key = jax.random.fold_in(jax.random.key(9), 3)
    rs2, rlv2 = rround.gossip_round_lanes(
        rs, rlv, key, rp, lane_reducer=rlanes.reduce_lanes_single)
    ts2, tlv2 = tround.gossip_round_lanes(
        ts, _t(np.asarray(rlv)), _t(np.asarray(jax.random.key_data(key)))
        .to(torch.int64), tp, lane_reducer=tlanes.reduce_lanes_single)
    _assert_states_equal(tstate.to_numpy(ts2), jax.device_get(rs2))
    want = np.asarray(rlv2)
    got = tlv2.numpy()
    exact = [i for i, name in enumerate(registry.REDUCE_LANES)
             if name not in ("pf_fast_sum", "pf_slow_sum", "lfail_num",
                             "lfail_den", "detect_latency_sum",
                             "informed_sum")]
    assert np.array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got, want, rtol=LANE_RTOL)


def _run_both(n, rounds, kw, plan=None, **opts):
    """The port's and the reference's lane runners on the same key."""
    import jax

    from consul_tpu import faults as rf
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate

    tp, rp = _params(n, fail_per_round=0.003, rejoin_per_round=0.02, **kw)
    rcp = tcp = None
    if plan is not None:
        rcp = rf.compile_plan(_ref_plan(plan), n)
        tcp = tf.compile_plan(plan, n, "cpu")
    rout = rround.make_run_rounds_lanes(rp, rounds, plan=rcp, **opts)(
        rstate.init_state(n), jax.random.key(7))
    tout = tround.make_run_rounds_lanes(tp, rounds, plan=tcp, **opts)(
        tstate.init_state(n, device="cpu"), prng.key(7))
    return jax.device_get(rout), tout


CASES = [(1024, 1, False), (1024, 2, False), (1024, 4, False),
         (1024, 1, True), (1024, 2, True), (1024, 4, True),
         (4096, 1, False), (4096, 4, True)]


@pytest.mark.parametrize("n,stale_k,overlap", CASES)
def test_lane_runner_matches_reference(ref, n, stale_k, overlap):
    rs, ts = _run_both(n, ROUNDS, dict(stale_k=stale_k), overlap=overlap)
    _assert_states_equal(tstate.to_numpy(ts), rs, informed_ulps=ENGINE_ULPS)
    assert int(ts.stats.suspicions) > 0 and int(ts.stats.crashes) > 0


def _assert_traces_match(got, want):
    cols = flight.trace_columns(got)
    wcols = {c: np.asarray(want)[:, i]
             for i, c in enumerate(flight.FLIGHT_COLUMNS)}
    for c in flight.FLIGHT_COLUMNS:
        if c in tstate.STATS_FIELDS and c != "detect_latency_sum":
            np.testing.assert_array_equal(cols[c], wcols[c], err_msg=c)
        elif c in ("t", "fault_phase", "max_local_health"):
            np.testing.assert_array_equal(cols[c], wcols[c], err_msg=c)
        else:
            np.testing.assert_allclose(cols[c], wcols[c], rtol=1e-6,
                                       atol=GAUGE_ATOL, err_msg=c)


@pytest.mark.parametrize("plan,stale_k", [("honest", 1), ("honest", 4),
                                          ("byz", 2), (None, 4)])
def test_lane_runner_with_plan_and_flight_matches_reference(ref, plan,
                                                            stale_k):
    kw = dict(stale_k=stale_k, corroboration_k=1 if plan == "byz" else 0)
    p = {"honest": _honest_plan, "byz": _byz_plan}[plan](1024) \
        if plan else None
    (rs, rtr), (ts, ttr) = _run_both(1024, 20, kw, plan=p,
                                     flight_every=4)
    _assert_states_equal(tstate.to_numpy(ts), rs, informed_ulps=ENGINE_ULPS)
    _assert_traces_match(ttr, rtr)
    # the column sums are the run's counters
    cols = flight.trace_columns(ttr)
    assert cols["suspicions"].sum() == int(ts.stats.suspicions)
    if plan is not None:
        assert set(cols["fault_phase"]) <= {0.0, 1.0, 2.0}


@pytest.mark.parametrize("overlap", [False, True])
def test_lane_run_cut_at_a_window_and_resumed_is_bitwise(overlap):
    p = tround.SimParams(n=1024, loss=0.05, tcp_fallback=False,
                         fail_per_round=0.003, rejoin_per_round=0.02,
                         slow_per_round=0.002, stale_k=4)
    key = prng.key(21)
    whole = tround.make_run_rounds_lanes(p, 32, overlap=overlap)(
        tstate.init_state(1024, device="cpu"), key)
    first = tround.make_run_rounds_lanes(p, 16, overlap=overlap, carry=True)
    second = tround.make_run_rounds_lanes(p, 16, overlap=overlap,
                                          carry=True)
    s = tstate.init_state(1024, device="cpu")
    if overlap:
        s, lv, table = first(s, key)
        s, lv, table = second(s, key, lanes0=lv, table0=table)
        s = tround.drain_overlap(s, table, p)
    else:
        s, lv = first(s, key)
        s, lv = second(s, key, lanes0=lv)
    a, b = tstate.to_numpy(s), tstate.to_numpy(whole)
    for f in tstate.NODE_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.stats, b.stats):
        assert x == y
    assert a.t == b.t and a.round_idx == b.round_idx == 32


def _eager_kernel(s, key, p, rounds):
    """The kernel runner's rounds as plain per-round calls: each
    ``block_round_ref`` on the last round's clamped partial sums."""
    from consul_tpu_torch.sim import cuda_round as cr

    arrays, sc = s.node_arrays(), tround.init_scalars(s, p)
    seeds = prng.round_seeds(key, 0, rounds)
    for r in range(rounds):
        arrays, part = cr.block_round_ref(arrays, sc, seeds[r], p)
        sc = tround.clamp_scalars(part.sum(0)[:8])
    return arrays


def _eager_fast(s, key, p, rounds):
    sc = tround.init_scalars(s, p)
    keys = prng.round_keys(key, s.round_idx, rounds)
    for r in range(rounds):
        s, sc = tround.gossip_round_fast(s, sc, keys[r], p)
    return s


def _eager_lanes(s, key, p, rounds):
    red = tlanes.reduce_lanes_single
    lv = tround.init_lanes(s, p, red)
    keys = prng.round_keys(key, s.round_idx, rounds)
    for r in range(rounds):
        s, lv = tround.gossip_round_lanes(s, lv, keys[r], p,
                                          lane_reducer=red)
    return s


def _kernel_runner(p, rounds):
    from consul_tpu_torch.sim import cuda_round as cr

    return cr.make_run_rounds_cuda(p, rounds)


DONATING_RUNNERS = {
    "kernel": (_kernel_runner, _eager_kernel),
    "live": (tround.make_run_rounds,
             lambda s, key, p, r: tround.run_rounds(s, key, p, r)[0]),
    "fast": (tround.make_run_rounds_fast, _eager_fast),
    "lanes": (tround.make_run_rounds_lanes, _eager_lanes)}


@pytest.mark.parametrize("engine", list(DONATING_RUNNERS))
def test_runner_updates_the_state_in_place(engine):
    """Every runner whose reference donates returns the caller's
    per-node tensors, updated, bit for bit its rounds run eagerly one by
    one; the clock, round and counters come back as new tensors and the
    caller's keep their values."""
    make, eager = DONATING_RUNNERS[engine]
    p = tround.SimParams(n=256, loss=0.05, fail_per_round=0.01,
                         rejoin_per_round=0.05)
    rounds = 12
    s = tstate.init_state(256, device="cpu")
    want = eager(tstate.init_state(256, device="cpu"), prng.key(1), p,
                 rounds)
    lanes = s.node_arrays()
    out = make(p, rounds)(s, prng.key(1))
    assert all(a is b for a, b in zip(out.node_arrays(), lanes))
    for a, b in zip(out.node_arrays(), want[:8]):
        assert torch.equal(a, b)
    assert int(out.round_idx) == rounds and int(s.round_idx) == 0
    assert float(out.t) == rounds and float(s.t) == 0.0
    assert out.t is not s.t
    assert all(x is not y for x, y in zip(out.stats, s.stats))
    if engine != "kernel":
        for a, b in zip(out.stats, want.stats):
            assert torch.equal(a, b)
        assert int(out.stats.crashes) > 0