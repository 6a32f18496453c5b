"""consul_tpu_torch's coordinates, topology and new draws against the
JAX reference.

Tolerances, each stated where it is used:

* ``prng.randint`` and ``topology.sample_pairs``: exact (integer
  arithmetic on the same threefry words).
* ``prng.normal`` within ``NORMAL_ULPS`` and ``prng.exponential`` within
  ``EXP_ULPS`` of the reference, element by element: the uniforms are
  bit for bit, PyTorch's ``erfinv`` / ``log1p`` and XLA's differ in the
  last bits.
* Float results built from those draws or from sums over a row (the
  topology's positions, RTTs, Vivaldi state) within ``SCALED_ULPS`` f32
  ulps of the array's largest magnitude: sums of 4-8 terms in another
  order, and values near zero next to values of the array's scale.
* ``vivaldi_step``'s ring cursor ``adj_idx`` exact.
* Live-engine runs: every int lane and counter exact, ``informed``
  within test_torch_faults's ``ENGINE_ULPS`` (the libraries' ``exp``
  differ in the last bit, and the rumors spread); coordinates within
  ``RUN_ATOL`` seconds after the run (last-bit differences compound
  through the relaxation), the quality trace within ``TRACE_ATOL``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from consul_tpu_torch.config import GossipConfig as TGossip
from consul_tpu_torch.sim import coords as tC
from consul_tpu_torch.sim import cuda_round, flight, prng
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim import topology as tT
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.scenarios import (COORDS_CONVERGED_MED_ERR,
                                            coords_plan, run_coords)
from test_torch_faults import ENGINE_ULPS, _assert_states_equal
from test_torch_harness import ref  # noqa: F401  (fixture)

NORMAL_ULPS = 64
EXP_ULPS = 2
SCALED_ULPS = 16
RUN_ATOL = 1e-6
TRACE_ATOL = 1e-4


def _scaled_close(x, y, ulps=SCALED_ULPS, what=""):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    assert x.shape == y.shape, what
    tol = ulps * 2.0 ** -23 * max(np.abs(y).max(), 1e-30)
    err = np.abs(x - y).max() if x.size else 0.0
    assert err <= tol, (what, err, tol)


def _elem_ulps(x, y):
    y = np.asarray(y)
    spacing = np.maximum(np.abs(y) * 2.0 ** -23, 2.0 ** -149)
    return (np.abs(np.asarray(x, np.float64) - y) / spacing).max()


def _tparams(n, **kw):
    return SimParams.from_gossip_config(TGossip.lan(), n=n,
                                        tcp_fallback=False, **kw)


def _rparams(n, **kw):
    from consul_tpu.config import GossipConfig as RGossip
    from consul_tpu.sim.params import SimParams as RParams

    return RParams.from_gossip_config(RGossip.lan(), n=n,
                                      tcp_fallback=False, **kw)


def _port_coords(c) -> tC.CoordState:
    import jax

    return tC.coords_from_numpy(jax.device_get(c), "cpu")


def _assert_coords_close(a: tC.CoordState, b, ulps=SCALED_ULPS):
    for f in tC.CoordState._fields:
        x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        if f == "adj_idx":
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            _scaled_close(x, y, ulps, f)


# ------------------------------------------------------------- draws


@pytest.mark.parametrize("shape,lo,hi", [((4096,), 1, 4096),
                                         ((70_000,), 1, 70_000),
                                         ((1000,), 0, 17),
                                         ((300, 5), -3, 9),
                                         ((64,), 5, 5)])
def test_randint_is_bit_exact(ref, shape, lo, hi):
    import jax
    import jax.numpy as jnp

    for seed in (0, 7):
        got = prng.randint(prng.key(seed), shape, lo, hi)
        want = jax.random.randint(jax.random.key(seed), shape, lo, hi,
                                  dtype=jnp.int32)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(100_000,), (1000, 8)])
def test_normal_and_exponential_within_ulps(ref, shape):
    import jax

    for seed in (0, 4):
        k, kj = prng.key(seed), jax.random.key(seed)
        assert _elem_ulps(prng.normal(k, shape).numpy(),
                          jax.random.normal(kj, shape)) <= NORMAL_ULPS
        assert _elem_ulps(prng.exponential(k, shape).numpy(),
                          jax.random.exponential(kj, shape)) <= EXP_ULPS
        # the uniform under both is bit for bit
        np.testing.assert_array_equal(
            prng.uniform(k, shape).numpy(),
            np.asarray(jax.random.uniform(kj, shape)))


# ---------------------------------------------------------- topology


def test_constants_match_the_scalar_client(ref):
    from consul_tpu.gossip import coordinate as rc

    for name in ("DIMENSION", "VIVALDI_ERROR_MAX", "VIVALDI_CE",
                 "VIVALDI_CC", "ADJUSTMENT_WINDOW", "HEIGHT_MIN",
                 "ZERO_THRESHOLD", "GRAVITY_RHO"):
        assert getattr(tC, name) == getattr(rc, name), name


def test_topology_and_samples_match_reference(ref):
    import jax
    import jax.numpy as jnp

    from consul_tpu.sim import topology as rT

    n = 4096
    tp = dict(n=n, seed=3, n_dcs=5, dims=3)
    got = tT.make_topology(tT.TopologyParams(**tp), "cpu")
    want = jax.device_get(rT.make_topology(rT.TopologyParams(**tp)))
    np.testing.assert_array_equal(got.dc.numpy(), want.dc)
    assert float(got.jitter_sigma) == float(want.jitter_sigma)
    _scaled_close(got.pos.numpy(), want.pos, what="pos")
    assert _elem_ulps(got.height.numpy(), want.height) <= EXP_ULPS + 2
    # from here on both sides share the reference's embedding
    topo = tT.topology_from_numpy(want, "cpu")
    for seed in (1, 2):
        j = tT.sample_pairs(n, prng.key(seed))
        jr = rT.sample_pairs(n, jax.random.key(seed))
        np.testing.assert_array_equal(j.numpy(), np.asarray(jr))
        assert not bool((j == torch.arange(n)).any())
        i = torch.arange(n)
        ij, ji = tT.true_rtt(topo, i, j), tT.true_rtt(topo, j, i)
        np.testing.assert_allclose(ij.numpy(), ji.numpy(), rtol=1e-6)
        assert bool((ij > 0).all())
        _scaled_close(ij.numpy(), rT.true_rtt(want, jnp.arange(n), jr),
                      what="true_rtt")
        obs = tT.sample_rtt(topo, i, j, prng.key(seed + 10))
        _scaled_close(obs.numpy(), rT.sample_rtt(
            want, jnp.arange(n), jr, jax.random.key(seed + 10)),
            what="sample_rtt")
        assert bool((obs > 0).all())


# ------------------------------------------------------------ Vivaldi


def _random_coords(n, seed, coincident=0):
    rng = np.random.default_rng(seed)
    vec = (rng.normal(size=(n, 8)) * 0.02).astype(np.float32)
    vec[:coincident] = 0.0
    return dict(
        vec=vec,
        error=rng.uniform(0.05, 1.5, n).astype(np.float32),
        height=rng.uniform(1e-5, 5e-3, n).astype(np.float32),
        adjustment=(rng.normal(size=n) * 1e-4).astype(np.float32),
        adj_samples=(rng.normal(size=(n, 20)) * 1e-4).astype(np.float32),
        adj_idx=rng.integers(0, 20, n).astype(np.int32))


@pytest.mark.parametrize("form", ["full", "indexed", "coincident",
                                  "masked"])
def test_vivaldi_step_matches_reference(ref, form):
    """The full and indexed forms, the coincident branch (random
    direction from the key), masked rows and non-positive RTTs."""
    import jax
    import jax.numpy as jnp

    from consul_tpu.sim import coords as rC

    n = 2048
    arrs = _random_coords(n, 1, coincident=n if form == "coincident"
                          else 0)
    rc = rC.CoordState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tc = tC.CoordState(**{k: torch.from_numpy(v.copy())
                          for k, v in arrs.items()})
    rng = np.random.default_rng(2)
    j = ((np.arange(n) + rng.integers(1, n, n)) % n).astype(np.int32)
    rtt = rng.uniform(0.001, 0.12, n).astype(np.float32)
    upd = None
    if form == "masked":
        rtt[::7] = 0.0
        rtt[3::11] = -1.0
        upd = rng.random(n) < 0.7
    i = None
    if form == "indexed":
        i = rng.permutation(n)[: n // 3].astype(np.int32)
        j, rtt = j[: n // 3], rtt[: n // 3]
    for seed in (0, 1):
        got = tC.vivaldi_step(
            tc, None if i is None else torch.from_numpy(i),
            torch.from_numpy(j), torch.from_numpy(rtt), prng.key(seed),
            None if upd is None else torch.from_numpy(upd))
        want = jax.device_get(rC.vivaldi_step(
            rc, None if i is None else jnp.asarray(i), jnp.asarray(j),
            jnp.asarray(rtt), jax.random.key(seed),
            None if upd is None else jnp.asarray(upd)))
        _assert_coords_close(got, want)
    moved = (got.vec != tc.vec).any(-1).numpy()
    if form == "masked":
        assert not moved[::7].any() and not moved[3::11].any()
        assert not moved[~upd].any() and moved.sum() > n // 3
    if form == "indexed":
        untouched = np.setdiff1d(np.arange(n), i)
        assert not moved[untouched].any()


def test_estimate_nearest_k_and_metrics_match_reference(ref):
    import jax
    import jax.numpy as jnp

    from consul_tpu.sim import coords as rC
    from consul_tpu.sim import topology as rT

    n, k, q = 4097, 9, 31
    arrs = _random_coords(n, 5)
    rc = rC.CoordState(**{a: jnp.asarray(v) for a, v in arrs.items()})
    tc = tC.CoordState(**{a: torch.from_numpy(v.copy())
                          for a, v in arrs.items()})
    i = np.arange(n, dtype=np.int32)
    j = np.array(rT.sample_pairs(n, jax.random.key(0)))
    _scaled_close(tC.estimate_rtt(tc, torch.from_numpy(i),
                                  torch.from_numpy(j)).numpy(),
                  rC.estimate_rtt(rc, i, j), what="estimate_rtt")
    idx, dist = tC.nearest_k(tc, q, k)
    ridx, rdist = rC.nearest_k(rc, q, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _scaled_close(dist.numpy(), rdist, what="nearest_k")
    assert q not in idx.tolist()
    topo_r = rT.make_topology(rT.TopologyParams(n=n, seed=2))
    topo_t = tT.topology_from_numpy(jax.device_get(topo_r), "cpu")
    drift = np.float32(0.0123)
    got = tC.coord_metrics(tc, topo_t, tC.CoordRoundAux(
        pair_j=torch.from_numpy(j), drift=torch.tensor(drift)))
    want = rC.coord_metrics(rc, topo_r, rC.CoordRoundAux(
        pair_j=jnp.asarray(j), drift=jnp.float32(drift)))
    assert got.dtype == torch.float32 and got.shape == (3,)
    # the same relative errors in, the percentiles interpolate as the
    # reference's do; XLA may fold the f32 position q/100·(n-1) in
    # another order (at n - 1 = 4096, a power of two), so they are held
    # in scaled ulps
    rel = np.abs(np.asarray(rC.estimate_rtt(rc, i, j))
                 - np.asarray(rT.true_rtt(topo_r, i, j))) \
        / np.maximum(np.asarray(rT.true_rtt(topo_r, i, j)), 1e-9)
    got_p = tC._percentiles(torch.from_numpy(rel), (50.0, 99.0))
    _scaled_close(torch.stack(got_p).numpy(),
                  [jnp.percentile(rel, 50.0), jnp.percentile(rel, 99.0)],
                  what="percentiles")
    _scaled_close(got.numpy(), want, what="coord_metrics")
    np.testing.assert_allclose(float(tC.round_drift(tc, tc._replace(
        vec=tc.vec + 0.001))), np.sqrt(8) * 0.001, rtol=1e-5)


# ------------------------------------------------------- engine runs


def test_run_rounds_coords_matches_reference(ref):
    """1,024 nodes, RTT-aware deadlines on, a probe timeout below the
    cross-DC RTT (so acks go late and suspicions start): int lanes
    exact, coordinates within RUN_ATOL."""
    import jax

    from consul_tpu.sim import coords as rC
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate
    from consul_tpu.sim import topology as rT

    n, rounds = 1024, 40
    tp = _tparams(n, coords_timeout=True).with_(probe_timeout=0.05)
    rp = _rparams(n, coords_timeout=True).with_(probe_timeout=0.05)
    topo_r = rT.make_topology(rT.TopologyParams(n=n, seed=1))
    topo_t = tT.topology_from_numpy(jax.device_get(topo_r), "cpu")
    s, c, tr = tround.run_rounds_coords(
        tstate.init_state(n, device="cpu"), tC.init_coords(n, device="cpu"),
        topo_t, prng.key(0), tp, rounds)
    rs, rc, rtr = jax.device_get(rround.run_rounds_coords(
        rstate.init_state(n), rC.init_coords(n), topo_r,
        jax.random.key(0), rp, rounds))
    _assert_states_equal(tstate.to_numpy(s), rs, ENGINE_ULPS)
    assert int(s.stats.suspicions) > 0
    for f in tC.CoordState._fields:
        if f == "adj_idx":
            np.testing.assert_array_equal(c.adj_idx.numpy(), rc.adj_idx)
        else:
            np.testing.assert_allclose(getattr(c, f).numpy(),
                                       np.asarray(getattr(rc, f)),
                                       rtol=0, atol=RUN_ATOL, err_msg=f)
    assert tr.shape == (rounds, 3)
    np.testing.assert_allclose(tr.numpy(), rtr, rtol=0, atol=TRACE_ATOL)


def test_coordinates_leave_the_dynamics_unchanged_without_deadlines():
    """The coordinate draws come off ``fold_in(key, COORD_FOLD)``: with
    ``coords_timeout`` off a run with coordinates is the run without
    them, lane for lane; the flight recorder's coordinate columns are
    ``run_rounds_coords``'s trace, and zeros on a run without them."""
    n, rounds = 1024, 12
    p = _tparams(n, loss=0.05)
    topo = tT.make_topology(tT.TopologyParams(n=n, seed=4), "cpu")
    s1, c1, tr1 = tround.run_rounds_coords(
        tstate.init_state(n, device="cpu"), tC.init_coords(n, device="cpu"),
        topo, prng.key(9), p, rounds)
    s2, _ = tround.run_rounds(tstate.init_state(n, device="cpu"),
                              prng.key(9), p, rounds)
    for f in tstate.NODE_FIELDS:
        np.testing.assert_array_equal(getattr(s1, f).numpy(),
                                      getattr(s2, f).numpy(), err_msg=f)
    s3, c3, fl = tround.run_rounds_flight(
        tstate.init_state(n, device="cpu"), prng.key(9), p, rounds,
        coords=tC.init_coords(n, device="cpu"), topo=topo)
    cols = [flight.COL[c] for c in flight.COORD_COLUMNS]
    np.testing.assert_array_equal(fl[:, cols].numpy(), tr1.numpy())
    np.testing.assert_array_equal(c3.vec.numpy(), c1.vec.numpy())
    _, plain = tround.run_rounds_flight(tstate.init_state(n, device="cpu"),
                                        prng.key(9), p, rounds)
    assert not plain[:, cols].any()
    assert bool((fl[:, flight.COL["rtt_err_med"]] > 0).all())


def test_kernel_runner_coord_trace_conforms_to_live_engine():
    """The kernel runner's coordinates (population ack gate, its own
    Philox stream for the protocol) learn the topology as well as the
    live engine's per-node gate: both medians under 0.3 and within 0.1
    of each other, the reference's bounds for its TPU runner
    (tests/test_coords.py:280-302), on the CPU plain path at 8,192
    nodes. After 100 rounds, not 60: on jax 0.9's stream the error sits
    on a plateau near 0.35 until about round 60, the reference's own
    engine included (``test_live_engine_convergence_is_the_references``)."""
    n, rounds = 8192, 100
    p = _tparams(n, loss=0.01)
    topo = tT.make_topology(tT.TopologyParams(n=n, seed=0), "cpu")
    run = cuda_round.make_run_rounds_cuda(p, rounds, coords=True,
                                          flight_every=1)
    _, c_k, tr_k = run(tstate.init_state(n, device="cpu"), prng.key(0),
                       coo=tC.init_coords(n, device="cpu"), topo=topo)
    _, _, tr_x = tround.run_rounds_coords(
        tstate.init_state(n, device="cpu"), tC.init_coords(n, device="cpu"),
        topo, prng.key(1), p, rounds)
    med_k = float(tr_k[-1, flight.COL["rtt_err_med"]])
    med_x = float(tr_x[-1, 0])
    assert med_k < 0.3 and med_x < 0.3, (med_k, med_x)
    assert abs(med_k - med_x) < 0.1
    assert med_k < float(tr_k[0, flight.COL["rtt_err_med"]])
    # stride 10 records the same rounds' rows as stride 1 does
    _, _, tr10 = cuda_round.make_run_rounds_cuda(
        p, rounds, coords=True, flight_every=10)(
        tstate.init_state(n, device="cpu"), prng.key(0),
        coo=tC.init_coords(n, device="cpu"), topo=topo)
    coord_cols = [flight.COL[c] for c in flight.COORD_COLUMNS]
    np.testing.assert_array_equal(tr10[:, coord_cols].numpy(),
                                  tr_k[9::10, coord_cols].numpy())


def test_live_engine_convergence_is_the_references(ref):
    """The reference's convergence pin (tests/test_coords.py:131-154:
    under 0.25 after 60 rounds at 4,096 nodes) does not hold on jax
    0.9's random stream for the reference itself; the port's live
    engine draws the same stream and gives the same median error trace
    within TRACE_ATOL, and both fall under the bar later."""
    import jax

    from consul_tpu.sim import coords as rC
    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate
    from consul_tpu.sim import topology as rT

    n, rounds = 4096, 90
    topo_r = rT.make_topology(rT.TopologyParams(n=n, seed=0))
    _, _, want = rround.run_rounds_coords(
        rstate.init_state(n), rC.init_coords(n), topo_r, jax.random.key(0),
        _rparams(n), rounds)
    _, _, got = tround.run_rounds_coords(
        tstate.init_state(n, device="cpu"), tC.init_coords(n, device="cpu"),
        tT.topology_from_numpy(jax.device_get(topo_r), "cpu"), prng.key(0),
        _tparams(n), rounds)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TRACE_ATOL)
    assert want[59, 0] > 0.25
    assert got[-1, 0] < 0.25 and want[-1, 0] < 0.25


def test_run_coords_passes_the_reference_smoke_bounds():
    rep, coords = run_coords(n=512, seed=0, device="cpu")
    assert rep["scenario"] == "coords"
    assert rep["rounds"] == coords_plan(512).total_rounds == 140
    assert rep["convergence_round"] > 0
    assert rep["final_med_err"] < 0.5
    assert rep["converged_med_err"] == COORDS_CONVERGED_MED_ERR
    phases = [ph["phase"] for ph in rep["flight"]["phases"]]
    assert phases == ["warmup", "partition", "heal"]
    assert all(len(ph["curve"]["rtt_err_med"]) == ph["rounds"]
               for ph in rep["flight"]["phases"])
    ups = tC.coordinate_updates(coords, count=3)
    assert [u["Node"] for u in ups] == ["sim-0", "sim-1", "sim-2"]
    assert len(ups[0]["Coord"]["Vec"]) == 8
    named = tC.coordinate_updates(coords, names=["a", "b"])
    assert [u["Node"] for u in named] == ["a", "b"]
    assert named[1]["Coord"]["Height"] == float(coords.height[1])
