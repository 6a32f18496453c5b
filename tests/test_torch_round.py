"""consul_tpu_torch's protocol round against the JAX reference.

* One round of ``round_core`` against the reference ``_round_core`` with
  the same numpy uniforms injected on both sides (the reference's
  ``u01=`` seam: each of ``jax.random.split(key, 5)``'s keys maps to its
  draw slot), in live and stale modes, for the LAN headline config and
  the full model (churn + slow + stats). Every int lane, the f32
  ``informed`` lane and the counters must be EXACT (the port computes in
  the same f32 op order); the stale scalars are sums taken in another
  order and must agree within 1e-5 relative.
* The threefry-driven engines (``gossip_round``, ``run_rounds``,
  ``make_run_rounds_fast``) draw the reference's own uniforms and must
  reproduce its states exactly at 16,384 nodes.
* Multi-round statistics of the kernel runner's plain path (its own
  Philox stream) against the reference fast path, at the tolerances the
  reference holds its TPU kernel to (tests/test_pallas_round.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from consul_tpu_torch.config import GossipConfig as TGossip
from consul_tpu_torch.sim import cuda_round, prng
from consul_tpu_torch.sim import params as tparams
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.metrics import fd_report
from test_torch_harness import ref  # noqa: F401  (fixture)

N = 16_384
SCALAR_RTOL = 1e-5

CONFIGS = {
    "lan": dict(loss=0.01, tcp_fallback=False, collect_stats=False),
    "full": dict(loss=0.05, tcp_fallback=False, fail_per_round=0.002,
                 rejoin_per_round=0.02, leave_per_round=0.001,
                 slow_per_round=0.002, slow_recover_per_round=0.03,
                 slow_factor=0.05, collect_stats=True),
}


def _params(name, n=N):
    from consul_tpu.config import GossipConfig as RGossip
    from consul_tpu.sim.params import SimParams as RParams

    kw = CONFIGS[name]
    return (tparams.SimParams.from_gossip_config(TGossip.lan(), n=n, **kw),
            RParams.from_gossip_config(RGossip.lan(), n=n, **kw))


def _warm_ref_state(n):
    """A reference state with dead, slow and suspect rows."""
    import jax.numpy as jnp

    from consul_tpu.sim import state as rstate

    s = rstate.init_state(n)
    s = rstate.with_crashed(s, jnp.arange(0, n, 97), age=3)
    s = rstate.with_slow(s, jnp.arange(1, n, 131))
    return s


def _assert_states_equal(a, b, exact_f32=True):
    """a: numpy view of a port state; b: fetched reference state."""
    for f in tstate.NODE_FIELDS:
        x, y = getattr(a, f), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in tstate.SimStats._fields:
        x, y = getattr(a.stats, f), np.asarray(getattr(b.stats, f))
        if f == "detect_latency_sum" and not exact_f32:
            np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=f)
        else:
            assert x == y, (f, x, y)
    assert float(a.t) == float(b.t) and int(a.round_idx) == int(b.round_idx)


@pytest.mark.parametrize("mode", ["stale", "live"])
@pytest.mark.parametrize("config", ["lan", "full"])
def test_round_core_matches_reference_with_injected_uniforms(ref, config,
                                                             mode):
    import jax
    import jax.numpy as jnp

    from consul_tpu.sim import round as rround

    tp, rp = _params(config)
    rs = _warm_ref_state(N)
    rsc = rround.init_scalars(rs, rp) if mode == "stale" else None
    rng = np.random.default_rng(17)
    key = jax.random.key(5)
    for r in range(3):
        k = jax.random.fold_in(key, r)
        u = rng.random((tround.N_DRAWS, N), dtype=np.float32)
        slot = {tuple(np.asarray(jax.random.key_data(kk)).tolist()): i
                for i, kk in enumerate(jax.random.split(k, 5))}

        def u_ref(kk):
            kd = tuple(np.asarray(jax.random.key_data(kk)).tolist())
            return jnp.asarray(u[slot[kd]])

        ts = tstate.from_numpy(jax.device_get(rs), "cpu")
        tsc = None if rsc is None else torch.from_numpy(np.array(rsc))
        out = rround._round_core(rs, rsc, k, rp, u01=u_ref)
        ts2, tsc2 = tround.round_core(ts, tsc, tp,
                                      lambda s: torch.from_numpy(u[s]))
        rs2 = jax.device_get(out[0])
        _assert_states_equal(tstate.to_numpy(ts2), rs2,
                             exact_f32=(mode == "live"))
        if mode == "stale":
            np.testing.assert_allclose(tsc2.numpy(), np.asarray(out[1]),
                                       rtol=SCALAR_RTOL, atol=1e-6)
        rs, rsc = out[0], out[1]


@pytest.mark.parametrize("config", ["lan", "full"])
def test_init_scalars_match_reference(ref, config):
    import jax

    from consul_tpu.sim import round as rround

    tp, rp = _params(config)
    rs = _warm_ref_state(N)
    ts = tstate.from_numpy(jax.device_get(rs), "cpu")
    np.testing.assert_allclose(tround.init_scalars(ts, tp).numpy(),
                               np.asarray(rround.init_scalars(rs, rp)),
                               rtol=SCALAR_RTOL)


def test_threefry_engines_reproduce_reference_states(ref):
    import jax

    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate

    tp, rp = _params("full")
    key, tkey = jax.random.key(3), prng.key(3)
    a = tround.gossip_round(tstate.init_state(N, device="cpu"), tkey, tp)
    b = rround.gossip_round(rstate.init_state(N), key, rp)
    _assert_states_equal(tstate.to_numpy(a), jax.device_get(b))

    a, _ = tround.run_rounds(tstate.init_state(N, device="cpu"), tkey,
                             tp, 12)
    b, _ = rround.run_rounds(rstate.init_state(N), key, rp, 12)
    _assert_states_equal(tstate.to_numpy(a), jax.device_get(b),
                         exact_f32=False)

    a = tround.make_run_rounds_fast(tp, 20)(
        tstate.init_state(N, device="cpu"), tkey)
    b = rround.make_run_rounds_fast(rp, 20)(rstate.init_state(N), key)
    _assert_states_equal(tstate.to_numpy(a), jax.device_get(b),
                         exact_f32=False)


def test_fast_runner_resume_from_carry_bitwise():
    tp, _ = _params("full")
    tkey = prng.key(8)
    straight = tround.make_run_rounds_fast(tp, 10)(
        tstate.init_state(4096, device="cpu"), tkey)
    half = tround.make_run_rounds_fast(tp, 5, carry=True)
    s, sc = half(tstate.init_state(4096, device="cpu"), tkey)
    s, _ = half(s, tkey, scalars0=sc)
    for x, y in zip(straight[:-1], s[:-1]):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(straight.stats, s.stats))
    with pytest.raises(ValueError, match="carry=True"):
        tround.make_run_rounds_fast(tp, 5)(s, tkey, scalars0=sc)


def test_packed_and_unpacked_layouts_run_bitwise_equal():
    tp, _ = _params("full", n=4096)
    tkey = prng.key(1)
    run = tround.make_run_rounds_fast(tp, 8)
    packed = run(tstate.init_state(4096, device="cpu"), tkey)
    wide = run(tstate.init_state(4096, packed=False, device="cpu"), tkey)
    assert wide.incarnation.dtype == torch.int32
    back = tstate.pack(wide)
    for f in tstate.NODE_FIELDS:
        assert torch.equal(getattr(back, f), getattr(packed, f)), f


def test_fd_report_matches_reference(ref):
    import jax

    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate
    from consul_tpu.sim.metrics import fd_report as r_fd_report

    tp, rp = _params("full", n=4096)
    b = rround.make_run_rounds_fast(rp, 6)(rstate.init_state(4096),
                                           jax.random.key(0))
    a = tstate.from_numpy(jax.device_get(b), "cpu")
    got, want = fd_report(a, tp).to_dict(), r_fd_report(b, rp).to_dict()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


# --------------------------------------------- multi-round statistics

STAT_N = 65_536


def _stat_runs(ref_p_kw, rounds, seed=0):
    """(port kernel runner on the CPU plain path, reference fast path)."""
    import jax

    from consul_tpu.sim import round as rround
    from consul_tpu.sim import state as rstate
    from consul_tpu.sim.params import SimParams as RParams

    tp = tparams.SimParams(n=STAT_N, **ref_p_kw)
    rp = RParams(n=STAT_N, **ref_p_kw)
    port = cuda_round.make_run_rounds_cuda(tp, rounds)(
        tstate.init_state(STAT_N, device="cpu"), prng.key(seed))
    ref_s = rround.make_run_rounds_fast(rp, rounds)(
        rstate.init_state(STAT_N), jax.random.key(seed + 1))
    return port, jax.device_get(ref_s)


def test_runner_matches_reference_dynamics(ref):
    port, r = _stat_runs(dict(loss=0.30, tcp_fallback=False,
                              collect_stats=False), 150)
    ps = int((port.status == tstate.SUSPECT).sum())
    rs = int((np.asarray(r.status) == tstate.SUSPECT).sum())
    assert rs > 0
    assert 0.85 < ps / rs < 1.15, (ps, rs)
    assert int((port.incarnation > 0).sum()) > 0


def test_runner_full_model_and_stats_conformance(ref):
    port, r = _stat_runs(dict(loss=0.20, tcp_fallback=False,
                              fail_per_round=0.002, rejoin_per_round=0.02,
                              slow_per_round=0.002,
                              slow_recover_per_round=0.03,
                              slow_factor=0.05, collect_stats=True), 150)
    assert abs(float(port.up.float().mean())
               - float(np.mean(np.asarray(r.down_age) < 0))) < 0.02
    assert abs(float(port.slow.float().mean())
               - float(np.mean(np.asarray(r.down_age) == -2))) < 0.01
    ps = int((port.status == tstate.SUSPECT).sum())
    rs = int((np.asarray(r.status) == tstate.SUSPECT).sum())
    assert 0.85 < ps / max(rs, 1) < 1.15, (ps, rs)
    for f in ("suspicions", "refutes", "crashes", "rejoins",
              "true_deaths_declared"):
        pv, rv = int(getattr(port.stats, f)), int(getattr(r.stats, f))
        assert rv > 0, f
        assert 0.8 < pv / rv < 1.25, (f, pv, rv)
    pl = float(port.stats.detect_latency_sum) \
        / max(int(port.stats.true_deaths_declared), 1)
    rl = float(r.stats.detect_latency_sum) \
        / max(int(r.stats.true_deaths_declared), 1)
    assert 0.7 < pl / rl < 1.4, (pl, rl)
