"""consul_tpu_torch's per-viewer tier (sim/views.py) against the JAX
reference.

* ``prng.uniform`` over a 2-D shape with bounds is bit for bit
  ``jax.random.uniform`` (the ``_pick`` draw).
* ``_key``/``_unkey`` and ``_merge`` equal the reference's on the same
  inputs; ``torch.argmax`` takes the first maximum and 0 on an all
  ``-inf`` row, as ``jnp.argmax`` does.
* ``views_round`` at n=128 from the same state and key: every lane
  equals the reference's where every pick agrees — and the test asserts
  that they do (PyTorch's and XLA's ``log`` differ in the last bits, so
  a Gumbel pick could flip where the top two candidates lie within a
  few ulp; none does at this size).
* The reference's ten ``tests/test_sim_views.py`` assertions and its
  ``test_views_mf_smoke_fast`` (``tests/test_conformance.py``) on the
  port.
* The viewer-sharded tier on gloo worlds of 2 and 4 CPU ranks: one
  round equals the reference's ``make_sharded_views_round`` on as many
  virtual devices, the ``all_to_all`` and ``pmax`` exchanges agree bit
  for bit over 35 rounds (push/pull fires), and the sharded tier detects
  crashes and repairs a partition as the reference's test asserts.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from consul_tpu_torch.config import GossipConfig as TGossip
from consul_tpu_torch.sim import metrics as tmetrics
from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim import views as tv
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import ALIVE, DEAD, SUSPECT
from test_torch_harness import cuda, ref, run_world  # noqa: F401  (fixtures)

N = 64
CPU = "cpu"


def _key(seed: int) -> torch.Tensor:
    return prng.key(seed, CPU)


def _run(st, seed, p, rounds):
    return tv.run_views(st, _key(seed), p, rounds)


def _crash(st: tv.ViewState, idx) -> tv.ViewState:
    up, down = st.up.clone(), st.down_round.clone()
    up[idx] = False
    down[idx] = st.round
    return st._replace(up=up, down_round=down)


def _assert_views_equal(got: tv.ViewState, want) -> None:
    for f in tv.ViewState._fields:
        if f == "stats":
            for g in tv.ViewStats._fields:
                assert int(getattr(got.stats, g)) == \
                    int(np.asarray(getattr(want.stats, g))), g
            continue
        x, y = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f)


def _to_ref(st: tv.ViewState):
    """A port ViewState as the reference's (jnp arrays)."""
    import jax.numpy as jnp

    from consul_tpu.sim import views as rv

    arrs = {f: jnp.asarray(getattr(st, f).numpy())
            for f in tv.ViewState._fields if f != "stats"}
    return rv.ViewState(stats=rv.ViewStats(*[jnp.asarray(x.numpy())
                                             for x in st.stats]), **arrs)


# ------------------------------------------------------------ draws


@pytest.mark.parametrize("shape,lo,hi", [((128, 128), 1e-9, 1.0),
                                         ((3, 70), 0.0, 1.0),
                                         ((5, 9), -2.0, 3.5),
                                         ((1000,), 0.25, 0.75)])
def test_uniform_with_shape_and_bounds_is_bit_exact(ref, shape, lo, hi):
    import jax

    for seed in (0, 9, 2**31 + 5):
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                             minval=lo, maxval=hi))
        got = prng.uniform(_key(seed), shape, minval=lo, maxval=hi).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_view_round_keys_follow_the_reference(ref):
    """The split / fold_in shapes the views draw from."""
    import jax

    k = jax.random.key(17)
    for num in (2, 3, 4, 6):
        want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
        assert np.array_equal(prng.split(_key(17), num).numpy(), want)
    for shard in (0, 1, 3):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(k, shard)))
        assert np.array_equal(prng.fold_in(_key(17), shard).numpy(), want)


def test_argmax_takes_the_first_maximum_and_zero_on_empty_rows(ref):
    import jax.numpy as jnp

    x = np.array([[1.0, 3.0, 3.0, 2.0],
                  [-np.inf] * 4,
                  [5.0, -np.inf, 5.0, 5.0]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=1))
    got = torch.argmax(torch.from_numpy(x), dim=1).numpy()
    assert got.tolist() == want.tolist() == [1, 0, 0]


def test_pick_matches_reference(ref):
    """A Gumbel-max pick over a random mask, an empty row included."""
    import jax

    from consul_tpu.sim import views as rv

    rng = np.random.default_rng(3)
    mask = rng.random((96, 96)) < 0.3
    mask[5] = False
    for seed in range(4):
        want = np.asarray(rv._pick(jax.random.key(seed), mask))
        got = tv._pick(_key(seed), torch.from_numpy(mask)).numpy()
        assert np.array_equal(got, want)
        assert got[5] == 0


# ------------------------------------------------------------ merges


def test_key_and_unkey_exact(ref):
    import jax.numpy as jnp

    from consul_tpu.sim import views as rv

    rng = np.random.default_rng(0)
    status = rng.choice([ALIVE, SUSPECT, DEAD], (40, 40)).astype(np.int8)
    inc = rng.integers(0, 1000, (40, 40), dtype=np.int32)
    k = tv._key(torch.from_numpy(status), torch.from_numpy(inc))
    want = np.asarray(rv._key(jnp.asarray(status), jnp.asarray(inc)))
    assert k.dtype == torch.int32 and np.array_equal(k.numpy(), want)
    s, i = tv._unkey(k)
    rs, ri = rv._unkey(jnp.asarray(want))
    assert s.dtype == torch.int8
    assert np.array_equal(s.numpy(), np.asarray(rs))
    assert np.array_equal(i.numpy(), np.asarray(ri))
    assert np.array_equal(s.numpy(), status)
    assert np.array_equal(i.numpy(), inc)


@pytest.mark.parametrize("lifeguard", [True, False])
def test_merge_exact(ref, lifeguard):
    """Random views, incoming keys (-1 where nothing arrived) and
    confirmation sources: every merged lane equals the reference's,
    the int8 confirmation counter and budget included."""
    from consul_tpu.sim import views as rv
    from consul_tpu.sim.params import SimParams as RParams

    n = 48
    rng = np.random.default_rng(1 + lifeguard)
    st = tv.init_views(n, device=CPU)
    status = rng.choice([ALIVE, SUSPECT, DEAD], (n, n)).astype(np.int8)
    inc = rng.integers(0, 5, (n, n), dtype=np.int32)
    st = st._replace(
        status=torch.from_numpy(status), inc=torch.from_numpy(inc),
        susp_start=torch.from_numpy(rng.integers(0, 9, (n, n),
                                                 dtype=np.int32)),
        susp_deadline=torch.from_numpy(rng.integers(5, 40, (n, n),
                                                    dtype=np.int32)),
        susp_conf=torch.from_numpy(rng.integers(0, 4, (n, n),
                                                dtype=np.int8)),
        budget=torch.from_numpy(rng.integers(0, 16, (n, n),
                                             dtype=np.int8)),
        lh=torch.from_numpy(rng.integers(0, 8, (n,), dtype=np.int8)),
        round=torch.tensor(11, dtype=torch.int32))
    own = tv._key(st.status, st.inc).numpy()
    inc_key = np.where(rng.random((n, n)) < 0.5,
                       own + rng.integers(-1, 3, (n, n)), -1).astype(np.int32)
    confirm = rng.random((n, n)) < 0.5
    kw = dict(n=n, lifeguard=lifeguard, loss=0.1)
    got = tv._merge(st, torch.from_numpy(inc_key), torch.from_numpy(confirm),
                    SimParams(**kw), st.lh)
    import jax.numpy as jnp

    want = rv._merge(_to_ref(st), jnp.asarray(inc_key), jnp.asarray(confirm),
                     RParams(**kw), jnp.asarray(st.lh.numpy()))
    _assert_views_equal(got, want)


def test_suspect_beats_alive_same_incarnation():
    """memberlist state.go: suspect(inc) overrides alive(inc);
    alive(inc+1) overrides suspect(inc); dead(inc) overrides both."""
    def key(status, inc):
        return int(tv._key(torch.tensor(status, dtype=torch.int8),
                           torch.tensor(inc, dtype=torch.int32)))

    a, s, d, a6 = (key(ALIVE, 5), key(SUSPECT, 5), key(DEAD, 5),
                   key(ALIVE, 6))
    assert s > a and d > s and a6 > d


# ------------------------------------------------------ one round


@pytest.mark.parametrize("kw", [
    dict(loss=0.02),
    dict(loss=0.1, fail_per_round=0.01, slow_per_round=0.02),
    dict(loss=0.05, fail_per_round=0.01, lifeguard=False)],
    ids=["quiet", "churn-slow", "no-lifeguard"])
def test_views_round_matches_reference(ref, monkeypatch, kw):
    """Both tiers 29 rounds from the same key (equal after every one),
    then round 29 (a push/pull round) from the same state: every lane
    exact. Every Gumbel pick of that round is drawn again by the
    reference's ``_pick`` on the same key and mask; the count that
    differ is printed and must be 0 (the libraries' ``log`` differ in
    the last bits, so a pick could flip only where the top two
    candidates lie within a few ulp)."""
    import jax
    import jax.numpy as jnp

    from consul_tpu.sim import views as rv
    from consul_tpu.sim.params import SimParams as RParams

    n = 128
    tp, rp = SimParams(n=n, **kw), RParams(n=n, **kw)
    st = _run(tv.init_views(n, device=CPU), 5, tp, 29)
    ref_st = rv.run_views(rv.init_views(n), jax.random.key(5), rp, 29)
    _assert_views_equal(st, ref_st)

    calls = []
    pick = tv._pick

    def spy(k, mask):
        # a pick's key may reach it underived (a prng.SubKey)
        kv = k.value() if isinstance(k, prng.SubKey) else k
        calls.append((kv.clone(), mask.clone()))
        return pick(k, mask)

    monkeypatch.setattr(tv, "_pick", spy)
    got = tv.views_round(st, _key(77), tp)
    # a gossip tick draws its fanout's picks from a key stack
    picks = [(k, m) for ks, m in calls for k in ks.reshape(-1, 2)]
    differ = sum(int((pick(k, m).numpy() != np.asarray(rv._pick(
        jax.random.wrap_key_data(k.numpy().astype(np.uint32)),
        jnp.asarray(m.numpy())))).sum()) for k, m in picks)
    print(f"{kw}: {len(picks)} picks of {n} rows, {differ} differ")
    assert len(picks) >= 1 + int(tp.gossip_ticks_per_round) * tp.gossip_nodes
    assert differ == 0
    _assert_views_equal(got, rv.views_round(_to_ref(st), jax.random.key(77),
                                            rp))


def test_view_metrics_and_rates_match_reference(ref):
    import jax

    from consul_tpu.sim import views as rv
    from consul_tpu.sim.params import SimParams as RParams

    kw = dict(n=96, loss=0.15, fail_per_round=0.01, tcp_fallback=False)
    st = _run(tv.init_views(96, device=CPU), 4, SimParams(**kw), 20)
    ref_st = rv.run_views(rv.init_views(96), jax.random.key(4),
                          RParams(**kw), 20)
    assert tv.view_metrics(st) == rv.view_metrics(ref_st)
    assert tv.view_rates(st, SimParams(**kw), 20) == \
        rv.view_rates(ref_st, RParams(**kw), 20)
    assert np.array_equal(tv.partition_reach(96, 40, CPU).numpy(),
                          np.asarray(rv.partition_reach(96, 40)))


# ----------------------------------- the reference's own assertions


def test_quiet_cluster_stays_converged():
    """loss=0: no suspicion ever starts, views all-ALIVE forever."""
    p = SimParams(n=N, loss=0.0)
    m = tv.view_metrics(_run(tv.init_views(N, device=CPU), 0, p, 40))
    assert m["fp_rate"] == 0.0
    assert m["suspect_pairs"] == 0
    assert m["view_divergence"] == 0.0
    assert m["max_incarnation"] == 0


def test_crash_detection_all_viewers():
    """Crashed nodes go DEAD in EVERY live viewer's view within the
    suspicion window + dissemination slack, and no live node with them."""
    p = SimParams(n=N, loss=0.01)
    st = _run(tv.init_views(N, device=CPU), 0, p, 10)
    st = _run(_crash(st, torch.arange(8)), 1, p, 60)
    m = tv.view_metrics(st)
    assert m["detected_frac"] == 1.0
    assert m["fp_rate"] == 0.0


def test_refutation_race_under_loss():
    """25% loss, no TCP fallback: suspicions fire constantly, live nodes
    keep refuting with higher incarnations and are essentially never
    declared dead."""
    p = SimParams(n=N, loss=0.25, tcp_fallback=False)
    m = tv.view_metrics(_run(tv.init_views(N, device=CPU), 5, p, 150))
    assert m["max_incarnation"] > 0, "no refutation ever happened"
    assert m["fp_rate"] < 0.01
    assert m["up"] == N


def _split_chain(seed: int, rounds: int):
    """The reference tests' key chain: key, k = split(key) per round."""
    key = _key(seed)
    for _ in range(rounds):
        key, k = prng.split(key, 2)
        yield k


def test_lifeguard_confirmations_shrink_timer():
    """Deadlines of suspicions never undercut start + min timeout, and
    never pass max timeout x (awareness ceiling + 1)."""
    p = SimParams(n=N, loss=0.2, tcp_fallback=False)
    min_r, max_r = tv._timeout_rounds(p)
    st = tv.init_views(N, device=CPU)
    seen = 0
    for k in _split_chain(7, 40):
        st = tv.views_round(st, k, p)
        sus = st.status == SUSPECT
        span = st.susp_deadline - st.susp_start
        seen += int(sus.sum())
        assert bool(((span >= min_r) | ~sus).all())
        assert bool(((span <= max_r * (p.awareness_max + 1)) | ~sus).all())
    assert seen > 0


def test_rumor_ordering_keys_monotonic():
    """Every (viewer, subject) merge key is non-decreasing over time: no
    view ever regresses to an older belief."""
    p = SimParams(n=N, loss=0.3, tcp_fallback=False, fail_per_round=0.002)
    st = tv.init_views(N, device=CPU)
    prev = tv._key(st.status, st.inc)
    for k in _split_chain(3, 50):
        st = tv.views_round(st, k, p)
        cur = tv._key(st.status, st.inc)
        assert bool((cur >= prev).all()), "a view regressed"
        prev = cur


def test_partition_heal_repair():
    """A clean 32/32 partition: halves declare each other dead; after
    the heal, reconnect hands the dead rumor to its subjects,
    refutations chase it out, and views fully reconverge."""
    p = SimParams(n=N, loss=0.0)
    st = tv.init_views(N, device=CPU)._replace(
        reach=tv.partition_reach(N, 32, CPU))
    st = _run(st, 2, p, 60)
    assert tv.view_metrics(st)["fp_rate"] > 0.45
    st = _run(st._replace(reach=torch.ones((N, N), dtype=torch.bool)),
              3, p, 120)
    m = tv.view_metrics(st)
    assert m["view_divergence"] == 0.0
    assert m["fp_rate"] == 0.0
    assert m["max_incarnation"] >= 1


def test_views_vs_meanfield_detection_agreement():
    """Both tiers, same config and crash set, detect every crashed node
    within the same round budget."""
    p = SimParams(n=N, loss=0.01)
    budget = 60
    vs = _run(tv.init_views(N, device=CPU), 0, p, 5)
    vs = _run(_crash(vs, torch.arange(6)), 1, p, budget)
    assert tv.view_metrics(vs)["detected_frac"] == 1.0
    ms = tstate.with_crashed(tstate.init_state(N, device=CPU), slice(0, 6))
    ms = tround.make_run_rounds(p, budget)(ms, _key(1))
    assert bool((ms.status[:6] == DEAD).all())


_CONF_CFG = dataclasses.replace(TGossip.local(), disable_tcp_pings=True,
                                suspicion_mult=4, gossip_nodes=3)


def test_views_mf_smoke_fast():
    """The reference's fast conformance stand-in (its
    test_conformance.py:516): at n=512 x 120 rounds, 10% loss, the
    views tier's subject-level suspicion and refutation rates within
    2.5x of the mean-field tier's, and the one-sided FP criterion."""
    n, rounds = 512, 120
    p = SimParams.from_gossip_config(_CONF_CFG, n=n, loss=0.10)
    mf, _ = tround.run_rounds(tstate.init_state(n, device=CPU), _key(0), p,
                              rounds)
    rep = tmetrics.fd_report(mf, p)
    nr = n * rounds
    mfr = {"susp": rep.suspicions / nr, "fp": rep.false_positives / nr,
           "ref": rep.refutes / nr}
    vr = tv.view_rates(_run(tv.init_views(n, device=CPU), 100, p, rounds),
                       p, rounds)
    for what, a, b in (("suspicion rate", mfr["susp"], vr["susp_rate"]),
                       ("refute rate", mfr["ref"], vr["refute_rate"])):
        assert a > 0 and b > 0, f"{what}: vacuous ({a} vs {b})"
        assert 1.0 / 2.5 < a / b < 2.5, (what, a, b)
    assert abs(mfr["fp"] - vr["fp_rate"]) < 0.01
    assert mfr["fp"] <= vr["fp_rate"] + 1e-4


# ----------------------------------------------- the sharded tier


def _gather_rows(ranks: list) -> dict:
    """Rank results (ViewStates of numpy arrays) as one state's arrays:
    the row fields concatenated in rank order, the rest rank 0's."""
    out = {f: (np.concatenate([getattr(r, f) for r in ranks])
               if f in tv.ROW_FIELDS else getattr(ranks[0], f))
           for f in tv.ViewState._fields if f != "stats"}
    out["stats"] = ranks[0].stats
    return out


def _views_world(mesh, cases: tuple) -> dict:
    """One launched rank: the round-trip cases named in ``cases``."""
    dev = mesh.device
    out = {}
    if "round" in cases:
        p = SimParams(n=64, loss=0.1, fail_per_round=0.01,
                      slow_per_round=0.02)
        rnd, init = tv.make_sharded_views_round(p, mesh)
        st = init()
        for r in range(3):
            st = rnd(st, prng.key(r, dev))
        out["round"] = st
    if "exchanges" in cases:
        p = SimParams(n=64, loss=0.10, fail_per_round=0.005)
        r_a, init = tv.make_sharded_views_round(p, mesh, "all_to_all")
        r_p, _ = tv.make_sharded_views_round(p, mesh, "pmax")
        a = b = init()
        key = prng.key(11, dev)
        for _ in range(35):
            key, k = prng.split(key, 2)
            a, b = r_a(a, k), r_p(b, k)
        out["exchanges"] = (a, b)
    if "scenario" in cases:
        out["scenario"] = _views_scenario(mesh)
    return out


def _views_scenario(mesh) -> list:
    """The reference's sharded-tier scenario at n=128: quiet, then 8
    crashes, then a 64/64 partition healed; ``view_metrics`` of the
    gathered views after each stage (every rank computes them)."""
    dev = mesh.device
    n = 128
    p = SimParams(n=n, loss=0.01)
    rnd, init = tv.make_sharded_views_round(p, mesh)
    rows = slice(mesh.rank * n // mesh.world, (mesh.rank + 1) * n // mesh.world)

    def run(st, key, rounds):
        for _ in range(rounds):
            key, k = prng.split(key, 2)
            st = rnd(st, k)
        return st, key

    def metrics(st):
        whole = {f: mesh.coll.all_gather(getattr(st, f), mesh.group)
                 .reshape((n,) + tuple(getattr(st, f).shape[1:]))
                 for f in tv.ROW_FIELDS}
        return tv.view_metrics(st._replace(**whole))

    out = []
    st, key = run(init(), prng.key(0, dev), 20)
    out.append(metrics(st))
    up = st.up.clone()
    up[:8] = False
    st, key = run(st._replace(up=up), key, 70)
    out.append(metrics(st))
    st = init()
    st = st._replace(reach=tv.partition_reach(n, 64, dev)[rows])
    st, key = run(st, prng.key(7, dev), 60)
    out.append(metrics(st))
    st, key = run(st._replace(reach=torch.ones_like(st.reach)), key, 130)
    out.append(metrics(st))
    return out


@functools.lru_cache(maxsize=None)
def _world(world: int) -> list:
    cases = ("round", "exchanges") + (("scenario",) if world == 4 else ())
    return run_world(world, _views_world, cases)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_views_round_matches_reference(ref, devices8, world):
    import jax

    from consul_tpu.sim import views as rv
    from consul_tpu.sim.params import SimParams as RParams

    rp = RParams(n=64, loss=0.1, fail_per_round=0.01, slow_per_round=0.02)
    rnd, init = rv.make_sharded_views_round(
        rp, rv.make_views_mesh(devices8[:world]))
    want = init()
    for r in range(3):
        want = rnd(want, jax.random.key(r))
    got = _gather_rows([r["round"] for r in _world(world)])
    for f, x in got.items():
        if f == "stats":
            for g in tv.ViewStats._fields:
                assert int(getattr(x, g)) == int(getattr(want.stats, g)), g
            continue
        y = np.asarray(getattr(want, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("world", [2, 4])
def test_all_to_all_exchange_matches_pmax(world):
    """Both exchanges from the same keys, 35 rounds (round 29 fires
    push/pull, so both call sites of the exchange run): bit for bit."""
    for rank in _world(world):
        a, b = rank["exchanges"]
        for f in tv.ViewState._fields:
            if f == "stats":
                assert all(int(x) == int(y) for x, y in zip(a.stats, b.stats))
                continue
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert int(a.round) == 35


def test_sharded_views_detect_and_repair():
    """The reference's sharded-tier scenario (its test_sim_views.py
    test_sharded_views_on_device_mesh) on 4 gloo ranks."""
    quiet, crashed, cut, healed = _world(4)[0]["scenario"]
    assert quiet["fp_rate"] == 0.0 and quiet["view_divergence"] == 0.0
    assert crashed["detected_frac"] == 1.0 and crashed["fp_rate"] == 0.0
    assert cut["fp_rate"] > 0.4
    assert healed["view_divergence"] == 0.0 and healed["fp_rate"] == 0.0
    assert healed["max_incarnation"] >= 1


@pytest.mark.cuda
def test_views_on_the_card_equal_the_host(cuda):
    """The bounded draw and 35 rounds of the views (push/pull included)
    on the card, bit for bit the host's."""
    k = _key(5)
    assert torch.equal(prng.uniform(k.to(cuda), (64, 96), 1e-9, 1.0).cpu(),
                       prng.uniform(k, (64, 96), 1e-9, 1.0))
    assert torch.equal(prng.uniform(k.to(cuda), (7, 9), -2.0, 3.5).cpu(),
                       prng.uniform(k, (7, 9), -2.0, 3.5))
    p = SimParams(n=128, loss=0.1, fail_per_round=0.01, slow_per_round=0.02)
    host = _run(tv.init_views(128, device=CPU), 3, p, 35)
    card = tv.run_views(tv.init_views(128, device=cuda), prng.key(3, cuda),
                        p, 35)
    _assert_views_equal(tv.ViewState(
        *[x.cpu() for x in card[:-1]],
        stats=tv.ViewStats(*[x.cpu() for x in card.stats])), host)
