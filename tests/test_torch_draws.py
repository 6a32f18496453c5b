"""consul_tpu_torch's fused draw and sum kernels (``sim/fused.py``).

CPU half: the kernels' plain twins, reached through the public
functions inside ``fused.twins()``, against the plain versions and the
JAX reference.

* Every draw mode (``words``: ``threefry2x32``, ``fold_in``, ``split``,
  ``round_keys``; ``xor``: ``bits``, ``randint``; ``seeds``:
  ``round_seeds``; ``uniform`` with each bound kind; ``u01_global``) is
  bit for bit the composite plain function and ``jax.random`` /
  ``jax.extend.random.threefry_2x32`` on seeded keys, key stacks and
  offsets near 2^32; so are the keys derived in the launch: the seeds
  draw against the reference's ``round_seeds``, a round's slots as the
  rows of one draw against ``split`` + ``uniform`` and the reference's
  ``lanes.u01_global`` slot by slot (the replay slot among them), and
  ``SubKey`` draws. The slot guard raises on a slot the round did not
  draw, ``round.draw_slots`` is the set the round body reads, the
  engines draw once a round, and the kernel's word loop (4 words a
  thread, vector stores on aligned rows, scalar tails of 1-3 words) is
  walked in Python over every word of the edge shapes.
* ``lanes.tree_sum_staged`` (the partials of the sum kernel's one
  launch, ``fused.sum_plan``: level t by the threads, level k by the
  CTAs' ranges, the fold) is bit for bit ``lanes.tree_sum`` over every
  length a hypothesis strategy draws in [1, 3 * 2^16], plus 1,048,576
  and 1,000,003 on 1 and 5 rows, the rows on both sides of the length
  at which a row is cut, uneven ranges and a last CTA that owns the
  carrying last position alone, under leading shapes, signed zeros and
  magnitudes from 1e-30 to 1e30; both agree with ``jnp.sum`` within
  ``JNP_RTOL`` of the sum of magnitudes (another order of f32
  additions). The plan, its ctypes arguments and the vector path's
  eligibility (aligned and misaligned bases, odd steps) are checked
  on their own.
* Routing: CPU tensors run the plain versions unless ``twins()`` is on;
  the kernel launchers refuse CPU tensors (no fallback); the graph cache
  counts the kernels' launches and keys on ``plain()``; the op counter
  sees a launch; the bounds count what the kernels move.

Card half (``cuda``-marked, skipped without a card): each kernel against
its plain version on the card inside ``fused.plain()``, bit for bit (the
sums at the paths' shapes, the split edges and a misaligned base; the
draws' derived keys, slot sets and rows that start off a vector
boundary), and a captured body holding both kernels, a few-long-rows sum
among them and the derived-key draws, replayed with new keys, offsets
and inputs, equal to its eager run.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from consul_tpu_torch.sim import (coord_kernel, costmodel, fused, graphs,
                                  lanes, prng)
from consul_tpu_torch.sim import round as tround
from test_torch_harness import cuda, ref  # noqa: F401  (fixtures)

SEEDS = (0, 1, 42, 2**31 - 1)
CPU = torch.device("cpu")
#: the bounds kinds of ``uniform``: [0, 1); the views' [1e-9, 1) and
#: normal's low end (power-of-two widths, one f32 rounding); widths
#: that are no power of two (the f64 product and sum)
BOUNDS = ((0.0, 1.0), (1e-9, 1.0), (prng._NORMAL_LO, 1.0), (2.0, 6.0),
          (-3.0, 5.5), (0.1, 0.7))
#: |sum - jnp.sum| over the sum of magnitudes: two orders of f32
#: additions over at most 2^20 terms differ by a few ulp of the largest
#: partial sum
JNP_RTOL = 1e-5


def _kd(k):
    import jax

    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _bits(x: torch.Tensor) -> np.ndarray:
    """The tensor's bits (floats as their int32 words)."""
    a = x.detach().cpu().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _twin_and_plain(fn, *args, **kw):
    with fused.twins():
        twin = fn(*args, **kw)
    return twin, fn(*args, **kw)


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(_bits(a), _bits(b))


# ------------------------------------------------------------- draws


@pytest.mark.parametrize("seed", SEEDS)
def test_words_mode_matches_jax(seed):
    import jax

    k, tk = jax.random.key(seed), prng.key(seed)
    twin, plain = _twin_and_plain(prng.split, tk, 5)
    assert _same(twin, plain)
    np.testing.assert_array_equal(twin.numpy(), _kd(jax.random.split(k, 5)))
    for d in (0, 7, 2**31 + 5, 2**32 - 1):
        twin, plain = _twin_and_plain(prng.fold_in, tk, d)
        assert _same(twin, plain)
        np.testing.assert_array_equal(twin.numpy(),
                                      _kd(jax.random.fold_in(k, d)))
    # a key stack splits each key
    stack = prng.split(tk, 3)
    twin, plain = _twin_and_plain(prng.split, stack, 4)
    assert _same(twin, plain) and twin.shape == (3, 4, 2)
    for i in range(3):
        np.testing.assert_array_equal(
            twin[i].numpy(),
            _kd(jax.random.split(jax.random.wrap_key_data(
                np.asarray(stack[i].numpy(), dtype=np.uint32)), 4)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_on_a_data_tensor_and_round_keys(seed):
    import jax

    k, tk = jax.random.key(seed), prng.key(seed)
    data = torch.tensor([0, 1, 2**31, 2**32 - 1, 12345], dtype=torch.int64)
    twin, plain = _twin_and_plain(prng.fold_in, tk, data)
    assert _same(twin, plain)
    for i, d in enumerate(data.tolist()):
        np.testing.assert_array_equal(twin[i].numpy(),
                                      _kd(jax.random.fold_in(k, d)))
    for start in (0, 5, torch.tensor(1000, dtype=torch.int32),
                  2**32 - 3):
        twin, plain = _twin_and_plain(prng.round_keys, tk, start, 12)
        assert _same(twin, plain)
        s0 = int(start)
        np.testing.assert_array_equal(
            twin.numpy(), np.stack([_kd(jax.random.fold_in(
                k, (s0 + i) & prng.MASK)) for i in range(12)]))
        twin, plain = _twin_and_plain(prng.round_seeds, tk, start, 12)
        assert _same(twin, plain) and twin.dtype == torch.int32


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry2x32_on_data_matches_jax(seed):
    import jax.extend.random as jxr
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    kw = rng.integers(0, 2**32, size=2, dtype=np.int64)
    x0 = rng.integers(0, 2**32, size=(3, 17), dtype=np.int64)
    x1 = rng.integers(0, 2**32, size=(3, 17), dtype=np.int64)
    k0, k1 = torch.tensor(kw[0]), torch.tensor(kw[1])
    twin, plain = _twin_and_plain(prng.threefry2x32, k0, k1,
                                  torch.from_numpy(x0),
                                  torch.from_numpy(x1))
    assert _same(twin, plain)
    # jax's count is both words' counters, flat: word 0's, then word 1's
    want = np.asarray(jxr.threefry_2x32(
        jnp.asarray(kw, dtype=jnp.uint32),
        jnp.asarray(np.concatenate([x0.ravel(), x1.ravel()]),
                    dtype=jnp.uint32)))
    np.testing.assert_array_equal(twin[0].numpy().ravel(), want[:x0.size])
    np.testing.assert_array_equal(twin[1].numpy().ravel(), want[x0.size:])


@pytest.mark.parametrize("seed", SEEDS)
def test_xor_mode_matches_jax(seed):
    import jax
    import jax.numpy as jnp

    k, tk = jax.random.key(seed), prng.key(seed)
    twin, plain = _twin_and_plain(prng.bits, tk)
    assert _same(twin, plain)
    assert int(twin) == int(jax.random.bits(k, dtype=jnp.uint32))
    for n in (1, 2, 3, 255, 4099):
        twin, plain = _twin_and_plain(prng.bits, tk, n)
        assert _same(twin, plain)
        np.testing.assert_array_equal(
            twin.numpy(), np.asarray(jax.random.bits(k, (n,),
                                                     dtype=jnp.uint32)))
    stack = prng.split(tk, 5)
    twin, plain = _twin_and_plain(prng.bits, stack)
    assert _same(twin, plain) and twin.shape == (5,)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", BOUNDS, ids=lambda b: f"{b[0]:g}-{b[1]:g}")
def test_uniform_mode_matches_jax(seed, bounds):
    import jax

    lo, hi = bounds
    k, tk = jax.random.key(seed), prng.key(seed)
    twin, plain = _twin_and_plain(prng.uniform, tk, (16, 257), lo, hi)
    assert _same(twin, plain)
    np.testing.assert_array_equal(
        _bits(twin), np.asarray(jax.random.uniform(
            k, (16, 257), minval=lo, maxval=hi)).view(np.int32))
    # a key stack draws for each key
    stack = prng.split(tk, 5)
    twin, plain = _twin_and_plain(prng.uniform, stack, 300, lo, hi)
    assert _same(twin, plain) and twin.shape == (5, 300)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_tails_and_randint_follow_the_uniform(seed):
    tk = prng.key(seed)
    for fn, args in ((prng.normal, ((64, 3),)),
                     (prng.exponential, ((129,),)),
                     (prng.randint, ((77,), 1, 4096))):
        twin, plain = _twin_and_plain(fn, tk, *args)
        assert _same(twin, plain)


@pytest.mark.parametrize("offset", [0, 77, 2**32 - 100, 2**32 + 5])
def test_u01_global_mode_matches_jax(offset):
    import jax.extend.random as jxr
    import jax.numpy as jnp

    tk = prng.key(3)
    twin, plain = _twin_and_plain(prng.u01_global, tk, offset, 4096)
    assert _same(twin, plain)
    idx = (offset + np.arange(4096, dtype=np.int64)) & prng.MASK
    y0 = np.asarray(jxr.threefry_2x32(
        jnp.asarray(tk.numpy(), dtype=jnp.uint32),
        jnp.asarray(np.concatenate([np.zeros_like(idx), idx]),
                    dtype=jnp.uint32)))[:idx.size]
    want = (y0 >> 8).astype(np.float32) * np.float32(2**-24)
    np.testing.assert_array_equal(_bits(twin), want.view(np.int32))
    # the offset as a device value (the lane engine's shard offset)
    with fused.twins():
        dev = prng.u01_global(tk, torch.tensor(offset), 4096)
    assert _same(dev, twin)


def test_draw_refuses_what_the_kernel_cannot_take():
    tk = prng.key(1)
    with pytest.raises(ValueError, match="dimensions"):
        fused.draw("uniform", tk[0].expand((1,) * (fused.MAX_DIMS + 1)),
                   tk[1], gen=4)
    d = fused.draw("xor", tk[0], tk[1], gen=8)
    with pytest.raises(ValueError, match="CUDA"):
        fused.threefry(d)
    # derived keys: a table that tiles the rows, at most MAX_DERIVE
    # words of 32 bits; the generated index with gen and no gen_hi
    two = tk[0].expand(3, 1), tk[1].expand(3, 1)
    for derive in ((0, 1), tuple(range(fused.MAX_DERIVE + 1)), (2**32,)):
        with pytest.raises(ValueError, match="derives"):
            fused.draw("uniform", *two, gen=4, derive=derive)
    with pytest.raises(ValueError, match="derives"):
        fused.draw("xor", tk[0], tk[1], derive=(1,))
    for kw in ({}, {"gen": 4, "gen_hi": True}):
        with pytest.raises(ValueError, match="generated index"):
            fused.draw("seeds", tk[0], tk[1], derive_gen=True, **kw)


def _np_keys(rng, n):
    """``n`` random raw keys made with numpy: (torch [n, 2], jax)."""
    import jax

    kw = rng.integers(0, 2**32, size=(n, 2), dtype=np.int64)
    return torch.from_numpy(kw), [jax.random.wrap_key_data(
        np.asarray(w, dtype=np.uint32)) for w in kw]


@pytest.mark.parametrize("seed", SEEDS)
def test_seeds_draw_equals_the_reference_round_seeds(ref, seed):
    """``round_seeds`` on the kernel's route is one draw whose keys are
    derived by the generated index (``fused.Draw.derive_gen``): its twin
    equals the reference's ``round_seeds`` at offsets near 2^32."""
    from consul_tpu.sim.round import round_seeds as ref_seeds

    rng = np.random.default_rng(seed)
    keys, jkeys = _np_keys(rng, 2)
    for tk, k in zip(keys, jkeys):
        for start, count in ((0, 1), (5, 3), (1000, 512), (2**31 - 100, 7)):
            with fused.twins():
                got = prng.round_seeds(tk, start, count)
                dev = prng.round_seeds(tk, torch.tensor(start), count)
            assert got.dtype == torch.int32 and got.shape == (count,)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(ref_seeds(k, start, count)))
            assert _same(dev, got)
            assert _same(got, prng.round_seeds(tk, start, count))


@pytest.mark.parametrize("slots", [(2, 3, 4), (1, 2, 3, 4),
                                   (0, 1, 2, 3, 4), (0, 2, 3, 4, 5),
                                   (0, 1, 2, 3, 4, 5), (5,)])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_slot_batched_draws_match_jax(ref, slots, seed):
    """A round's slots as the rows of one draw (each row's key derived
    from the round key by its slot word): ``threefry_u01`` is
    ``jax.random.split(k, 5)[s]`` + ``uniform`` and ``global_u01`` the
    reference's ``lanes.u01_global`` on the same key, slot by slot; slot
    5 is ``fold_in(k, REPLAY_FOLD)``'s."""
    import jax

    from consul_tpu.sim import lanes as rlanes

    rng = np.random.default_rng(100 + seed)
    (tk,), (k,) = _np_keys(rng, 1)
    n = 4 * 257 + 3
    offset = 2**32 - 700
    ref_keys = list(jax.random.split(k, 5)) + [
        jax.random.fold_in(k, prng.REPLAY_FOLD)]
    with fused.twins():
        u = prng.threefry_u01(tk, n, slots)
        g = prng.global_u01(tk, offset, n, slots)
        rows = [(u(s), g(s)) for s in slots]
    plain_u = prng.threefry_u01(tk, n, slots)
    plain_g = prng.global_u01(tk, offset, n, slots)
    for s, (us, gs) in zip(slots, rows):
        assert _same(us, plain_u(s)) and _same(gs, plain_g(s))
        np.testing.assert_array_equal(
            _bits(us), np.asarray(jax.random.uniform(ref_keys[s], (n,)))
            .view(np.int32))
        np.testing.assert_array_equal(
            _bits(gs), np.asarray(rlanes.u01_global(ref_keys[s], offset,
                                                    n)).view(np.int32))


def test_slot_guard_raises_on_a_slot_not_drawn():
    tk = prng.key(4)
    for twins in (False, True):
        with fused.twins() if twins else _nothing():
            for fn, args in ((prng.threefry_u01, (tk, 64)),
                             (prng.global_u01, (tk, 3, 64))):
                u = fn(*args, (2, 3, 4))
                u(3)
                for slot in (0, 1, 5):
                    with pytest.raises(ValueError, match="not drawn"):
                        u(slot)


def _nothing():
    import contextlib

    return contextlib.nullcontext()


def _frames(n):
    """A fault frame and a byzantine one at ``n`` nodes (the chip
    smoke's check plans, in their attack rounds)."""
    import chip_smoke

    from consul_tpu_torch import faults

    out = {}
    for name, plan in chip_smoke.check_plans(n).items():
        cp = faults.compile_plan(plan, n, torch.device("cpu"))
        out[name] = faults.fault_frame(cp, chip_smoke.CHECK_ROUNDS[name])
    return out


def test_draw_slots_are_the_slots_the_round_reads():
    """``round.draw_slots`` is exactly the set ``_round_body`` reads
    under each params and frame kind: a source of all six slots records
    what the body asks for. A grid that sweeps the slow model draws its
    slot for every point (the union)."""
    from consul_tpu_torch import bench
    from consul_tpu_torch.sim import params as tparams
    from consul_tpu_torch.sim import scenarios, state

    n = 256
    frames = _frames(n)
    cases = [(bench.headline_params(n), None),
             (bench.diag_params(n), None),
             (bench.diag_params(n).with_(fail_per_round=0.01), None),
             (scenarios.chaos_params(n), frames["fault"]),
             (scenarios.chaos_params(n), frames["byz"]),
             (bench.diag_params(n), frames["byz"])]
    s0 = state.init_state(n, device=CPU)
    for p, fx in cases:
        read = set()
        full = prng.threefry_u01(prng.key(3), n, prng.SLOTS)

        def spy(slot):
            read.add(slot)
            return full(slot)

        tround.round_core(s0, None, p, spy, fx)
        assert tuple(sorted(read)) == tround.draw_slots(p, fx), (p, fx)
    lan = scenarios.autotune_params("lan", n).with_(slow_per_round=0.0)
    assert tround.U_SLOW not in tround.draw_slots(lan)
    for axes, slow in (({"slow_per_round": (0.0, 0.001)}, True),
                       ({"gossip_nodes": (2, 3)}, False)):
        tp, _ = tparams.grid_params(lan, tparams.SweepAxes.of(**axes),
                                    "cpu")
        want = sorted(tround.draw_slots(lan) + (tround.U_SLOW,) * slow)
        assert tround.draw_slots(tp) == tuple(want)


def test_engines_draw_once_a_round_on_the_kernel_route(monkeypatch):
    """The threefry launches of each engine's call on the kernel's
    route (its twin on the CPU; ``prng._draw`` counted): the kernel
    runner one a call (its seeds), the live, lane and xla grid engines
    one a round beside their round keys, the views two words draws a
    round (the gossip chain) beside their uniforms."""
    from consul_tpu_torch import bench
    from consul_tpu_torch.sim import (cuda_round, params, scenarios,
                                      state, sweep, views)

    seen = []

    def count(d):
        seen.append(d.mode)
        return prng._draw_twin(d)

    monkeypatch.setattr(prng, "_draw", count)
    n, rounds = 1024, 4
    key = prng.key(5)
    p = bench.diag_params(n)
    with fused.twins():
        for run, want in (
                (cuda_round.make_run_rounds_cuda(bench.headline_params(n),
                                                 rounds), {"seeds": 1}),
                (tround.make_run_rounds(p, rounds),
                 {"words": 1, "uniform": rounds}),
                (tround.make_run_rounds_lanes(p, rounds),
                 {"words": 1, "u01_global": rounds})):
            seen.clear()
            run(state.init_state(n, device=CPU), key)
            assert {m: seen.count(m) for m in set(seen)} == want
        tp, _ = params.grid_params(
            scenarios.autotune_params("lan", 256),
            params.SweepAxes.of(**bench.AUTOTUNE_GRID), "cpu")
        grid = sweep.make_run_sweep(scenarios.autotune_params("lan", 256),
                                    2, engine="xla", device="cpu")
        seen.clear()
        grid(tp, key)
        assert {m: seen.count(m) for m in set(seen)} == \
            {"words": 1, "uniform": 2}
        pv = params.SimParams(n=64, loss=0.01)
        st = views.init_views(64, device=CPU)
        # round 0 is no push/pull round
        assert views._pp_every(pv) > 1
        seen.clear()
        views.views_round(st, key, pv)
        ticks = int(pv.gossip_ticks_per_round)
        assert seen.count("words") == 2
        assert seen.count("uniform") == 2 + 2 + ticks


def _kernel_writes(rows, words, blocks_cap, vec=4, threads=8):
    """The (row, word, vector store) of every output word the draw
    kernel's loops write, walked in Python over its grid (``threads`` a
    block here, ``blocks_cap`` resident blocks), as
    ``launch``/``draw_kernel`` in csrc/prng_kernels.cu index them."""
    bx = min(-(-words // (threads * vec)), blocks_cap)
    by = max(1, min(blocks_cap // bx, rows, 65535))
    out = []
    for bxi in range(bx):
        for byi in range(by):
            for t in range(threads):
                for batch in range(byi, rows, by * threads):
                    for b in range(threads):
                        row = batch + b * by
                        if row >= rows:
                            break
                        orow = row * words
                        j0 = bxi * threads * vec + t * vec
                        while j0 < words:
                            left = words - j0
                            full = left >= vec and orow % vec == 0
                            for v in range(min(left, vec)):
                                out.append((row, j0 + v, full))
                            j0 += bx * threads * vec
    return out


@pytest.mark.parametrize("rows, words", [(1, 1), (1, 3), (1, 4), (1, 5),
                                         (1, 31), (1, 32), (1, 33),
                                         (3, 7), (5, 64), (5, 65), (2, 66),
                                         (17, 3), (40, 100)])
@pytest.mark.parametrize("cap", [1, 3, 64])
def test_kernel_word_loop_writes_every_word_once(rows, words, cap):
    """The kernel's word loop at the vector width's edges: every word
    of the index space is written once; a vector store only where its 4
    words lie in the row and the row starts on a vector boundary (a row
    of a length that is no multiple of 4 takes scalar stores from its
    second row on); tails of 1-3 words."""
    got = _kernel_writes(rows, words, cap)
    assert sorted((r, j) for r, j, _ in got) == \
        [(r, j) for r in range(rows) for j in range(words)]
    for r, j, vec in got:
        assert vec == ((r * words) % 4 == 0 and words - (j - j % 4) >= 4)


@pytest.mark.parametrize("mode", ["words", "xor", "seeds", "uniform",
                                  "u01_global"])
@pytest.mark.parametrize("shape", [(1,), (3,), (4,), (5,), (7,), (3, 5),
                                   (2, 4), (5, 1), (2, 3, 6), (4, 1023)])
def test_draw_twin_at_the_vector_edges(mode, shape):
    """Each mode's twin on index spaces at and beyond the vector width,
    rows whose tails are 1-3 words, with keys per row, per word and
    derived: equal to the plain composite."""
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    kw = torch.from_numpy(rng.integers(0, 2**32, size=shape[:-1] + (1, 2),
                                       dtype=np.int64))
    j = torch.arange(shape[-1])

    def out(y0, y1):
        if mode == "words":
            return torch.stack([y0, y1], dim=-1)
        if mode == "xor":
            return y0 ^ y1
        if mode == "seeds":
            return ((y0 ^ y1) >> 1).to(torch.int32)
        if mode == "uniform":
            return ((y0 ^ y1) >> 9).to(torch.float32) * 2.0 ** -23
        return prng._u01_of(y0)

    # a row key (stride 0 along the words): plain, and derived by a word
    y = prng.threefry2x32(kw[..., 0], kw[..., 1], 0, j)
    assert _same(prng._draw_twin(fused.draw(
        mode, kw[..., 0], kw[..., 1], gen=shape[-1])), out(*y))
    keys = prng.fold_in(kw, 7)
    y = prng.threefry2x32(keys[..., 0], keys[..., 1], 0, j)
    assert _same(prng._draw_twin(fused.draw(
        mode, kw[..., 0], kw[..., 1], gen=shape[-1], derive=(7,))), out(*y))
    # a key a word: derived by the generated index, counters zero
    keys = prng.fold_in(kw, j)
    y = prng.threefry2x32(keys[..., 0], keys[..., 1], 0, 0)
    assert _same(prng._draw_twin(fused.draw(
        mode, kw[..., 0], kw[..., 1], gen=shape[-1], derive_gen=True)),
        out(*y))


# -------------------------------------------------------------- sums


def _sum_input(rng, lead, length, zeros=False) -> torch.Tensor:
    x = rng.standard_normal(lead + (length,)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-30, 31, size=x.shape)
    if zeros:
        x[..., ::3] = -0.0
        x[..., 1::5] = 0.0
    return torch.from_numpy(x.astype(np.float32))


def _check_sum(x: torch.Tensor) -> None:
    want = lanes.tree_sum(x)
    assert _same(lanes.tree_sum_staged(x), want)
    with fused.twins():
        assert _same(lanes.tree_sum(x), want)


@settings(max_examples=40, deadline=None, database=None)
@given(length=st.integers(1, 3 * 2**16),
       lead=st.sampled_from([(), (1,), (3,), (2, 2)]),
       seed=st.integers(0, 2**16), zeros=st.booleans())
def test_staged_tree_sum_is_tree_sum(length, lead, seed, zeros):
    _check_sum(_sum_input(np.random.default_rng(seed), lead, length, zeros))


@pytest.mark.parametrize("length", [1, 2, 3, 7, 1023, 1024, 1025, 16384,
                                    16385, 1_000_003, 1_048_576])
def test_staged_tree_sum_at_the_plans_edges(length):
    _check_sum(_sum_input(np.random.default_rng(length), (1,), length,
                          zeros=True))


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("length", [1_000_003, 1_048_576])
def test_staged_tree_sum_on_few_long_rows(rows, length):
    plan = fused.sum_plan(rows, length)
    assert plan.chunks > 1
    _check_sum(_sum_input(np.random.default_rng(length + rows), (rows,),
                          length, zeros=True))


@pytest.mark.parametrize("rows, length, chunks", [
    (1, 32752, 1), (1, 32753, 2), (fused.ROWS_ALONE - 1, 32768, 2),
    (fused.ROWS_ALONE, 32768, 1), (fused.ROWS_ALONE + 1, 32768, 1)])
def test_staged_tree_sum_where_a_row_is_cut(rows, length, chunks):
    """A row of 32,752 leaves 2,047 positions at level 4, one CTA's; one
    of 32,753 leaves 2,048 and is cut in two while the rows do not fill
    the card; from ``ROWS_ALONE`` rows on, a row of 32,768 keeps one
    CTA."""
    assert fused.sum_plan(rows, length).chunks == chunks
    _check_sum(_sum_input(np.random.default_rng(rows), (rows,), length))


@pytest.mark.parametrize("length, last", [(1_000_003, 8), (100003, 13),
                                          (278529, 1), (86016, 4)])
def test_staged_tree_sum_on_uneven_ranges(length, last):
    """Ranges that split a row's level k unevenly, down to a last CTA
    that owns the carrying last position alone (278,529) or one float4
    group (86,016)."""
    plan = fused.sum_plan(1, length)
    a, b = plan.ranges()[-1]
    assert plan.chunks > 1 and b - a == last and b == plan.nk
    assert plan.nk % plan.width == last % plan.width
    assert fused.vector_path(plan, 0) == (length % 4 == 0)
    _check_sum(_sum_input(np.random.default_rng(length), (2,), length,
                          zeros=True))


def test_staged_tree_sum_on_many_rows_and_lane_tables():
    """Rows that pack several to a CTA among them (the lanes grid
    engine's block partials of 1,024, the lane tables of 64)."""
    rng = np.random.default_rng(5)
    _check_sum(_sum_input(rng, (4097,), 1024, zeros=True))
    # enough rows for one launch a row, and the lane tables [K, 64]
    _check_sum(_sum_input(rng, (265,), 2049))
    _check_sum(_sum_input(rng, (lanes.N_LANES,), lanes.LANE_BLOCKS))


def test_signed_zeros_and_block_partials():
    for length in (1, 2, 3, 5, 1025, 17001):
        x = torch.full((2, length), -0.0)
        want = lanes.tree_sum(x)
        assert _bits(want).tolist() == [_bits(torch.tensor(-0.0)).item()] * 2
        assert _same(lanes.tree_sum_staged(x), want)
        assert _bits(lanes.tree_sum_staged(x, plus_zero=True)).tolist() == \
            [0, 0]
    stack = _sum_input(np.random.default_rng(2), (4,), 64 * 40, zeros=True)
    stack[1] = -0.0
    want = lanes._block_partials(stack, lanes.LANE_BLOCKS)
    with fused.twins():
        assert _same(lanes._block_partials(stack, lanes.LANE_BLOCKS), want)
    assert not bool(torch.signbit(want[1]).any())


@pytest.mark.parametrize("length", [3, 1000, 65536, 1_000_003])
def test_tree_sum_agrees_with_jnp_sum(length):
    import jax.numpy as jnp

    x = _sum_input(np.random.default_rng(length), (3,), length)
    want = np.asarray(jnp.sum(jnp.asarray(x.numpy()), axis=-1))
    scale = x.abs().sum(-1).double().numpy()
    for got in (lanes.tree_sum(x), lanes.tree_sum_staged(x)):
        err = np.abs(got.double().numpy() - want.astype(np.float64))
        assert (err <= JNP_RTOL * scale).all()


def test_sum_plan_launches():
    """One launch a sum at every shape: a row of fewer than 2,048 level-t
    positions (8,192 when the rows fill the card) gets one CTA, which
    folds level t; a longer one is cut into CTAs of one float4 group a
    thread (four), whose ranges of level k cover it, and the last to
    arrive folds it."""
    for rows, length in ((40, 64), (1, 1), (1, 16384), (2048, 16384),
                         (2048, 65536), (300, 2**20), (1, 2**20),
                         (5, 2**20), (1, 1_000_003), (3, 1025), (1, 2**24)):
        plan = fused.sum_plan(rows, length)
        assert plan.rows == rows and plan.length == length
        assert plan.lengths[0] == length and len(plan.h) == plan.k
        assert plan.t == min(fused.THREAD_LEVELS, len(
            fused._lengths(length)) - 1)
        ranges = plan.ranges()
        assert plan.pack == 1 or plan.chunks == 1
        assert len(ranges) == plan.chunks and ranges[0][0] == 0
        assert ranges[-1][1] == plan.nk and all(
            b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
        assert fused.sum_smem(plan) <= 4 * fused.SMEM_N
        if plan.chunks > 1:
            assert plan.width >= fused.MIN_WIDTH
            # level k is the deepest that leaves MIN_WIDTH a CTA
            assert plan.nk // 2 < plan.chunks * fused.MIN_WIDTH
        else:
            assert (plan.k, plan.nk) == (plan.t, plan.nt)
    # short rows, and many rows: one CTA a row, level t folded in place;
    # short rows that fill the card several times over pack as many rows
    # to a CTA as give each thread 4 positions
    for rows, length, pack in ((2048, 16384, 1), (40, 64, 1),
                               (1, 16384, 1), (2048, 65536, 1),
                               (131072, 1024, 16), (3000, 64, 11),
                               (4097, 1024, 15)):
        plan = fused.sum_plan(rows, length)
        assert (plan.chunks, plan.k, plan.t, plan.pack) == (1, 4, 4, pack)
        assert plan.pack * plan.nt <= fused.SUM_THREADS * fused.SUM_VEC \
            or plan.pack == 1
    # few long rows: one float4 group a thread
    one = fused.sum_plan(1, 2**20)
    assert (one.chunks, one.t, one.k, one.nk, one.width) == (64, 4, 10, 1024,
                                                             16)
    assert fused.sum_plan(5, 2**20).chunks == 64
    few = fused.sum_plan(fused.ROWS_ALONE - 1, 65536)
    assert (few.chunks, few.k, few.nk, few.width) == (4, 10, 64, 16)
    # many long rows: four
    assert fused.sum_plan(300, 2**20).chunks == 16
    # the longest rows: at most SMEM_N / (2 * MIN_WIDTH) CTAs, beyond 48
    # KB a CTA
    longest = fused.sum_plan(1, 2**24)
    assert longest.chunks == fused.SMEM_N // (2 * fused.MIN_WIDTH)
    assert fused.sum_smem(longest) == 65536
    with pytest.raises(ValueError):
        fused.sum_plan(1, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        fused.sum_plan(1, 2**31)
    with pytest.raises(ValueError, match="longer"):
        fused.sum_plan(1, 2**30)


def test_vector_path_eligibility():
    """float4 loads where the row length, every step h and each CTA's
    width are multiples of 4 and the base is 16-byte aligned."""
    plan = fused.sum_plan(2048, 16384)
    assert fused.vector_path(plan, 0) and fused.vector_path(plan, 4096)
    for ptr in (4, 8, 12, 4100):
        assert not fused.vector_path(plan, ptr)
    assert fused.vector_path(fused.sum_plan(5, 2**20), 256)
    # an odd step: 65,540's first step h_0 is 32,770
    odd = fused.sum_plan(1, 65540)
    assert any(h % 4 for h in odd.h)
    assert not fused.vector_path(odd, 0)
    # lengths that are no multiple of 4
    for length in (1, 3, 1025, 1_000_003):
        assert not fused.vector_path(fused.sum_plan(1, length), 0)
    # an aligned-looking base on a misaligned contiguous view
    x = torch.zeros(1 + 4 * 4096)[1:].view(4, 4096)
    assert x.is_contiguous() and x.contiguous().data_ptr() == x.data_ptr()
    assert not fused.vector_path(fused.sum_plan(4, 4096), x.data_ptr())


# ---------------------------------------------------------- routing


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached a kernel route")

    monkeypatch.setattr(prng, "_draw", refuse)
    monkeypatch.setattr(lanes, "_fused_sum", refuse)
    fused.reset_launches()
    tk = prng.key(5)
    prng.uniform(tk, 64)
    prng.round_seeds(tk, 0, 4)
    prng.u01_global(tk, 3, 16)
    lanes.tree_sum(torch.ones(3, 9))
    lanes._block_partials(torch.ones(2, 128), 64)
    assert not fused.routed(tk)
    with fused.plain():
        assert not fused.routed(tk)
    with fused.twins():
        assert fused.routed(tk)
        with pytest.raises(AssertionError, match="kernel route"):
            prng.uniform(tk, 64)
        with fused.plain():
            assert not fused.routed(tk)
    assert dict(fused.LAUNCHES) == {}


def test_kernel_launchers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fused.tree_sum(torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        fused.threefry(fused.draw("words", prng.key(1)[0],
                                  prng.key(1)[1]))


def test_graph_cache_counts_the_kernels_and_keys_on_the_switch():
    cache = graphs.GraphCache(counters=())
    assert cache.counters == (fused.LAUNCHES, coord_kernel.LAUNCHES)
    assert cache.counters[1] is coord_kernel.LAUNCHES
    assert not fused.plain_active()
    with fused.plain():
        assert fused.plain_active()


def test_op_counter_sees_a_kernel_launch():
    x, y = torch.ones(8), torch.ones(2)
    with costmodel.OpCounter() as c:
        assert fused.OBSERVERS == [c]
        fused._observe((x,), (y,))
    assert fused.OBSERVERS == []
    assert (c.bytes, c.ops, c.calls) == (40, 2, 1)


def test_kernel_bounds():
    tk = prng.key(1)
    d = fused.draw("uniform", tk[..., 0, None], tk[..., 1, None],
                   gen=2**20)
    b = costmodel.draw_bound(d)
    assert b["words"] == 2**20 and b["bytes"] == 4 * 2**20 + 16
    assert b["int32_ops"] == 2**20 * (costmodel.THREEFRY_INT_OPS + 1 + 3)
    assert b["bound_by"] == "operations"
    # the issue bound: 67 instructions a threefry, the uniform's xor,
    # shift, conversion and product; PR 12's integer-lane count beside
    assert b["instructions"] == 2**20 * (67 + 3 + 1) == \
        2**20 * costmodel.draw_instructions_per_word("uniform")
    assert math.isclose(b["bound_ms"], b["instructions"]
                        / costmodel.ISSUE_PER_S * 1e3)
    assert math.isclose(b["int32_bound_ms"], b["int32_ops"]
                        / costmodel.INT32_OPS_PER_S * 1e3)
    assert b["bound_ms"] < b["int32_bound_ms"]
    u = fused.draw("u01_global", tk[0], tk[1], gen=8, base=torch.tensor(1))
    assert costmodel.draw_bound(u)["instructions"] == 8 * (64 + 2 + 1)
    # a derived key's evaluation: once a row, or once a word
    rows = fused.draw("uniform", tk[0].expand(4, 1), tk[1].expand(4, 1),
                      gen=2**20, derive=(0, 1, 2, 3))
    assert costmodel.draw_bound(rows)["int32_ops"] == \
        4 * b["int32_ops"] + 4 * costmodel.THREEFRY_INT_OPS
    seeds = fused.draw("seeds", tk[0], tk[1], gen=512,
                       base=torch.tensor(3), derive_gen=True)
    assert costmodel.draw_bound(seeds)["int32_ops"] == 512 * (
        2 * costmodel.THREEFRY_INT_OPS + 1 + 2)
    s = costmodel.sum_bound(64, 16384)
    assert s["bytes"] == 4 * 64 * 16385 and s["bound_by"] == "bytes"
    assert math.isclose(s["bound_ms"],
                        s["bytes"] / costmodel.HBM_BYTES_PER_S * 1e3)


# ------------------------------------------------------- on the card


def _kernel_and_plain(fn, *args):
    got = fn(*args)
    with fused.plain():
        want = fn(*args)
    return got, want


@pytest.mark.cuda
def test_draw_kernel_equals_its_plain_version(cuda):
    tk = prng.key(9, device=cuda)
    stack = prng.split(tk, 5)
    cases = [(prng.split, tk, 7), (prng.split, stack, 3),
             (prng.fold_in, tk, 2**31 + 5),
             (prng.fold_in, tk, torch.arange(300, device=cuda)),
             (prng.bits, tk), (prng.bits, tk, 65536), (prng.bits, stack),
             (prng.round_keys, tk, torch.tensor(7, device=cuda), 48),
             (prng.round_seeds, tk, torch.tensor(7, device=cuda), 512),
             (prng.u01_global, tk, 2**32 - 100, 4096),
             (prng.normal, tk, (255, 3)), (prng.exponential, tk, (1000,)),
             (prng.randint, tk, (333,), 1, 4096)]
    cases += [(prng.uniform, k, n, lo, hi) for k in (tk, stack)
              for n in (1, 3, 65536) for lo, hi in BOUNDS]
    # keys derived in the launch: each operand form, rows that start off
    # a vector boundary (lengths 1-3 past a multiple of 4)
    sub = prng.SubKey(tk, prng.COORD_FOLD)
    sub_stack = prng.SubKey(prng.split(stack, 3), 1)
    start = torch.tensor(2**32 - 9, device=cuda)
    cases += [(prng.round_seeds, tk, start, n) for n in (1, 2, 3, 5, 4099)]
    cases += [(prng.split, sub, 4), (prng.split, sub_stack, 3),
              (prng.round_keys, sub, start, 48),
              (prng.u01_global, sub, start, 4098),
              (prng.normal, sub, (1001,)), (prng.randint, sub, (77,), 1, 77),
              (prng.randint, tk, (65539,), 1, 4096)]
    cases += [(prng.uniform, k, n, lo, hi) for k in (sub, sub_stack)
              for n in (1, 3, 4097) for lo, hi in BOUNDS[:3]]
    for fn, *args in cases:
        got, want = _kernel_and_plain(fn, *args)
        assert _same(got, want), (fn.__name__, args)
    for slots in ((2, 3, 4), (1, 2, 3, 4), (0, 2, 3, 4, 5),
                  (0, 1, 2, 3, 4, 5)):
        for n in (1, 6, 4097, 65536):
            for fn, args in ((prng.threefry_u01, (tk, n)),
                             (prng.global_u01, (tk, start, n))):
                got, want = _kernel_and_plain(
                    lambda: tuple(map(fn(*args, slots), slots)))
                assert _same(got, want), (fn.__name__, slots, n)


@pytest.mark.cuda
def test_draw_kernel_takes_64_bit_indices(cuda):
    """A draw of 2^31 + 5 words (past the 32-bit index path): its
    slices at the start, middle and end equal the plain version's draw
    of those slices."""
    tk = prng.key(21, device=cuda)
    words, piece = 2**31 + 5, 4099
    big = prng.u01_global(tk, 11, words)
    for a in (0, words // 2 + 1, words - piece):
        with fused.plain():
            want = prng.u01_global(tk, 11 + a, piece)
        assert _same(big[a:a + piece], want), a


@pytest.mark.cuda
def test_sum_kernel_equals_its_plain_version(cuda):
    rng = np.random.default_rng(4)
    for lead, length in (((1,), 1), ((1,), 2), ((1,), 3), ((1,), 7),
                         ((2,), 1025), ((1,), 1_000_003),
                         ((1,), 1_048_576), ((5,), 1_048_576),
                         ((40, 64), 16384), ((2048,), 16384),
                         ((2048,), 65536), ((lanes.N_LANES,), 64),
                         ((300,), 2049), ((3,), 32752), ((3,), 32753),
                         ((263,), 32768), ((264,), 32768),
                         ((1,), 278529), ((1,), 86016), ((3,), 65540),
                         ((1,), 2**24), ((4097,), 1024), ((1000,), 7)):
        x = _sum_input(rng, lead, length, zeros=True).to(cuda)
        got, want = _kernel_and_plain(lanes.tree_sum, x)
        assert _same(got, want), (lead, length)
    # a contiguous tensor whose base is not 16-byte aligned
    flat = _sum_input(rng, (), 1 + 4 * 65536, zeros=True).to(cuda)
    x = flat[1:].view(4, 65536)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    got, want = _kernel_and_plain(lanes.tree_sum, x)
    assert _same(got, want)
    stack = _sum_input(rng, (4,), 64 * 40, zeros=True).to(cuda)
    stack[1] = -0.0
    got, want = _kernel_and_plain(lanes._block_partials, stack, 64)
    assert _same(got, want)
    with pytest.raises(ValueError, match="f32"):
        lanes.tree_sum(torch.ones(4, dtype=torch.float64, device=cuda))


@pytest.mark.cuda
def test_captured_draws_and_sums_replay_new_inputs(cuda):
    cache = graphs.GraphCache()

    def body(donated, key, offset, x, long):
        u = prng.threefry_u01(key, 1001, (0, 1, 2, 3, 4, 5))
        g = prng.global_u01(key, offset, 4096, (0, 2, 3, 4, 5))
        return (prng.round_seeds(key, offset, 48),
                prng.u01_global(key, offset, 4096),
                prng.uniform(key, 1000), prng.fold_in(key, offset),
                *map(u, range(6)), *map(g, (0, 2, 3, 4, 5)),
                prng.round_keys(prng.SubKey(key, prng.COORD_FOLD), offset,
                                8),
                prng.uniform(prng.SubKey(prng.split(key, 3), 2), 4099),
                prng.randint(key, (333,), 1, 333),
                lanes.tree_sum(x), lanes._block_partials(x, 64),
                lanes.tree_sum(long))

    dummy = torch.zeros(1, device=cuda)
    # the few long rows are cut across CTAs: each replay must find the
    # arrival counters at zero
    assert fused.sum_plan(5, 2**20).chunks > 1
    for i in range(5):
        args = (prng.key(100 + i, device=cuda),
                torch.tensor(2**32 - 5 + 7 * i, device=cuda),
                torch.randn(3, 64 * 300, device=cuda),
                torch.randn(5, 2**20, device=cuda))
        fused.reset_launches()
        got = cache(("draws",), body, (dummy,), *args)
        launches = dict(fused.LAUNCHES)
        fused.reset_launches()
        with graphs.eager():
            want = body((dummy,), *args)
        assert launches == dict(fused.LAUNCHES)
        assert all(_same(a, b) for a, b in zip(got, want)), i
    # the second call captures and replays, the last three replay
    assert cache.stats()[0]["replays"] == 4


def test_chip_smoke_draws_phase_on_the_twins():
    """``chip_smoke.py``'s draws phase, rehearsed on the CPU at small
    sizes with the kernels' plain twins in the kernels' place: every
    draw, sum, captured body and engine runs, compares and reports; the
    timing cases are built (their bounds computed) but not timed."""
    import chip_smoke

    m = chip_smoke.modules()
    dev = torch.device("cpu")
    with fused.twins():
        draws, bad = chip_smoke.kernel_checks(
            torch, m, dev, chip_smoke.draw_cases(
                torch, m, dev, words=(1, 2, 3, 255, 4096, 16384, 65536),
                stacks=(1, 5, 16)))
        sums, b = chip_smoke.kernel_checks(
            torch, m, dev, chip_smoke.sum_cases(
                torch, m, dev, lengths=(1, 2, 3, 7, 1025, 17001),
                grid_l=256, lane_l=64 * 64,
                edges=((5, 65536), (1, 100003), (3, 65540))))
        bad += b
        captured, b = chip_smoke.captured_draws(torch, m, dev)
        bad += b
        wide, b = chip_smoke.wide_draw_check(torch, m, dev, words=3 * 4099,
                                             piece=4099)
        bad += b
        engines, b, launches = chip_smoke.draws_engines(
            torch, m, dev, profile=False, n=1024, grid_n=256, views_n=64,
            lane_rounds=4, views_rounds=3, runner_calls=((1, 8), (8, 8)),
            live_rounds=4, plan_rounds=4)
        bad += b
    assert bad == [] and launches == {}
    assert all(draws.values()) and all(sums.values()) and len(draws) > 80
    assert len(wide) == 3 and all(wide.values())
    assert len(engines) == 10 and all(c["bitwise"]
                                      for c in captured["calls"])
    cases = chip_smoke.draw_timing_cases(torch, m, dev, n=4096, grid_l=64,
                                         views=64)
    assert {c[0] for c in cases} == set(chip_smoke.DRAW_KERNELS)
    assert all(c[4]["bound_ms"] > 0 for c in cases)
    bare = chip_smoke.draw_timing_cases(torch, m, dev, n=4096, grid_l=64,
                                        views=64, bounds=False)
    assert all(c[4] is None for c in bare if c[0] != "tree_sum")
    prng_calls = {(c[0], c[1]): c[2] for c in bare}
    # a draw row's one launch makes what its plain side (the twin of the
    # same draw) and its prng call make (randint's two rows of words are
    # folded into its integers)
    for name, shape, kern, plain, *_ in cases:
        if name == "tree_sum":
            continue
        with fused.twins():
            got = _flat(kern()).reshape(-1)
            assert _same(got, _flat(plain()).reshape(-1)), shape
            if name != "threefry/xor":
                assert _same(got, _flat(prng_calls[name, shape]())
                             .reshape(-1)), shape


def _flat(x) -> torch.Tensor:
    """A draw's output, or a round's slot rows, as one tensor."""
    if isinstance(x, tuple):
        return torch.stack(x)
    return x


def _kernel_reads(args: fused.DrawArgs, ptr_name: str, stride_name: str):
    """The int64 words the draw kernel reads for one operand, in output
    order, through its pointer, sizes and strides (draw_kernel's row and
    word indexing), read from host memory at those addresses."""
    import ctypes

    ptr = getattr(args, ptr_name)
    nd = args.ndim
    size, stride = list(args.size)[:nd], list(getattr(args, stride_name))
    words = size[-1]
    rows = math.prod(size[:-1])
    out = []
    for row in range(rows):
        rem, off = row, 0
        for d in range(nd - 2, -1, -1):
            off += (rem % size[d]) * stride[d]
            rem //= size[d]
        for j in range(words):
            out.append(ctypes.c_int64.from_address(
                ptr + 8 * (off + j * stride[nd - 1])).value)
    return out


def test_draw_args_address_every_operand(monkeypatch):
    """Every ``Draw`` the prng functions build, turned into the kernel's
    arguments on the CPU: the words the kernel would load through each
    pointer and stride are the expanded operands' values."""
    seen = []

    def record(d):
        seen.append(d)
        return prng._draw_twin(d)

    monkeypatch.setattr(prng, "_draw", record)
    tk = prng.key(8)
    stack = prng.split(tk, 3)
    with fused.twins():
        prng.split(stack, 4)
        prng.fold_in(tk, torch.arange(5) * 7)
        prng.fold_in(stack, 9)
        prng.bits(tk)
        prng.bits(tk, 5)
        prng.uniform(stack, (2, 3), -3.0, 5.5)
        prng.round_seeds(tk, torch.tensor(4, dtype=torch.int32), 6)
        prng.u01_global(tk, 2**32 - 2, 4)
        prng.threefry2x32(tk[0], tk[1], torch.arange(6).view(2, 3), 0)
        # keys derived in the launch
        prng.threefry_u01(tk, 5, (0, 2, 3, 4, 5))
        prng.global_u01(tk, 7, 5, (1, 2, 3, 4))
        prng.uniform(prng.SubKey(stack, 2), 3)
        prng.split(prng.SubKey(tk, prng.COORD_FOLD), 4)
        prng.randint(tk, (5,), 1, 5)
    # round_seeds is one draw: the seeds, keys derived by the index
    assert len(seen) == 14
    assert [d.derive for d in seen[9:]] == [
        (0, 2, 3, 4, prng.REPLAY_FOLD), (1, 2, 3, 4), (2,),
        (prng.COORD_FOLD,), (0, 1)]
    assert [d.derive_gen for d in seen] == [False] * 6 + [True] \
        + [False] * 7
    for d in seen:
        out = fused.draw_out(d)
        args = fused.draw_args(d, out)
        assert args.ndim == max(1, len(d.shape)) <= fused.MAX_DIMS
        assert math.prod(list(args.size)) == out.numel() // (
            2 if d.mode == "words" else 1)
        for name in ("k0", "k1", "x0", "x1"):
            t = getattr(d, name)
            if t is None:
                assert getattr(args, name) is None
                continue
            assert _kernel_reads(args, name, "s" + name) == \
                t.reshape(-1).tolist()
        assert (args.base is None) == (d.base is None)
        assert args.out == out.data_ptr()
        assert args.derive == fused.DERIVE[
            "gen" if d.derive_gen else "row" if d.derive else "none"]
        assert list(args.dword)[:args.nderive] == list(d.derive)


def test_sum_stage_args():
    for rows, length in ((1, 1), (3, 1025), (1, 1_000_003), (300, 65536),
                         (1, 2**24), (2048, 16384), (5, 2**20), (4096, 1024)):
        plan = fused.sum_plan(rows, length)
        a = fused.sum_args(plan, plus_zero=True)
        assert (a.rows, a.length, a.nt, a.nk, a.width, a.chunks, a.pack,
                a.t, a.j) == (rows, length, plan.nt, plan.nk, plan.width,
                              plan.chunks, plan.pack, plan.t, plan.j)
        assert a.plus_zero == 1 and a.odd == plan.odd()
        assert list(a.h)[:plan.k] == list(plan.h)
        assert list(a.h)[plan.k:] == [0] * (fused.MAX_LEVELS - plan.k)
        assert plan.h == tuple(n // 2 for n in plan.lengths[:plan.k])
        assert a.odd == sum(1 << i for i, n in enumerate(plan.lengths[:-1])
                            if n % 2)
        assert fused.sum_args(plan, plus_zero=False).plus_zero == 0


def test_draw_kernel_labels_and_word_loop_parser():
    """``chip_smoke.py``'s env phase names each draw-kernel instantiation
    (mode, index type, row kind, words a thread) and reads the SASS a
    word of its word loop: the shortest backward branch's body holding
    19 funnel shifts a word."""
    import chip_smoke

    ns = "_ZN48_GLOBAL__N__da3303ab_15_prng_kernels_cu_7fd9c0ad11"
    assert chip_smoke.kernel_label(
        ns + "draw_kernelILi3EiLb1ELi4EEEv8DrawArgs") == \
        "threefry/uniform/i32/row/v4"
    assert chip_smoke.kernel_label(
        ns + "draw_kernelILi2ElLb0ELi1EEEv8DrawArgs") == \
        "threefry/seeds/i64/v1"

    def listing(name, body):
        lines = [f"\t\tFunction : {ns}{name}"]
        for i, ins in enumerate(body):
            lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                         f"          /* 0x0000 */")
        return lines

    loop = ["SHF.L.W.U32.HI R1, R1, 0xd, R1", "LOP3.LUT R1, R1, R2, RZ",
            "IADD3 R2, R2, R1, RZ"] * 76 + ["NOP", "IMAD R3, R3, 0x1, R4"]
    outer = ["S2R R0, SR_TID.X"] + loop + ["@P0 BRA 0x10", "BRA 0x0",
                                           "EXIT"]
    text = "\n".join(listing("draw_kernelILi4EiLb1ELi4EEEv8DrawArgs",
                             outer))
    got = chip_smoke.word_loop_sass(text)
    # the inner loop: 76 x 3 + 1 (the NOP left out) + the branch, 4 words
    inner = got["threefry/u01_global/i32/row/v4"]
    assert inner["per_word"] == (76 * 3 + 1 + 1) / 4
    assert inner["by_op_per_word"]["SHF"] == 76 / 4


def test_broadcast_shape_is_torchs():
    """The draw wrapper's shape broadcast is ``torch.broadcast_shapes``,
    refusals included, over random shapes with 0, 1 and wider dims."""
    rng = np.random.default_rng(5)
    for _ in range(2000):
        shapes = [tuple(int(d) for d in rng.choice([0, 1, 2, 3, 5],
                                                  rng.integers(0, 5)))
                  for _ in range(rng.integers(1, 5))]
        try:
            want = tuple(torch.broadcast_shapes(*shapes))
        except RuntimeError:
            with pytest.raises(ValueError, match="do not broadcast"):
                fused.broadcast_shape(*shapes)
            continue
        assert fused.broadcast_shape(*shapes) == want, shapes
    assert fused.broadcast_shape() == ()
