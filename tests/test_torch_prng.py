"""consul_tpu_torch PRNG streams.

threefry2x32 and the per-round streams are bit-exact against jax with
``jax_threefry_partitionable=True`` (jax 0.9's default); the Philox the
round kernels run is checked against a pure-Python integer Philox and
the published Random123 known-answer vectors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from consul_tpu_torch.sim import prng
from test_torch_harness import cuda, ref  # noqa: F401  (fixtures)

KEYS = (0, 1, 42, 2**31 - 1)


def _kd(k):
    import jax

    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_jax_threefry_is_partitionable():
    import jax

    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", KEYS)
def test_threefry_primitives_bit_exact(seed):
    import jax
    import jax.numpy as jnp

    k, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _kd(k))
    np.testing.assert_array_equal(prng.split(tk, 5).numpy(),
                                  _kd(jax.random.split(k, 5)))
    for d in (0, 7, 2**31 + 5):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _kd(jax.random.fold_in(k, d)))
    assert int(prng.bits(tk)) == int(jax.random.bits(k, dtype=jnp.uint32))
    np.testing.assert_array_equal(
        prng.bits(tk, 257).numpy(),
        np.asarray(jax.random.bits(k, (257,), dtype=jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(tk, 4096).numpy(),
                                  np.asarray(jax.random.uniform(k, (4096,))))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("start", [0, 5, 1000])
def test_round_keys_and_seeds_bit_exact(ref, seed, start):
    import jax

    from consul_tpu.sim.round import round_keys, round_seeds

    k, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(prng.round_keys(tk, start, 12).numpy(),
                                  _kd(round_keys(k, start, 12)))
    got = prng.round_seeds(tk, torch.tensor(start, dtype=torch.int32), 12)
    assert got.dtype == torch.int32 and bool((got >= 0).all())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(round_seeds(k, start, 12)))


def test_round_seeds_segment_invariant():
    tk = prng.key(9)
    whole = prng.round_seeds(tk, 0, 24)
    parts = torch.cat([prng.round_seeds(tk, 0, 8),
                       prng.round_seeds(tk, 8, 5),
                       prng.round_seeds(tk, 13, 11)])
    assert torch.equal(whole, parts)


# ------------------------------------------------------------- Philox

M = 0xFFFFFFFF


def _philox_py(c, k):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c0, c1, c2, c3 = c
    k0, k1 = k
    for _ in range(10):
        p0 = 0xD2511F53 * c0
        p1 = 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0) & M, p1 & M, \
            ((p0 >> 32) ^ c3 ^ k1) & M, p0 & M
        k0, k1 = (k0 + 0x9E3779B9) & M, (k1 + 0xBB67AE85) & M
    return c0, c1, c2, c3


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    assert _philox_py(ctr, key) == want
    got = prng.philox4x32(tuple(torch.tensor(x) for x in ctr),
                          tuple(torch.tensor(x) for x in key))
    assert tuple(int(x) for x in got) == want


def test_philox_tensor_matches_python_integers():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(6, 300), dtype=np.int64)
    got = prng.philox4x32(tuple(torch.from_numpy(w) for w in words[:4]),
                          tuple(torch.from_numpy(w) for w in words[4:]))
    for j in range(words.shape[1]):
        want = _philox_py(tuple(int(w) for w in words[:4, j]),
                          tuple(int(w) for w in words[4:, j]))
        assert tuple(int(g[j]) for g in got) == want


def test_philox_draws_are_kernel_words():
    """Slot s is word s & 3 of the call on counter (node, s >> 2): one
    Philox call serves four draws."""
    seed = torch.tensor(123456789, dtype=torch.int32)
    node = torch.arange(1000, 1100)
    draws = prng.philox_u01(seed, 1100)
    for slot in range(6):
        bits = prng.philox_bits(seed, node, slot)
        for j in (0, 17, 99):
            assert int(bits[j]) == _philox_py(
                (1000 + j, slot >> 2, 0, 0), (123456789, 0))[slot & 3]
        u = prng.philox_uniform(seed, node, slot)
        assert u.dtype == torch.float32
        assert bool((u >= 0).all()) and bool((u < 1).all())
        assert torch.equal(u * 2**24, (bits >> 8).to(torch.float32))
        assert torch.equal(draws(slot)[1000:], u)


@pytest.mark.cuda
def test_streams_on_the_card_equal_the_host(cuda):
    tk = prng.key(4)
    assert torch.equal(prng.round_seeds(tk.to(cuda), 3, 64).cpu(),
                       prng.round_seeds(tk, 3, 64))
    seed = torch.tensor(77, dtype=torch.int32)
    node = torch.arange(4096)
    assert torch.equal(prng.philox_bits(seed.to(cuda), node.to(cuda),
                                        2).cpu(),
                       prng.philox_bits(seed, node, 2))
