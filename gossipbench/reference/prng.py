"""The random streams the simulation draws from, in plain PyTorch.

Written from the published generators, not from the program:

* Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random numbers:
  as easy as 1, 2, 3", SC'11), keyed and counted as JAX's partitionable
  threefry is: ``key``, ``fold_in``, ``split``, ``uniform`` and the
  per-round streams built on them (round ``r``'s key is ``fold_in(base,
  r)``);
* the global-index stream of the lane engine: node ``i`` draws word 0
  of ``threefry(k, (0, i))``, its top 24 bits;
* Philox4x32-10 (same paper), keyed by a round's 31-bit seed and counted
  by ``(node, call, 0, 0)``; draw slot ``s`` is word ``s & 3`` of call
  ``s >> 2``, its top 24 bits.

Words are int64 tensors holding values in [0, 2^32) except inside
threefry's rounds, which run on int32 words whose adds wrap as uint32's.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def threefry(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on broadcastable words; returns the two
    output words as int64 in [0, 2^32)."""
    k0, k1 = _i32(k0), _i32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    y0, y1 = torch.broadcast_tensors(_i32(x0) + k0, _i32(x1) + k1)
    y0, y1 = y0.clone(), y1.clone()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0.add_(y1)
            hi = y1 << r
            y1.bitwise_right_shift_(32 - r).bitwise_and_(
                (1 << r) - 1).bitwise_or_(hi).bitwise_xor_(y0)
        y0.add_(ks[(i + 1) % 3])
        y1.add_(ks[(i + 2) % 3] + (i + 1))
    return y0.to(torch.int64) & MASK, y1.to(torch.int64) & MASK


def key(seed: int, device=None) -> torch.Tensor:
    """The ``[2]`` key of an integer seed (``jax.random.key``)."""
    return torch.tensor([(seed >> 32) & MASK if seed >= 0 else 0,
                         seed & MASK], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """A key from ``k`` and uint32 ``data``; a 1-D ``data`` gives a
    ``[len, 2]`` stack."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    y0, y1 = threefry(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry(k[..., 0, None], k[..., 1, None], 0, i)
    return torch.stack([y0, y1], dim=-1)


def uniform(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(k, (n,))`` in f32: the xor of the two words,
    its top 23 bits as a mantissa in [1, 2), minus one."""
    j = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry(k[0], k[1], 0, j)
    return ((y0 ^ y1) >> 9).to(torch.float32) * (2.0 ** -23)


def round_keys(k: torch.Tensor, start, count: int) -> torch.Tensor:
    idx = torch.as_tensor(start, dtype=torch.int64, device=k.device) \
        + torch.arange(count, dtype=torch.int64, device=k.device)
    return fold_in(k, idx)


def round_seeds(k: torch.Tensor, start, count: int) -> torch.Tensor:
    """One non-negative int32 seed a round: a round key's
    ``jax.random.bits``, shifted right once."""
    rk = round_keys(k, start, count)
    z = torch.zeros_like(rk[..., 0])
    y0, y1 = threefry(rk[..., 0], rk[..., 1], z, z)
    return ((y0 ^ y1) >> 1).to(torch.int32)


def _top24(w: torch.Tensor) -> torch.Tensor:
    return (w >> 8).to(torch.float32) * (2.0 ** -24)


def u01_global(k: torch.Tensor, n: int) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, _ = threefry(k[0], k[1], torch.zeros_like(idx), idx)
    return _top24(y0)


def threefry_slots(k: torch.Tensor, n: int):
    """A round's draws on the live engine: slot s (0-4) is
    ``uniform(split(k, 5)[s], n)``."""
    keys = split(k, 5)
    return lambda slot: uniform(keys[slot], n)


def global_slots(k: torch.Tensor, n: int):
    """A round's draws on the lane engine: slot s is
    ``u01_global(split(k, 5)[s], n)``."""
    keys = split(k, 5)
    return lambda slot: u01_global(keys[slot], n)


_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    p0 = b * (a & 0xFFFF)
    p1 = b * (a >> 16)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & MASK
    return hi, lo


def philox(c, k):
    """Philox4x32-10 on a 4-word counter and a 2-word key."""
    c0, c1, c2, c3 = c
    k0, k1 = k
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & MASK
        k1 = (k1 + _W1) & MASK
    return c0, c1, c2, c3


def philox_slots(seed: torch.Tensor, n: int):
    """A round's draws on the kernel runner, keyed by its seed."""
    node = torch.arange(n, dtype=torch.int64, device=seed.device)
    s = seed.to(torch.int64) & MASK
    z = torch.zeros_like(node)
    calls: dict = {}

    def u01(slot: int) -> torch.Tensor:
        if slot >> 2 not in calls:
            calls[slot >> 2] = philox((node, z + (slot >> 2), z, z), (s, 0))
        return _top24(calls[slot >> 2][slot & 3])

    return u01
