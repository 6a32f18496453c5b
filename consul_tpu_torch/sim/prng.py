"""Counter-based random streams in plain PyTorch.

Two generators live here:

* **threefry2x32**, bit-exact with JAX's default PRNG
  (``jax_threefry_partitionable=True``): ``key``, ``fold_in``, ``split``,
  ``bits``, ``uniform`` (any shape, with bounds) and ``randint`` (and ``normal`` /
  ``exponential``, exact up to the last bits of ``erfinv`` / ``log1p``),
  and on top of them the per-round streams
  ``round_keys`` / ``round_seeds`` of the JAX package's
  ``sim/round.py`` and the lane engine's global-index stream
  ``u01_global`` (its ``sim/lanes.py``). A run seeded with the same
  base key therefore draws
  the same per-round kernel seeds in both packages, and a run cut at a
  call boundary resumes seed for seed (round ``r``'s key is
  ``fold_in(base, r)``, independent of how the run is cut).
* **Philox4x32-10** (Salmon et al., "Parallel random numbers: as easy as
  1, 2, 3", SC'11) — the generator the CUDA round kernels run per node.
  ``philox_bits`` is its plain twin: the same 32-bit words for the same
  key and counter, so the kernels' plain versions draw exactly what the
  kernels draw. One call gives four words, so draw slot ``s`` is word
  ``s & 3`` of the call on counter ``(node, s >> 2, 0, 0)``.

Words are carried in int64 tensors holding values in [0, 2^32), masked
after every add and shift (PyTorch on the CPU has no ``<<`` for uint32);
threefry's rounds run on int32 words, whose adds wrap as uint32's do.

On the card every threefry draw is one launch of the draw kernel
(``fused.threefry``): each function builds its ``fused.Draw`` and
``_draw`` launches it. The functions' own bodies are the plain versions,
which CPU tensors run (and the card inside ``fused.plain()``);
``_draw_twin`` is the kernel's plain twin, which CPU tensors run inside
``fused.twins()``. A launch may derive its keys first (one level of
``fold_in``): ``round_seeds`` is one launch, a round's slots
(``threefry_u01``, ``global_u01``) are the rows of one launch, and a
``SubKey`` (``fold_in(k, word)``, that is ``split(k, n)[word]``, left
uncomputed) is derived by the draw that takes it.
Philox's multiplications split one factor into 16-bit halves so no
product leaves int64's range.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch

from consul_tpu_torch.sim import fused

MASK = 0xFFFFFFFF

Start = Union[int, torch.Tensor]

# ------------------------------------------------------------- threefry

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _i32(x) -> torch.Tensor:
    """uint32 words (int64 tensors or ints) as int32 two's complement."""
    return torch.as_tensor(x).to(torch.int32)


def _threefry_i32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int32 two's-complement words,
    updated in place: an int32 add wraps mod 2^32 as the uint32 add
    does, and a rotation is ``(x << r) | ((x >> (32 - r)) & (2^r - 1))``
    (the mask clears the arithmetic shift's sign copies) — a quarter of
    an int64 version's memory traffic and about a sixth of its time on
    the CPU. Returns the two words as int32."""
    k0, k1 = _i32(k0), _i32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
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
    return y0, y1


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on broadcastable int64 word tensors;
    returns the two output words (int64 in [0, 2^32))."""
    if isinstance(k0, torch.Tensor) and fused.routed(k0):
        dev = k0.device
        w = _draw(fused.draw("words", _on(k0, dev), _on(k1, dev),
                             _counter(x0, dev), _counter(x1, dev)))
        return w[..., 0], w[..., 1]
    y0, y1 = _threefry_i32(k0, k1, x0, x1)
    return y0.to(torch.int64) & MASK, y1.to(torch.int64) & MASK


def key(seed: int, device=None) -> torch.Tensor:
    """A raw threefry key ``[2]`` from an integer seed (``jax.random.key``)."""
    return torch.tensor([(seed >> 32) & MASK if seed >= 0 else 0,
                         seed & MASK], dtype=torch.int64, device=device)


def _on(x, device) -> torch.Tensor:
    """``x`` as an int64 tensor on ``device``. A Python int is written by
    a fill: a copy from host memory would make the host wait for the
    card."""
    if isinstance(x, int):
        return torch.full((), x, dtype=torch.int64, device=device)
    return torch.as_tensor(x, device=device).to(torch.int64)


def _counter(x, device) -> Optional[torch.Tensor]:
    """A counter word operand of a draw: None for the int 0."""
    if isinstance(x, int) and x == 0:
        return None
    return _on(x, device)


def _draw(d: fused.Draw) -> torch.Tensor:
    """One fused draw: the kernel for CUDA operands, its plain twin
    (``_draw_twin``) for CPU ones."""
    if d.k0.device.type == "cuda":
        return fused.threefry(d)
    return _draw_twin(d)


def _draw_twin(d: fused.Draw) -> torch.Tensor:
    """The draw kernel's plain twin: ``d`` in PyTorch ops, the keys
    derived and the counters made as the kernel makes them, the output
    laid out as ``fused.draw_out`` lays it out."""
    dev = d.k0.device
    k0, k1 = d.k0, d.k1
    c0 = 0 if d.x0 is None else d.x0
    c1 = 0 if d.x1 is None else d.x1
    j = None
    if d.gen:
        j = torch.arange(d.shape[-1], dtype=torch.int64, device=dev)
        if d.base is not None:
            j = d.base + j
    if d.derive_gen:
        # the key of word j is fold_in(k, base + j); the counter keeps
        # its data words
        k0, k1 = _threefry_i32(k0, k1, 0, j & MASK)
    elif d.derive:
        # row r's key is fold_in(k, derive[r % len(derive)]), made once
        # a row where the key is the same along it
        if k0.stride(-1) == 0 and k1.stride(-1) == 0:
            k0, k1 = k0[..., :1], k1[..., :1]
        lead = d.shape[:-1]
        w = torch.tensor(d.derive, dtype=torch.int64, device=dev).repeat(
            math.prod(lead) // len(d.derive)).view(lead + (1,))
        k0, k1 = _threefry_i32(k0, k1, 0, w)
    if d.gen and not d.derive_gen:
        c1 = c1 + (j & MASK)
        if d.gen_hi:
            c0 = c0 + (j >> 32)
    y0, y1 = _threefry_i32(k0, k1, c0, c1)
    y0, y1 = y0.expand(d.shape), y1.expand(d.shape)
    if d.mode == "words":
        return torch.stack([y0.to(torch.int64) & MASK,
                            y1.to(torch.int64) & MASK], dim=-1)
    if d.mode == "u01_global":
        return _u01_of(y0.to(torch.int64) & MASK)
    w = (y0 ^ y1).to(torch.int64) & MASK
    if d.mode == "xor":
        return w
    if d.mode == "seeds":
        return (w >> 1).to(torch.int32)
    f = (w >> 9).to(torch.float32) * (2.0 ** -23)
    if d.scale == "pow2":
        f = torch.clamp_min(f * d.width + d.lo, d.lo)
    elif d.scale == "f64":
        f = torch.clamp_min((f.double() * d.width + d.lo).float(), d.lo)
    return f


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``k`` and uint32 ``data``
    (a 1-D ``data`` tensor gives a ``[len, 2]`` stack of keys)."""
    d = _on(data, k.device)
    if fused.routed(k):
        return _draw(fused.draw("words", k[..., 0], k[..., 1], x1=d))
    d = d & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


@dataclasses.dataclass(frozen=True)
class SubKey:
    """``fold_in(parent, word)`` — which is ``split(parent, n)[word]``
    for any ``n > word`` — left for the draw that takes it as its key:
    on the kernel's route that draw derives it in its own launch, the
    plain versions compute ``fold_in`` first (``value``). ``split``,
    ``uniform`` (and ``normal``, ``exponential``), ``randint``,
    ``u01_global`` and ``round_keys`` take one. A key stack's
    ``SubKey`` indexes like the stack: ``sub[i]`` is ``SubKey(
    parent[i], word)``."""

    parent: torch.Tensor
    word: int

    def __getitem__(self, i) -> "SubKey":
        return SubKey(self.parent[i], self.word)

    def value(self) -> torch.Tensor:
        return fold_in(self.parent, self.word)


Key = Union[torch.Tensor, SubKey]


def subkeys(k: torch.Tensor, num: int) -> list:
    """``split(k, num)`` as ``num`` ``SubKey``s: no launch until a draw
    takes one."""
    return [SubKey(k, i) for i in range(num)]


def _parts(k: Key) -> tuple:
    """(the key tensor a launch reads, the words it derives by)."""
    if isinstance(k, SubKey):
        return k.parent, (k.word,)
    return k, ()


def _value(k: Key) -> torch.Tensor:
    return k.value() if isinstance(k, SubKey) else k


def split(k: Key, num: int) -> torch.Tensor:
    """``jax.random.split(k, num)`` -> ``[num, 2]`` keys; a ``[..., 2]``
    key stack splits each key: ``[..., num, 2]``."""
    pk, derive = _parts(k)
    if fused.routed(pk):
        return _draw(fused.draw("words", pk[..., 0, None], pk[..., 1, None],
                                gen=num, derive=derive))
    k = _value(k)
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], 0, i)
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, n: int = 0) -> torch.Tensor:
    """32-bit random words of ``k`` (``jax.random.bits``): the scalar
    word for ``n == 0`` (per key, for a ``[..., 2]`` key stack), else an
    ``[n]`` vector."""
    if fused.routed(k):
        if n == 0:
            return _draw(fused.draw("xor", k[..., 0], k[..., 1]))
        return _draw(fused.draw("xor", k[0], k[1], gen=n, gen_hi=True))
    if n == 0:
        z = torch.zeros_like(k[..., 0])
        y0, y1 = threefry2x32(k[..., 0], k[..., 1], z, z)
    else:
        j = torch.arange(n, dtype=torch.int64, device=k.device)
        y0, y1 = threefry2x32(k[0], k[1], j >> 32, j & MASK)
    return y0 ^ y1


Shape = Union[int, tuple]


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _numel(shape: tuple) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def uniform(k: Key, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=, maxval=)`` in f32, bit for
    bit. Element i of the flattened shape takes word i (the partitionable
    stream counts row-major); its top 23 bits are the mantissa of a
    float in [1, 2), minus one — exactly ``(word >> 9) * 2**-23`` — then
    scaled as JAX does: ``max(lo, f * (hi - lo) + lo)`` with the bounds
    and their difference rounded to f32. XLA fuses the multiply-add
    (one rounding); here the product is exact in f64 and the sum is
    rounded to f64, then to f32 — or, for a power-of-two width (the
    views' picks: [1e-9, 1) has width 1), exact in f32. The counter is
    int32, so a draw holds fewer than 2^31 words. A ``[..., 2]`` key
    stack draws for each key: ``[..., *shape]``."""
    shape = _shape(shape)
    pk, derive = _parts(k)
    if fused.routed(pk):
        f = _draw(fused.draw("uniform", pk[..., 0, None], pk[..., 1, None],
                             gen=_numel(shape), minval=minval,
                             maxval=maxval, derive=derive))
        return f.view(tuple(pk.shape[:-1]) + shape)
    k = _value(k)
    j = torch.arange(_numel(shape), dtype=torch.int32, device=k.device)
    y0, y1 = _threefry_i32(k[..., 0, None], k[..., 1, None], 0, j)
    f = ((y0 ^ y1) >> 9 & 0x7FFFFF).to(torch.float32) * (2.0 ** -23)
    if (minval, maxval) != (0.0, 1.0):
        lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
        width = torch.tensor(maxval, dtype=torch.float32,
                             device=k.device) - lo
        if math.frexp(float(width))[0] == 0.5:
            # a power-of-two width: f * width is exact, one rounding
            f = f * width + lo
        else:
            f = (f.double() * width.double() + lo.double()).float()
        f = torch.maximum(f, lo)
    return f.view(tuple(k.shape[:-1]) + shape)


#: ``jax.random.normal`` draws its uniform on [nextafter(-1, 0), 1): the
#: low end in f32, and the width ``1 - lo`` as XLA rounds it in f32
_NORMAL_LO = -1.0 + 2.0 ** -24
_NORMAL_WIDTH = 2.0
_SQRT2_F32 = float(torch.tensor(2.0 ** 0.5, dtype=torch.float32))


def normal(k: Key, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in f32: sqrt(2)·erfinv(u) of the
    uniform ``max(lo, f·(1 - lo) + lo)`` on [lo, 1), f the word's
    [0, 1) float. The uniform is bit for bit; PyTorch's ``erfinv`` and
    XLA's differ in the last bits (the tests bound them in ulps)."""
    f = uniform(k, shape)
    u = torch.clamp_min(f * _NORMAL_WIDTH + _NORMAL_LO, _NORMAL_LO)
    return _SQRT2_F32 * torch.special.erfinv(u)


def exponential(k: Key, shape: Shape) -> torch.Tensor:
    """``jax.random.exponential(k, shape)`` in f32: ``-log1p(-u)`` of
    the bit-exact uniform (the two libraries' ``log1p`` differ in the
    last bits)."""
    return -torch.log1p(-uniform(k, shape))


def randint(k: Key, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval, int32)``, bit for
    bit: two 32-bit words per element from ``split(k, 2)``, folded into
    [minval, maxval) by the same wrapping uint32 remainders
    ((hi % span) · m + lo % span) % span, where m = ((2^16 % span)^2
    mod 2^32) % span — which wraps to 0 once span exceeds 2^16. On the
    kernel's route both words are one launch: the two split keys derived
    as its two rows."""
    shape = _shape(shape)
    span = maxval - minval if maxval > minval else 1
    mult = ((((2 ** 16) % span) ** 2) & MASK) % span
    k = _value(k)
    count = _numel(shape)
    if fused.routed(k):
        hi, lo = _draw(fused.draw("xor", k[0].expand(2, 1),
                                  k[1].expand(2, 1), gen=count,
                                  gen_hi=True, derive=(0, 1)))
    else:
        k1, k2 = split(k, 2)
        hi, lo = bits(k1, count), bits(k2, count)
    if mult:
        off = (((hi % span) * mult) & MASK) + lo % span
        off = (off & MASK) % span
    else:
        # a span above 2^16: the high word's term is 0, and lo % span
        # (below 2^32) is already the wrapped remainder
        off = lo % span
    return (off + minval).to(torch.int32).view(shape)


def round_keys(k: Key, start: Start, count: int) -> torch.Tensor:
    """``[count, 2]`` per-round keys for ABSOLUTE rounds
    start..start+count-1: round r's key is ``fold_in(k, r)``, a pure
    function of the base key and the absolute round index."""
    pk, derive = _parts(k)
    if fused.routed(pk):
        return _draw(fused.draw("words", pk[..., 0], pk[..., 1], gen=count,
                                base=_on(start, pk.device), derive=derive))
    k = _value(k)
    idx = _on(start, k.device) \
        + torch.arange(count, dtype=torch.int64, device=k.device)
    return fold_in(k, idx)


def round_seeds(k: torch.Tensor, start: Start, count: int) -> torch.Tensor:
    """``[count]`` non-negative int32 kernel seeds for absolute rounds
    start..start+count-1 (one word of each round key, shifted right
    once) — the same stream the JAX package feeds its TPU kernels. On
    the kernel's route one launch derives each round's key and draws
    its word."""
    if fused.routed(k):
        return _draw(fused.draw("seeds", k[..., 0], k[..., 1], gen=count,
                                base=_on(start, k.device), derive_gen=True))
    rk = round_keys(k, start, count)
    return (bits(rk) >> 1).to(torch.int32)


# --------------------------------------------------------- Philox4x32-10

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of constant ``a`` and
    word tensor ``b``, without leaving int64 range."""
    p0 = b * (a & 0xFFFF)
    p1 = b * (a >> 16)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & MASK
    return hi, lo


def philox4x32(c, k):
    """Philox4x32-10 on a 4-word counter ``c`` and 2-word key ``k``
    (broadcastable int64 word tensors or ints); returns 4 words."""
    c0, c1, c2, c3 = c
    k0, k1 = k
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK
        k1 = (k1 + PHILOX_W1) & MASK
    return c0, c1, c2, c3


def philox_words(seed: torch.Tensor, node: torch.Tensor, call: int):
    """The four words of one kernel Philox call: Philox4x32-10 keyed by
    ``(seed, 0)`` on counter ``(node, call, 0, 0)``. ``seed`` is an int32
    0-d tensor, ``node`` the global node indices."""
    s = seed.to(torch.int64) & MASK
    node = node.to(torch.int64)
    z = torch.zeros_like(node)
    return philox4x32((node, z + call, z, z), (s, 0))


def philox_bits(seed: torch.Tensor, node: torch.Tensor,
                slot: int) -> torch.Tensor:
    """The kernels' per-node word for draw ``slot``: word ``slot & 3`` of
    call ``slot >> 2`` (one Philox call serves four draws)."""
    return philox_words(seed, node, slot >> 2)[slot & 3]


def _u01_of(bits: torch.Tensor) -> torch.Tensor:
    """The kernels' conversion: the top 24 bits, ``(bits >> 8) * 2**-24``."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def philox_uniform(seed: torch.Tensor, node: torch.Tensor,
                   slot: int) -> torch.Tensor:
    """f32 uniform in [0, 1) from ``philox_bits``."""
    return _u01_of(philox_bits(seed, node, slot))


# ------------------------------------------------ per-node draw sources

#: a round body's draw source: slot index -> [L] f32 uniforms
U01 = Callable[[int], torch.Tensor]


#: the JAX engines key the byzantine replay draw (slot 5) by folding
#: this constant into the round key, off the five split keys
REPLAY_FOLD = 0xB12A
#: and the coordinate draws (probe pairs, RTT jitter, Vivaldi direction,
#: and the kernel runner's population ack gate) by folding this one
COORD_FOLD = 0x5EED


#: a round's draw slots: 0-4 key ``split(k, 5)[slot]``, 5 (the replay
#: draw of byzantine rounds) ``fold_in(k, REPLAY_FOLD)``
SLOTS = tuple(range(6))
REPLAY_SLOT = 5


def slot_words(slots: tuple) -> tuple:
    """The word each slot's key folds into the round key (``split``'s
    index is ``fold_in``'s word)."""
    return tuple(REPLAY_FOLD if s == REPLAY_SLOT else s for s in slots)


def _check_slot(slot: int, slots: tuple) -> None:
    if slot not in slots:
        raise ValueError(f"draw slot {slot} was not drawn: this round "
                         f"draws the slots {slots}")


def _slot_rows(rows: torch.Tensor, slots: tuple) -> U01:
    """The source over one launch's ``[len(slots), n]`` rows."""
    at = {s: i for i, s in enumerate(slots)}

    def u01(slot: int) -> torch.Tensor:
        _check_slot(slot, slots)
        return rows[at[slot]]

    return u01


def threefry_u01(k: torch.Tensor, n: int, slots: tuple) -> U01:
    """The JAX engines' draws for one round: slot s < 5 draws
    ``uniform(split(k, 5)[s], (n,))``; slot 5 (the replay draw of
    byzantine rounds) draws from ``fold_in(k, REPLAY_FOLD)``. ``slots``
    are those the round reads (``round.draw_slots``); asking for another
    raises. On the kernel's route they are the rows of one launch, each
    deriving its slot key from ``k``; the plain version splits and draws
    a slot when it is first read."""
    slots = tuple(slots)
    if fused.routed(k):
        return _slot_rows(_draw(fused.draw(
            "uniform", k[0].expand(len(slots), 1),
            k[1].expand(len(slots), 1), gen=n,
            derive=slot_words(slots))), slots)
    keys = split(k, 5)

    def u01(slot: int) -> torch.Tensor:
        _check_slot(slot, slots)
        if slot == REPLAY_SLOT:
            return uniform(fold_in(k, REPLAY_FOLD), n)
        return uniform(keys[slot], n)

    return u01


def u01_global(k: Key, offset: Start, length: int) -> torch.Tensor:
    """The lane engine's ``[length]`` uniforms keyed by (key, GLOBAL node
    index): one threefry2x32 evaluation per node on the counter pair
    ``(0, offset + i)``, word 0, top 24 bits — so node i draws the same
    value whatever slice of the pool is computed (reference
    ``lanes.u01_global``). Not ``uniform``: a different stream."""
    pk, derive = _parts(k)
    if fused.routed(pk):
        return _draw(fused.draw("u01_global", pk[0], pk[1], gen=length,
                                base=_on(offset, pk.device), derive=derive))
    k = _value(k)
    idx = (_on(offset, k.device)
           + torch.arange(length, dtype=torch.int64, device=k.device)) \
        & MASK
    y0, _ = threefry2x32(k[0], k[1], torch.zeros_like(idx), idx)
    return _u01_of(y0)


def global_rows(k: torch.Tensor, offset: Start, n: int,
                slots: tuple) -> torch.Tensor:
    """``global_u01``'s rows on the kernel's route: one launch of
    ``[len(slots), n]`` uniforms, row i slot ``slots[i]``'s (the rows the
    lane kernel reads)."""
    slots = tuple(slots)
    return _draw(fused.draw(
        "u01_global", k[0].expand(len(slots), 1),
        k[1].expand(len(slots), 1), gen=n, base=_on(offset, k.device),
        derive=slot_words(slots)))


def global_u01(k: torch.Tensor, offset: Start, n: int,
               slots: tuple) -> U01:
    """The lane engine's draws for one round over nodes offset..offset+
    n-1: slots 0-4 from ``split(k, 5)``, slot 5 (byzantine replay) from
    ``fold_in(k, REPLAY_FOLD)``, each through ``u01_global``; ``slots``
    and the launch as in ``threefry_u01`` (``global_rows``)."""
    slots = tuple(slots)
    if fused.routed(k):
        return _slot_rows(global_rows(k, offset, n, slots), slots)
    keys = split(k, 5)

    def u01(slot: int) -> torch.Tensor:
        _check_slot(slot, slots)
        kk = fold_in(k, REPLAY_FOLD) if slot == REPLAY_SLOT else keys[slot]
        return u01_global(kk, offset, n)

    return u01


def philox_u01(seed: torch.Tensor, n: int) -> U01:
    """The round kernels' draws for one round over nodes 0..n-1: Philox
    keyed by the round's seed; slot s is word ``s & 3`` of call ``s >> 2``
    on counter (node index, call). Each call runs once, on first use."""
    node = torch.arange(n, dtype=torch.int64, device=seed.device)
    calls: dict = {}

    def u01(slot: int) -> torch.Tensor:
        if slot >> 2 not in calls:
            calls[slot >> 2] = philox_words(seed, node, slot >> 2)
        return _u01_of(calls[slot >> 2][slot & 3])

    return u01
