"""The fused draw and sum kernels' wrappers, launch counts and switches.

The JAX package leaves its two commonest primitives to XLA, which
compiles each ``jax.random`` draw into one fused elementwise kernel and
each ``jnp.sum`` into one reduce. The port's plain versions spell them
out as PyTorch ops: a threefry draw is ~140 elementwise launches
(``prng._threefry_i32``), a fixed-order sum one or two a halving step
(``lanes.tree_sum``). Two CUDA sources take their place on the card:

* ``csrc/prng_kernels.cu`` — ``threefry``: one launch a draw, in the
  modes ``words`` (``threefry2x32``, ``fold_in``, ``split``,
  ``round_keys``), ``xor`` (``bits``, ``randint``'s two words),
  ``seeds`` (``round_seeds``), ``uniform`` (with its scaling) and
  ``u01_global``. A draw may derive its keys in the launch
  (``fold_in`` by a word of a table a row, or by the generated index),
  so a round's slots, or its seeds, are one launch. ``prng`` builds
  each draw's ``Draw`` and routes it here.
* ``csrc/sum_kernels.cu`` — ``tree_sum``: ``lanes.tree_sum``'s order of
  additions in one launch a sum (``sum_plan``): a long row is cut
  across CTAs, and its last CTA to arrive folds it.

Both are held bit for bit to the plain versions, so every engine's
state, statistics and trace stay what they were. Routing
(``routed``): a CUDA tensor goes to the kernel, a CPU tensor to the
plain version that ran before the kernels. Two switches change that,
and nothing on a main path uses them: ``plain()`` runs the plain
versions on the card too (the checks that hold a kernel against its
plain version), ``twins()`` runs each kernel's plain twin — the same
``Draw`` or ``sum_plan`` in PyTorch — on the CPU (the tests that prove
the wrapper's arithmetic without a card). A failed build or launch
raises; nothing falls back to the plain version.

``LAUNCHES`` counts each launch by kernel (``threefry/<mode>``,
``tree_sum``), apart from ``cuda_round.LAUNCHES``, whose exact counts
the round-kernel checks compare. ``graphs.GraphCache`` counts it like
the round kernels' (a capture takes its increments back, a replay adds
them) and keys its graphs on the ``plain()`` switch. The op counter
(``costmodel.OpCounter``) cannot see a ctypes launch, so each launch
reports its tensors to the counters in ``OBSERVERS``.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from consul_tpu_torch.utils import build

DRAW_SOURCE = "prng_kernels"
SUM_SOURCE = "sum_kernels"
SOURCES = (DRAW_SOURCE, SUM_SOURCE)

#: the draw kernel's output modes (csrc/prng_kernels.cu ``Mode``)
MODES = {"words": 0, "xor": 1, "seeds": 2, "uniform": 3, "u01_global": 4}
#: its key derivations (``Derive``): none, a table word a row, the
#: generated index; and the table's most words
DERIVE = {"none": 0, "row": 1, "gen": 2}
MAX_DERIVE = 8
#: the uniform's scaling (``Scale``): none for [0, 1), a power-of-two
#: width in f32, any other width through f64
SCALES = {"unit": 0, "pow2": 1, "f64": 2}
MAX_DIMS = 6

#: the sum kernel's limits (csrc/sum_kernels.cu; ``_sum_lib`` checks
#: them): halving steps of a row shorter than 2^31, the levels a thread
#: walks in registers, the positions a CTA may hold in shared memory
#: (128 KB), the threads of a CTA
MAX_LEVELS = 31
THREAD_LEVELS = 4
SMEM_N = 32768
SUM_THREADS = 256
#: the positions a thread loads at once on the vector path
SUM_VEC = 4
#: rows that fill the card (two CTAs on each of the H100's 132 SMs):
#: their CTAs take ``SUM_GROUPS`` float4 groups a thread (16 leaf loads
#: each), fewer rows' CTAs one
ROWS_ALONE = 264
SUM_GROUPS = 4
#: the fewest level-k positions a cut row's CTA owns (each leaf load of
#: a warp then covers whole 64-byte halves of lines; 32 left the last
#: CTA twice the positions to fold for no faster loads)
MIN_WIDTH = 16

#: launches per kernel since the last ``reset_launches()``; incremented
#: only where a kernel is launched (never by a plain version)
LAUNCHES: collections.Counter = collections.Counter()

#: counters (``costmodel.OpCounter``) a launch reports its tensors to
OBSERVERS: list = []

_plain = contextvars.ContextVar("consul_tpu_torch_fused_plain",
                                default=False)
_twins = contextvars.ContextVar("consul_tpu_torch_fused_twins",
                                default=False)


def reset_launches() -> None:
    LAUNCHES.clear()


@contextlib.contextmanager
def _set(var: contextvars.ContextVar):
    token = var.set(True)
    try:
        yield
    finally:
        var.reset(token)


def plain():
    """Inside this block every device runs the plain PyTorch versions of
    the draws and sums (the comparison of a kernel with its plain
    version), ``twins()`` or not."""
    return _set(_plain)


def twins():
    """Inside this block CPU tensors run each kernel's plain twin (the
    kernel's own decomposition in PyTorch) in place of the plain
    version, unless ``plain()`` is on."""
    return _set(_twins)


def plain_active() -> bool:
    """Whether ``plain()`` is on (a graph key part: a graph captured with
    the kernels is not replayed inside ``plain()``)."""
    return _plain.get()


def routed(x: torch.Tensor) -> bool:
    """Whether a draw or sum on ``x`` takes the kernel's route: the
    kernel on the card, its twin on the CPU inside ``twins()``; never
    inside ``plain()``."""
    if _plain.get():
        return False
    return x.device.type == "cuda" or _twins.get()


def _observe(ins, outs) -> None:
    for obs in OBSERVERS:
        obs.add(ins, outs)


def _check_launch(rc: int, what: str, error_string) -> None:
    if rc != 0:
        msg = error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------- draws


class Draw(NamedTuple):
    """One threefry draw over an index space ``shape``: key words ``k0``,
    ``k1`` and the counter words' data ``x0``, ``x1`` (int64 tensors or
    None for 0), each expanded to ``shape``; ``gen`` adds the index j
    along the last dimension, plus ``base`` (a 0-d int64 device tensor or
    None), to word 1 (and ``j >> 32`` to word 0 when ``gen_hi``, which
    takes no base); ``mode`` names the output; ``lo``, ``width`` and
    ``scale`` the uniform's scaling; ``raw`` the operands as given (the
    bytes a launch reads). ``derive`` folds a word into the key before
    the draw (``fold_in``): row r (over the leading dimensions, row-major)
    by ``derive[r % len(derive)]``; ``derive_gen`` by the generated index
    ``base + j`` in place of the counter's."""

    mode: str
    shape: tuple
    k0: torch.Tensor
    k1: torch.Tensor
    x0: Optional[torch.Tensor]
    x1: Optional[torch.Tensor]
    gen: bool
    base: Optional[torch.Tensor]
    gen_hi: bool
    lo: float
    width: float
    scale: str
    raw: tuple
    derive: tuple = ()
    derive_gen: bool = False


@functools.lru_cache(maxsize=None)
def uniform_scale(minval: float, maxval: float) -> tuple:
    """(lo, width, scale) of ``uniform``'s bounds: both rounded to f32 as
    ``prng.uniform`` rounds them, the width's f32 difference, and how it
    scales (``SCALES``)."""
    lo = np.float32(minval)
    width = np.float32(maxval) - lo
    if (minval, maxval) == (0.0, 1.0):
        scale = "unit"
    elif math.frexp(float(width))[0] == 0.5:
        scale = "pow2"
    else:
        scale = "f64"
    return float(lo), float(width), scale


def broadcast_shape(*shapes) -> tuple:
    """``torch.broadcast_shapes`` of the operands' shapes, in plain
    Python: a draw's wrapper runs on the host every eager period, and
    torch's version costs it ~0.1 ms."""
    out = [1] * max((len(s) for s in shapes), default=0)
    for s in shapes:
        for i, d in enumerate(s, len(out) - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {[tuple(x) for x in shapes]} "
                                     "do not broadcast")
                out[i] = d
    return tuple(out)


def draw(mode: str, k0: torch.Tensor, k1: torch.Tensor, x0=None, x1=None,
         gen: Optional[int] = None, base: Optional[torch.Tensor] = None,
         gen_hi: bool = False, minval: float = 0.0,
         maxval: float = 1.0, derive: tuple = (),
         derive_gen: bool = False) -> Draw:
    """The ``Draw`` of ``mode`` on these operands: the index space is
    their broadcast shape, with ``gen`` (the generated counter's count)
    as its last dimension when given. ``derive`` (uint32 words, one a
    row, repeating) or ``derive_gen`` (needs ``gen``, not ``gen_hi``)
    derive the keys in the launch (``Draw``)."""
    ops = [t for t in (k0, k1, x0, x1) if t is not None]
    shape = broadcast_shape(*(t.shape for t in ops),
                            *(() if gen is None else ((gen,),)))
    if len(shape) > MAX_DIMS:
        raise ValueError(f"a draw spans at most {MAX_DIMS} dimensions; "
                         f"got {tuple(shape)}")
    derive = tuple(int(w) for w in derive)
    if derive:
        rows = math.prod(shape[:-1])
        if derive_gen or not shape or len(derive) > MAX_DERIVE \
                or rows % len(derive) \
                or not all(0 <= w <= 0xFFFFFFFF for w in derive):
            raise ValueError(f"a draw derives its rows' keys by 1 to "
                             f"{MAX_DERIVE} uint32 words that tile its "
                             f"{rows} rows; got {derive}")
    if derive_gen and (gen is None or gen_hi):
        raise ValueError("a key derived by the generated index needs "
                         "gen and no gen_hi")
    if gen_hi and (gen is None or base is not None):
        raise ValueError("gen_hi counts the generated index from 0: it "
                         "needs gen and no base")
    lo, width, scale = uniform_scale(minval, maxval)

    def ex(t):
        return None if t is None else t.expand(shape)

    return Draw(mode, tuple(shape), ex(k0), ex(k1), ex(x0), ex(x1),
                gen is not None, base, gen_hi, lo, width, scale,
                tuple(t for t in ops + [base] if t is not None), derive,
                derive_gen)


class DrawArgs(ctypes.Structure):
    """Mirror of ``struct DrawArgs`` in prng_kernels.cu."""

    _fields_ = ([(f, ctypes.c_void_p)
                 for f in ("k0", "k1", "x0", "x1", "base", "out")]
                + [(f, ctypes.c_int)
                   for f in ("ndim", "gen", "gen_hi", "scale")]
                + [("lo", ctypes.c_float), ("width", ctypes.c_float)]
                + [(f, ctypes.c_int) for f in ("derive", "nderive")]
                + [("dword", ctypes.c_uint32 * MAX_DERIVE),
                   ("rows", ctypes.c_int64)]
                + [(f, ctypes.c_int64 * MAX_DIMS)
                   for f in ("size", "sk0", "sk1", "sx0", "sx1")])


@functools.lru_cache(maxsize=None)
def _draw_lib() -> ctypes.CDLL:
    lib = build.load(DRAW_SOURCE)
    lib.prng_kernels_max_dims.argtypes = []
    lib.prng_kernels_max_dims.restype = ctypes.c_int
    lib.prng_kernels_max_derive.argtypes = []
    lib.prng_kernels_max_derive.restype = ctypes.c_int
    if (lib.prng_kernels_max_dims(), lib.prng_kernels_max_derive()) != \
            (MAX_DIMS, MAX_DERIVE):
        raise RuntimeError("prng_kernels.cu and fused's MAX_DIMS and "
                           "MAX_DERIVE disagree")
    lib.launch_threefry.argtypes = [DrawArgs, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.launch_threefry.restype = ctypes.c_int
    lib.prng_kernels_error_string.argtypes = [ctypes.c_int]
    lib.prng_kernels_error_string.restype = ctypes.c_char_p
    return lib


def draw_out(d: Draw) -> torch.Tensor:
    """An empty output of ``d``: ``[*shape, 2]`` int64 words, int64
    xor words, int32 seeds or f32 uniforms."""
    dev = d.k0.device
    if d.mode == "words":
        return torch.empty(d.shape + (2,), dtype=torch.int64, device=dev)
    dtype = {"xor": torch.int64, "seeds": torch.int32}.get(d.mode,
                                                           torch.float32)
    return torch.empty(d.shape, dtype=dtype, device=dev)


#: bytes a word of each mode's output takes
OUT_BYTES = {"words": 16, "xor": 8, "seeds": 4, "uniform": 4,
             "u01_global": 4}


def draw_out_bytes(d: Draw) -> int:
    return math.prod(d.shape) * OUT_BYTES[d.mode]


def _words_operand(t: Optional[torch.Tensor], dev, name: str):
    if t is None:
        return None, (0,) * MAX_DIMS
    if t.device != dev or t.dtype != torch.int64:
        raise ValueError(f"draw operand {name} must be int64 on {dev}; "
                         f"got {t.dtype} on {t.device}")
    return t.data_ptr(), tuple(t.stride()) + (0,) * (MAX_DIMS - t.dim())


def draw_args(d: Draw, out: torch.Tensor) -> DrawArgs:
    """The kernel's arguments for ``d`` writing ``out``: every operand
    int64 on ``out``'s device and the base one int64 there."""
    dev = out.device
    if d.base is not None and (d.base.device != dev
                               or d.base.dtype != torch.int64
                               or d.base.numel() != 1):
        raise ValueError(f"a draw's base must be one int64 on {dev}")
    ops = {n: _words_operand(getattr(d, n), dev, n)
           for n in ("k0", "k1", "x0", "x1")}
    # a 0-d draw is one word: an index space of (1,)
    size = tuple(d.shape) or (1,)
    return DrawArgs(
        k0=ops["k0"][0], k1=ops["k1"][0], x0=ops["x0"][0],
        x1=ops["x1"][0],
        base=None if d.base is None else d.base.data_ptr(),
        out=out.data_ptr(), ndim=len(size), gen=int(d.gen),
        gen_hi=int(d.gen_hi), scale=SCALES[d.scale], lo=d.lo,
        width=d.width,
        derive=DERIVE["gen" if d.derive_gen else
                      "row" if d.derive else "none"],
        nderive=len(d.derive),
        dword=(ctypes.c_uint32 * MAX_DERIVE)(*d.derive),
        size=(ctypes.c_int64 * MAX_DIMS)(
            *size, *(1,) * (MAX_DIMS - len(size))),
        **{f"s{n}": (ctypes.c_int64 * MAX_DIMS)(*ops[n][1]) for n in ops})


def threefry(d: Draw) -> torch.Tensor:
    """Launch the draw kernel on ``d`` (CUDA operands) and return its
    output (``draw_out``); raises on a refused or failed launch."""
    if d.k0.device.type != "cuda":
        raise ValueError("fused.threefry launches on CUDA tensors; the "
                         "CPU runs prng's plain versions")
    out = draw_out(d)
    if out.numel():
        args = draw_args(d, out)
        lib = _draw_lib()
        _check_launch(lib.launch_threefry(args, MODES[d.mode],
                                          _stream(out)),
                      f"threefry/{d.mode}", lib.prng_kernels_error_string)
        LAUNCHES[f"threefry/{d.mode}"] += 1
        _observe(d.raw, (out,))
    return out


# ----------------------------------------------------------------- sums


class SumPlan(NamedTuple):
    """The one launch of ``rows`` row sums of ``length`` (see
    csrc/sum_kernels.cu): each thread walks the leaf trees of level ``t``,
    each CTA owns ``width`` positions of level ``k`` (a row's last CTA may
    own fewer; ``chunks`` CTAs a row) and joins levels ``t`` .. ``k`` in
    shared memory, and the row's last CTA folds level ``k``; an uncut
    row's CTA holds ``pack`` rows; the halving lengths ``lengths[0..k]``
    and steps ``h[0..k-1]``."""

    rows: int
    length: int
    t: int
    k: int
    lengths: tuple
    h: tuple
    chunks: int
    width: int
    pack: int

    @property
    def nt(self) -> int:
        return self.lengths[self.t]

    @property
    def nk(self) -> int:
        return self.lengths[self.k]

    @property
    def j(self) -> int:
        """The levels a CTA joins in shared memory."""
        return self.k - self.t

    def odd(self) -> int:
        """Bit i set when the length of level i is odd (i < k)."""
        return sum(1 << i for i in range(self.k) if self.lengths[i] % 2)

    def ranges(self) -> list:
        """Each CTA's range [a, b) of a row's level-k positions."""
        return [(a, min(a + self.width, self.nk))
                for a in range(0, self.nk, self.width)]


def _lengths(length: int) -> list:
    out = [length]
    while out[-1] > 1:
        out.append((out[-1] + 1) // 2)
    return out


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _quads(length: int, h: tuple) -> bool:
    """Whether a row and its unrolled steps come in whole float4s."""
    return length % SUM_VEC == 0 and all(s % SUM_VEC == 0 for s in h)


@functools.lru_cache(maxsize=None)
def sum_plan(rows: int, length: int) -> SumPlan:
    """The launch of ``rows`` row sums of ``length``. A thread walks
    ``THREAD_LEVELS`` levels (fewer on a short row). A row is cut into
    CTAs of one float4 group a thread when the rows do not fill the card
    (``ROWS_ALONE``), of ``SUM_GROUPS`` when they do (one CTA for a row
    of fewer): few long rows then spread over the card, many rows keep
    one CTA a row. Each CTA of a cut row owns a range of level k, the
    deepest level that leaves ``MIN_WIDTH`` positions a CTA, and the
    row's last CTA folds level k; a row of one CTA folds level t, and
    short rows that fill the card several times over pack as many to a
    CTA as give its threads 4 positions each."""
    if length < 1:
        raise ValueError("tree_sum needs a non-empty last dimension")
    if length >= 2**31:
        raise ValueError(f"tree_sum takes rows shorter than 2^31; got "
                         f"{length}")
    lengths = _lengths(length)
    t = min(THREAD_LEVELS, len(lengths) - 1)
    nt = lengths[t]
    groups = SUM_GROUPS if rows >= ROWS_ALONE else 1
    # at most SMEM_N / (2 * MIN_WIDTH) CTAs a row: level k then fits
    chunks = min(max(1, nt // (SUM_THREADS * SUM_VEC * groups)),
                 SMEM_N // (2 * MIN_WIDTH))
    k = t if chunks == 1 else max(i for i in range(t, len(lengths))
                                  if lengths[i] >= chunks * MIN_WIDTH)
    h = tuple(n // 2 for n in lengths[:k])
    quantum = SUM_VEC if _quads(length, h) else 1
    nk = lengths[k]
    width = _ceil(_ceil(nk, chunks), quantum) * quantum
    if (width << (k - t)) > SMEM_N or nk > SMEM_N:
        raise ValueError(f"a row of {length} is longer than one launch "
                         "of tree_sum folds")
    pack = 1 if chunks > 1 else max(
        1, min(rows // ROWS_ALONE, SUM_THREADS * SUM_VEC // nt))
    return SumPlan(rows, length, t, k, tuple(lengths[:k + 1]), h,
                   _ceil(nk, width), width, pack)


def vector_path(plan: SumPlan, ptr: int) -> bool:
    """Whether the launch loads float4s: the row length and every step
    ``h`` are multiples of 4 (so the row is at least 16 long and a thread
    walks ``THREAD_LEVELS``), so is each CTA's width, and the data starts
    on 16 bytes."""
    return (_quads(plan.length, plan.h) and plan.width % SUM_VEC == 0
            and plan.t == THREAD_LEVELS and ptr % (4 * SUM_VEC) == 0)


def sum_smem(plan: SumPlan) -> int:
    """The shared-memory bytes of the launch: a CTA's segments of level
    t, or its packed rows' level k, which it folds."""
    return 4 * max(plan.width << plan.j, plan.pack * plan.nk)


class SumArgs(ctypes.Structure):
    """Mirror of ``struct SumPlan`` in sum_kernels.cu."""

    _fields_ = ([("rows", ctypes.c_int64)]
                + [(f, ctypes.c_int32)
                   for f in ("length", "nt", "nk", "width", "chunks",
                             "pack", "t", "j", "odd", "plus_zero")]
                + [("h", ctypes.c_int32 * MAX_LEVELS)])


def sum_args(plan: SumPlan, plus_zero: bool) -> SumArgs:
    return SumArgs(rows=plan.rows, length=plan.length, nt=plan.nt,
                   nk=plan.nk, width=plan.width, chunks=plan.chunks,
                   pack=plan.pack, t=plan.t, j=plan.j, odd=plan.odd(),
                   plus_zero=int(plus_zero),
                   h=(ctypes.c_int32 * MAX_LEVELS)(*plan.h))


@functools.lru_cache(maxsize=None)
def _sum_lib() -> ctypes.CDLL:
    lib = build.load(SUM_SOURCE)
    lib.sum_kernels_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    lib.sum_kernels_layout.restype = None
    got = [ctypes.c_int() for _ in range(4)]
    lib.sum_kernels_layout(*(ctypes.byref(v) for v in got))
    want = (MAX_LEVELS, THREAD_LEVELS, SMEM_N, SUM_THREADS)
    if tuple(v.value for v in got) != want:
        raise RuntimeError(
            f"sum_kernels.cu's (levels, thread levels, shared positions, "
            f"threads) are {tuple(v.value for v in got)}; fused maps "
            f"{want}")
    lib.launch_tree_sum.argtypes = [ctypes.c_void_p, SumArgs, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.launch_tree_sum.restype = ctypes.c_int
    lib.sum_kernels_error_string.argtypes = [ctypes.c_int]
    lib.sum_kernels_error_string.restype = ctypes.c_char_p
    return lib


def tree_sum(x: torch.Tensor, plus_zero: bool = False) -> torch.Tensor:
    """``lanes.tree_sum`` of a CUDA f32 tensor over its last dimension
    (plus +0.0 when ``plus_zero``: ``lanes._block_partials``), in the one
    launch of ``sum_plan``; raises on a non-f32 tensor or a refused or
    failed launch."""
    if x.device.type != "cuda":
        raise ValueError("fused.tree_sum launches on CUDA tensors; the "
                         "CPU runs lanes' plain version")
    if x.dtype != torch.float32:
        raise ValueError(f"tree_sum sums f32 rows; got {x.dtype}")
    if x.dim() == 0:
        raise ValueError("tree_sum needs a last dimension")
    lead = tuple(x.shape[:-1])
    rows = math.prod(lead)
    out = torch.empty(lead, dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    src = x.contiguous()
    plan = sum_plan(rows, x.shape[-1])
    scratch = arrivals = None
    if plan.chunks > 1:
        scratch = torch.empty((rows, plan.nk), dtype=torch.float32,
                              device=x.device)
        arrivals = torch.zeros(rows, dtype=torch.int32, device=x.device)
    lib = _sum_lib()
    vec = SUM_VEC if vector_path(plan, src.data_ptr()) else 1
    _check_launch(lib.launch_tree_sum(
        src.data_ptr(), sum_args(plan, plus_zero), vec, sum_smem(plan),
        out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(), _stream(x)),
        "tree_sum", lib.sum_kernels_error_string)
    LAUNCHES["tree_sum"] += 1
    _observe((x,), (out,))
    return out
