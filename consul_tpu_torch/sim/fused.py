"""The fused draw and sum kernels' wrappers, launch counts and switches.

The JAX package leaves its two commonest primitives to XLA, which
compiles each ``jax.random`` draw into one fused elementwise kernel and
each ``jnp.sum`` into one reduce. The port's plain versions spell them
out as PyTorch ops: a threefry draw is ~140 elementwise launches
(``prng._threefry_i32``), a fixed-order sum one or two a halving step
(``lanes.tree_sum``). Two CUDA sources take their place on the card:

* ``csrc/prng_kernels.cu`` — ``threefry``: one launch a draw, in the
  modes ``words`` (``threefry2x32``, ``fold_in``, ``split``,
  ``round_keys``), ``xor`` (``bits``, and ``round_seeds`` as int32),
  ``uniform`` (with its scaling) and ``u01_global``. ``prng`` builds
  each draw's ``Draw`` and routes it here.
* ``csrc/sum_kernels.cu`` — ``tree_sum``: ``lanes.tree_sum``'s order of
  additions in one or two launches (``sum_plan``).

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

#: the draw kernel's output modes (csrc/prng_kernels.cu ``Mode``); a
#: ``seeds`` draw is the ``xor`` mode written as int32 (its count is
#: ``threefry/xor``)
MODES = {"words": 0, "xor": 1, "seeds": 2, "uniform": 3, "u01_global": 4}
#: the uniform's scaling (``Scale``): none for [0, 1), a power-of-two
#: width in f32, any other width through f64
SCALES = {"unit": 0, "pow2": 1, "f64": 2}
MAX_DIMS = 6

#: the sum kernels' limits (csrc/sum_kernels.cu; ``_sum_lib`` checks
#: them): levels a thread may unroll, the block stage's longest level
MAX_LEVELS = 24
SMEM_N = 1024
#: rows that fill the card with one block each (two on each of the
#: H100's 132 SMs): fewer rows of more than ``SMEM_N`` take two launches
ROWS_ALONE = 264
#: the longest level the second launch's blocks start from
SPLIT_N = 16384

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
    None), to word 1 (and ``(base + j) >> 32`` to word 0 when
    ``gen_hi``); ``mode`` names the output; ``lo``, ``width`` and
    ``scale`` the uniform's scaling; ``raw`` the operands as given (the
    bytes a launch reads)."""

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


def draw(mode: str, k0: torch.Tensor, k1: torch.Tensor, x0=None, x1=None,
         gen: Optional[int] = None, base: Optional[torch.Tensor] = None,
         gen_hi: bool = False, minval: float = 0.0,
         maxval: float = 1.0) -> Draw:
    """The ``Draw`` of ``mode`` on these operands: the index space is
    their broadcast shape, with ``gen`` (the generated counter's count)
    as its last dimension when given."""
    ops = [t for t in (k0, k1, x0, x1) if t is not None]
    shape = torch.broadcast_shapes(*(t.shape for t in ops),
                                   *(() if gen is None else ((gen,),)))
    if len(shape) > MAX_DIMS:
        raise ValueError(f"a draw spans at most {MAX_DIMS} dimensions; "
                         f"got {tuple(shape)}")
    lo, width, scale = uniform_scale(minval, maxval)

    def ex(t):
        return None if t is None else t.expand(shape)

    return Draw(mode, tuple(shape), ex(k0), ex(k1), ex(x0), ex(x1),
                gen is not None, base, gen_hi, lo, width, scale,
                tuple(t for t in ops + [base] if t is not None))


class DrawArgs(ctypes.Structure):
    """Mirror of ``struct DrawArgs`` in prng_kernels.cu."""

    _fields_ = ([(f, ctypes.c_void_p)
                 for f in ("k0", "k1", "x0", "x1", "base", "out")]
                + [(f, ctypes.c_int)
                   for f in ("ndim", "gen", "gen_hi", "scale")]
                + [("lo", ctypes.c_float), ("width", ctypes.c_float)]
                + [(f, ctypes.c_int64 * MAX_DIMS)
                   for f in ("size", "sk0", "sk1", "sx0", "sx1")])


@functools.lru_cache(maxsize=None)
def _draw_lib() -> ctypes.CDLL:
    lib = build.load(DRAW_SOURCE)
    lib.prng_kernels_max_dims.argtypes = []
    lib.prng_kernels_max_dims.restype = ctypes.c_int
    if lib.prng_kernels_max_dims() != MAX_DIMS:
        raise RuntimeError("prng_kernels.cu and fused.MAX_DIMS disagree")
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
        LAUNCHES["threefry/xor" if d.mode == "seeds"
                 else f"threefry/{d.mode}"] += 1
        _observe(d.raw, (out,))
    return out


# ----------------------------------------------------------------- sums


class SumStage(ctypes.Structure):
    """Mirror of ``struct SumStage`` in sum_kernels.cu."""

    _fields_ = [("rows", ctypes.c_int64), ("length", ctypes.c_int64),
                ("nk", ctypes.c_int64), ("odd", ctypes.c_int64),
                ("k", ctypes.c_int), ("plus_zero", ctypes.c_int),
                ("delta", ctypes.c_int64 * MAX_LEVELS)]


class Stage(NamedTuple):
    """One launch of a row sum: ``kernel`` ``level`` (level ``k`` of
    every row into a scratch) or ``rows`` (level ``k`` into shared
    memory, then the rest of the steps), on rows of ``length``; the
    halving lengths ``lengths[0..k]`` and steps ``h[0..k-1]``."""

    kernel: str
    length: int
    k: int
    lengths: tuple
    h: tuple

    @property
    def nk(self) -> int:
        return self.lengths[self.k]

    def delta(self) -> tuple:
        """The leaf offset's step after a leaf with t trailing ones:
        h_t - sum of h_b for b < t."""
        return tuple(self.h[t] - sum(self.h[:t]) for t in range(self.k))

    def odd(self) -> int:
        """Bit j set when the length of level j is odd (j < k)."""
        return sum(1 << j for j in range(self.k) if self.lengths[j] % 2)


def _lengths(length: int) -> list:
    out = [length]
    while out[-1] > 1:
        out.append((out[-1] + 1) // 2)
    return out


def _stage(kernel: str, length: int, longest: int) -> Stage:
    """The stage that unrolls the fewest levels leaving at most
    ``longest`` positions."""
    lengths = _lengths(length)
    k = next(i for i, n in enumerate(lengths) if n <= longest)
    return Stage(kernel, length, k, tuple(lengths[:k + 1]),
                 tuple(n // 2 for n in lengths[:k]))


@functools.lru_cache(maxsize=None)
def sum_plan(rows: int, length: int) -> tuple:
    """The launches of ``rows`` row sums of ``length``: one ``rows``
    launch when the rows fill the card or are at most ``SPLIT_N`` long;
    else a ``level`` launch to at most ``SPLIT_N`` positions a row over
    the whole card, then a ``rows`` launch on those."""
    if length < 1:
        raise ValueError("tree_sum needs a non-empty last dimension")
    if length <= SPLIT_N or rows >= ROWS_ALONE:
        return (_stage("rows", length, SMEM_N),)
    first = _stage("level", length, SPLIT_N)
    return first, _stage("rows", first.nk, SMEM_N)


@functools.lru_cache(maxsize=None)
def _sum_lib() -> ctypes.CDLL:
    lib = build.load(SUM_SOURCE)
    lib.sum_kernels_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.sum_kernels_layout.restype = None
    levels, smem = ctypes.c_int(), ctypes.c_int()
    lib.sum_kernels_layout(ctypes.byref(levels), ctypes.byref(smem))
    if (levels.value, smem.value) != (MAX_LEVELS, SMEM_N):
        raise RuntimeError(
            f"sum_kernels.cu unrolls at most {levels.value} levels into "
            f"{smem.value} positions; fused maps {MAX_LEVELS} and {SMEM_N}")
    for fn in (lib.launch_sum_level, lib.launch_sum_rows):
        fn.argtypes = [ctypes.c_void_p, SumStage, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.sum_kernels_error_string.argtypes = [ctypes.c_int]
    lib.sum_kernels_error_string.restype = ctypes.c_char_p
    return lib


def _stage_args(st: Stage, rows: int, plus_zero: bool) -> SumStage:
    if st.k > MAX_LEVELS - 1:
        raise ValueError(f"a row of {st.length} would unroll {st.k} "
                         f"levels; the kernel takes {MAX_LEVELS - 1}")
    delta = st.delta() + (0,) * (MAX_LEVELS - st.k)
    return SumStage(rows=rows, length=st.length, nk=st.nk, odd=st.odd(),
                    k=st.k, plus_zero=int(plus_zero),
                    delta=(ctypes.c_int64 * MAX_LEVELS)(*delta))


def tree_sum(x: torch.Tensor, plus_zero: bool = False) -> torch.Tensor:
    """``lanes.tree_sum`` of a CUDA f32 tensor over its last dimension
    (plus +0.0 when ``plus_zero``: ``lanes._block_partials``), in the
    launches of ``sum_plan``; raises on a non-f32 tensor or a refused or
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
    lib = _sum_lib()
    stream = _stream(x)
    plan = sum_plan(rows, x.shape[-1])
    for st in plan:
        last = st.kernel == "rows"
        args = _stage_args(st, rows, plus_zero and last)
        if last:
            dst = out
            rc = lib.launch_sum_rows(src.data_ptr(), args, dst.data_ptr(),
                                     stream)
        else:
            dst = torch.empty((rows, st.nk), dtype=torch.float32,
                              device=x.device)
            rc = lib.launch_sum_level(src.data_ptr(), args, dst.data_ptr(),
                                      stream)
        _check_launch(rc, f"tree_sum/{st.kernel}",
                      lib.sum_kernels_error_string)
        LAUNCHES["tree_sum"] += 1
        src = dst
    _observe((x,), (out,))
    return out
