"""The Vivaldi coordinate round as three kernels: wrappers and arguments.

A period's coordinate round in plain PyTorch (``coords.probe_plain``,
``coords.vivaldi_step_plain`` with ``coords.round_drift``,
``coords.quality_plain``) gathers the probe pairs' rows with advanced
indexing, which ATen serves one thread block a row, and spends ~150
elementwise launches around the gathers. ``csrc/coord_kernels.cu``
holds the three launches that take their place, each reading an agent's
own rows coalesced and its pair's rows once, in place:

* ``coord_probe`` (``probe``) — the observed round trips and, with
  RTT-aware deadlines, ``timely`` and ``late_in``;
* ``vivaldi_relax`` (``relax``) — ``vivaldi_step``'s full form, the
  gate ``ack & up[pair_j]`` and each agent's moved distance, into a new
  state (out of place: the update is Jacobi);
* ``coord_quality`` (``quality``) — the quality row's per-agent
  relative error.

The kernels' note in the source says which sum order they take. A grid
of G points (coordinates ``[G, N, ...]``) is one launch: the pairs, the
draws and the latency map are shared, each point has its own rows, and
a swept deadline constant is a ``[G, 1]`` f32 leaf read by pointer.

* Routing (``coords.probe``, ``coords.relax``, ``coords.coord_metrics``,
  ``coords.vivaldi_step``'s full form): CUDA tensors launch here, CPU
  tensors take the plain versions. The wrappers take CUDA tensors only
  and raise on anything else, as on a failed build or launch.
* Counting: each launch adds one to ``LAUNCHES[<kernel>]``, which
  ``graphs.GraphCache`` counts per replay, and reports its tensors to
  ``fused.OBSERVERS``.
* Capture: a launch reads every input by pointer on the current stream,
  allocates its outputs with ``torch.empty`` and reads nothing on the
  host, so a CUDA graph holds it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from consul_tpu_torch.sim import fused

SOURCE = "coord_kernels"
#: the coordinate dimensions and the adjustment ring the kernels take
#: (``coords.DIMENSION``, ``coords.ADJUSTMENT_WINDOW``), the latency
#: map's dimensions at most, and the threads a block
DIMS = 8
WINDOW = 20
MAX_TOPO_DIMS = 8
THREADS = 256
NAMES = ("coord_probe", "vivaldi_relax", "coord_quality")

LAUNCHES: collections.Counter = collections.Counter()

_F32 = torch.float32
_I32 = torch.int32


def reset_launches() -> None:
    LAUNCHES.clear()


def launches() -> int:
    """Every coordinate launch counted so far."""
    return sum(LAUNCHES.values())


class ProbeArgs(ctypes.Structure):
    """Mirror of ``struct ProbeArgs`` in coord_kernels.cu."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "pos", "theight", "sigma", "pair_j", "z", "q_in", "vec", "height",
        "adjustment", "lh", "mult_g", "interval_g", "timeout_g", "rtt_obs",
        "timely", "late_in")] + [
        ("n", ctypes.c_longlong), ("points", ctypes.c_int),
        ("topo_dims", ctypes.c_int)] + [
        (f, ctypes.c_float) for f in ("mult", "interval", "timeout")]


class RelaxArgs(ctypes.Structure):
    """Mirror of ``struct RelaxArgs`` in coord_kernels.cu."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "vec", "error", "height", "samples", "adj_idx", "pair_j", "rtt",
        "u_dir", "ack", "up", "o_vec", "o_error", "o_height",
        "o_adjustment", "o_samples", "o_adj_idx", "relaxed", "moved")] + [
        ("n", ctypes.c_longlong), ("points", ctypes.c_int)]


class QualityArgs(ctypes.Structure):
    """Mirror of ``struct QualityArgs`` in coord_kernels.cu."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "pos", "theight", "pair_j", "vec", "height", "adjustment",
        "rel")] + [
        ("n", ctypes.c_longlong), ("points", ctypes.c_int),
        ("topo_dims", ctypes.c_int)]


STRUCTS = (ProbeArgs, RelaxArgs, QualityArgs)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from consul_tpu_torch.utils import build

    lib = build.load(SOURCE)
    got = [ctypes.c_int() for _ in range(7)]
    lib.coord_kernels_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 7
    lib.coord_kernels_layout.restype = None
    lib.coord_kernels_layout(*(ctypes.byref(v) for v in got))
    want = (DIMS, WINDOW, MAX_TOPO_DIMS, THREADS,
            *(ctypes.sizeof(s) for s in STRUCTS))
    if tuple(v.value for v in got) != want:
        raise RuntimeError(
            f"coord_kernels.cu's (dims, window, topology dims, threads, "
            f"struct bytes) are {tuple(v.value for v in got)}; "
            f"coord_kernel maps {want}")
    for name, struct in zip(NAMES, STRUCTS):
        fn = getattr(lib, f"launch_{name}")
        fn.argtypes = [struct, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.coord_kernels_error_string.argtypes = [ctypes.c_int]
    lib.coord_kernels_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, args, like: torch.Tensor, ins, outs) -> None:
    lib = _lib()
    fused._check_launch(getattr(lib, f"launch_{name}")(args,
                                                        fused._stream(like)),
                        name, lib.coord_kernels_error_string)
    LAUNCHES[name] += 1
    fused._observe(ins, outs)


# ------------------------------------------------------------ arguments


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _want(x: torch.Tensor, name: str, dtype, shape: tuple, dev,
          align: int = 1) -> None:
    if not isinstance(x, torch.Tensor) or x.device != dev \
            or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.data_ptr() % align:
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}"
               + ("" if x.is_contiguous() else ", not contiguous")
               if isinstance(x, torch.Tensor) else type(x).__name__)
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {dev}"
            + (f", {align}-byte aligned" if align > 1 else "")
            + f"; got {got}")


def _on_card(x: torch.Tensor, what: str) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(
            f"{what} runs on CUDA tensors; {x.device} tensors take the "
            "plain version in sim/coords.py")
    return x.device


def _lead(coords) -> tuple:
    """The grid's leading shape of ``coords`` (``()`` for one run)."""
    return tuple(coords.vec.shape[:-2])


def _check_coords(coords, n: int, dev, fields: Sequence[str]) -> tuple:
    lead = _lead(coords)
    shapes = {"vec": lead + (n, DIMS), "error": lead + (n,),
              "height": lead + (n,), "adjustment": lead + (n,),
              "adj_samples": lead + (n, WINDOW), "adj_idx": lead + (n,)}
    for f in fields:
        _want(getattr(coords, f), f"coords.{f}",
              _I32 if f == "adj_idx" else _F32, shapes[f], dev,
              16 if f in ("vec", "adj_samples") else 1)
    return lead


def _check_topo(topo, n: int, dev) -> int:
    dims = topo.pos.shape[-1] if topo.pos.dim() == 2 else 0
    if not 1 <= dims <= MAX_TOPO_DIMS:
        raise ValueError(f"the latency map takes 1 to {MAX_TOPO_DIMS} "
                         f"dimensions; topo.pos is {tuple(topo.pos.shape)}")
    _want(topo.pos, "topo.pos", _F32, (n, dims), dev)
    _want(topo.height, "topo.height", _F32, (n,), dev)
    _want(topo.jitter_sigma, "topo.jitter_sigma", _F32, (), dev)
    return dims


def _constant(v, points: int, dev, name: str):
    """A deadline constant: a float as itself, a swept leaf as a pointer
    to its ``points`` f32 values."""
    if not isinstance(v, torch.Tensor):
        return float(v), None
    flat = v.reshape(-1)
    _want(flat, name, _F32, (points,), dev)
    return 0.0, flat


def probe_args(coords, topo, pair_j: torch.Tensor, z: torch.Tensor,
               out: tuple, q_in: Optional[torch.Tensor] = None,
               lh: Optional[torch.Tensor] = None,
               deadline: Optional[tuple] = None) -> tuple:
    """``coord_probe``'s ``ProbeArgs`` and the tensors it reads: the
    pointers of the latency map, the pair, the jitter normal, the
    outputs ``out`` = (rtt_obs, timely, late_in) and, with deadlines
    (``q_in``), the coordinates, the local health and the deadline
    constants (``deadline`` = (mult, interval, timeout), floats or
    swept leaves); no check of devices."""
    n = pair_j.shape[-1]
    lead = _lead(coords) if coords is not None else ()
    points = math.prod(lead)
    ins = [topo.pos, topo.height, topo.jitter_sigma, pair_j, z]
    consts, ptrs = [0.0] * 3, [None] * 3
    if q_in is not None:
        for k, (v, name) in enumerate(zip(deadline, (
                "the deadline multiplier", "the probe interval",
                "the probe timeout"))):
            consts[k], ptrs[k] = _constant(v, points, pair_j.device, name)
        ins += [q_in, coords.vec, coords.height, coords.adjustment, lh] \
            + [x for x in ptrs if x is not None]
    rtt_obs, timely, late_in = out
    args = ProbeArgs(
        pos=_ptr(topo.pos), theight=_ptr(topo.height),
        sigma=_ptr(topo.jitter_sigma), pair_j=_ptr(pair_j), z=_ptr(z),
        q_in=_ptr(q_in),
        vec=_ptr(coords.vec) if q_in is not None else None,
        height=_ptr(coords.height) if q_in is not None else None,
        adjustment=_ptr(coords.adjustment) if q_in is not None else None,
        lh=_ptr(lh), mult_g=_ptr(ptrs[0]), interval_g=_ptr(ptrs[1]),
        timeout_g=_ptr(ptrs[2]), rtt_obs=_ptr(rtt_obs),
        timely=_ptr(timely), late_in=_ptr(late_in), n=n,
        points=points if q_in is not None else 1,
        topo_dims=topo.pos.shape[-1], mult=consts[0], interval=consts[1],
        timeout=consts[2])
    return args, ins


def relax_args(coords, pair_j: torch.Tensor, rtt: torch.Tensor,
               u_dir: torch.Tensor, ack: Optional[torch.Tensor],
               up: Optional[torch.Tensor], new, relaxed: torch.Tensor,
               moved: torch.Tensor) -> tuple:
    """``vivaldi_relax``'s ``RelaxArgs`` and the tensors it reads: the
    coordinates in, the pairs, round trips and direction draws, the
    gates (null: every agent acked / no target gate), the new state
    ``new`` and the gate and moved rows out."""
    n = pair_j.shape[-1]
    ins = [coords.vec, coords.error, coords.height, coords.adj_samples,
           coords.adj_idx, pair_j, rtt, u_dir] \
        + [x for x in (ack, up) if x is not None]
    args = RelaxArgs(
        vec=_ptr(coords.vec), error=_ptr(coords.error),
        height=_ptr(coords.height), samples=_ptr(coords.adj_samples),
        adj_idx=_ptr(coords.adj_idx), pair_j=_ptr(pair_j), rtt=_ptr(rtt),
        u_dir=_ptr(u_dir), ack=_ptr(ack), up=_ptr(up),
        o_vec=_ptr(new.vec), o_error=_ptr(new.error),
        o_height=_ptr(new.height), o_adjustment=_ptr(new.adjustment),
        o_samples=_ptr(new.adj_samples), o_adj_idx=_ptr(new.adj_idx),
        relaxed=_ptr(relaxed), moved=_ptr(moved), n=n,
        points=math.prod(_lead(coords)))
    return args, ins


def quality_args(coords, topo, pair_j: torch.Tensor,
                 rel: torch.Tensor) -> tuple:
    """``coord_quality``'s ``QualityArgs`` and the tensors it reads."""
    ins = [topo.pos, topo.height, pair_j, coords.vec, coords.height,
           coords.adjustment]
    args = QualityArgs(
        pos=_ptr(topo.pos), theight=_ptr(topo.height), pair_j=_ptr(pair_j),
        vec=_ptr(coords.vec), height=_ptr(coords.height),
        adjustment=_ptr(coords.adjustment), rel=_ptr(rel),
        n=pair_j.shape[-1], points=math.prod(_lead(coords)),
        topo_dims=topo.pos.shape[-1])
    return args, ins


# ------------------------------------------------------------- launches


def probe(coords, topo, pair_j: torch.Tensor, z: torch.Tensor,
          q_in: Optional[torch.Tensor] = None,
          lh: Optional[torch.Tensor] = None,
          deadline: Optional[tuple] = None) -> tuple:
    """One ``coord_probe`` launch: (rtt_obs ``[N]``, timely, late_in),
    the last two ``[..., N]`` with deadlines (``q_in``, ``lh``,
    ``deadline``), else None. ``coords`` may be None without
    deadlines."""
    dev = _on_card(pair_j, "coord_probe")
    n = pair_j.shape[-1]
    _want(pair_j, "pair_j", _I32, (n,), dev)
    _want(z, "the jitter normal", _F32, (n,), dev)
    _check_topo(topo, n, dev)
    rtt_obs = torch.empty(n, dtype=_F32, device=dev)
    timely = late_in = None
    if q_in is not None:
        if lh is None or deadline is None or coords is None:
            raise ValueError("deadlines need the coordinates, the local "
                             "health and the deadline constants")
        lead = _check_coords(coords, n, dev, ("vec", "height",
                                              "adjustment"))
        _want(q_in, "q_in", _I32, (n,), dev)
        _want(lh, "the local health", _I32, lead + (n,), dev)
        timely = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
        late_in = torch.empty(lead + (n,), dtype=_F32, device=dev)
    args, ins = probe_args(coords, topo, pair_j, z,
                           (rtt_obs, timely, late_in), q_in, lh, deadline)
    _launch("coord_probe", args, pair_j, ins,
            [x for x in (rtt_obs, timely, late_in) if x is not None])
    return rtt_obs, timely, late_in


def relax(coords, pair_j: torch.Tensor, rtt: torch.Tensor,
          u_dir: torch.Tensor, ack: Optional[torch.Tensor] = None,
          up: Optional[torch.Tensor] = None) -> tuple:
    """One ``vivaldi_relax`` launch: (the new state, of ``coords``' type;
    relaxed ``[..., N]`` bool, ``ack & up[..., pair_j]``; moved
    ``[..., N]`` f32, each agent's distance moved). ``u_dir`` is the
    step's ``[N * 8]`` direction uniforms; ``ack`` None relaxes every
    agent with a positive round trip, ``up`` None gates no target."""
    dev = _on_card(coords.vec, "vivaldi_relax")
    n = pair_j.shape[-1]
    lead = _check_coords(coords, n, dev, coords._fields)
    _want(pair_j, "pair_j", _I32, (n,), dev)
    _want(rtt, "the round trips", _F32, (n,), dev)
    _want(u_dir, "the direction draws", _F32, (n * DIMS,), dev, 16)
    for x, name in ((ack, "ack"), (up, "up")):
        if x is not None:
            _want(x, name, torch.bool, lead + (n,), dev)
    new = type(coords)(*(torch.empty_like(x) for x in coords))
    relaxed = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    moved = torch.empty(lead + (n,), dtype=_F32, device=dev)
    args, ins = relax_args(coords, pair_j, rtt, u_dir, ack, up, new,
                           relaxed, moved)
    _launch("vivaldi_relax", args, pair_j, ins, [*new, relaxed, moved])
    return new, relaxed, moved


def quality(coords, topo, pair_j: torch.Tensor) -> torch.Tensor:
    """One ``coord_quality`` launch: ``[..., N]`` f32, each agent's
    relative RTT-estimate error to its probe target on ``coords``."""
    dev = _on_card(coords.vec, "coord_quality")
    n = pair_j.shape[-1]
    lead = _check_coords(coords, n, dev, ("vec", "height", "adjustment"))
    _want(pair_j, "pair_j", _I32, (n,), dev)
    _check_topo(topo, n, dev)
    rel = torch.empty(lead + (n,), dtype=_F32, device=dev)
    args, ins = quality_args(coords, topo, pair_j, rel)
    _launch("coord_quality", args, pair_j, ins, [rel])
    return rel
