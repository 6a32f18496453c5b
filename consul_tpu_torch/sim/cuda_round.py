"""The round kernels' wrappers, their plain versions, and the runner.

Counterpart of the JAX package's ``consul_tpu/sim/pallas_round.py``.
Two CUDA kernels (``csrc/round_kernels.cu``) carry the hot loop:

* ``round_kernel`` — one protocol period per launch; replaces the TPU
  kernel ``_round_kernel`` (pallas_round.py:439) in all four of its
  variants: stable and full (honest), ``fault`` (a fault plan's frame:
  8 per-node lanes and ``mid``) and ``byz`` (4 more byzantine lanes);
  a frame's lanes are the round's, or the plan's phase rows, which the
  kernel reads at the device phase (``faults.InPlaceFrame``).
  Per round it reads 15 B/node of state and writes 13 B/node in the
  stable variant, 15 B/node in the others; the fault variants read 29 /
  42 B/node of frame besides (29,360,128 B / 31,457,280 B / 61,865,984 B
  / 75,497,472 B at 1,048,576 nodes).
* ``mega_kernel`` — R periods per launch on frozen scalars, each node
  held in registers across the rounds; replaces ``_mega_kernel``
  (pallas_round.py:526). It moves the bytes of one round per call.

Both are held back by instructions per node-round rather than bytes;
the source's note says how they spend fewer (four draws per Philox call,
the round's uniform terms tabulated once per block, consecutive nodes
per thread with wide loads).

Beside each kernel sits its plain PyTorch version (``block_round_ref``,
``mega_round_ref``): the same protocol body as ``round.round_core``
drawing the same Philox words the kernel draws. A wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it checks
device, dtype, shape and contiguity, launches the kernel, counts the
launch in ``LAUNCHES`` and raises if the launch failed — there is no
fallback.

The runner (``make_run_rounds_cuda``) also records what the JAX kernel
runner records — flight rows, black-box rings and Vivaldi coordinates —
from the kernels' output tensors between launches, as the JAX runner
builds them outside its kernel. A flight row on the card is one launch
of a third kernel, ``flight_row`` (``record_flight_row``: the recorded
round's fusion in the JAX runner; on the CPU ``flight.flight_row``);
the rings are PyTorch ops, and the coordinate round on the card is a
``coord_probe`` and a ``vivaldi_relax`` launch (``sim/coord_kernel.py``;
``coord_round``) and a ``coord_quality`` launch a recorded round.

Both kernels write a ``[partials_rows(rows), 18]`` table of per-block
partial sums (8 population scalars, then the 10 SimStats counters): a
grid of at most ``GRID_BLOCKS`` blocks walks tiles of ``TILE`` nodes, so
node i lands in row ``(i // TILE) % partials_rows(rows)``
(``partials_row_of``). The runner folds the table into the next call's
stale scalars in PyTorch, as the JAX runner folds the TPU kernel's
partials outside the kernel.

The STABLE variant (configs with no churn, no slow model and no stats,
``SimParams.age_mutable`` false) never writes down_age: a dead row's
age stays frozen at its entry value, as the TPU kernel's does. A fault
frame forces the full behaviour (churn drawn, down_age written).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import itertools
from typing import Optional, Sequence

import torch

from consul_tpu_torch.faults import (FRAME_ABI, CompiledFaultPlan,
                                     FaultFrame, InPlaceFrame, check_frame,
                                     check_in_place, detection_gate,
                                     frame_pointers, frames_at,
                                     frames_in_place, plan_phases,
                                     scale_plan)
from consul_tpu_torch.sim import blackbox as blackbox_mod
from consul_tpu_torch.sim import coords as coords_mod
from consul_tpu_torch.sim import flight, graphs, prng, topology
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.round import (LAT, N_LANES, N_SCALARS, N_STATS,
                                        SCALAR_FLOORS, _cast_like,
                                        _round_body, _shrink,
                                        _trunc_poisson, clamp_scalars,
                                        init_scalars, pf_arrays)
from consul_tpu_torch.sim.state import (CONF_MAX, STATS_FIELDS, TICK_MAX,
                                        SimState, SimStats, check_packed)
from consul_tpu_torch.utils import build, telemetry

#: the kernels' partials layout (round_kernels.cu; ``_lib`` checks it):
#: nodes per block step, and most blocks (4 on each of the H100's 132
#: SMs); how many threads share a tile is each kernel's own choice
#: (``kernel_layout``)
TILE = 512
GRID_BLOCKS = 528
SOURCE = "round_kernels"
#: most blocks of a ``flight_row`` launch, and so rows of its partials
#: scratch, of FLIGHT_SUMS_BYTES each (``_lib`` checks both)
FLIGHT_BLOCKS = 528
FLIGHT_SUMS_BYTES = 40

#: launches per kernel and variant since the last ``reset_launches()``,
#: and by ``frame/in_place`` / ``frame/gathered`` the fault launches by
#: how their frame reached the kernel (``round_kernel``); incremented
#: only where a kernel is launched (never by a plain version)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def variant(p: SimParams, fx=None) -> str:
    """'byz' / 'fault' for a byzantine / honest fault frame (a
    ``FaultFrame`` or an ``InPlaceFrame``); else 'full' when a round can
    change down_age, 'stable' when not."""
    if isinstance(fx, InPlaceFrame):
        fx = fx.lanes
    if fx is not None:
        return "fault" if fx.attacked is None else "byz"
    return "full" if p.age_mutable else "stable"


def partials_rows(rows: int) -> int:
    """Rows of the kernels' partials table for ``rows`` nodes: one per
    block of the grid, ``min(GRID_BLOCKS, tiles)``."""
    return max(1, min(GRID_BLOCKS, -(-rows // TILE)))


def partials_row_of(rows: int, device=None) -> torch.Tensor:
    """The partials row of each node: block b walks tiles b, b +
    partials_rows, ...; every node is in exactly one row."""
    node = torch.arange(rows, dtype=torch.int64, device=device)
    return (node // TILE) % partials_rows(rows)


class RoundParams(ctypes.Structure):
    """Mirror of ``struct RoundParams`` in round_kernels.cu."""

    _fields_ = [("rows", ctypes.c_int)] + [
        (f, ctypes.c_float) for f in (
            "n_f", "inv_n", "probe_interval", "fail_p", "leave_p",
            "fail_leave_p", "rejoin_p", "slow_p", "slow_recover_p",
            "slow_factor", "one_minus_slow_factor", "p_direct", "p_relay",
            "p_tcp", "fanout_ticks", "one_minus_loss", "susp_max_s",
            "shrink_r", "shrink_omr", "conf_k_f")] + [
        (f, ctypes.c_int) for f in (
            "awareness_max", "indirect_checks", "corroboration_k",
            "lifeguard", "shrink_on", "patience_on", "churn_on", "slow_on",
            "stats_on", "write_age")]


class FaultArrays(ctypes.Structure):
    """Mirror of ``struct FaultArrays`` in round_kernels.cu: the lanes'
    pointers in ``FRAME_ABI`` order, the device phase (null for a frame
    whose lanes are the round's) and each lane's stride between phases,
    in elements of its dtype (0: the lane is the round's)."""

    _fields_ = [(f, ctypes.c_void_p) for f in FRAME_ABI] + [
        ("phase", ctypes.c_void_p),
        ("stride", ctypes.c_int64 * len(FRAME_ABI))]


def fault_arrays(fx) -> FaultArrays:
    """The kernel's ``FaultArrays`` of a gathered ``FaultFrame`` (no
    phase, every stride 0) or of an ``InPlaceFrame`` (its phase rows,
    its device phase and its strides)."""
    if not isinstance(fx, InPlaceFrame):
        return FaultArrays(**frame_pointers(fx))
    return FaultArrays(
        **frame_pointers(fx.lanes), phase=fx.phase.data_ptr(),
        stride=(ctypes.c_int64 * len(FRAME_ABI))(
            *(fx.strides.get(f, 0) for f in FRAME_ABI)))


class FlightArgs(ctypes.Structure):
    """Mirror of ``struct FlightArgs`` in round_kernels.cu."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "status", "inc", "informed", "age", "lh")] + [
        ("rows", ctypes.c_int), ("phase_host", ctypes.c_float)] + [
        (f, ctypes.c_void_p) for f in (
            "t", "phase", "acc", "acc_lat", "prev", "prev_lat", "coord",
            "row", "partials", "ticket")]


@functools.lru_cache(maxsize=None)
def kernel_params(p: SimParams, rows: int) -> RoundParams:
    """The host-folded constants of ``p`` (f64 folds, cast to f32 once —
    the values the plain version's Python-float operands round to)."""
    return RoundParams(
        rows=rows, n_f=float(p.n), inv_n=1.0 / p.n,
        probe_interval=p.probe_interval, fail_p=p.fail_per_round,
        fail_leave_p=p.fail_per_round + p.leave_per_round,
        rejoin_p=p.rejoin_per_round, slow_p=p.slow_per_round,
        slow_recover_p=p.slow_recover_per_round,
        slow_factor=p.slow_factor,
        one_minus_slow_factor=1.0 - p.slow_factor,
        leave_p=p.leave_per_round,
        p_direct=p.p_direct, p_relay=p.p_relay, p_tcp=p.p_tcp,
        fanout_ticks=p.fanout_ticks, one_minus_loss=p.one_minus_loss,
        susp_max_s=p.suspicion_max_s, shrink_r=p.shrink_r,
        shrink_omr=p.shrink_omr, conf_k_f=float(p.confirmation_k),
        awareness_max=p.awareness_max, indirect_checks=p.indirect_checks,
        corroboration_k=p.corroboration_k,
        lifeguard=int(p.lifeguard),
        shrink_on=int(p.lifeguard
                      and p.suspicion_max_s > p.suspicion_min_s),
        patience_on=int(p.lifeguard and p.enabled("slow_per_round")),
        churn_on=int(p.has_churn), slow_on=int(p.enabled("slow_per_round")),
        stats_on=int(p.collect_stats), write_age=int(p.age_mutable))


#: the kernel variants, by the launch counters' names
VARIANTS = ("round_kernel/stable", "round_kernel/full", "round_kernel/fault",
            "round_kernel/byz", "mega_kernel/stable", "mega_kernel/full")


def kernel_layout() -> dict:
    """Nodes per thread and threads per block of each variant's kernel
    (builds the library)."""
    npt = _lib().nodes_per_thread
    return {v: {"nodes_per_thread": npt[i], "threads_per_block":
                TILE // npt[i]}
            for v, i in zip(VARIANTS, (0, 0, 1, 2, 3, 3))}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    tile, blocks = ctypes.c_int(), ctypes.c_int()
    npt = (ctypes.c_int * 4)()
    lib.round_kernels_layout(ctypes.byref(tile), ctypes.byref(blocks), npt)
    if (tile.value, blocks.value) != (TILE, GRID_BLOCKS):
        raise RuntimeError(
            f"round_kernels.cu walks tiles of {tile.value} nodes on at most "
            f"{blocks.value} blocks; cuda_round maps {TILE} and "
            f"{GRID_BLOCKS}")
    lib.nodes_per_thread = tuple(npt)
    ptrs = [ctypes.c_void_p] * 8
    lib.launch_round_kernel.argtypes = [RoundParams, *ptrs,
                                        ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.launch_round_kernel.restype = ctypes.c_int
    lib.launch_round_kernel_fault.argtypes = [
        RoundParams, *ptrs, FaultArrays, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.launch_round_kernel_fault.restype = ctypes.c_int
    lib.launch_mega_kernel.argtypes = [RoundParams, *ptrs,
                                       ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]
    lib.launch_mega_kernel.restype = ctypes.c_int
    layout = [ctypes.c_int() for _ in range(6)]
    lib.flight_row_layout(*(ctypes.byref(x) for x in layout))
    want = (flight.N_COLS, len(flight.GAUGE_COLUMNS), N_STATS, LAT,
            FLIGHT_BLOCKS, FLIGHT_SUMS_BYTES)
    got = tuple(x.value for x in layout)
    if got != want:
        raise RuntimeError(
            f"round_kernels.cu writes flight rows of (columns, gauges, "
            f"counters, latency index, most blocks, partials row bytes) "
            f"{got}; cuda_round maps {want}")
    lib.launch_flight_row.argtypes = [FlightArgs, ctypes.c_void_p]
    lib.launch_flight_row.restype = ctypes.c_int
    lib.round_kernels_error_string.argtypes = [ctypes.c_int]
    lib.round_kernels_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.round_kernels_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_inputs(arrays: Sequence[torch.Tensor], scalars: torch.Tensor,
                  seeds: torch.Tensor) -> int:
    rows, = check_packed(arrays, "the round kernels")
    dev = arrays[0].device
    if (scalars.device != dev or scalars.dtype != torch.float32
            or tuple(scalars.shape) != (N_SCALARS,)
            or not scalars.is_contiguous()):
        raise ValueError("scalars must be a contiguous f32 "
                         f"[{N_SCALARS}] tensor on {dev}")
    if (seeds.device != dev or seeds.dtype != torch.int32
            or seeds.dim() != 1 or not seeds.is_contiguous()):
        raise ValueError(f"seeds must be a contiguous 1-D int32 tensor "
                         f"on {dev}")
    return rows


def _partials_out(out, rows, dev):
    shape = (partials_rows(rows), N_LANES)
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    if tuple(out.shape) != shape or out.dtype != torch.float32 \
            or out.device != dev or not out.is_contiguous():
        raise ValueError(f"partials buffer must be a contiguous f32 "
                         f"{shape} tensor on {dev}")
    return out


# ------------------------------------------------------- plain versions


def _block_sums(lanes, rows: int) -> torch.Tensor:
    """Per-node contribution lanes -> the [partials_rows, N_LANES] table:
    tile t of TILE nodes adds to row t % partials_rows (nodes past the
    end are zeros)."""
    blocks = partials_rows(rows)
    walks = -(-rows // (TILE * blocks))
    dev = lanes[0].device
    stack = torch.zeros((N_LANES, walks * blocks * TILE),
                        dtype=torch.float32, device=dev)
    for i, lane in enumerate(lanes):
        if lane is not None:
            stack[i, :rows] = lane
    return stack.view(N_LANES, walks, blocks, TILE).sum((1, 3)).t() \
        .contiguous()


def kernel_tables(scal: torch.Tensor, p: SimParams) -> dict:
    """Plain twin of the shared-memory tables the kernels build once per
    block (round_kernels.cu, ``build_tables``), computed by the body's
    own functions on every index: ``shrink`` [CONF_MAX + 1]; ``len0``
    [4], a new suspicion's length for c0 = n_fail - 1; and for the
    honest variants ``pf_fast``/``pf_slow``/``p_ack`` [2, levels] by
    (slow, lh) (one level when patience is off: lh does not enter), and
    ``cdf`` [4, 4], the truncated Poisson's compared CDF terms for the
    rate classes 0 not eligible, 1 down, 2 up and fast, 3 up and
    slow."""
    dev = scal.device
    n_live, n_elig, n_up_elig = scal[0], scal[1], scal[2]
    sbar = scal[3] / n_up_elig
    c = torch.arange(CONF_MAX + 1, dtype=torch.int32, device=dev)
    scale = scal[6] / scal[7] if p.lifeguard \
        else torch.tensor(1.0, dtype=torch.float32, device=dev)
    timeout0 = scale * p.suspicion_max_s * _shrink(c[:4], p)
    len0 = torch.clamp_max(torch.ceil(timeout0 / p.probe_interval),
                           float(TICK_MAX)).to(torch.int32)
    levels = p.awareness_max + 1 \
        if p.lifeguard and p.enabled("slow_per_round") else 1
    lh = torch.arange(levels, dtype=torch.int32, device=dev).expand(2, -1)
    slow = torch.tensor([[False], [True]], device=dev).expand(2, levels)
    _, pf_fast, pf_slow = pf_arrays(slow, lh, sbar, n_live / p.n, p)
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = (n_up_elig / n_elig) * (1.0 - mix)
    up = torch.tensor([False, False, True, True], device=dev)
    slow_c = torch.tensor([False, False, False, True], device=dev)
    eligf = torch.tensor([0.0, 1.0, 1.0, 1.0], device=dev)
    nl = torch.clamp_min(n_live, 1e-9)
    base_fail = torch.where(slow_c, scal[5] / nl, scal[4] / nl)
    p_fail = torch.where(up, base_fail, 1.0)
    if p.corroboration_k > 0:
        p_fail = p_fail * detection_gate(up, None, p)
    lam = n_live / torch.clamp_min(n_elig - 1.0, 1.0) * p_fail * eligf
    cdf: list = []
    _trunc_poisson(torch.zeros_like(lam), lam, cdf=cdf)
    return {"shrink": _shrink(c, p), "len0": len0, "pf_fast": pf_fast,
            "pf_slow": pf_slow, "p_ack": p_ack,
            "cdf": torch.stack(cdf, 1)}


def _one_round(vals, arrays, scalars, seed, p, margin=None, fx=None):
    rows = arrays[0].shape[0]
    outs, lanes = _round_body(vals, scalars, p,
                              prng.philox_u01(seed, rows), margin=margin,
                              fx=fx, kernel_sums=True)
    outs = _cast_like(outs, arrays)
    if not p.age_mutable and fx is None:
        # the stable variant never stores down_age
        outs = outs[:3] + (arrays[3],) + outs[4:]
    return outs, lanes


def block_round_ref(arrays, scalars, seed, p: SimParams,
                    margin: Optional[list] = None,
                    fx: Optional[FaultFrame] = None):
    """Plain version of ``round_kernel``: one period on the packed
    arrays with ``seed``'s Philox draws and the fault view ``fx`` as
    given (no ``fault_gain`` blend: the runner applies it). Returns (new
    arrays, partials [partials_rows, 18]); the inputs are not modified."""
    outs, lanes = _one_round(arrays, arrays, scalars, seed, p, margin, fx)
    return outs, _block_sums(lanes, arrays[0].shape[0])


def mega_round_ref(arrays, scalars, seeds, p: SimParams):
    """Plain version of ``mega_kernel``: ``len(seeds)`` periods on the
    frozen ``scalars``; counter lanes sum over every round, scalar lanes
    are the last round's. Returns (new arrays, partials)."""
    vals = tuple(arrays)
    acc = [None] * N_LANES
    for r in range(seeds.shape[0]):
        vals, lanes = _one_round(vals, arrays, scalars, seeds[r], p)
        for i in range(N_SCALARS, N_LANES):
            if lanes[i] is not None:
                acc[i] = lanes[i] if acc[i] is None else acc[i] + lanes[i]
    acc[:N_SCALARS] = lanes[:N_SCALARS]
    return vals, _block_sums(acc, arrays[0].shape[0])


# -------------------------------------------------------------- wrappers


def round_kernel(arrays, scalars: torch.Tensor, seeds: torch.Tensor,
                 r: int, p: SimParams,
                 out: Optional[torch.Tensor] = None,
                 fx=None) -> torch.Tensor:
    """One period over ``arrays`` (updated IN PLACE) with the stale
    ``scalars``, seed ``seeds[r]`` and, for the fault variants, the
    round's fault view ``fx``: a ``FaultFrame``, or an ``InPlaceFrame``
    whose phase rows the kernel reads in place; returns the
    [partials_rows, 18] partial sums. CPU tensors run
    ``block_round_ref`` (an ``InPlaceFrame`` resolved first). A launch
    with a frame also counts its route, ``frame/in_place`` or
    ``frame/gathered``."""
    rows = _check_inputs(arrays, scalars, seeds)
    if not 0 <= r < seeds.shape[0]:
        raise IndexError(f"seed index {r} outside seeds[{seeds.shape[0]}]")
    dev = arrays[0].device
    in_place = isinstance(fx, InPlaceFrame)
    if in_place:
        check_in_place(fx, dev, rows)
    elif fx is not None:
        check_frame(fx, dev, ((rows,),))
    partials = _partials_out(out, rows, dev)
    if dev.type == "cpu":
        outs, sums = block_round_ref(arrays, scalars, seeds[r], p,
                                     fx=fx.resolve() if in_place else fx)
        for a, o in zip(arrays, outs):
            a.copy_(o)
        partials.copy_(sums)
        return partials
    lib = _lib()
    ptrs = [a.data_ptr() for a in arrays]
    tail = (scalars.data_ptr(), seeds.data_ptr() + 4 * r,
            partials.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if fx is None:
        rc = lib.launch_round_kernel(kernel_params(p, rows), *ptrs, *tail)
    else:
        rc = lib.launch_round_kernel_fault(
            kernel_params(p, rows), *ptrs, fault_arrays(fx),
            int(variant(p, fx) == "byz"), *tail)
    _check_launch(lib, rc, "round_kernel")
    LAUNCHES[f"round_kernel/{variant(p, fx)}"] += 1
    if fx is not None:
        LAUNCHES["frame/in_place" if in_place else "frame/gathered"] += 1
    return partials


def mega_kernel(arrays, scalars: torch.Tensor, seeds: torch.Tensor,
                p: SimParams,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``len(seeds)`` periods over ``arrays`` (updated IN PLACE) on
    frozen ``scalars``; returns the [partials_rows, 18] partial sums (counter
    lanes are call totals, scalar lanes the last round's). CPU tensors
    run ``mega_round_ref``."""
    rows = _check_inputs(arrays, scalars, seeds)
    dev = arrays[0].device
    partials = _partials_out(out, rows, dev)
    if dev.type == "cpu":
        outs, sums = mega_round_ref(arrays, scalars, seeds, p)
        for a, o in zip(arrays, outs):
            a.copy_(o)
        partials.copy_(sums)
        return partials
    lib = _lib()
    rc = lib.launch_mega_kernel(
        kernel_params(p, rows), *[a.data_ptr() for a in arrays],
        scalars.data_ptr(), seeds.data_ptr(), int(seeds.shape[0]),
        partials.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, rc, "mega_kernel")
    LAUNCHES[f"mega_kernel/{variant(p)}"] += 1
    return partials


def flight_scratch(dev) -> tuple:
    """A ``flight_row`` launch's scratch on ``dev``: the blocks' partials
    and the arrival ticket, zero (each launch leaves it zero again), so
    one pair serves every launch on a stream."""
    return (torch.empty((FLIGHT_BLOCKS, FLIGHT_SUMS_BYTES // 8),
                        dtype=torch.int64, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))


def _check_flight(arrays, trace, t, acc, acc_lat, prev, prev_lat, phase,
                  coord_row, scratch) -> None:
    """The card's inputs: the packed lanes, and contiguous trace, clock,
    counters and scratch of their dtypes and sizes on the lanes'
    device."""
    check_packed(arrays, "flight_row")
    dev = arrays[0].device
    if trace.dim() != 2 or trace.shape[1] != flight.N_COLS:
        raise ValueError(f"trace must be [rows, {flight.N_COLS}], not "
                         f"{tuple(trace.shape)}")
    want = {"trace": (trace, torch.float32, None),
            "t": (t, torch.float32, 1),
            "acc": (acc, torch.int32, N_STATS),
            "acc_lat": (acc_lat, torch.float32, 1),
            "prev": (prev, torch.int32, N_STATS),
            "prev_lat": (prev_lat, torch.float32, 1)}
    if isinstance(phase, torch.Tensor):
        want["phase"] = (phase, torch.int64, 1)
    if coord_row is not None:
        want["coord_row"] = (coord_row, torch.float32,
                             len(flight.COORD_COLUMNS))
    if scratch is not None:
        want["partials"] = (scratch[0], torch.int64,
                            FLIGHT_BLOCKS * FLIGHT_SUMS_BYTES // 8)
        want["ticket"] = (scratch[1], torch.int32, 1)
    for name, (x, dt, numel) in want.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous() \
                or (numel is not None and x.numel() != numel):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"{numel or 'any'} elements on {dev}")


def record_flight_row(trace: torch.Tensor, i: int, record_every: int,
                      arrays, t: torch.Tensor, acc: torch.Tensor,
                      acc_lat: torch.Tensor, prev: torch.Tensor,
                      prev_lat: torch.Tensor, phase=-1,
                      coord_row: Optional[torch.Tensor] = None,
                      scratch: Optional[tuple] = None) -> None:
    """The flight row of the post-round packed ``arrays`` into the
    decimation slot of run-local round ``i`` in ``trace`` (as
    ``flight.record_row``), IN PLACE: the clock ``t``, the gauges, the
    phase (a host int, or a ``[1]`` int64 device phase), the
    counters' delta — the int32 ``acc`` and the f32 latency lane
    ``acc_lat`` against their last-recorded snapshot ``prev`` /
    ``prev_lat``, which then moves to them, in place — and ``coord_row``
    (zeros when None). CPU tensors build the row with
    ``flight.flight_row``; CUDA tensors launch ``flight_row``, one
    launch, on ``scratch`` (``flight_scratch``; made for the call when
    None)."""
    dev = arrays[0].device
    if dev.type == "cpu":
        delta = (acc - prev).to(torch.float32)
        delta[LAT] = acc_lat - prev_lat
        flight.record_row(trace, flight.flight_row(
            up=arrays[3] < 0, status=arrays[0], informed=arrays[2],
            local_health=arrays[7], incarnation=arrays[1], t=t,
            stats_delta=delta, phase=phase, coord_row=coord_row),
            i, record_every)
        prev.copy_(acc)
        prev_lat.copy_(acc_lat)
        return
    if coord_row is not None:
        coord_row = coord_row.to(torch.float32).contiguous()
    _check_flight(arrays, trace, t, acc, acc_lat, prev, prev_lat, phase,
                  coord_row, scratch)
    partials, ticket = flight_scratch(dev) if scratch is None else scratch
    slot = min(i // record_every, trace.shape[0] - 1)   # record_row's
    on_device = isinstance(phase, torch.Tensor)
    lib = _lib()
    args = FlightArgs(
        status=arrays[0].data_ptr(), inc=arrays[1].data_ptr(),
        informed=arrays[2].data_ptr(), age=arrays[3].data_ptr(),
        lh=arrays[7].data_ptr(), rows=arrays[0].shape[0],
        phase_host=-1.0 if on_device else float(phase),
        t=t.data_ptr(), phase=phase.data_ptr() if on_device else None,
        acc=acc.data_ptr(), acc_lat=acc_lat.data_ptr(),
        prev=prev.data_ptr(), prev_lat=prev_lat.data_ptr(),
        coord=None if coord_row is None else coord_row.data_ptr(),
        row=trace[slot].data_ptr(), partials=partials.data_ptr(),
        ticket=ticket.data_ptr())
    rc = lib.launch_flight_row(args,
                               torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, rc, "flight_row")
    LAUNCHES["flight_row"] += 1


# ---------------------------------------------------------------- runner


def _refuse(p: SimParams, R: int, plan, coords: bool,
            flight_every: Optional[int], blackbox: bool) -> None:
    """The combinations the JAX kernel runner refuses, for the same
    reasons (pallas_round.py:858-915)."""
    if R < 1:
        raise ValueError(f"rounds_per_call must be >= 1: {R}")
    if R > 1:
        if plan is not None:
            raise ValueError(
                "the megakernel freezes its inputs for the whole call but "
                "fault frames vary per round; run fault plans with "
                "rounds_per_call=1")
        if coords:
            raise ValueError(
                "coords updates run between kernel launches on per-round "
                "probe pairs; the megakernel surfaces state only at call "
                "boundaries — use rounds_per_call=1")
    if flight_every is not None and not p.collect_stats:
        raise ValueError(
            "flight recording rides the kernel's stats lanes; build "
            "SimParams with collect_stats=True")
    if flight_every is not None and flight_every % R:
        raise ValueError(
            f"the megakernel surfaces state every rounds_per_call={R} "
            f"rounds: flight stride {flight_every} must be a multiple of "
            "it (registry.STALE_EMISSION_RULE, rpc playing stale_k)")
    if blackbox and flight_every is None:
        raise ValueError(
            "the black-box tracer writes rings on the flight recorder's "
            "recorded rounds; pass flight_every (stride 1 for full causal "
            "timelines)")
    if coords and p.coords_timeout:
        raise ValueError(
            "coords_timeout gates each probe's ack on its pair's RTT "
            "inside the round body — the kernel's ack draw is internal, "
            "so this combination would silently diverge; use the live "
            "engine (round.run_rounds_coords / run_rounds_flight) for "
            "RTT-aware timeout studies")


def coord_ack_rate(sc: torch.Tensor) -> torch.Tensor:
    """The population ack rate of the stale scalars ``sc`` a round
    kernel consumed — the kernel runner's Vivaldi update gate (the
    kernel's per-node ack draw stays in the kernel)."""
    n_live, n_elig, n_up_elig, n_slow = sc[0], sc[1], sc[2], sc[3]
    sbar = n_slow / torch.clamp_min(n_up_elig, 1e-9)
    e_f = sc[4] / torch.clamp_min(n_live, 1e-9)
    e_s = sc[5] / torch.clamp_min(n_live, 1e-9)
    return (n_up_elig / n_elig) * (1.0 - ((1.0 - sbar) * e_f + sbar * e_s))


def coord_round(coo: coords_mod.CoordState, topo: topology.Topology,
                key: torch.Tensor, up: torch.Tensor, sc: torch.Tensor):
    """One round's Vivaldi update over the kernel's output: explicit
    pairs and their observed RTTs from ``split(key, 4)``, probers acking
    at the population rate of the scalars ``sc`` the kernel consumed.
    Returns (coords', CoordRoundAux). On the card the probes and the
    relaxation are one ``coord_probe`` and one ``vivaldi_relax`` launch
    (``coords.probe``, ``coords.relax``)."""
    n = up.shape[0]
    k_pair, k_jit, k_dir, k_ack = prng.split(key, 4)
    pair_j = topology.sample_pairs(n, k_pair)
    rtt_obs, _, _ = coords_mod.probe(coo, topo, pair_j, k_jit)
    acked = up & (prng.uniform(k_ack, n) < coord_ack_rate(sc))
    coo2, _, drift = coords_mod.relax(coo, pair_j, rtt_obs, k_dir, acked,
                                      up)
    return coo2, coords_mod.CoordRoundAux(pair_j=pair_j, drift=drift)


def make_run_rounds_cuda(p: SimParams, rounds: int,
                         rounds_per_call: int = 1, carry: bool = False,
                         plan: Optional[CompiledFaultPlan] = None,
                         coords: bool = False,
                         flight_every: Optional[int] = None,
                         blackbox: bool = False):
    """The kernel hot loop: ``run(state, key, scalars0=None, coo=None,
    topo=None, tracked=None, bb0=None)`` -> ``(state[, coords][,
    trace][, blackbox][, scalars])``, the bare state when no option
    adds to it.

    ``rounds_per_call=1`` launches ``round_kernel`` once per round and
    folds its partials into the next round's stale scalars;
    ``rounds_per_call=R > 1`` launches ``mega_kernel`` once per R rounds
    on scalars frozen for the call (the ``stale_k == R`` schedule).
    Per-round seeds are ``prng.round_seeds(key, state.round_idx,
    rounds)``, so a run cut at a call boundary and resumed with the
    returned scalars (``carry=True``, ``scalars0=``) draws the same
    seeds as the uncut run. Counters accumulate in int32 with an f32
    latency lane, starting from the state's own counters (so a resumed
    run adds in the uncut run's order).

    ``plan`` (``faults.compile_plan`` on the state's device) threads a
    FaultPlan through the kernel: each round's frame, keyed by the
    absolute round on the device (the call's phases looked up once,
    ``faults.plan_phases``), feeds the ``fault`` (honest plan) or ``byz``
    (byzantine plan) variant of ``round_kernel``. On the card the frame
    is read in place (``faults.frames_in_place``: the kernel indexes the
    plan's phase rows by the device phase; ``frame/in_place``); on the
    CPU the plain version takes ``faults.frames_at``'s gathered lanes.
    When ``p.fault_gain`` is not 1 the plan is blended
    once here (``scale_plan``), which gives every frame the bits of the
    reference's per-round ``scale_frame``.

    ``flight_every=k`` arms the flight recorder: after the launch that
    ends a window (and the run), ``record_flight_row`` writes a row of
    the updated packed arrays (one ``flight_row`` launch on the card,
    ``flight.flight_row`` on the CPU); its counter lanes are the delta of
    the int32 run accumulator against its last-recorded snapshot, its
    phase the plan's (the call's phase lookup). ``blackbox=True`` adds event
    rings for the ``tracked`` ids (or resumes ``bb0``) on the same
    rounds, with the frame's attack mask on byzantine plans. On the
    megakernel rows and rings land on call boundaries only, stamped with
    the call's last round, so k must be a multiple of R.

    ``coords=True`` (per-round runner only) relaxes the CoordState
    ``coo`` over the ``topo`` embedding after every launch
    (``coord_round``, keyed by ``round_keys(fold_in(key,
    prng.COORD_FOLD), state.round_idx, rounds)``); ``coord_metrics``
    fills the coordinate columns on recorded rounds only.

    On the card the whole call — the seeds, ``init_scalars``, the frames,
    the launches, the per-round sum and clamp, the counters and the
    recorders — is one CUDA graph, captured on the first call of each
    argument shape and replayed after (``graphs.GraphCache``: the JAX
    runner's one jitted program); ``LAUNCHES`` counts what each replay
    launches. ``graphs.eager()`` runs it launch by launch, as the CPU
    always does. The state is donated (``graphs``' module doc): the
    passed state and the returned one share the per-node tensors; every
    other returned tensor is fresh. The combinations the JAX runner
    refuses are refused by name (``_refuse``)."""
    R = rounds_per_call
    _refuse(p, R, plan, coords, flight_every, blackbox)
    if rounds % R:
        raise ValueError(f"rounds={rounds} must be a multiple of "
                         f"rounds_per_call={R}")
    if plan is not None and p.fault_gain != 1.0:
        # the kernel consumes the frame as given: blend the plan here
        plan = scale_plan(plan, p.fault_gain)
    keep = torch.ones(N_STATS)
    keep[LAT] = 0.0
    # the JAX megakernel runner's t + f32(R) * probe_interval, its step
    # folded in f32 on the host once: an f32 value, so adding the Python
    # float to the f32 clock rounds as the f32 add does, and no call
    # makes a tensor (a host-to-device copy, which syncs the host)
    step = float(torch.tensor(float(R), dtype=torch.float32)
                 * torch.tensor(p.probe_interval, dtype=torch.float32))
    # the counter mask and the scalar floors, copied to each device once
    # (a copy from host memory makes the host wait)
    consts: dict = {}
    record = flight_every is not None
    cache = graphs.GraphCache(counters=(LAUNCHES,))

    def body(arrays, t, r0, st0, key, scalars0, coo, topo, tracked, bb):
        """The whole call on device tensors: ``r0`` is the state's
        round, ``st0`` its SimStats; no host read, no value of a call
        baked in."""
        dev = arrays[0].device
        if dev not in consts:
            consts[dev] = (keep.to(dev), torch.tensor(
                SCALAR_FLOORS, dtype=torch.float32, device=dev),
                flight_scratch(dev) if record and dev.type == "cuda"
                else None)
        keep_d, floors, scratch = consts[dev]
        state = SimState(*arrays, t=t, round_idx=r0, stats=st0)
        fxs, phs = itertools.repeat(None), None
        if plan is not None:
            # the phases looked up once a call serve the frames and the
            # recorder; on the card the kernel reads the plan's rows in
            # place at the device phase, on the CPU the plain version
            # takes gathered frames
            phases = plan_phases(plan, r0, rounds)
            phs = phases[1]
            fxs = (frames_in_place if dev.type == "cuda" else frames_at)(
                plan, r0, rounds, p.fault_gain, phases=phases)
        scalars = init_scalars(state, p) if scalars0 is None \
            else scalars0.clone()
        seeds = prng.round_seeds(key, r0, rounds)
        rows = arrays[0].shape[0]
        buf = torch.empty((partials_rows(rows), N_LANES),
                          dtype=torch.float32, device=dev)
        # the accumulators start from the state's counters, so a run cut
        # at a call boundary and resumed adds the latency lane in the
        # order of the uncut run
        acc_i = torch.stack([torch.zeros((), dtype=torch.int32, device=dev)
                             if i == LAT else getattr(st0, f).to(torch.int32)
                             for i, f in enumerate(STATS_FIELDS)])
        acc_lat = st0.detect_latency_sum.to(torch.float32).clone()
        trace = None
        if record:
            trace = flight.empty_trace(rounds, flight_every, dev)
            prev = (acc_i.clone(), acc_lat.clone())
            if blackbox and bb is None:
                bb = blackbox_mod.init_blackbox(state, tracked,
                                                p.blackbox_ring)
        if coords:
            ckeys = prng.round_keys(prng.SubKey(key, prng.COORD_FOLD),
                                    r0, rounds)
        for c, fx in zip(range(rounds // R), fxs):
            sc_in = scalars
            if R == 1:
                partials = round_kernel(arrays, scalars, seeds, c, p,
                                        out=buf, fx=fx)
                t = t + p.probe_interval
            else:
                partials = mega_kernel(arrays, scalars,
                                       seeds[c * R:(c + 1) * R], p,
                                       out=buf)
                t = t + step
            sums = partials.sum(0)
            scalars = clamp_scalars(sums[:N_SCALARS], floors)
            if p.collect_stats:
                stat = sums[N_SCALARS:]
                acc_i += (stat * keep_d).to(torch.int32)
                acc_lat += stat[LAT]
            if coords:
                coo, aux = coord_round(coo, topo, ckeys[c], arrays[3] < 0,
                                       sc_in)
            if not record:
                continue
            i_last = (c + 1) * R - 1   # the call's last round, run-local

            def rec(carry):
                (pi, pl), bbc = carry
                crow = coords_mod.coord_metrics(coo, topo, aux) \
                    if coords else None
                r_abs = r0 + i_last
                ph = -1 if phs is None else phs[i_last:i_last + 1]
                # the row and the window's counter delta; the snapshot
                # moves to the accumulators in place
                record_flight_row(trace, i_last, flight_every, arrays, t,
                                  acc_i, acc_lat, pi, pl, phase=ph,
                                  coord_row=crow, scratch=scratch)
                if bbc is not None:
                    bbc = blackbox_mod.record(
                        bbc, round_idx=r_abs, phase=ph,
                        status=arrays[0], incarnation=arrays[1],
                        susp_conf=arrays[6], up=arrays[3] < 0,
                        attacked=None if fx is None else
                        fx.lane("attacked") if isinstance(fx, InPlaceFrame)
                        else fx.attacked)
                return (pi, pl), bbc

            prev, bb = flight.maybe_record((prev, bb), i_last, rounds,
                                           flight_every, rec)
        st = st0
        if p.collect_stats:
            st = SimStats(**{f: acc_lat if i == LAT else acc_i[i].clone()
                             for i, f in enumerate(STATS_FIELDS)})
        return t, r0 + rounds, st, coo, trace, bb, scalars

    def run(state: SimState, key: torch.Tensor, scalars0=None, coo=None,
            topo=None, tracked=None, bb0=None):
        if scalars0 is not None and not carry:
            raise ValueError("scalars0 needs a carry=True runner")
        if coords and (coo is None or topo is None):
            raise ValueError("a coords=True runner needs coo= (a "
                             "CoordState) and topo= (a Topology)")
        if blackbox and tracked is None and bb0 is None:
            raise ValueError("blackbox=True runner needs a tracked id "
                             "tensor (blackbox.default_tracked)")
        with telemetry.span("sim.runner.call"):
            with telemetry.span("sim.runner.prologue"):
                arrays = state.node_arrays()
                dev = arrays[0].device
                key = key.to(dev)
                if scalars0 is not None:
                    scalars0 = scalars0.to(device=dev, dtype=torch.float32)
                if tracked is not None and bb0 is None:
                    tracked = tracked.to(device=dev, dtype=torch.int32)
                else:
                    tracked = None
            t, r, st, coo, trace, bb, scalars = cache(
                "run", body, arrays, state.t, state.round_idx, state.stats,
                key, scalars0, coo if coords else None,
                topo if coords else None, tracked if blackbox else None,
                bb0 if blackbox else None)
            with telemetry.span("sim.runner.epilogue"):
                out = SimState(*arrays, t=t, round_idx=r, stats=st)
                res = (out, coo) if coords else (out,)
                if record:
                    res = res + (trace,)
                if blackbox:
                    res = res + (bb,)
                if carry:
                    res = res + (scalars,)
                return res[0] if len(res) == 1 else res

    run.graphs = cache
    return run
