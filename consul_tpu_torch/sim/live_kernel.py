"""The live engine's protocol period as three kernels around its sums.

The live engine (``round.round_core`` with ``scalars=None``) takes its
population scalars from the period's own post-churn arrays: three
``torch.sum`` stages, each fed by the one before (``round._round_body``'s
first ``_sums`` call, then the pf and the Lifeguard sums, which both
need only the first's scalars). The plain body spells the period out as
~420 PyTorch launches. ``csrc/lane_kernels.cu`` holds its counterpart,
``live_round<STAGE>``, one launch a stage between the sums:

* ``a`` — churn and the slow model; the first sums' 4 rows;
* ``b`` — a's steps again, the population terms from a's sums, the
  prober's miss terms, the ack and the Lifeguard update; the 4 rows of
  the second and third sums;
* ``c`` — b's steps again and the rest of the period on all 8 sums; the
  8 lanes narrowed (into ``into`` where given: a runner's donated carry,
  which may be the state's own lanes) and, with stats, the counter rows
  ``round._stats_add`` sums (int32, which it sums as it sums its own
  f32 masks cast to int32, and the f32 latency).

Each stage redoes the per-node steps it needs from the packed lanes and
the drawn slot rows, in registers. The sums stay ``torch.sum`` of one row
each, on rows whose starts are aligned as a fresh tensor's, so the period
is the plain body's bit for bit on the card: the lanes, the counters and
the clock. The constants are the lane kernel's (``lane_kernel.consts``,
``lane_kernel.table``) and so are its arithmetic rules.

* Routing (``round.round_core``): an honest live period of one run —
  no fault frame, no grid, no coordinates, no probe events — on packed
  lanes takes this route where ``fused.routed`` says so: the kernels on
  the card, their twin on the CPU inside ``fused.twins()``; never inside
  ``fused.plain()``. A failed build or launch raises.
* Counting: each stage's launch adds one to
  ``fused.LAUNCHES["live_round/<a|b|c>"]`` (which ``graphs.GraphCache``
  counts per replay) and reports its tensors to ``fused.OBSERVERS``.
* The twin: each stage's evaluation in PyTorch (``lane_kernel``'s
  ``churn_twin`` and ``probe_twin``, and stage c as the lane kernel's
  twin on the 8 sums as stale scalars, which is the same arithmetic),
  writing the same buffers, which the same sums read.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from consul_tpu_torch.sim import fused
from consul_tpu_torch.sim import lane_kernel as LK
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import (ALIVE, NODE_FIELDS, PACKED_DTYPES,
                                        STATS_FIELDS, SUSPECT)

STAGES = ("a", "b", "c")
NAMES = tuple(f"live_round/{s}" for s in STAGES)
#: the slots a live period may read (never the byzantine replay's)
_SLOT_FIELDS = LK._SLOT_FIELDS[:5]
#: the counter rows stage c writes, by their index in ``STATS_FIELDS``:
#: suspicions, refutes, false positives, true deaths, then (under churn)
#: crashes, rejoins, leaves; the latency sum is its own f32 row
COUNTS = (0, 1, 2, 3, 5, 6, 7)
CHURN_COUNTS = (5, 6, 7)
LAT = 4
#: rows start on 512 bytes, as a fresh tensor from the caching allocator
#: does (the sums' vector loads take the alignment into their order)
ROW_ALIGN = 128

_F32 = torch.float32
_I32 = torch.int32


class LiveIO(ctypes.Structure):
    """Mirror of ``struct LiveIO`` in lane_kernels.cu."""

    _fields_ = ([(f, ctypes.c_void_p) for f in NODE_FIELDS]
                + [("o_" + f, ctypes.c_void_p) for f in NODE_FIELDS]
                + [(f, ctypes.c_void_p) for f in ("tab",) + _SLOT_FIELDS]
                + [("sums", ctypes.c_void_p * 8)]
                + [(f, ctypes.c_void_p) for f in ("rows", "counts", "lat")]
                + [("stride", ctypes.c_longlong), ("stats", ctypes.c_int)])


def takes(vals: Sequence[torch.Tensor], p) -> bool:
    """Whether the stages can run this period: one run (``SimParams``, not
    a grid's) on the packed layout, as contiguous ``[N]`` lanes on one
    device (a wide state runs the plain body)."""
    if not isinstance(p, SimParams) or len(vals) != len(NODE_FIELDS):
        return False
    dev, shape = vals[0].device, vals[0].shape
    return len(shape) == 1 and all(
        a.device == dev and a.dtype == dt and a.shape == shape
        and a.is_contiguous() for a, dt in zip(vals, PACKED_DTYPES))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = LK._lib()
    lib.live_io_size.argtypes = []
    lib.live_io_size.restype = ctypes.c_int
    if lib.live_io_size() != ctypes.sizeof(LiveIO):
        raise RuntimeError(
            f"lane_kernels.cu's LiveIO is {lib.live_io_size()} bytes; "
            f"live_kernel maps {ctypes.sizeof(LiveIO)}")
    lib.launch_live_round.argtypes = [LK.LaneConsts, LiveIO, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.launch_live_round.restype = ctypes.c_int
    return lib


def padded(n: int) -> int:
    """A row's length in the stages' buffers: ``n`` rounded up to
    ``ROW_ALIGN``."""
    return -(-n // ROW_ALIGN) * ROW_ALIGN


class Period:
    """One period's inputs and buffers: the lanes, the slot rows, the
    constants, the outputs, the 4 sum rows, the counter rows."""

    def __init__(self, vals, u01, slots, p: SimParams, into):
        self.vals = tuple(vals)
        if not takes(self.vals, p):
            raise ValueError("live_round takes the packed layout as "
                             "contiguous [N] lanes of one run")
        self.dev = self.vals[0].device
        self.n = n = self.vals[0].shape[0]
        self.slots = tuple(slots)
        self.u = {s: u01(s) for s in self.slots}
        for s, row in self.u.items():
            if row.device != self.dev or row.dtype != _F32 \
                    or tuple(row.shape) != (n,) or not row.is_contiguous():
                raise ValueError(f"slot {s}'s draws must be contiguous f32 "
                                 f"({n},) on {self.dev}")
        self.c = LK.consts(p, (n,))
        self.tab = LK.table(p, 1, self.dev)
        if into is None:
            self.outs = tuple(torch.empty_like(v) for v in self.vals)
        else:
            self.outs = tuple(into)
            if not takes(self.outs, p) or self.outs[0].shape != (n,) \
                    or self.outs[0].device != self.dev:
                raise ValueError("into takes 8 contiguous packed lanes "
                                 "of the state's shape and device")
        self.stats = bool(p.collect_stats)
        stride = padded(n)
        self.stride = stride
        self.buf = torch.empty((4, stride), dtype=_F32, device=self.dev)
        self.rows = [self.buf[k, :n] for k in range(4)]
        self.counts = self.lat = None
        if self.stats:
            self.counts = torch.empty((len(COUNTS), stride), dtype=_I32,
                                      device=self.dev)
            self.lat = torch.empty(stride, dtype=_F32, device=self.dev)

    def counter_lanes(self) -> list:
        """Stage c's counter rows in ``STATS_FIELDS`` order (None where
        the plain body's lane is None: no churn, no attack)."""
        lanes = [None] * len(STATS_FIELDS)
        for k, i in enumerate(COUNTS):
            if i not in CHURN_COUNTS or self.c.churn_on:
                lanes[i] = self.counts[k, :self.n]
        lanes[LAT] = self.lat[:self.n]
        return lanes


def live_round(vals: Sequence[torch.Tensor], u01, slots: tuple,
               p: SimParams,
               into: Optional[Sequence[torch.Tensor]] = None) -> tuple:
    """One live period over the packed ``vals`` (``[N]``) on the round's
    draws ``u01`` (``slots``' rows, ``round.draw_slots``): returns (the 8
    new lanes, the counter lanes in ``STATS_FIELDS`` order, or None
    without stats). The lanes are ``into`` when given (may be ``vals``),
    else new. CUDA tensors launch the stages, CPU tensors run their twin
    under the CPU's division rule."""
    per = Period(vals, u01, slots, p, into)
    stage = launch if per.dev.type == "cuda" else twin_stage
    stage(per, 0, ())
    sa = [torch.sum(r) for r in per.rows]
    stage(per, 1, sa)
    sb = [torch.sum(r) for r in per.rows]
    stage(per, 2, sa + sb)
    return per.outs, per.counter_lanes() if per.stats else None


def live_args(per: Period, stage: int, sums: list) -> LiveIO:
    """A stage's ``LiveIO``: pointers of the input and output lanes, the
    table, each drawn slot's row (null where not drawn), the sums read
    (null past those the stage takes), the sum rows, the counter rows
    and the padded row length."""
    ptrs = [s.data_ptr() for s in sums] + [None] * (8 - len(sums))
    return LiveIO(
        **{f: a.data_ptr() for f, a in zip(NODE_FIELDS, per.vals)},
        **{"o_" + f: a.data_ptr() for f, a in zip(NODE_FIELDS, per.outs)},
        tab=per.tab.data_ptr(),
        **{f: per.u[s].data_ptr() for s, f in enumerate(_SLOT_FIELDS)
           if s in per.u},
        sums=(ctypes.c_void_p * 8)(*ptrs), rows=per.buf.data_ptr(),
        counts=None if per.counts is None else per.counts.data_ptr(),
        lat=None if per.lat is None else per.lat.data_ptr(),
        stride=per.stride, stats=int(per.stats))


def launch(per: Period, stage: int, sums: list) -> None:
    lib = _lib()
    fused._check_launch(lib.launch_live_round(per.c,
                                              live_args(per, stage, sums),
                                              stage,
                                              fused._stream(per.vals[0])),
                        NAMES[stage], lib.lane_kernels_error_string)
    fused.LAUNCHES[NAMES[stage]] += 1
    ins = (*per.vals, per.tab, *per.u.values(), *sums)
    if stage < 2:
        fused._observe(ins, per.rows)
    else:
        fused._observe(ins, per.outs + (tuple(
            r for r in per.counter_lanes() if r is not None)
            if per.stats else ()))


# ------------------------------------------------------------------ twin


def _terms(sa: list, c: LK.LaneConsts, rule: str) -> tuple:
    """(sbar, frac_up_elig, live_frac) from stage a's sums, as the plain
    body derives them (``derive`` in the kernel)."""
    n_up_elig = torch.clamp_min(sa[2], 1e-9)
    sbar = sa[3] / n_up_elig
    frac_up_elig = n_up_elig / torch.clamp_min(sa[1], 1.0)
    return sbar, frac_up_elig, LK.by_number(sa[0], c.n_f, c.recip_n, rule)


def stale_scalars(sums: list) -> torch.Tensor:
    """The 8 sums as the stale scalar vector the lane kernel reads: the
    floors of ``round.SCALAR_FLOORS`` on the counts and the Lifeguard
    denominator (stage c's population terms are the lane kernel's on
    it)."""
    return torch.stack([sums[0], torch.clamp_min(sums[1], 1.0),
                        torch.clamp_min(sums[2], 1e-9), sums[3], sums[4],
                        sums[5], sums[6], torch.clamp_min(sums[7], 1e-9)])


def twin_stage(per: Period, stage: int, sums: list,
          rule: str = LK.CPU_RULE) -> None:
    """Stage ``stage`` in PyTorch: writes what the kernel writes."""
    c = per.c
    col = LK.columns(per.tab, False)
    if stage < 2:
        at = {s: s for s in per.u}
        v = LK.churn_twin(per.vals, per.u, at, c, col, None)
        upf = v.up.to(_F32)
        if stage == 0:
            elig = (v.status == ALIVE) | (v.status == SUSPECT)
            eligf = elig.to(_F32)
            rows = [upf, eligf, upf * eligf,
                    (v.slow_eff & v.up & elig).to(_F32)]
        else:
            sbar, frac_up_elig, live_frac = _terms(sums, c, rule)
            _, pf_fast, pf_slow, p_ack, _, lh = LK.probe_twin(
                v, sbar, frac_up_elig, live_frac, per.u[LK.U_ACK], c, col,
                None)
            w_fail = upf * (1.0 - p_ack)
            rows = [upf * pf_fast, upf * pf_slow,
                    w_fail * (lh.to(_F32) + 1.0), w_fail]
        for dst, r in zip(per.rows, rows):
            dst.copy_(r)
        return
    stack = torch.empty((LK.N_ROWS, per.n), dtype=_F32, device=per.dev)
    outs = LK.twin(per.vals, stale_scalars(sums),
                   [per.u[s] for s in per.slots], per.slots, c, per.tab,
                   None, stack, "write" if per.stats else "skip", False,
                   rule)
    for dst, o in zip(per.outs, outs):
        dst.copy_(o)
    if per.stats:
        for k, i in enumerate(COUNTS):
            per.counts[k, :per.n].copy_(stack[LK.STATS_ROW + i].to(_I32))
        per.lat[:per.n].copy_(stack[LK.STATS_ROW + LAT])
