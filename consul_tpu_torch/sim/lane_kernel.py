"""The lane engine's protocol period as one kernel: wrapper, packing, twin.

The JAX package's exact lane engine runs its round (``_round_core`` in
lane mode) as one jitted program, which XLA compiles into one fused
elementwise kernel. The port's plain version is ``round._round_body(...,
lane_mode=True)`` on stale scalars: the same protocol as ~380 PyTorch
launches a round. ``csrc/lane_kernels.cu`` holds its counterpart,
``lane_round<FRAME, BYZ>``: one launch computes a round for every node
from the 8 packed state lanes, the round's drawn slot rows (the one
``prng.global_rows`` launch), the stale scalars and, on a fault round,
the frame's lanes, and writes the narrowed lanes and the round's
``[N_REDUCE_LANES, ..., rows]`` contribution stack
(``registry.REDUCE_LANES`` order; a lane the body leaves None is a row
of +0.0). One run is ``[N]`` lanes on ``SimParams``; a grid of constants
(the sweep's ``lanes`` engine) is ``[G, N]`` lanes on a
``params.TracedParams`` whose swept constants are ``[G, 1]`` tensors.

* Packing: the constant table (``table``: ``[G, len(COLUMNS)]`` f32 on
  the device, each point's constants built by the plain body's own
  expressions — ``COLUMNS`` — so each entry has the bits the body's
  operand has: a Python float's f32 cast, an f64 fold, or a leaf's f32
  arithmetic; a device tensor, so a grid's leaves move between calls of
  a CUDA graph), the constants the graph key fixes and the switches
  (``consts``, launch arguments), the stale scalars, the slot rows and
  the frame's lanes (device pointers, ``lane_args``), the output state
  and stack.
* Routing (``round``'s ``fused.routed``): a state on the card goes to
  the kernel, a CPU state inside ``fused.twins()`` to the kernel's twin,
  a CPU state otherwise and every device inside ``fused.plain()`` to the
  plain body. A failed build or launch raises.
* Counting: each launch adds one to ``fused.LAUNCHES["lane_round"]``
  (which ``graphs.GraphCache`` counts per replay) and reports its tensors
  to ``fused.OBSERVERS``.
* The twin (``twin``): the kernel's evaluation in PyTorch, from the same
  table and constants, op for op on per-node tensors shaped as the plain
  body shapes them, so on the CPU it equals the plain body bit for bit.
  ATen divides a CUDA tensor by a Python number as a product with the
  f32 reciprocal (``div_true_kernel_cuda``), a CPU tensor by a division,
  and any tensor by a tensor (a swept probe interval) by a division: the
  constants hold each divisor's reciprocal, the kernel takes the card's
  rule (``CARD_RULE``), the twin either.

Window mode (``round._lane_window``): ``stats="add"`` adds the round's 10
counter rows onto the stack's (the plain loop's ``pend + rows``),
``stats="skip"`` leaves them, and ``inst=False`` skips the 22 other rows,
which the window's last round writes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from consul_tpu_torch.faults import (FRAME_ABI, FaultFrame, check_frame,
                                     frame_lanes, frame_pointers, ipow)
from consul_tpu_torch.sim import fused, registry
from consul_tpu_torch.sim.params import TracedParams
from consul_tpu_torch.sim.state import (ALIVE, ALIVE_AGE, CONF_MAX, DEAD,
                                        LEFT, NODE_FIELDS, SLOW_AGE,
                                        SUSPECT, TICK_MAX, TTL_NEVER,
                                        check_packed)

SOURCE = "lane_kernels"
NAME = "lane_round"
N_ROWS = registry.N_REDUCE_LANES
#: the stack's counter rows (``lanes.STATS_SLICE``) and its first gauge
STATS_ROW = len(registry.LANE_SCALARS)
N_STATS = len(registry.STATS_FIELDS)
GAUGE_ROW = STATS_ROW + N_STATS
STATS_MODES = {"skip": 0, "write": 1, "add": 2}
#: how ATen divides a tensor by a Python number: on the card a product
#: with the f32 reciprocal, on the CPU a division
CARD_RULE = "reciprocal"
CPU_RULE = "divide"
RULES = (CARD_RULE, CPU_RULE)
#: the frame kinds the launcher takes: none, honest, byzantine
FRAME_KINDS = {"none": 0, "fault": 1, "byz": 2}

#: the draw slots (``round.U_*``; this module cannot import round)
U_CHURN, U_SLOW, U_ACK, U_POIS, U_HEAR, U_REPLAY = range(6)
_SLOT_FIELDS = ("u_churn", "u_slow", "u_ack", "u_pois", "u_hear",
                "u_replay")

_F32 = torch.float32
_I32 = torch.int32

def _columns(p) -> tuple:
    """A point's constants by the plain body's expressions (``p`` a
    SimParams or a TracedParams: each a Python number or a leaf), in
    ``lane_kernels.cu``'s ``Col`` order."""
    return (p.probe_interval, p.fail_per_round, p.leave_per_round,
            p.fail_per_round + p.leave_per_round, p.rejoin_per_round,
            p.slow_per_round, p.slow_recover_per_round, p.slow_factor,
            1.0 - p.slow_factor, p.p_direct, p.p_relay, p.p_tcp,
            p.fanout_ticks, p.one_minus_loss, p.suspicion_max_s,
            p.shrink_r, p.shrink_omr, p.confirmation_k, p.awareness_max,
            p.corroboration_k)


#: the table's columns (``Col`` in lane_kernels.cu)
COLUMNS = ("probe_interval", "fail_p", "leave_p", "fail_leave_p",
           "rejoin_p", "slow_p", "slow_recover_p", "slow_factor",
           "one_minus_slow_factor", "p_direct", "p_relay", "p_tcp",
           "fanout_ticks", "one_minus_loss", "susp_max_s", "shrink_r",
           "shrink_omr", "confirmation_k", "awareness_max",
           "corroboration_k")
COL = {name: i for i, name in enumerate(COLUMNS)}


class LaneConsts(ctypes.Structure):
    """Mirror of ``struct LaneConsts`` in lane_kernels.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in ("rows", "row_len", "points")]
                + [(f, ctypes.c_float) for f in ("inv_n", "n_f", "recip_n",
                                                 "recip_pi")]
                + [("recip_k", ctypes.c_float * 4)]
                + [(f, ctypes.c_int) for f in (
                    "div_pi", "indirect_checks", "lifeguard", "shrink_on",
                    "churn_on", "slow_on", "gate_on")])


class LaneIO(ctypes.Structure):
    """Mirror of ``struct LaneIO`` in lane_kernels.cu."""

    _fields_ = ([(f, ctypes.c_void_p) for f in NODE_FIELDS]
                + [("o_" + f, ctypes.c_void_p) for f in NODE_FIELDS]
                + [(f, ctypes.c_void_p)
                   for f in ("scal", "tab") + _SLOT_FIELDS + ("stack",)]
                + [(f, ctypes.c_int)
                   for f in ("stats_mode", "write_inst", "frame_rows")])


class FrameArrays(ctypes.Structure):
    """Mirror of ``struct FrameArrays`` in lane_kernels.cu."""

    _fields_ = [(f, ctypes.c_void_p) for f in FRAME_ABI]


def _swept(p) -> tuple:
    """(the static SimParams, the swept names) of ``p``."""
    if isinstance(p, TracedParams):
        return p.static, frozenset(p.leaves)
    return p, frozenset()


def consts(p, shape: tuple) -> LaneConsts:
    """The launch's constants for lanes of ``shape`` (``(N,)`` or ``(G,
    N)``): those the graph key fixes — ``1 / n`` folded in f64 as Python
    folds it, ``n`` and the f32 reciprocals ATen takes on the card for a
    division by a number (``1.0f / f32(b)``) — and the switches, from
    ``p``'s static part and which constants it sweeps."""
    return _consts(*_swept(p), tuple(shape))


@functools.lru_cache(maxsize=None)
def _consts(static, swept: frozenset, shape: tuple) -> LaneConsts:
    one = np.float32(1.0)
    points = math.prod(shape[:-1])

    def on(*names):
        return any(nm in swept or bool(getattr(static, nm))
                   for nm in names)

    return LaneConsts(
        rows=points * shape[-1], row_len=shape[-1], points=points,
        inv_n=float(np.float32(1.0 / static.n)),
        n_f=float(np.float32(static.n)),
        recip_n=float(one / np.float32(static.n)),
        recip_pi=float(one / np.float32(static.probe_interval)),
        recip_k=(ctypes.c_float * 4)(*(float(one / np.float32(k))
                                       for k in range(1, 5))),
        div_pi=int("probe_interval" in swept),
        indirect_checks=int(static.indirect_checks),
        lifeguard=int(static.lifeguard),
        shrink_on=int(static.lifeguard and (
            bool(swept & {"suspicion_mult", "suspicion_max_timeout_mult",
                          "probe_interval"})
            or static.suspicion_max_s > static.suspicion_min_s)),
        churn_on=int(on("fail_per_round", "leave_per_round",
                        "rejoin_per_round")),
        slow_on=int(on("slow_per_round")),
        gate_on=int(on("corroboration_k")))


#: a SimParams' table on each device, made once (fills: a copy from host
#: memory would make the host wait, and a CUDA graph cannot hold it)
_tables: dict = {}


def table(p, points: int, device) -> torch.Tensor:
    """The ``[points, len(COLUMNS)]`` f32 constant table of ``p`` on
    ``device``: a column of a Python number is filled with its f32 cast,
    a leaf's ``[G, 1]`` (or ``[1, 1]``) values are cast to f32. A
    SimParams' table is kept; a grid's is made from its leaves on the
    device, by device ops alone (a CUDA graph replays it with new
    leaves)."""
    key = None if isinstance(p, TracedParams) else (p, points, device)
    if key in _tables:
        return _tables[key]
    cols = []
    for v in _columns(p):
        if isinstance(v, torch.Tensor):
            v = v.to(device=device, dtype=_F32).reshape(-1)
            if v.numel() != points:
                raise ValueError(f"a swept constant has {v.numel()} "
                                 f"points; the lanes have {points}")
            cols.append(v)
        else:
            cols.append(torch.full((points,), v, dtype=_F32, device=device))
    tab = torch.stack(cols, 1)
    if key is not None:
        _tables[key] = tab
    return tab


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from consul_tpu_torch.utils import build

    lib = build.load(SOURCE)
    got = [ctypes.c_int() for _ in range(3)]
    sizes = (ctypes.c_int * 3)()
    lib.lane_kernels_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    lib.lane_kernels_layout.restype = None
    lib.lane_kernels_layout(*(ctypes.byref(v) for v in got), sizes)
    want = (N_ROWS, STATS_ROW, len(COLUMNS), ctypes.sizeof(LaneConsts),
            ctypes.sizeof(LaneIO), ctypes.sizeof(FrameArrays))
    if tuple(v.value for v in got) + tuple(sizes) != want:
        raise RuntimeError(
            f"lane_kernels.cu's (rows, counter row, table columns, struct "
            f"bytes) are {tuple(v.value for v in got) + tuple(sizes)}; "
            f"lane_kernel maps {want}")
    lib.launch_lane_round.argtypes = [LaneConsts, LaneIO, FrameArrays,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.launch_lane_round.restype = ctypes.c_int
    lib.lane_kernels_error_string.argtypes = [ctypes.c_int]
    lib.lane_kernels_error_string.restype = ctypes.c_char_p
    return lib


def frame_kind(fx: Optional[FaultFrame]) -> str:
    if fx is None:
        return "none"
    return "fault" if fx.attacked is None else "byz"


def _check(vals, scal, u, slots, fx, stack, stats, tab) -> tuple:
    """The launch's inputs as the kernel takes them: the packed lanes,
    contiguous, of one shape ``(N,)`` or ``(G, N)`` on one device; the
    f32 stale scalars ``[8]`` or ``[8, G]``; the slot rows ``[len(slots),
    N]`` f32; the frame's f32 lanes and bool masks, all ``(N,)`` or all
    the lanes' shape, and ``mid`` one f32 or one a point; the stack
    ``[N_ROWS, *shape]`` f32 (given for ``stats="add"``); the table
    ``[G, len(COLUMNS)]``. Returns (the lanes' shape, the points)."""
    shape = check_packed(vals, NAME, (1, 2))
    dev, points, n = vals[0].device, math.prod(shape[:-1]), shape[-1]

    def bad(t, want_shape, dtype=_F32):
        return t.device != dev or t.dtype != dtype \
            or tuple(t.shape) != want_shape or not t.is_contiguous()

    if bad(scal, (8,) + shape[:-1]):
        raise ValueError(f"stale scalars must be contiguous f32 "
                         f"{(8,) + shape[:-1]} on {dev}")
    if len(set(slots)) != len(slots) or not {U_ACK, U_POIS, U_HEAR} \
            <= set(slots):
        raise ValueError(f"slot set {slots} lacks a slot the round draws")
    if bad(u, (len(slots), n)):
        raise ValueError(f"slot rows must be contiguous f32 "
                         f"({len(slots)}, {n}) on {dev}")
    if fx is not None:
        check_frame(fx, dev, ((n,), shape))
    if stats not in STATS_MODES:
        raise ValueError(f"stats must be one of {tuple(STATS_MODES)}")
    if stack is None and stats == "add":
        raise ValueError("stats='add' adds onto a given stack")
    if stack is not None and bad(stack, (N_ROWS,) + shape):
        raise ValueError(f"stack must be contiguous f32 "
                         f"{(N_ROWS,) + shape} on {dev}")
    if bad(tab, (points, len(COLUMNS))):
        raise ValueError(f"the table must be contiguous f32 "
                         f"({points}, {len(COLUMNS)}) on {dev}")
    return shape, points


def lane_args(vals, scal, u, slots, outs, stack, fx, stats: str,
              inst: bool, tab: torch.Tensor) -> tuple:
    """The launch's ``(LaneIO, FrameArrays, frame kind)``: pointers of
    the input and output lanes, the scalars, the table, each drawn
    slot's row (null where not drawn) and the stack, the window mode and
    whether the frame has a row a point; the frame's lanes."""
    row_bytes = u.shape[-1] * u.element_size()
    at = {s: u.data_ptr() + i * row_bytes for i, s in enumerate(slots)}
    kind = frame_kind(fx)
    io = LaneIO(**{f: a.data_ptr() for f, a in zip(NODE_FIELDS, vals)},
                **{"o_" + f: a.data_ptr() for f, a in zip(NODE_FIELDS,
                                                          outs)},
                scal=scal.data_ptr(), tab=tab.data_ptr(),
                stack=stack.data_ptr(), stats_mode=STATS_MODES[stats],
                write_inst=int(inst),
                frame_rows=int(fx is not None
                               and fx.psend.shape == vals[0].shape
                               and vals[0].dim() == 2),
                **{f: at.get(s) for s, f in enumerate(_SLOT_FIELDS)})
    fr = FrameArrays() if fx is None else FrameArrays(**frame_pointers(fx))
    return io, fr, FRAME_KINDS[kind]


def lane_round(vals: Sequence[torch.Tensor], scal: torch.Tensor,
               u: torch.Tensor, slots: tuple, p,
               fx: Optional[FaultFrame] = None,
               stack: Optional[torch.Tensor] = None, stats: str = "write",
               inst: bool = True,
               tab: Optional[torch.Tensor] = None) -> tuple:
    """One lane-engine period over the packed ``vals`` (``[N]``, or
    ``[G, N]`` for a grid) on the stale scalars ``scal`` (``[8]`` /
    ``[8, G]``), the slot rows ``u`` (``slots``' rows, the one draw of
    ``prng.global_rows``) and the scaled frame ``fx``: returns (the 8 new
    lanes, the stack). The stack is ``stack`` when given (window mode:
    ``stats`` and ``inst`` as in the module's doc), else new; ``tab`` is
    ``table(p, ...)``, made here when not given. CUDA tensors launch the
    kernel, CPU tensors run its twin under the CPU's division rule; the
    inputs are not modified."""
    slots = tuple(slots)
    dev = vals[0].device
    if tab is None:
        tab = table(p, math.prod(vals[0].shape[:-1]), dev)
    shape, _ = _check(vals, scal, u, slots, fx, stack, stats, tab)
    if stack is None:
        stack = torch.empty((N_ROWS,) + shape, dtype=_F32, device=dev)
    c = consts(p, shape)
    if dev.type != "cuda":
        outs = twin(vals, scal, u, slots, c, tab, fx, stack, stats, inst,
                    CPU_RULE)
        return outs, stack
    outs = tuple(torch.empty_like(v) for v in vals)
    io, fr, kind = lane_args(vals, scal, u, slots, outs, stack, fx, stats,
                             inst, tab)
    lib = _lib()
    fused._check_launch(lib.launch_lane_round(c, io, fr, kind,
                                              fused._stream(vals[0])),
                        NAME, lib.lane_kernels_error_string)
    fused.LAUNCHES[NAME] += 1
    frame = () if fx is None else tuple(getattr(fx, f)
                                        for f in frame_lanes(fx))
    fused._observe((*vals, scal, tab, u, *frame)
                   + ((stack,) if stats == "add" else ()), (*outs, stack))
    return outs, stack


# ------------------------------------------------------------------ twin


def by_number(x, b, rb, rule: str):
    """``x / b`` for a Python number ``b`` as ATen divides under ``rule``:
    a product with its f32 reciprocal ``rb`` on the card, a division on
    the CPU."""
    return x * rb if rule == CARD_RULE else x / b


def columns(tab: torch.Tensor, grid: bool):
    """A reader of the table's columns by name: a point's 0-d entry, or
    a grid's ``[G, 1]`` column."""
    def col(name):
        k = COL[name]
        return tab[:, k:k + 1] if grid else tab[0, k]

    return col


def _clamp_lh(x, col):
    return torch.minimum(torch.clamp_min(x, 0),
                         col("awareness_max").to(_I32))


def churn_twin(vals, u, at: dict, c: LaneConsts, col,
               fx: Optional[FaultFrame]) -> SimpleNamespace:
    """A period's first steps in the kernels' (and the plain body's)
    order: the lanes widened, the dead aged, churn and the slow model.
    ``at`` maps a slot to its row of ``u``. Returns the per-node tensors
    by name."""
    frame = fx is not None
    (status_in, inc_in, informed, age_in, slen_in, sttl_in, conf_in,
     lh_in) = vals
    age = age_in.to(_I32)
    up = age < 0
    slow = age == SLOW_AGE
    status = status_in.to(_I32)
    inc = inc_in.to(_I32)
    slen = slen_in.to(_I32)
    sttl = sttl_in.to(_I32)
    s_conf = conf_in.to(_I32)
    lh = lh_in.to(_I32)
    new_rumor = torch.zeros_like(up)
    crash = leave = rejoin = None
    age = torch.where(age >= 0, torch.clamp_max(age + 1, TICK_MAX), age)

    if frame or c.churn_on:
        uc = u[at[U_CHURN]]
        fail_p, rejoin_p = col("fail_p"), col("rejoin_p")
        if frame:
            fail_p = fail_p + fx.crash_p
            leave_p = col("leave_p") + fx.leave_p
            rejoin_p = rejoin_p + fx.rejoin_p
            fail_leave = fail_p + leave_p
        else:
            fail_leave = col("fail_leave_p")
        crash = up & (uc < fail_p)
        leave = up & (uc >= fail_p) & (uc < fail_leave)
        rejoin = (~up) & (uc < rejoin_p)
        up = (up & ~(crash | leave)) | rejoin
        age = torch.where(crash | leave, 0, age)
        age = torch.where(rejoin, ALIVE_AGE, age)
        slow = slow & up
        status = torch.where(leave, LEFT, status)
        status = torch.where(rejoin, ALIVE, status)
        inc = torch.where(rejoin, torch.clamp_max(inc + 1, TICK_MAX), inc)
        lh = torch.where(rejoin, 0, lh)
        started = leave | rejoin
        informed = torch.where(started, c.inv_n, informed)
        sttl = torch.where(started, TTL_NEVER, sttl)
        new_rumor = new_rumor | started

    if c.slow_on:
        u_s = u[at[U_SLOW]]
        slow = torch.where(slow, u_s >= col("slow_recover_p"),
                           u_s < col("slow_p")) & up
    slow_eff = (slow | fx.slow_f) & up if frame else slow
    return SimpleNamespace(
        age=age, up=up, slow=slow, slow_eff=slow_eff, status=status,
        inc=inc, informed=informed, slen=slen, sttl=sttl, s_conf=s_conf,
        lh=lh, new_rumor=new_rumor, crash=crash, leave=leave,
        rejoin=rejoin)


def probe_twin(v: SimpleNamespace, sbar, frac_up_elig, live_frac, u_ack,
               c: LaneConsts, col, fx: Optional[FaultFrame]) -> tuple:
    """The prober's side of a period on ``churn_twin``'s nodes ``v`` and
    a point's population terms: ``(g, pf_fast, pf_slow, p_ack, ack, lh)``,
    ``lh`` after the Lifeguard update."""
    frame = fx is not None
    sf = col("slow_factor")
    g = torch.where(v.slow_eff, sf, 1.0).to(_F32)
    if c.lifeguard and (frame or c.slow_on):
        patience = 1.0 - torch.exp2(-v.lh.to(_F32))
    else:
        patience = torch.zeros_like(g)
    if frame:
        rt = fx.psend * fx.precv
        relay_m = rt * fx.mid

    def noack(gj):
        ge_i = g + (1.0 - g) * patience
        ge_j = gj + (1.0 - gj) * patience
        pair2 = ipow(ge_i * ge_j, 2)
        p_d = col("p_direct") * pair2
        ge_p_slow = sf + col("one_minus_slow_factor") * patience
        e_gp4 = (1.0 - sbar) * 1.0 + sbar * ipow(ge_p_slow, 4)
        p_relay1 = live_frac * col("p_relay") * pair2 * e_gp4
        p_tcp = col("p_tcp") * ge_i * ge_j
        if frame:
            p_d = p_d * rt
            p_relay1 = p_relay1 * relay_m
            p_tcp = p_tcp * rt
        p_no_relay = ipow(1.0 - p_relay1, c.indirect_checks)
        return (1.0 - p_d) * p_no_relay * (1.0 - p_tcp)

    pf_fast = noack(torch.tensor(1.0, dtype=_F32))
    pf_slow = noack(sf)
    mix_i = (1.0 - sbar) * pf_fast + sbar * pf_slow
    p_ack = frac_up_elig * (1.0 - mix_i)
    ack = v.up & (u_ack < p_ack)
    failed = v.up & ~ack
    lh = v.lh
    if c.lifeguard:
        lh = _clamp_lh(lh + failed.to(_I32) - ack.to(_I32), col)
    return g, pf_fast, pf_slow, p_ack, ack, lh


def twin(vals, scal, u, slots, c: LaneConsts, tab: torch.Tensor,
         fx: Optional[FaultFrame], stack: torch.Tensor, stats: str = "write",
         inst: bool = True, rule: str = CPU_RULE) -> tuple:
    """The kernel's period in PyTorch, from the constants ``c`` and the
    table ``tab`` under the division ``rule`` (``RULES``): a point's
    terms on 0-d tensors (``[G, 1]`` for a grid), the per-node chain on
    the lanes' shape in the kernel's (and the plain body's) order.
    Writes ``stack`` as the kernel does and returns the 8 new lanes in
    the input dtypes."""
    if rule not in RULES:
        raise ValueError(f"rule must be one of {RULES}; got {rule!r}")
    frame = fx is not None
    byz = frame and fx.attacked is not None
    dev = vals[0].device
    at = {s: i for i, s in enumerate(slots)}
    grid = vals[0].dim() == 2
    col = columns(tab, grid)
    pi = col("probe_interval")
    fanout, oml = col("fanout_ticks"), col("one_minus_loss")

    # the terms every node of a point shares (derive() in the kernel)
    if grid:
        scal = scal.unsqueeze(-1)
    n_live, n_elig, n_up_elig = scal[0], scal[1], scal[2]
    sbar = scal[3] / n_up_elig
    frac_up_elig = n_up_elig / n_elig
    live_frac = by_number(n_live, c.n_f, c.recip_n, rule)
    nl = torch.clamp_min(n_live, 1e-9)
    e_pf_fast, e_pf_slow = scal[4] / nl, scal[5] / nl
    probe_rate = n_live / torch.clamp_min(n_elig - 1.0, 1.0)
    if c.lifeguard:
        scale = scal[6] / scal[7]
        if byz:
            scale = torch.clamp_min(scale, 1.0)
    else:
        scale = torch.ones((), dtype=_F32, device=dev)
    log_den = torch.log(col("confirmation_k") + 1.0)

    def shrink(cc):
        if not c.shrink_on:
            return torch.ones_like(cc, dtype=_F32)
        frac = torch.log(cc.to(_F32) + 1.0) / log_den
        return torch.maximum(1.0 - col("shrink_omr") * frac,
                             col("shrink_r"))

    v = churn_twin(vals, u, at, c, col, fx)
    age, up, slow, slow_eff = v.age, v.up, v.slow, v.slow_eff
    status, inc, informed = v.status, v.inc, v.informed
    slen, sttl, s_conf, new_rumor = v.slen, v.sttl, v.s_conf, v.new_rumor
    crash, leave, rejoin = v.crash, v.leave, v.rejoin
    elig = (status == ALIVE) | (status == SUSPECT)
    eligf = elig.to(_F32)
    g, pf_fast, pf_slow, p_ack, ack, lh = probe_twin(
        v, sbar, frac_up_elig, live_frac, u[at[U_ACK]], c, col, fx)

    base_fail = torch.where(slow_eff, e_pf_slow, e_pf_fast)
    if frame:
        base_fail = 1.0 - (1.0 - base_fail) * fx.suspw
    p_fail_j = torch.where(up, base_fail, 1.0)
    if byz or c.gate_on:
        p_fail_j = p_fail_j * _gate(up, fx, c, col("p_direct"),
                                    col("corroboration_k").to(_I32))
    lam_fail = probe_rate * p_fail_j * eligf
    if byz:
        lam_fail = lam_fail + fx.spur_susp * eligf
    u_pois = u[at[U_POIS]]
    n_fail = torch.zeros_like(lam_fail, dtype=_I32)
    term = torch.exp(-lam_fail)
    cdf = term
    for k in range(1, 5):
        n_fail = n_fail + (u_pois > cdf).to(_I32)
        term = by_number(term * lam_fail, float(k), c.recip_k[k - 1],
                         rule)
        cdf = cdf + term

    sttl = torch.where(status == SUSPECT, sttl - 1, sttl)
    starts = (n_fail > 0) & (status == ALIVE)
    confirms = (n_fail > 0) & (status == SUSPECT)
    c0 = torch.clamp_min(n_fail - 1, 0)
    timeout0 = scale * col("susp_max_s") * shrink(c0)
    ticks0 = torch.ceil(timeout0 / pi if c.div_pi
                        else by_number(timeout0, pi, c.recip_pi, rule))
    len0 = torch.clamp_max(ticks0, float(TICK_MAX)).to(_I32)
    status = torch.where(starts, SUSPECT, status)
    slen = torch.where(starts, len0, slen)
    sttl = torch.where(starts, len0, sttl)
    s_conf = torch.where(starts, c0, s_conf)
    informed = torch.where(starts, c.inv_n, informed)
    new_rumor = new_rumor | starts

    c_new = torch.clamp_max(s_conf + n_fail, CONF_MAX)
    ratio = shrink(c_new) / shrink(s_conf)
    len2 = torch.ceil(slen.to(_F32) * ratio).to(_I32)
    sttl = torch.where(confirms, sttl - (slen - len2), sttl)
    slen = torch.where(confirms, len2, slen)
    s_conf = torch.where(confirms, c_new, s_conf)

    lam_hear = fanout * informed * oml * g
    if frame:
        lam_hear = lam_hear * fx.hear_w
    if byz:
        lam_hear = lam_hear * (1.0 - fx.replay)
    p_hear = 1.0 - torch.exp(-lam_hear)
    wrongly = up & ((status == SUSPECT) | (status == DEAD)) & ~new_rumor
    refute = wrongly & (u[at[U_HEAR]] < p_hear)
    status = torch.where(refute, ALIVE, status)
    inc = torch.where(refute, torch.clamp_max(inc + 1, TICK_MAX), inc)
    informed = torch.where(refute, c.inv_n, informed)
    sttl = torch.where(refute, TTL_NEVER, sttl)
    slen = torch.where(refute, 0, slen)
    s_conf = torch.where(refute, 0, s_conf)
    new_rumor = new_rumor | refute
    if c.lifeguard:
        lh = _clamp_lh(lh + refute.to(_I32), col)

    if byz:
        bump = up & (status == ALIVE) & ~new_rumor \
            & (u[at[U_REPLAY]] < fx.replay)
        inc = torch.where(bump, torch.clamp_max(inc + 1, TICK_MAX), inc)
        informed = torch.where(bump, c.inv_n, informed)
        new_rumor = new_rumor | bump

    declare = (status == SUSPECT) & (sttl <= 0)
    status = torch.where(declare, DEAD, status)
    informed = torch.where(declare, c.inv_n, informed)
    sttl = torch.where(declare, TTL_NEVER, sttl)
    new_rumor = new_rumor | declare
    lat = (age + 1).to(_F32) * pi

    grow = (~new_rumor) & (informed < 1.0)
    lam_g = fanout * informed * oml
    if frame:
        lam_g = lam_g * fx.mid
    if byz:
        lam_g = lam_g * (1.0 - fx.replay)
    informed = torch.where(
        grow, informed + (1.0 - informed) * (1.0 - torch.exp(-lam_g)),
        informed)
    age_out = torch.where(up, torch.where(slow, SLOW_AGE, ALIVE_AGE), age)

    upf2 = up.to(_F32)
    suspect = status == SUSPECT
    elig2 = (status == ALIVE) | suspect
    elig2f = elig2.to(_F32)
    lhf = lh.to(_F32)
    if inst:
        w_fail2 = upf2 * (1.0 - p_ack)
        rows = [upf2, elig2f, upf2 * elig2f,
                (slow_eff & up & elig2).to(_F32), upf2 * pf_fast,
                upf2 * pf_slow, w_fail2 * (lhf + 1.0), w_fail2]
        for i, r in enumerate(rows):
            stack[i] = r
        gauges = [upf2, informed, suspect.to(_F32),
                  (up & (suspect | (status == DEAD))).to(_F32), lhf,
                  inc.to(_F32)] + [(lh >= k).to(_F32) for k in range(1, 9)]
        for i, r in enumerate(gauges):
            stack[GAUGE_ROW + i] = r
    if stats != "skip":
        tp = declare & ~up
        zero = torch.zeros_like(upf2)

        def f(m):
            return zero if m is None else m.to(_F32)

        counters = [f(starts), f(refute), f(declare & up), f(tp),
                    torch.where(tp, lat, 0.0), f(crash), f(rejoin),
                    f(leave)]
        counters += ([f(starts & fx.attacked),
                      f(declare & up & fx.attacked)] if byz
                     else [zero, zero])
        for i, r in enumerate(counters):
            row = stack[STATS_ROW + i]
            row.copy_(row + r if stats == "add" else r)
    outs = (status, inc, informed, age_out, slen, sttl, s_conf, lh)
    return tuple(o.to(v.dtype) for o, v in zip(outs, vals))


def _gate(up: torch.Tensor, fx: Optional[FaultFrame], c: LaneConsts,
          p_direct: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``faults.detection_gate`` for each point's k, as the kernel adds
    it: P(Binom(m, q) >= k), q = p_direct·mid·(1-af), its terms j >= k
    added in order, for k >= 1; (1-af)^m on down nodes and 1 on live ones
    for k = 0."""
    dev = up.device
    m = c.indirect_checks
    one = torch.ones((), dtype=_F32, device=dev)
    af = fx.forge_ack if (fx is not None and fx.forge_ack is not None) \
        else torch.zeros((), dtype=_F32, device=dev)
    mid = fx.mid if fx is not None else one
    q = p_direct * mid * (one - af)
    total = torch.zeros_like(q)
    for j in range(m + 1):
        term = math.comb(m, j) * ipow(q, j) * ipow(1.0 - q, m - j)
        total = torch.where(k <= j, total + term, total)
    return torch.where(k >= 1, torch.clamp(total, 0.0, 1.0),
                       torch.where(up, one, ipow(one - af, m)))
