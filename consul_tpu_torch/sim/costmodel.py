"""Kernel-plane roofline observatory: analytic cost model, counted and
timed attribution, and the perf-regression ledger.

Counterpart of the JAX package's ``consul_tpu/sim/costmodel.py``, in three
layers:

* **Analytic model** (``analytic_cost``): per-round HBM bytes and
  operations per engine config, from the registry and SimParams — the
  packed state's dtypes x N, one f32 write and read per draw site, the
  registry's pinned count of materialised intermediates per engine, the
  lane block table over the pinned reduction budget, and the flight and
  black-box rows under decimation. The numbers are the reference's on the
  same params: the port's engines are ``xla``, ``fast``, ``lanes``,
  ``overlap`` and ``cuda``, and ``cuda`` reads the registry's ``pallas``
  entries (the registry keeps the reference's engine tuple, which its
  layout digest folds in). Beside it, ``kernel_bound``: the bytes and
  operations of one launch of the CUDA round kernels, and the least time
  the H100 could take for them.

* **Counted and timed attribution** (``measure_bandwidth``,
  ``measured_cost``, ``measure_config``, ``roofline_table``): a copy and
  triad on the run's device give its achievable bandwidth; each engine
  config is timed on its real runner, and its per-round bytes are
  COUNTED — for the eager engines by ``OpCounter``, which adds up the
  bytes of every aten op's tensor inputs and outputs, over the marginal
  difference of a k- and a 2k-round run (init work cancels); for the
  kernel runner by ``kernel_bound`` over the runner's launch inputs, one
  call's bytes over its R rounds (the megakernel moves the state once a
  call). Both are counts, as XLA's "bytes accessed" is a count, not
  hardware counters: they say what the program asks the memory for, not
  what the caches let through. Roofline utilisation is achieved bytes/s
  over the measured peak; a model-vs-counted ratio beyond
  ``registry.COSTMODEL_BOUND`` is flagged.

* **Perf-regression ledger** (``load_ledger``, ``history_rows``,
  ``check_regression``): every ``<FAMILY>_r<NN>.json`` under a record
  root loads and validates by family (a broken record fails by file and
  key), ``history_rows`` gives one trajectory row per record, and
  ``check_regression`` compares fresh samples against the latest record
  of a metric under the median+IQR refusal band. The validators are the
  reference's, so a record either package writes, the other accepts.
  ``latest_twin_guard``, ``latest_users_guard`` and
  ``latest_raft_guard`` read the baseline each family's guard re-runs.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import time
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from consul_tpu_torch.sim import (coord_kernel, cuda_round, fused, graphs,
                                  lane_kernel, prng, registry)
from consul_tpu_torch.sim.flight import FLIGHT_COLUMNS, trace_bytes
from consul_tpu_torch.sim.round import (make_run_rounds, make_run_rounds_fast,
                                        make_run_rounds_lanes)
from consul_tpu_torch.sim.state import NODE_FIELDS, SimState, init_state
from consul_tpu_torch.utils.platform import default_device, device_name

# ------------------------------------------------------ analytic model

#: the port's engines: the live (``xla``) and stale-scalar (``fast``)
#: PyTorch engines, the lane engine synchronous and overlapped, and the
#: CUDA kernel runner (``cuda``: ``round_kernel`` at R=1, ``mega_kernel``
#: at R > 1), which the registry's tables carry as ``pallas``
ENGINES = ("xla", "fast", "lanes", "overlap", "cuda")
_REGISTRY_ENGINE = {"cuda": "pallas"}

#: the SimState per-node field widths (bytes), from the digest-pinned
#: packed layout; the tests hold it against the real init_state leaves
STATE_FIELD_BYTES = tuple(
    (name, nbytes) for name, _, nbytes in registry.STATE_PACKED_FIELDS)

#: model bytes per node per draw site: one f32 uniform vector
#: materialised (4 B write) and consumed (4 B read)
_DRAW_BYTES = 8

_VECS = dict(registry.COSTMODEL_INTERMEDIATE_VECS)
_FLOPS = dict(registry.COSTMODEL_FLOPS)


def state_bytes_per_node() -> int:
    """Per-node state bytes from the declared dtype table."""
    return sum(b for _, b in STATE_FIELD_BYTES)


def n_draw_sites(p) -> int:
    """Per-round per-node uniform draw sites the round body executes for
    these params (ack, suspicion-arrival Poisson and refutation hearing
    always; churn and the slow-node model each add one gated draw)."""
    draws = 3
    if p.fail_per_round or p.rejoin_per_round or p.leave_per_round:
        draws += 1
    if p.slow_per_round:
        draws += 1
    return draws


def reductions_per_run(rounds: int, stale_k: int,
                       overlap: bool = False) -> int:
    """The pinned lane-reduction budget for an R-round run: one per
    window plus the two staged init_lanes reductions, plus the overlap
    schedule's drain fold."""
    return -(-rounds // max(1, stale_k)) + 2 + (1 if overlap else 0)


def analytic_cost(p, rounds: int, engine: str = "lanes",
                  record_every: Optional[int] = None,
                  blackbox: bool = False,
                  rounds_per_call: int = 1) -> dict[str, Any]:
    """The analytic per-round cost of one engine config: itemized byte
    terms (``registry.COSTMODEL_BYTE_TERMS`` order), their total, an
    operation estimate and the arithmetic intensity. The lane engines
    read ``p.stale_k``, the kernel runner ``rounds_per_call``. Equal, key
    for key, to the reference's ``analytic_cost`` with ``cuda`` in the
    place of ``pallas``."""
    if engine not in ENGINES:
        raise ValueError(
            f"unknown cost-model engine {engine!r} (expected one of "
            f"{', '.join(ENGINES)})")
    reg = _REGISTRY_ENGINE.get(engine, engine)
    n = p.n
    k = p.stale_k if engine in ("lanes", "overlap") else 1
    state_rw = 2 * state_bytes_per_node() * n
    draws = _DRAW_BYTES * n_draw_sites(p) * n
    vecs = float(_VECS[reg])
    if k > 1:
        vecs += registry.COSTMODEL_WINDOW_VECS * (k - 1) ** 2 / k
    intermediates = 8.0 * vecs * n
    flops = float(_FLOPS[reg]) * n
    if k > 1:
        flops += registry.COSTMODEL_FLOP_WINDOW * (k - 1) ** 2 / k * n

    # the lane block table, amortized over the pinned reduction budget
    lane_reduce = 0.0
    collectives = 0
    if engine in ("lanes", "overlap"):
        collectives = reductions_per_run(rounds, k, engine == "overlap")
        payload = registry.N_REDUCE_LANES * registry.LANE_BLOCKS * 4
        lane_reduce = payload * collectives / rounds
    elif engine == "cuda":
        # the kernels' partials table accumulates the stat lanes once
        # per call
        payload = registry.N_REDUCE_LANES * registry.LANE_BLOCKS * 4
        lane_reduce = payload / max(1, rounds_per_call)

    flight = trace_bytes(rounds, record_every) / rounds \
        if record_every else 0.0
    bb = 0.0
    if blackbox and record_every:
        # K tracked agents, one int32[4] record per event, a handful of
        # events per tracked agent per recorded window
        bb = p.blackbox_k * 4 * 4 * 2 / record_every

    terms = {"state_rw": float(state_rw), "uniform_draws": float(draws),
             "intermediates": intermediates, "lane_reduce": lane_reduce,
             "flight": flight, "blackbox": bb}
    assert set(terms) == set(registry.COSTMODEL_BYTE_TERMS)
    total = sum(terms.values())
    return {
        "engine": engine,
        "n": n,
        "stale_k": k,
        "rounds_per_call": rounds_per_call if engine == "cuda" else 1,
        "terms": terms,
        "bytes_per_round": total,
        "bytes_per_round_per_node": total / n,
        "flops_per_round": flops,
        "arithmetic_intensity": flops / total,
        "collectives_per_round": (collectives / rounds
                                  if collectives else 0.0),
    }


def config_label(engine: str, stale_k: int = 1,
                 rounds_per_call: int = 1,
                 lane_blocks: Optional[int] = None) -> str:
    label = engine
    if engine in ("lanes", "overlap") and stale_k != 1:
        label = f"{engine}-k{stale_k}"
    if engine == "cuda" and rounds_per_call != 1:
        label = f"cuda-x{rounds_per_call}"
    if engine == "lanes" and lane_blocks is not None \
            and lane_blocks != registry.LANE_BLOCKS:
        label = f"{label}-b{lane_blocks}"
    return label


# ------------------------------------------------- the kernels' count

#: H100 SXM peaks: HBM3 bandwidth and f32 arithmetic outside the tensor
#: cores (67 TFLOP/s, NVIDIA data sheet), and 32-bit integer
#: arithmetic, which the data sheet does not give: 64 INT32 lanes on
#: each of the 132 SMs (H100 white paper) at the 1.98 GHz boost clock.
#: Integer and f32 operations run on separate lanes, so the bound by
#: operations is the larger of the two types' times. The operation
#: counts below model only a part of the body (``kernel_bound``), so
#: that bound is a lower bound, and a low one where the body's
#: uncounted control flow dominates (the megakernel).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: instructions issued: 4 warp-instructions a clock on each SM (one a
#: scheduler), whatever pipe runs them (H100 white paper)
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9

#: integer operations of one Philox4x32-10 call on the card, which gives
#: four words: per round two widening multiplies and two three-input
#: xors. The key schedule depends only on seeds[r] and is shared by
#: every call, so no call pays for it.
PHILOX_INT_OPS = 10 * (2 + 2)
#: integer operations to make a uniform of one word: the shift and the
#: int->float conversion
DRAW_INT_OPS = 2
#: f32 operations that every node does in a period, whatever its state,
#: where the no-ack and Poisson terms are per node (the fault and byz
#: variants; counted from node_round in round_kernels.cu): two no-ack
#: evaluations (13 each), the ack mix and test (6), the truncated
#: Poisson's rate, exp and four terms (20), the 8 scalar lanes (8). The
#: suspicion timeouts, refutation, epidemic growth, patience, slow and
#: stats terms are left out: their count depends on the data, so the
#: bound does not claim them.
BODY_F32_OPS = 2 * 13 + 6 + 20 + 8
#: the same in the honest variants, which read the no-ack terms, p_ack
#: and the Poisson thresholds from the block's tables: the ack test (1),
#: four threshold compares (4), the miss weight 1 - p_ack (1) and the 8
#: scalar lanes (8)
TABLE_BODY_F32_OPS = 1 + 4 + 1 + 8
#: f32 operations a fault frame adds to every node's period: the four
#: churn-rate sums, the round trip and relay factor (2), their three
#: products in each no-ack evaluation (6), the suspicion-weighted miss
#: (3). A byzantine frame adds the spurious-suspicion arrivals (2). The
#: detection gate, the refutation and growth factors are left out, like
#: the other data-dependent terms.
FAULT_F32_OPS = 4 + 2 + 6 + 3
BYZ_F32_OPS = 2


def kernel_bound(p, arrays, rounds=1, fx=None, out=None) -> dict:
    """The least time one launch of ``rounds`` periods on ``arrays``
    could take: the larger of its bytes (each input read once, each
    output written once: state, fault frame, scalars, seeds, partials)
    over the HBM rate and its modelled operations, integer ones over
    ``INT32_OPS_PER_S`` and f32 ones over ``F32_OPS_PER_S``: a lower
    bound, since the model counts the random draws and the f32 body
    terms named below, not the loads' unpacking, the branches and the
    state updates.

    Philox calls counted, as this input needs them: call 0 of every
    node and round (it serves churn, slow, ack and Poisson), and on a
    byzantine frame call 1 of every live node whose replay pressure is
    positive; the call 1 of wrongly suspected nodes (refutation) is left
    out. Draws, each a shift and a conversion: every node's Poisson
    draw, every node's churn and slow draws where those models are on (a
    fault frame always draws churn), the ack draw of every live node and
    the replay draws above. The honest variants read their no-ack and
    Poisson terms from tables (``TABLE_BODY_F32_OPS``), the fault ones
    compute them per node (``BODY_F32_OPS``). Liveness moves only under
    churn: the live count comes from the input without churn, and from
    ``out`` (the plain version's output on this input: liveness is final
    once churn is drawn) for a single fault round; a churn config without
    a frame is refused."""
    if fx is None and p.has_churn:
        raise ValueError("kernel_bound counts live nodes from the input, "
                         "which churn would change within the call")
    if fx is not None and (rounds != 1 or out is None):
        raise ValueError("a fault frame shapes one round: pass rounds=1 "
                         "and the plain version's output as out=")
    rows = arrays[0].shape[0]
    age = arrays[3]
    node_bytes = sum(a.element_size() for a in arrays)
    mutable = p.age_mutable or fx is not None
    written = node_bytes - (0 if mutable else age.element_size())
    frame_bytes = 0
    if fx is not None:
        lanes = [a for a in fx if a is not None and a.dim() == 1]
        frame_bytes = sum(a.element_size() for a in lanes)
    state_bytes = rows * (node_bytes + written)
    nbytes = state_bytes + rows * frame_bytes \
        + 4 * cuda_round.N_SCALARS + 4 * rounds \
        + 4 * cuda_round.N_LANES * cuda_round.partials_rows(rows) \
        + (4 if fx is not None else 0)
    calls = rows
    if fx is None:
        draws = rows * (1 + int(p.enabled("slow_per_round"))) \
            + int((age < 0).sum())
        f32_ops = rounds * rows * TABLE_BODY_F32_OPS
    else:
        up = out[3] < 0
        draws = rows * (2 + int(p.enabled("slow_per_round"))) \
            + int(up.sum())
        per_node = BODY_F32_OPS + FAULT_F32_OPS
        if fx.attacked is not None:
            replays = int((up & (fx.replay > 0)).sum())
            calls += replays
            draws += replays
            per_node += BYZ_F32_OPS
        f32_ops = rows * per_node
    int_ops = rounds * (calls * PHILOX_INT_OPS + draws * DRAW_INT_OPS)
    return {"state_bytes": state_bytes, "frame_bytes": rows * frame_bytes,
            "philox_calls": rounds * calls, "draws": rounds * draws,
            **_bound(nbytes, int_ops, f32_ops)}


def _bound(nbytes: int, int_ops: float, f32_ops: float) -> dict:
    """The larger of ``nbytes`` over the HBM rate and the operations
    over their rates (integer and f32 lanes run side by side)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return {"bytes": nbytes, "int32_ops": int_ops, "f32_ops": f32_ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


#: integer operations of one Threefry-2x32 evaluation on the card: 20
#: rotations of an add, a funnel shift and a xor, 5 key injections of
#: two adds, the first injection's two adds (the key schedule's third
#: word is made once a row, so no word pays for it)
THREEFRY_INT_OPS = 20 * 3 + 5 * 2 + 2
#: integer operations a word's output adds, by draw mode: the xor, the
#: shift, the int -> float conversion
DRAW_MODE_INT_OPS = {"words": 0, "xor": 1, "seeds": 2, "uniform": 3,
                     "u01_global": 2}
#: f32 operations a uniform word's scaling adds to its conversion's one
#: product: none, a product, a sum and a max (power-of-two width), or
#: the max alone (the f64 product and sum are not counted)
SCALE_F32_OPS = {"unit": 0, "pow2": 3, "f64": 1}
#: instructions one Threefry-2x32 evaluation issues at the least: each
#: of the 20 rounds an add, a funnel shift and an xor (no instruction
#: does two of them), the 5 key injections into word 1, the last one
#: into word 0 (the others ride the next round's add as one three-input
#: add), the counter's add. A mode that reads word 0 alone
#: (``u01_global``) drops the last round's rotation, xor and injection
#: into word 1.
THREEFRY_INSTRUCTIONS = 20 * 3 + 5 + 1 + 1
WORD0_DROPS = 3


def draw_bound(d: "fused.Draw") -> dict:
    """The least time one launch of the draw kernel on ``d`` could take:
    its operands read once (``d.raw``: keys, counter data, base) and its
    output written once, over the HBM rate; its instructions over the
    card's issue rate (``ISSUE_PER_S``): a word's Threefry evaluation
    (``THREEFRY_INSTRUCTIONS``), its output's integer and f32 operations
    (``DRAW_MODE_INT_OPS``, the uniform's product and
    ``SCALE_F32_OPS``), and a derived key's evaluation, once a row for a
    table word and once a word for the generated index. Every pipe
    issues from the same 4 schedulers an SM, so no count of one pipe's
    operations is a lower bound: the kernel moves adds to the FMA pipe.
    ``int32_ops`` and ``int32_bound_ms`` keep the count PR 12 bounded
    by, 72 integer operations a Threefry at the integer lanes' rate,
    which the kernel beats on long draws (PERF.md §6, PR 14)."""
    words = math.prod(d.shape)
    nbytes = sum(t.numel() * t.element_size() for t in d.raw) \
        + fused.draw_out_bytes(d)
    derived = words if d.derive_gen else \
        math.prod(d.shape[:-1]) if d.derive else 0
    f32_ops = words * (1 + SCALE_F32_OPS[d.scale]) \
        if d.mode in ("uniform", "u01_global") else 0
    instructions = words * (
        THREEFRY_INSTRUCTIONS + DRAW_MODE_INT_OPS[d.mode]
        - (WORD0_DROPS if d.mode == "u01_global" else 0)) \
        + f32_ops + derived * THREEFRY_INSTRUCTIONS
    int_ops = words * (THREEFRY_INT_OPS + int(d.gen)
                       + DRAW_MODE_INT_OPS[d.mode]) \
        + derived * THREEFRY_INT_OPS
    old = _bound(nbytes, int_ops, f32_ops)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = instructions / ISSUE_PER_S * 1e3
    return {"words": words, "bytes": nbytes, "instructions": instructions,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "int32_ops": int_ops, "int32_bound_ms": old["bound_ms"]}


def draw_instructions_per_word(mode: str, scale: str = "unit") -> int:
    """``draw_bound``'s instructions a word of a draw with no derived
    key (the env phase holds it under the kernel's own SASS a word)."""
    return THREEFRY_INSTRUCTIONS + DRAW_MODE_INT_OPS[mode] \
        - (WORD0_DROPS if mode == "u01_global" else 0) \
        + ((1 + SCALE_F32_OPS[scale])
           if mode in ("uniform", "u01_global") else 0)


def sum_bound(rows: int, length: int) -> dict:
    """The least time a ``tree_sum`` of ``rows`` f32 rows of ``length``
    could take: every element read once, one f32 a row written, and
    ``length - 1`` additions a row."""
    return _bound(4 * rows * (length + 1), 0, rows * (length - 1))


def flight_bound(arrays) -> dict:
    """The least time one ``flight_row`` launch could take: the five
    packed lanes a row reads (status, incarnation, informed, down_age,
    local_health; 10 B a node) read once and the f32 row written once,
    over the HBM rate. Its counters, clock and snapshot are a few dozen
    bytes and its operations a handful a node; neither is counted."""
    rows = arrays[0].shape[0]
    lanes = (0, 1, 2, 3, 7)
    read = rows * sum(arrays[i].element_size() for i in lanes)
    written = 4 * len(FLIGHT_COLUMNS)
    return {"read_bytes": read, "written_bytes": written,
            **_bound(read + written, 0, 0)}


def lane_bound(vals, u, fx=None, stats: str = "write",
               inst: bool = True) -> dict:
    """The least time one ``lane_round`` launch could take, from its
    inputs and outputs: the packed state lanes ``vals`` (``[N]`` or
    ``[G, N]``), the slot rows ``u``, the 8 scalars and the constant
    table's row of each point, and the frame ``fx``'s lanes read once,
    the stack's counter rows read once more when ``stats`` is "add"; the
    state lanes and the stack rows the launch writes (the 22
    instantaneous rows with ``inst``, the 10 counter rows unless
    "skip") written once; over the HBM rate. Its operations: the f32
    body terms every node does (``BODY_F32_OPS``, and a frame's
    ``FAULT_F32_OPS`` / ``BYZ_F32_OPS``: the per-node no-ack and Poisson
    terms), over the f32 rate; no integer work is counted."""
    rows = vals[0].numel()
    points = math.prod(vals[0].shape[:-1])
    node = sum(a.element_size() for a in vals)
    frame = 0 if fx is None else sum(
        a.numel() * a.element_size() for a in fx
        if isinstance(a, torch.Tensor))
    counters = len(registry.STATS_FIELDS)
    stack_rows = (registry.N_REDUCE_LANES - counters if inst else 0) \
        + (counters if stats != "skip" else 0)
    read = rows * node + u.numel() * u.element_size() \
        + 4 * (8 + len(lane_kernel.COLUMNS)) * points + frame \
        + (4 * counters * rows if stats == "add" else 0)
    written = rows * node + 4 * stack_rows * rows
    per_node = BODY_F32_OPS
    if fx is not None:
        per_node += FAULT_F32_OPS + (BYZ_F32_OPS if fx.attacked is not None
                                     else 0)
    return {"read_bytes": read, "written_bytes": written,
            **_bound(read + written, 0, rows * per_node)}


#: the state lanes each stage of a live period needs (``live_kernel``):
#: a churns and tests the slow model (status, down_age), b adds the
#: Lifeguard update (local_health), c the whole period
LIVE_STAGE_LANES = (("status", "down_age"),
                    ("status", "down_age", "local_health"), None)
#: the slots each stage reads, of those the round draws (c all of them)
LIVE_STAGE_SLOTS = ((0, 1), (0, 1, 2), None)


def live_bound(vals, slots: tuple, stage: int, stats: bool,
               churn: bool) -> dict:
    """The least time one launch of live-period stage ``stage`` (0, 1, 2:
    a, b, c) could take, in bytes over the HBM rate: the state lanes
    and drawn slot rows it needs (``LIVE_STAGE_LANES``,
    ``LIVE_STAGE_SLOTS``), its sums and the constant table's row read
    once; its 4 sum rows (a, b) or the new lanes and, with ``stats``,
    the counter rows (c: the latency and the first four counters, the
    three churn counters under ``churn``) written once."""
    rows = vals[0].numel()
    lanes = LIVE_STAGE_LANES[stage] or NODE_FIELDS
    node = sum(a.element_size() for f, a in zip(NODE_FIELDS, vals)
               if f in lanes)
    want = LIVE_STAGE_SLOTS[stage]
    drawn = sum(1 for s in slots if want is None or s in want)
    read = rows * (node + 4 * drawn) + 4 * (4 * stage
                                            + len(lane_kernel.COLUMNS))
    if stage < 2:
        written = rows * 4 * 4
    else:
        written = rows * (sum(a.element_size() for a in vals)
                          + (4 * (5 + 3 * churn) if stats else 0))
    return {"read_bytes": read, "written_bytes": written,
            **_bound(read + written, 0, 0)}


#: bytes an agent's coordinate rows take in one point: the ``[8]``
#: position, error, height, the ``[20]`` ring and its cursor (the
#: adjustment is rewritten from the ring, never read by the relaxation)
COORD_ROW_BYTES = 4 * coord_kernel.DIMS + 4 + 4 + 4 * coord_kernel.WINDOW \
    + 4


def coord_bound(n: int, points: int = 0, topo_dims: int = 4,
                deadlines: bool = True) -> dict:
    """The least time each coordinate launch (``coord_kernel.NAMES``)
    could take at ``n`` agents (``points`` > 0: a grid of that many),
    in bytes over the HBM rate, each input read once and each output
    written once, whatever a launch reads again (a target's rows):

    * ``coord_probe`` — the latency map (a ``topo_dims`` row and a
      height an agent), the pairs and the jitter normal in, the round
      trips out; with ``deadlines`` the random probers, and a point's
      positions, heights, adjustments and local health in, ``timely``
      (1 B) and ``late_in`` out;
    * ``vivaldi_relax`` — the pairs and round trips, a point's rows
      (``COORD_ROW_BYTES``) and its two gates in; its new rows, the
      adjustment, the gate and the moved distance out. The direction
      draws are read only for coincident agents (a cold start) and are
      not counted;
    * ``coord_quality`` — the latency map and the pairs, a point's
      positions, heights and adjustments in, the relative error out.

    Their operations (a few dozen f32 terms an agent) are not counted."""
    g = max(points, 1)
    map_bytes = 4 * topo_dims + 4
    estimate = 4 * coord_kernel.DIMS + 4 + 4
    probe = n * (map_bytes + 4 + 4 + 4)
    if deadlines:
        probe += n * 4 + g * n * (estimate + 4 + 1 + 4)
    relax = n * (4 + 4) + g * n * (
        COORD_ROW_BYTES + 1 + 1 + COORD_ROW_BYTES + 4 + 1 + 4)
    quality = n * (map_bytes + 4) + g * n * (estimate + 4)
    return {name: _bound(b, 0, 0) for name, b in zip(
        coord_kernel.NAMES, (probe, relax, quality))}


# ---------------------------------------- counted and timed attribution


class EngineUnavailable(ValueError):
    """An engine that cannot run on the requested device: the kernel
    runner off the card (its wrappers would time the plain versions).
    The roofline table and the autotuner record such a point as a
    skipped row; every other failure propagates."""


class OpCounter(TorchDispatchMode):
    """Counts what the eager engines ask the memory for: for every aten
    op, the bytes of its tensor inputs and outputs (``bytes``) and the
    element count of its outputs (``ops``), each tensor at numel x
    element size. View ops are left out: their output aliases their
    input and moves nothing (XLA counts no bytes for a bitcast). A
    count, like XLA's per-HLO "bytes accessed": a broadcast input counts
    its full size, an in-place op its operand twice (read and write),
    and nothing is known of caches. A launch of the draw or sum kernels
    (``fused``), which dispatches no aten op, adds its operands and
    outputs the same way (``add``), each counted once: the kernel reads
    a broadcast key once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.calls = 0

    def __enter__(self):
        fused.OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        fused.OBSERVERS.remove(self)
        return super().__exit__(*exc)

    def add(self, ins, outs) -> None:
        """Count one call that read tensors ``ins`` and wrote ``outs``."""
        self.bytes += sum(t.numel() * t.element_size()
                          for t in list(ins) + list(outs))
        self.ops += sum(t.numel() for t in outs)
        self.calls += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.add([t for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)],
                     [t for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)])
        return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lane_k(engine: str, p) -> int:
    return p.stale_k if engine in ("lanes", "overlap") else 1


def measured_cost(p, engine: str, lane_blocks=None,
                  rounds_per_call: int = 1, device=None,
                  state: Optional[SimState] = None
                  ) -> tuple[float, float]:
    """Per-round (bytes, operations) the engine's program asks for.

    The eager engines (xla, fast, lanes, overlap) keep the reference's
    marginal protocol: a k- and a 2k-round run (k = the lane cadence)
    from fresh states, each under ``OpCounter`` and run eagerly
    (``graphs.eager()``: a replayed CUDA graph dispatches no op, so the
    count is of the ops the graph holds), differenced, so init
    work (init_scalars, the staged init_lanes reductions, the key
    stream's set-up) cancels and the steady-state round remains. The
    kernel runner (``cuda``) runs nothing: its bytes and operations are
    ``kernel_bound``'s over its launch inputs (``state``, or a fresh
    one), one call's over its R rounds."""
    dev = default_device(device)
    if engine == "cuda":
        s = state if state is not None else init_state(p.n, device=dev)
        kb = kernel_bound(p, s.node_arrays(), rounds_per_call)
        return (kb["bytes"] / rounds_per_call,
                (kb["int32_ops"] + kb["f32_ops"]) / rounds_per_call)
    k = _lane_k(engine, p)
    key = prng.key(0, device=dev)
    counts = []
    for r in (k, 2 * k):
        run = _runner(p, engine, r, 1, lane_blocks)
        s = init_state(p.n, device=dev)
        # a replayed graph dispatches no aten op: count an eager call
        with graphs.eager(), OpCounter() as c:
            run(s, key)
        counts.append(c)
    return ((counts[1].bytes - counts[0].bytes) / k,
            (counts[1].ops - counts[0].ops) / k)


def _time_ms(fn, dev: torch.device) -> float:
    """One call of ``fn``: CUDA events on the card, the host clock on
    the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def measure_bandwidth(mbytes: int = 64, reps: int = 5,
                      device=None) -> dict[str, Any]:
    """Achievable memory bandwidth on the run's device: a copy and a
    STREAM triad (``a + 0.5 b``) over ``mbytes``-MB f32 tensors, best of
    ``reps`` after a warm-up, timed with CUDA events on the card.
    ``peak_gbps`` — the larger of the two — is the roofline's
    denominator: a ceiling measured on this device, not a data sheet's.
    The row names the device type and the card."""
    dev = default_device(device)
    n = mbytes * (1 << 20) // 4
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = torch.ones(n, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)

    def copy():
        out.copy_(x)

    def triad():
        torch.add(x, y, alpha=0.5, out=out)

    copy()
    triad()
    _sync(dev)
    best_c = min(_time_ms(copy, dev) for _ in range(reps))
    best_t = min(_time_ms(triad, dev) for _ in range(reps))
    copy_gbps = 2 * n * 4 / (best_c / 1e3) / 1e9
    triad_gbps = 3 * n * 4 / (best_t / 1e3) / 1e9
    return {
        "mbytes": mbytes,
        "copy_gbps": round(copy_gbps, 2),
        "triad_gbps": round(triad_gbps, 2),
        "peak_gbps": round(max(copy_gbps, triad_gbps), 2),
        "platform": dev.type,
        "device": device_name(dev),
    }


def _runner(p, engine: str, rounds: int, rounds_per_call: int,
            lane_blocks=None):
    """The real runner of an engine config, as production runs it:
    ``run(state, key) -> state``. ``lane_blocks`` is the lane engine's
    block-table width (the autotuner's block-shape axis)."""
    if engine != "lanes" and lane_blocks is not None:
        raise ValueError(
            f"lane_blocks is the lanes engine's block-shape knob; "
            f"engine {engine!r} has no block table to resize")
    if engine == "xla":
        return make_run_rounds(p, rounds)
    if engine == "fast":
        return make_run_rounds_fast(p, rounds)
    if engine in ("lanes", "overlap"):
        return make_run_rounds_lanes(p, rounds,
                                     overlap=engine == "overlap",
                                     lane_blocks=lane_blocks)
    if engine == "cuda":
        return cuda_round.make_run_rounds_cuda(
            p, rounds, rounds_per_call=rounds_per_call)
    raise ValueError(f"unknown engine {engine!r}")


def measure_config(p, rounds: int = 24, engine: str = "lanes",
                   rounds_per_call: int = 1, reps: int = 3,
                   peak_gbps: Optional[float] = None,
                   measure_bytes: bool = True,
                   lane_blocks: Optional[int] = None,
                   return_samples: bool = False,
                   perf_registry=None, device=None) -> dict[str, Any]:
    """Measure ONE engine config end to end — the seam the autotuner
    (``sim/autotune.py``) sweeps.

    The real runner runs from a fresh state: two untimed warm-up calls
    (the first builds the kernels and fills PyTorch's caches; on the
    card the second captures the runner's CUDA graph), then ``reps``
    timed calls, each ended by a device reduce read back as a scalar
    (``float(state.informed.sum())``).
    Returns the ``registry.PROFILE_ROOFLINE_ROW`` dict: best ms/round,
    the analytic model's bytes, the counted bytes and operations
    (``measured_cost``; skipped with ``measure_bytes=False``), their
    ratio and the flag beyond ``COSTMODEL_BOUND``, achieved GB/s of the
    counted bytes (the model's when not counted), the utilisation
    against ``peak_gbps`` (None skips it), and on the card the peak
    device memory the warm-up calls allocated above the state
    (``temp_bytes_measured``; None on the CPU). Every timed rep is
    observed as ``sim.round.<config>`` by ``perf_registry`` (an object
    with ``.observe(name, seconds)``; None records nothing).

    ``cuda`` on a CPU device raises ``EngineUnavailable``: its wrappers
    would time the plain PyTorch versions, not the kernels."""
    dev = default_device(device)
    k = _lane_k(engine, p)
    if rounds % max(k, rounds_per_call):
        raise ValueError(
            f"rounds={rounds} must be a multiple of the reduction "
            f"cadence (stale_k={k}, rounds_per_call={rounds_per_call})")
    if engine == "cuda" and dev.type != "cuda":
        raise EngineUnavailable(
            "the cuda engine launches the CUDA round kernels, which run "
            f"only on a card; on {dev.type} its wrappers would time the "
            "plain PyTorch versions")
    label = config_label(engine, k, rounds_per_call, lane_blocks)
    model = analytic_cost(p, rounds, engine,
                          rounds_per_call=rounds_per_call)
    run = _runner(p, engine, rounds, rounds_per_call, lane_blocks)
    key = prng.key(0, device=dev)
    s0 = init_state(p.n, device=dev)
    on_card = dev.type == "cuda" and measure_bytes
    if on_card:
        _sync(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    # warm-up: kernels built, caches filled, the CUDA graph captured
    s = run(run(s0, key), prng.fold_in(key, reps + 1))
    _sync(dev)
    temp_measured = (torch.cuda.max_memory_allocated(dev) - base
                     if on_card else None)
    bytes_measured = flops_measured = None
    if measure_bytes and engine == "cuda":
        bytes_measured, flops_measured = measured_cost(
            p, engine, rounds_per_call=rounds_per_call, device=dev,
            state=s)
    best = float("inf")
    samples_ms = []
    for i in range(reps):
        t0 = time.perf_counter()
        s = run(s, prng.fold_in(key, i + 1))
        checksum = float(s.informed.sum())   # end-to-end honest
        dt = time.perf_counter() - t0
        if not checksum > 0:
            raise RuntimeError(f"{label}: checksum {checksum} after a "
                               "timed rep")
        best = min(best, dt)
        samples_ms.append(dt / rounds * 1e3)
        if perf_registry is not None:
            perf_registry.observe(f"sim.round.{label}", dt / rounds)
    ms_per_round = best / rounds * 1e3

    if measure_bytes and engine != "cuda":
        bytes_measured, flops_measured = measured_cost(
            p, engine, lane_blocks, device=dev)

    bytes_model = model["bytes_per_round"]
    ratio = None if not bytes_measured else bytes_measured / bytes_model
    flagged = bool(ratio is not None
                   and not (1.0 / registry.COSTMODEL_BOUND
                            <= ratio <= registry.COSTMODEL_BOUND))
    bytes_eff = bytes_measured if bytes_measured else bytes_model
    achieved_gbps = bytes_eff / (ms_per_round / 1e3) / 1e9
    if engine in ("lanes", "overlap"):
        blocks = lane_blocks if lane_blocks is not None \
            else registry.LANE_BLOCKS
    else:
        blocks = None   # no block table in this engine
    extra = {}
    if return_samples:
        # the --check-regression --family PROFILE protocol: every rep's
        # ms/round, not best-of — the refusal band needs the spread
        extra["samples_ms_per_round"] = [round(x, 4) for x in samples_ms]
    return {
        **extra,
        "config": label,
        "engine": engine,
        "stale_k": k,
        "rounds_per_call": rounds_per_call,
        "lane_blocks": blocks,
        "ms_per_round": round(ms_per_round, 4),
        "rounds_per_sec": round(1e3 / ms_per_round, 1),
        "bytes_model": round(bytes_model, 1),
        "bytes_measured": (None if bytes_measured is None
                           else round(bytes_measured, 1)),
        "model_vs_measured": None if ratio is None else round(ratio, 3),
        "flagged": flagged,
        "flops_model": round(model["flops_per_round"], 1),
        "flops_measured": (None if flops_measured is None
                           else round(flops_measured, 1)),
        "temp_bytes_measured": (None if temp_measured is None
                                else float(temp_measured)),
        "arithmetic_intensity": round(model["arithmetic_intensity"], 4),
        "achieved_gbps": round(achieved_gbps, 3),
        "util": (None if not peak_gbps
                 else round(achieved_gbps / peak_gbps, 4)),
        "collectives_per_round": round(model["collectives_per_round"], 4),
    }


#: the --profile roofline ladder: (engine, stale_k, rounds_per_call) —
#: xla, fast, lanes at stale_k 1/2/4, overlap at 4, and the kernel
#: runner at R 1/4/8. Six measure on a CPU device; the cuda rows record
#: their skip there
ROOFLINE_CONFIGS = (
    ("xla", 1, 1),
    ("fast", 1, 1),
    ("lanes", 1, 1),
    ("lanes", 2, 1),
    ("lanes", 4, 1),
    ("overlap", 4, 1),
    ("cuda", 1, 1),
    ("cuda", 1, 4),
    ("cuda", 1, 8),
)


def roofline_table(p, rounds: int = 24, reps: int = 3,
                   bandwidth: Optional[dict] = None,
                   configs=ROOFLINE_CONFIGS, device=None) -> dict[str, Any]:
    """Measure the engine ladder against the measured roofline.

    ``p`` is the base (stale_k=1) SimParams; each config derives its
    own, and its rounds round down to its cadence. A config whose engine
    cannot run on this device (``EngineUnavailable``: the kernel runner
    off the card) records ``{"config", "engine", "stale_k",
    "rounds_per_call", "skipped"}``; any other failure raises. Returns
    {bandwidth, rows, flags}; ``flags`` names every row whose
    model-vs-counted ratio left ``COSTMODEL_BOUND``."""
    dev = default_device(device)
    if bandwidth is None:
        bandwidth = measure_bandwidth(device=dev)
    rows = []
    for engine, k, rpc in configs:
        pk = p.with_(stale_k=k) if engine in ("lanes", "overlap") else p
        cadence = max(k, rpc)
        r = rounds if rounds % cadence == 0 \
            else cadence * max(1, rounds // cadence)
        try:
            rows.append(measure_config(
                pk, rounds=r, engine=engine, rounds_per_call=rpc,
                reps=reps, peak_gbps=bandwidth["peak_gbps"], device=dev))
        except EngineUnavailable as e:
            rows.append({"config": config_label(engine, k, rpc),
                         "engine": engine, "stale_k": k,
                         "rounds_per_call": rpc,
                         "skipped": f"{type(e).__name__}: {e}"})
    flags = [r["config"] for r in rows if r.get("flagged")]
    return {"bandwidth": bandwidth, "rows": rows, "flags": flags}


# --------------------------------------------- perf-regression ledger
#
# Pure host code over dicts: the record loader, the per-family schema
# validators (the reference's, all twelve families), the trajectory
# table and the refusal-band regression check.


class LedgerError(ValueError):
    """A recorded artifact failed schema validation (named file+key)."""


_RECORD_RE = re.compile(r"^([A-Z]+)_r(\d+)\.json$")

#: the refusal band: a fresh measurement whose IQR/median exceeds it
#: refuses to certify or convict
STABILITY_BAND = 0.10


def _require(name: str, data: dict, keys) -> None:
    missing = [k for k in keys if k not in data]
    if missing:
        raise LedgerError(
            f"{name}: missing required keys {sorted(missing)} "
            f"(present: {sorted(data)[:12]})")


def _require_num(name: str, data: dict, keys) -> None:
    for k in keys:
        v = data.get(k)
        if v is not None and not isinstance(v, (int, float)):
            raise LedgerError(
                f"{name}: key {k!r} must be numeric or null, "
                f"got {type(v).__name__} ({v!r})")


def _validate_bench_envelope(name: str, parsed: dict) -> None:
    _require(name, parsed, ("metric", "value", "unit", "vs_baseline"))
    _require_num(name, parsed, ("value", "vs_baseline"))


def _validate_bench(name: str, d: dict) -> None:
    """Recorded BENCH round: {n, cmd, rc, tail, parsed} where parsed is
    the bench's one JSON stdout line (None when the round errored before
    printing one — the tail carries the traceback)."""
    _require(name, d, ("n", "cmd", "rc", "tail", "parsed"))
    if d["parsed"] is not None:
        if not isinstance(d["parsed"], dict):
            raise LedgerError(f"{name}: parsed must be an object or "
                              f"null, got {type(d['parsed']).__name__}")
        _validate_bench_envelope(f"{name}.parsed", d["parsed"])


def _validate_multichip(name: str, d: dict) -> None:
    if "n_devices" in d:  # the probe records of rounds 1-5
        _require(name, d, ("n_devices", "rc", "ok", "skipped", "tail"))
        return
    _require(name, d, ("metric", "platform"))
    if d.get("skipped"):
        return
    _require(name, d, ("ladder",))
    core = ("devices", "n", "rounds_per_sec", "ms_per_round",
            "weak_scaling_efficiency")
    for i, row in enumerate(d["ladder"]):
        _require(f"{name}.ladder[{i}]", row, core)
        _require_num(f"{name}.ladder[{i}]", row, core)


def _validate_profile(name: str, d: dict) -> None:
    _require(name, d, ("metric", "value", "unit", "platform",
                       "profile"))
    _require_num(name, d, ("value",))
    prof = d["profile"]
    if not isinstance(prof, dict):
        raise LedgerError(f"{name}: profile must be an object")
    if d.get("schema", 0) >= registry.PROFILE_SCHEMA_VERSION:
        _require(f"{name}.profile", prof, ("roofline",))
        roof = prof["roofline"]
        _require(f"{name}.profile.roofline", roof,
                 ("bandwidth", "rows", "flags"))
        measured = 0
        for i, row in enumerate(roof["rows"]):
            rn = f"{name}.profile.roofline.rows[{i}]"
            if "skipped" in row:
                _require(rn, row, ("config", "engine"))
                continue
            _require(rn, row, registry.PROFILE_ROOFLINE_ROW)
            _require_num(rn, row, ("ms_per_round", "bytes_model",
                                   "achieved_gbps"))
            measured += 1
        if measured < 6:
            raise LedgerError(
                f"{name}: a v{registry.PROFILE_SCHEMA_VERSION} "
                f"roofline table needs >= 6 measured engine configs, "
                f"got {measured}")


def _validate_sweep(name: str, d: dict) -> None:
    _require(name, d, ("metric", "platform"))
    if d.get("skipped"):
        return
    _require(name, d, ("n", "rounds", "grid", "objectives", "classes"))
    for cls, row in d["classes"].items():
        _require(f"{name}.classes[{cls}]", row,
                 ("grid_size", "scenarios_per_sec", "chosen", "pareto"))


def _validate_serve(name: str, d: dict) -> None:
    _require(name, d, ("metric", "unit", "levels", "headline_rps"))
    for i, lvl in enumerate(d["levels"]):
        _require(f"{name}.levels[{i}]", lvl,
                 ("concurrency", "rps", "p50_ms", "p99_ms"))
        _require_num(f"{name}.levels[{i}]", lvl, ("rps", "p50_ms"))
    _require(f"{name}.headline_rps", d["headline_rps"],
             ("value", "samples", "stability_band"))


def _validate_byz(name: str, d: dict) -> None:
    _require(name, d, ("metric", "n", "classes", "corroboration_sweep"))


def _validate_tune(name: str, d: dict) -> None:
    """Autotuner record (sim/autotune.py): the swept config rows plus
    the per-(platform, n) winner the cache persists."""
    _require(name, d, ("metric", "platform", "n", "rounds", "rows",
                       "winner"))
    if not isinstance(d["rows"], list) or not d["rows"]:
        raise LedgerError(f"{name}: rows must be a non-empty list")
    for i, row in enumerate(d["rows"]):
        rn = f"{name}.rows[{i}]"
        if not isinstance(row, dict):
            raise LedgerError(f"{rn}: row must be an object")
        if "skipped" in row:
            _require(rn, row, ("config", "engine"))
            continue
        _require(rn, row, registry.AUTOTUNE_WINNER_KEYS)
        _require_num(rn, row, ("rounds_per_sec",))
    _require(f"{name}.winner", d["winner"],
             registry.AUTOTUNE_WINNER_KEYS)
    _require_num(f"{name}.winner", d["winner"], ("rounds_per_sec",))


def _validate_scenario(name: str, d: dict) -> None:
    if d.get("skipped"):
        _require(name, d, ("metric",))
        return
    _require(name, d, ("metric", "n", "platform", "scenarios",
                       "wall_s"))
    _require_num(name, d, ("wall_s",))


def _validate_twin(name: str, d: dict) -> None:
    """Digital-twin soak record: a virtual-member ladder of rungs, each a
    real-agent soak (registry.TWIN_RUNG_KEYS) or an honest skip naming
    its reason, plus the smoke-scale re-measurement envelope."""
    _require(name, d, ("metric", "platform", "ladder", "smoke_guard"))
    if not isinstance(d["ladder"], list) or not d["ladder"]:
        raise LedgerError(f"{name}: ladder must be a non-empty list")
    measured = 0
    for i, rung in enumerate(d["ladder"]):
        rn = f"{name}.ladder[{i}]"
        if not isinstance(rung, dict):
            raise LedgerError(f"{rn}: rung must be an object")
        if rung.get("skipped"):
            _require(rn, rung, ("n", "reason"))
            continue
        measured += 1
        _require(rn, rung, registry.TWIN_RUNG_KEYS)
        _require_num(rn, rung, ("join_s", "agent_p99_ms",
                                "jain_fairness"))
        if not rung.get("resume_digest_equal"):
            raise LedgerError(
                f"{rn}: resume_digest_equal must be true — a rung "
                "whose checkpoint resume diverged is a broken run, "
                "not a record")
        err = rung["member_view_err_post_heal"]
        if not isinstance(err, (int, float)) \
                or err > registry.TWIN_CONVERGE_TOL:
            raise LedgerError(
                f"{rn}: member_view_err_post_heal {err!r} exceeds the "
                f"convergence tolerance {registry.TWIN_CONVERGE_TOL} "
                "— a rung that never converged must be an honest "
                "skip, not a record whose capped converge_rounds "
                "reads as merely slow")
    if not measured:
        raise LedgerError(
            f"{name}: every rung skipped — record the failure as a "
            "skipped BENCH-style envelope, not an empty twin ladder")
    sg = d["smoke_guard"]
    _require(f"{name}.smoke_guard", sg,
             ("n", "rounds", "converge_rounds", "samples"))
    _require_num(f"{name}.smoke_guard", sg, ("converge_rounds",))


def _validate_users(name: str, d: dict) -> None:
    """Open-loop traffic record: an RPS ladder over the mixed
    virtual-user surface workload, each rung a measured row
    (registry.USERS_RUNG_KEYS) with per-surface attribution or an honest
    skip, carrying saturation evidence (a rung with ``rejected > 0`` and
    a bounded admitted p99)."""
    _require(name, d, ("metric", "unit", "engine", "ladder",
                       "headline", "headline_rung", "saturation"))
    eng = d["engine"]
    if not isinstance(eng, dict):
        raise LedgerError(f"{name}: engine must be an object")
    _require(f"{name}.engine", eng, ("users", "seed", "zipf_s",
                                     "surface_mix"))
    mix = eng["surface_mix"]
    if not isinstance(mix, dict) or not mix:
        raise LedgerError(f"{name}.engine: surface_mix must be a "
                          "non-empty object")
    unknown = set(mix) - set(registry.USERS_SURFACES)
    if unknown:
        raise LedgerError(
            f"{name}.engine: unknown surface(s) {sorted(unknown)} "
            f"(known: {', '.join(registry.USERS_SURFACES)})")
    if not isinstance(d["ladder"], list) or not d["ladder"]:
        raise LedgerError(f"{name}: ladder must be a non-empty list")
    measured = 0
    saturated = 0
    for i, rung in enumerate(d["ladder"]):
        rn = f"{name}.ladder[{i}]"
        if not isinstance(rung, dict):
            raise LedgerError(f"{rn}: rung must be an object")
        if rung.get("skipped"):
            _require(rn, rung, ("target_rps", "reason"))
            continue
        measured += 1
        _require(rn, rung, registry.USERS_RUNG_KEYS)
        _require_num(rn, rung, ("target_rps", "achieved_rps",
                                "p50_ms", "p99_ms", "rejected"))
        surfaces = rung["surfaces"]
        if not isinstance(surfaces, dict) or not surfaces:
            raise LedgerError(f"{rn}: surfaces must be a non-empty "
                              "object")
        bad = set(surfaces) - set(registry.USERS_SURFACES)
        if bad:
            raise LedgerError(f"{rn}: unknown surface(s) "
                              f"{sorted(bad)}")
        for sname, row in surfaces.items():
            _require(f"{rn}.surfaces[{sname}]", row,
                     registry.USERS_SURFACE_KEYS)
        if rung.get("rejected", 0) > 0:
            saturated += 1
    if not measured:
        raise LedgerError(
            f"{name}: every rung skipped — record the failure as a "
            "skipped BENCH-style envelope, not an empty users ladder")
    if not saturated:
        raise LedgerError(
            f"{name}: no rung shows rejected > 0 — the ladder never "
            "drove admission control past saturation, so the record "
            "carries no graceful-degradation evidence (raise the top "
            "target_rps or lower rpc_queue_limit and re-record)")
    sat = d["saturation"]
    _require(f"{name}.saturation", sat,
             ("target_rps", "rejected", "admitted_p99_ms"))
    _require_num(f"{name}.saturation", sat,
                 ("rejected", "admitted_p99_ms"))
    if not sat.get("rejected"):
        raise LedgerError(f"{name}.saturation: rejected must be > 0")
    _require(f"{name}.headline", d["headline"],
             ("value", "samples", "stability_band"))
    _require(f"{name}.headline_rung", d["headline_rung"],
             ("target_rps",))


def _validate_raft_shards(rn: str, rung: dict, n_shards: int) -> None:
    """Per-shard attribution rows inside one sharded RAFT rung, each
    held to the single-group contract (stage names under
    ``raft.shard.<id>.``, the RAFT_COVERAGE_MIN floor per shard)."""
    shards = rung.get("shards")
    if not isinstance(shards, dict):
        raise LedgerError(
            f"{rn}: sharded record (raft_shards={n_shards}) but rung "
            "has no per-shard 'shards' map — a multi-raft headline "
            "without per-shard attribution is a blind spot")
    want = {str(s) for s in range(n_shards)}
    if set(shards) != want:
        raise LedgerError(
            f"{rn}.shards: shard ids {sorted(shards)} != expected "
            f"{sorted(want)} — every consensus group must report")
    for sid_s in sorted(shards, key=int):
        sid = int(sid_s)
        srow = shards[sid_s]
        sn = f"{rn}.shards[{sid}]"
        if not isinstance(srow, dict):
            raise LedgerError(f"{sn}: shard row must be an object")
        _require(sn, srow, registry.RAFT_SHARD_KEYS)
        _require_num(sn, srow, ("commit_p50_ms", "commit_p99_ms",
                                "coverage_p50"))
        expected = set(registry.raft_shard_stages(sid))
        shares = srow["stage_share_p50"]
        if not isinstance(shares, dict):
            raise LedgerError(f"{sn}: stage_share_p50 must be an "
                              "object")
        missing = expected - set(shares)
        if missing:
            raise LedgerError(
                f"{sn}.stage_share_p50: shard {sid} is missing "
                f"stage(s) {sorted(missing)} — every depth-0 commit "
                "window must be attributed per shard")
        unknown = set(shares) - expected
        if unknown:
            raise LedgerError(
                f"{sn}.stage_share_p50: shard {sid} has unknown "
                f"stage(s) {sorted(unknown)} (known: "
                f"{', '.join(sorted(expected))})")
        cov = srow["coverage_p50"]
        # a shard that committed nothing this rung records
        # commit_batches == 0 and is exempt
        if srow.get("commit_batches") and \
                cov < registry.RAFT_COVERAGE_MIN:
            raise LedgerError(
                f"{sn}: shard {sid} stage coverage {cov:.3f} is "
                f"below {registry.RAFT_COVERAGE_MIN:.0%} of its "
                "commit e2e p50 — a shard must not hide behind a "
                "well-attributed sibling")


def _validate_raft(name: str, d: dict) -> None:
    """Consensus-plane commit-path record: a PUT ladder against a
    3-server loopback cluster, each rung a measured row
    (registry.RAFT_RUNG_KEYS) or an honest skip; a rung whose stage
    windows explain less than RAFT_COVERAGE_MIN of the commit p50 is
    refused, and sharded records carry per-shard rows."""
    _require(name, d, ("metric", "unit", "cluster", "ladder",
                       "headline", "headline_rung"))
    cl = d["cluster"]
    if not isinstance(cl, dict):
        raise LedgerError(f"{name}: cluster must be an object")
    _require(f"{name}.cluster", cl, ("servers", "sync",
                                     "payload_bytes"))
    n_shards = cl.get("raft_shards", 1)
    if not isinstance(n_shards, int) or n_shards < 1:
        raise LedgerError(f"{name}.cluster: raft_shards must be a "
                          f"positive int, got {n_shards!r}")
    if not isinstance(d["ladder"], list) or not d["ladder"]:
        raise LedgerError(f"{name}: ladder must be a non-empty list")
    measured = 0
    for i, rung in enumerate(d["ladder"]):
        rn = f"{name}.ladder[{i}]"
        if not isinstance(rung, dict):
            raise LedgerError(f"{rn}: rung must be an object")
        if rung.get("skipped"):
            _require(rn, rung, ("target_rps", "reason"))
            continue
        measured += 1
        _require(rn, rung, registry.RAFT_RUNG_KEYS)
        _require_num(rn, rung, ("target_rps", "achieved_rps",
                                "p50_ms", "p99_ms", "commit_p50_ms",
                                "commit_p99_ms", "coverage_p50"))
        shares = rung["stage_share_p50"]
        if not isinstance(shares, dict):
            raise LedgerError(f"{rn}: stage_share_p50 must be an "
                              "object")
        missing = set(registry.RAFT_STAGES) - set(shares)
        if missing:
            raise LedgerError(
                f"{rn}.stage_share_p50: missing stage(s) "
                f"{sorted(missing)} — every depth-0 commit window "
                "must be attributed")
        unknown = set(shares) - set(registry.RAFT_STAGES)
        if unknown:
            raise LedgerError(
                f"{rn}.stage_share_p50: unknown stage(s) "
                f"{sorted(unknown)} (known: "
                f"{', '.join(registry.RAFT_STAGES)})")
        cov = rung["coverage_p50"]
        if cov < registry.RAFT_COVERAGE_MIN:
            raise LedgerError(
                f"{rn}: stage coverage {cov:.3f} is below "
                f"{registry.RAFT_COVERAGE_MIN:.0%} of commit e2e p50 "
                "— the attribution has a blind spot; fix the ledger, "
                "don't record around it")
        if n_shards > 1:
            _validate_raft_shards(rn, rung, n_shards)
    if not measured:
        raise LedgerError(
            f"{name}: every rung skipped — record the failure as a "
            "skipped BENCH-style envelope, not an empty raft ladder")
    _require(f"{name}.headline", d["headline"],
             ("value", "samples", "stability_band"))
    _require(f"{name}.headline_rung", d["headline_rung"],
             ("target_rps",))


_VALIDATORS = {
    "BENCH": _validate_bench,
    "MULTICHIP": _validate_multichip,
    "PROFILE": _validate_profile,
    "SWEEP": _validate_sweep,
    "SERVE": _validate_serve,
    "BYZ": _validate_byz,
    "CHAOS": _validate_scenario,
    "COORDS": _validate_scenario,
    "TUNE": _validate_tune,
    "TWIN": _validate_twin,
    "USERS": _validate_users,
    "RAFT": _validate_raft,
}
assert set(_VALIDATORS) == set(registry.LEDGER_FAMILIES)


def validate_record(filename: str, data: Any) -> None:
    """Schema-validate one recorded artifact by family. Raises
    LedgerError naming the file and the offending key; an unknown
    ``<NAME>_r<NN>.json`` family fails too."""
    m = _RECORD_RE.match(os.path.basename(filename))
    if not m:
        raise LedgerError(
            f"{filename}: not a recorded-artifact name "
            "(expected <FAMILY>_r<NN>.json)")
    family = m.group(1)
    if family not in _VALIDATORS:
        raise LedgerError(
            f"{filename}: unknown record family {family!r} (known: "
            f"{', '.join(registry.LEDGER_FAMILIES)}) — register a "
            "validator in sim/costmodel.py and extend "
            "registry.LEDGER_FAMILIES")
    if not isinstance(data, dict):
        raise LedgerError(f"{filename}: record must be a JSON object, "
                          f"got {type(data).__name__}")
    _VALIDATORS[family](os.path.basename(filename), data)


def iter_record_files(root: str) -> list[str]:
    """Every recorded-artifact path in `root`, (family, round)-sorted."""
    out = []
    for fn in os.listdir(root):
        m = _RECORD_RE.match(fn)
        if m:
            out.append((m.group(1), int(m.group(2)),
                        os.path.join(root, fn)))
    return [p for _, _, p in sorted(out)]


def load_ledger(root: str) -> list[dict[str, Any]]:
    """Load + validate every recorded artifact under `root`. Returns
    [{file, family, round, data}] sorted by (family, round). A record
    that fails to parse or validate raises LedgerError by name — the
    ledger never silently drops a broken record."""
    records = []
    for path in iter_record_files(root):
        fn = os.path.basename(path)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise LedgerError(f"{fn}: unreadable record: {e}") from e
        validate_record(fn, data)
        m = _RECORD_RE.match(fn)
        records.append({"file": fn, "family": m.group(1),
                        "round": int(m.group(2)), "data": data})
    return records


def _headline_of(rec: dict[str, Any]):
    """(metric, value, unit, note) extracted per family — the one
    trajectory number each record contributes to the history."""
    d, fam = rec["data"], rec["family"]
    if fam == "BENCH":
        p = d.get("parsed")
        if not p:
            tail = (d.get("tail") or "").strip().splitlines()
            return (None, None, None,
                    f"errored (rc={d.get('rc')}): "
                    f"{tail[-1][:60] if tail else 'no output'}")
        note = ""
        if p.get("error"):
            note = f"error: {p['error'][:60]}"
        elif p.get("skipped"):
            note = f"skipped: {p.get('reason', '')[:60]}"
        elif p.get("full_model_rounds_per_sec") is not None:
            note = (f"full-model "
                    f"{p['full_model_rounds_per_sec']:,.0f} r/s "
                    f"({p.get('full_model_kernel', '?')})")
        return p.get("metric"), p.get("value"), p.get("unit"), note
    if fam == "PROFILE":
        note = ""
        if d.get("full_model_rounds_per_sec") is not None:
            note = (f"full-model "
                    f"{d['full_model_rounds_per_sec']:,.0f} r/s")
        roof = (d.get("profile") or {}).get("roofline")
        if roof:
            utils = [r.get("util") for r in roof["rows"]
                     if r.get("util") is not None]
            if utils:
                note += f"; best util {max(utils):.1%}"
        return d.get("metric"), d.get("value"), d.get("unit"), note
    if fam == "MULTICHIP":
        if "n_devices" in d:
            note = ("ok" if d.get("ok")
                    else "skipped" if d.get("skipped") else "failed")
            return ("mesh_weak_scaling", None, None,
                    f"harness probe ({d['n_devices']} devices): {note}")
        if d.get("skipped"):
            return d.get("metric"), None, None, \
                f"skipped: {d.get('reason', '')[:60]}"
        top = d["ladder"][-1]
        return (d.get("metric"), top.get("rounds_per_sec"), "rounds/s",
                f"{top['devices']} devices, eff "
                f"{top['weak_scaling_efficiency']}")
    if fam == "SWEEP":
        if d.get("skipped"):
            return d.get("metric"), None, None, "skipped"
        best = max(row.get("scenarios_per_sec", 0)
                   for row in d["classes"].values())
        return (d.get("metric"), best, "scenarios/s",
                f"{len(d['classes'])} classes, grid "
                f"{next(iter(d['classes'].values()))['grid_size']}")
    if fam == "SERVE":
        hl = d["headline_rps"]
        note = ("REFUSED: " + hl.get("unstable", "")[:60]
                if hl.get("headline") is None else "stable")
        top = d["levels"][-1]
        return (d.get("metric"), top.get("rps"), d.get("unit"),
                f"C={top['concurrency']}; headline {note}")
    if fam == "BYZ":
        ks = [row.get("corroboration_k")
              for row in d.get("corroboration_sweep", {}).get(
                  "sweep", [])] if isinstance(
                      d.get("corroboration_sweep"), dict) else []
        return (d.get("metric"), None, None,
                f"{len(d['classes'])} attack classes"
                + (f", k sweep {len(ks)} pts" if ks else ""))
    if fam == "TUNE":
        w = d["winner"]
        measured = sum(1 for r in d["rows"] if "skipped" not in r)
        return (d.get("metric"), w.get("rounds_per_sec"), "rounds/s",
                f"winner {w.get('config')} of {measured} measured "
                f"configs (n={d.get('n')})")
    if fam == "TWIN":
        rungs = [r for r in d["ladder"] if not r.get("skipped")]
        top = max(rungs, key=lambda r: r.get("n", 0))
        skipped = len(d["ladder"]) - len(rungs)
        return (d.get("metric"), top.get("agent_p99_ms"), "ms (p99)",
                f"{top['n']:,} virtual members, jain "
                f"{top.get('jain_fairness', 0):.3f}"
                + (f", {skipped} rung(s) skipped" if skipped else ""))
    if fam == "USERS":
        hl = d["headline"]
        note = ("REFUSED: " + hl.get("unstable", "")[:60]
                if hl.get("headline") is None else "stable")
        rungs = [r for r in d["ladder"] if not r.get("skipped")]
        top = max(rungs, key=lambda r: r.get("achieved_rps") or 0)
        sat = d.get("saturation") or {}
        return (d.get("metric"), top.get("achieved_rps"),
                d.get("unit"),
                f"{d['engine'].get('users', 0):,} users, shed "
                f"{sat.get('rejected', 0)} @ {sat.get('target_rps')} "
                f"rps; headline {note}")
    if fam == "RAFT":
        hl = d["headline"]
        note = ("REFUSED: " + hl.get("unstable", "")[:60]
                if hl.get("headline") is None else "stable")
        rungs = [r for r in d["ladder"] if not r.get("skipped")]
        top = max(rungs, key=lambda r: r.get("achieved_rps") or 0)
        return (d.get("metric"), top.get("achieved_rps"),
                d.get("unit"),
                f"commit p50 {top.get('commit_p50_ms', 0):.2f} ms, "
                f"stage coverage {top.get('coverage_p50', 0):.0%}; "
                f"headline {note}")
    # CHAOS / COORDS
    if d.get("skipped"):
        return d.get("metric"), None, None, "skipped"
    return (d.get("metric"), d.get("wall_s"), "s (wall)",
            f"{len(d.get('scenarios', {}))} scenario(s)")


def history_rows(records: list[dict]) -> list[dict[str, Any]]:
    """The trajectory table: one row per record, (family, round)
    ordered."""
    rows = []
    for rec in records:
        metric, value, unit, note = _headline_of(rec)
        rows.append({"file": rec["file"], "family": rec["family"],
                     "round": rec["round"], "metric": metric,
                     "value": value, "unit": unit, "note": note})
    return rows


def format_history(rows: list[dict]) -> str:
    """Human table for ``bench --history``."""
    cols = ("file", "metric", "value", "unit", "note")
    widths = {c: len(c) for c in cols}
    printable = []
    for r in rows:
        pr = {
            "file": r["file"],
            "metric": r["metric"] or "-",
            "value": ("-" if r["value"] is None
                      else f"{r['value']:,.1f}"),
            "unit": r["unit"] or "-",
            "note": r["note"] or "",
        }
        printable.append(pr)
        for c in cols:
            widths[c] = max(widths[c], len(pr[c]))
    lines = ["  ".join(c.ljust(widths[c]) for c in cols),
             "  ".join("-" * widths[c] for c in cols)]
    for pr in printable:
        lines.append("  ".join(pr[c].ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def latest_metric(records: list[dict], metric: str
                  ) -> Optional[dict[str, Any]]:
    """The newest record carrying a non-null value for `metric` — the
    regression baseline. None when no record of that metric exists."""
    best = None
    for rec in records:
        m, value, unit, _ = _headline_of(rec)
        if m == metric and value is not None:
            if best is None or (rec["family"], rec["round"]) >= \
                    (best["family"], best["round"]):
                best = {"file": rec["file"], "family": rec["family"],
                        "round": rec["round"], "metric": m,
                        "value": value, "unit": unit}
    return best


def latest_profile_util(records: list[dict]
                        ) -> Optional[dict[str, Any]]:
    """The newest PROFILE record's best roofline utilisation row — the
    ``--check-regression --family PROFILE`` baseline: {file, round,
    util, config, engine, stale_k, rounds_per_call, lane_blocks, smoke,
    n}. Rows with util > 1 are cache artefacts, not roofline points, so
    the best util <= 1 row is preferred; None when no recorded roofline
    carries a utilisation."""
    profs = sorted((r for r in records if r["family"] == "PROFILE"),
                   key=lambda r: r["round"], reverse=True)
    for rec in profs:
        roof = (rec["data"].get("profile") or {}).get("roofline")
        rows = [row for row in (roof or {}).get("rows", ())
                if row.get("util") is not None]
        if not rows:
            continue
        physical = [row for row in rows if row["util"] <= 1.0]
        best = max(physical or rows, key=lambda row: row["util"])
        return {"file": rec["file"], "round": rec["round"],
                "util": best["util"], "config": best["config"],
                "engine": best["engine"],
                "stale_k": best.get("stale_k", 1),
                "rounds_per_call": best.get("rounds_per_call", 1),
                "lane_blocks": best.get("lane_blocks"),
                "smoke": bool(rec["data"].get("smoke")),
                "n": rec["data"].get("n")}
    return None


def _newest_first(records: list[dict], family: str) -> list[dict]:
    return sorted((r for r in records if r["family"] == family),
                  key=lambda r: r["round"], reverse=True)


def latest_twin_guard(records: list[dict]) -> Optional[dict[str, Any]]:
    """The newest TWIN record's smoke-guard envelope — the
    ``--family TWIN`` baseline: {file, round, n, rounds,
    converge_rounds, samples}. The guard re-runs the smoke-scale twin of
    the same n and rounds and compares convergence rounds. None when no
    TWIN record carries one."""
    for rec in _newest_first(records, "TWIN"):
        sg = rec["data"].get("smoke_guard")
        if sg:
            return {"file": rec["file"], "round": rec["round"], **sg}
    return None


def _latest_rung_guard(records: list[dict], family: str,
                       workload: str) -> Optional[dict[str, Any]]:
    """The newest ``family`` record's headline rung: {file, round,
    target_rps, <workload>, value}, ``value`` the measured rung's
    achieved req/s at the headline's target rate and ``workload`` the
    record's description of what the guard re-runs."""
    for rec in _newest_first(records, family):
        d = rec["data"]
        hr = d.get("headline_rung")
        if not hr:
            continue
        target = hr.get("target_rps")
        rung = next((r for r in d.get("ladder", ())
                     if not r.get("skipped")
                     and r.get("target_rps") == target), None)
        if rung is None:
            continue
        return {"file": rec["file"], "round": rec["round"],
                "target_rps": target, workload: d.get(workload, {}),
                "value": rung.get("achieved_rps")}
    return None


def latest_users_guard(records: list[dict]) -> Optional[dict[str, Any]]:
    """The newest USERS record's re-measurement envelope: {file, round,
    target_rps, engine, value} — the admitted req/s of the recorded
    headline rung and the open-loop rate and virtual-user population
    that produced it. None when no USERS record has one."""
    return _latest_rung_guard(records, "USERS", "engine")


def latest_raft_guard(records: list[dict]) -> Optional[dict[str, Any]]:
    """The newest RAFT record's re-measurement envelope: {file, round,
    target_rps, cluster, value} — the PUT req/s of the recorded headline
    rung and the rate, server count and durability mode that produced
    it. None when no RAFT record has one."""
    return _latest_rung_guard(records, "RAFT", "cluster")


def check_regression(samples: list[float], baseline: float,
                     band: float = STABILITY_BAND) -> dict[str, Any]:
    """The median+IQR refusal band applied to a regression gate.

    ``samples`` are fresh throughput trials (higher is better),
    ``baseline`` the latest recorded value of the same metric. Verdicts:
    ``regression`` (median below baseline x (1 - band) with a spread
    tight enough to claim it), ``pass``, or ``unstable`` (fewer than 3
    samples, or IQR/median above the band: a noisy host neither
    certifies nor convicts)."""
    if baseline is None or not isinstance(baseline, (int, float)) \
            or baseline <= 0:
        raise ValueError(f"check_regression needs a positive recorded "
                         f"baseline, got {baseline!r} — the caller "
                         "must refuse (exit 2) before measuring")
    med = statistics.median(samples)
    out = {"samples": [round(s, 1) for s in samples],
           "median": round(med, 1),
           "baseline": round(float(baseline), 1),
           "ratio": round(med / baseline, 4),
           "band": band}
    if len(samples) < 3:
        out["verdict"] = "unstable"
        out["reason"] = (f"need >= 3 fresh samples for a regression "
                         f"claim (got {len(samples)})")
        return out
    qs = statistics.quantiles(samples, n=4)
    iqr = qs[2] - qs[0]
    out["iqr_over_median"] = round(iqr / med, 4) if med else None
    if med and iqr / med > band:
        out["verdict"] = "unstable"
        out["reason"] = (f"IQR/median {iqr / med:.3f} exceeds the "
                         f"{band:.0%} refusal band — host too noisy "
                         "to certify or convict")
        return out
    if med < baseline * (1.0 - band):
        out["verdict"] = "regression"
        out["reason"] = (f"fresh median {med:,.1f} is "
                         f"{1 - med / baseline:.1%} below the recorded "
                         f"{baseline:,.1f} (band {band:.0%})")
    else:
        out["verdict"] = "pass"
    return out
