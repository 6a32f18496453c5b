"""Fused reduction lanes: one reduction per round, in a fixed order.

The port of the JAX package's ``consul_tpu/sim/lanes.py``. In the lane
engine (``round.make_run_rounds_lanes``) a round's every population
statistic — the eight stale scalars, the SimStats counters, the flight
gauges' numerators and the local-health exceedance histogram — is a
named row of one ``[N_LANES, ..., L]`` contribution stack
(``registry.REDUCE_LANES``), and the round reduces it once.

The reduction goes through a fixed ``LANE_BLOCKS``-wide block table:
contributions reduce to per-block partials (a block is a contiguous
``L / LANE_BLOCKS`` node range), then the table folds to the lane
vector. Both stages add by pairwise halving (``tree_sum``): every sum is
one fixed tree of f32 additions, whatever the leading (grid) shape and
whatever the device, so a grid row of the sweep engine is bit for bit
its one-point run on the card as on the host. XLA's order inside a
block differs, so the port's f32 lanes agree with the reference's
within a few ulp; the count lanes (sums of 0/1 below 2^24) are exact.

Stacks, tables and lane vectors carry any leading shape after the lane
axis: ``[K, L]`` for one run, ``[K, G, L]`` for a G-point grid, reduced
to ``[K]`` / ``[K, G]``.

On a mesh (``sim/mesh.py``) each rank holds a contiguous slice of the
pool. ``mesh_lane_reducer`` puts the rank's block partials into its own
columns of a zero ``[K, LANE_BLOCKS]`` table and ``fold`` all-reduces
the table (SUM, over the reduction scope's process group: the window's
one collective), then folds it exactly as one device does. The sum is
exact: every column has one owner and the other ranks add +0.0, and
``_block_partials`` writes no -0.0 (it adds +0.0 to every partial, the
one value for which ``x + 0.0`` is not ``x``). So the mesh's lane
vectors equal one device's bit for bit, whatever the world size.

On the card every sum here is the sum kernel (``fused.tree_sum``: the
same additions in the same order, in one launch a sum, with
``_block_partials``' +0.0 folded in); CPU tensors run the halving below,
and ``tree_sum_staged`` is the kernel's plain twin (the partials of its
``fused.sum_plan`` in PyTorch), which CPU tensors run inside
``fused.twins()``.

Not ported: the reference's jax batching patch for its optimization
barrier (no PyTorch meaning).
"""

from __future__ import annotations

import math

import torch

from consul_tpu_torch.sim import fused, registry
from consul_tpu_torch.sim.state import STATS_FIELDS, SimStats

N_LANES = registry.N_REDUCE_LANES
LANE = registry.LANE
LANE_BLOCKS = registry.LANE_BLOCKS

_N_SC = len(registry.LANE_SCALARS)
_LAT = STATS_FIELDS.index("detect_latency_sum")
#: the SimStats counter rows of a contribution stack: a staleness-k
#: window sums exactly these rows per node over its k rounds
STATS_SLICE = slice(_N_SC, _N_SC + len(STATS_FIELDS))
_GAUGE0 = _N_SC + len(STATS_FIELDS)
_HIST_SLICE = slice(_GAUGE0 + len(registry.LANE_GAUGES), N_LANES)

#: floors of the stale scalars, applied after the reduction:
#: n_elig >= 1, n_up_elig >= 1e-9, lfail_den >= 1e-9
_FLOORS = (float("-inf"), 1.0, 1e-9, float("-inf"), float("-inf"),
           float("-inf"), float("-inf"), 1e-9)


def check_pool(n: int, blocks: int = LANE_BLOCKS) -> None:
    if n % blocks:
        raise ValueError(
            f"lane engine pools must divide the {blocks}-wide block "
            f"table evenly: n={n}")


def check_flight_config(p, flight_every) -> None:
    """The flight recorder's preconditions on the lane engine: counter
    columns ride the SimStats lanes, so stats must be on; the
    max_local_health gauge decodes the exceedance histogram, which
    covers lh >= 1..len(LANE_LH_HIST); rows are emitted only on
    reduction rounds, so the stride must be a multiple of stale_k
    (registry.STALE_EMISSION_RULE)."""
    if flight_every is None:
        return
    if not p.collect_stats:
        raise ValueError(
            "the flight recorder's counter columns ride the SimStats "
            "lanes; build SimParams with collect_stats=True")
    limit = len(registry.LANE_LH_HIST)
    if p.awareness_max > limit:
        raise ValueError(
            f"the lane engine's flight max_local_health gauge covers "
            f"awareness_max <= {limit} (registry.LANE_LH_HIST); got "
            f"{p.awareness_max} — use the XLA run_rounds_flight "
            "recorder for larger awareness ceilings")
    if flight_every % p.stale_k:
        raise ValueError(
            f"flight rows are emitted only on reduction rounds: "
            f"record stride {flight_every} must be a multiple of "
            f"stale_k={p.stale_k} (registry.STALE_EMISSION_RULE)")


def check_schedule(p, rounds: int, flight_every, overlap: bool) -> None:
    """The staleness/overlap schedule's preconditions: ``stale_k`` a
    positive int (a partial final window runs as its own reduction, so
    any round count works) — except under overlap, whose drain needs
    uniform windows; and overlap consumes each reduction a window late,
    so flight rows (which need the synchronous reduction) are refused
    with it."""
    k = p.stale_k
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"stale_k must be a positive int: {k!r}")
    if overlap and rounds % k:
        raise ValueError(
            f"overlap needs uniform reduction windows: rounds={rounds} "
            f"must be a multiple of stale_k={k}")
    if overlap and flight_every is not None:
        raise ValueError(
            "overlap consumes each lane reduction one window late — "
            "flight rows need the synchronous reduction; record with "
            "overlap=False (the amortization still comes from stale_k)")
    check_flight_config(p, flight_every)


# -------------------------------------------------- fixed-order sums


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by pairwise halving: element i adds element
    i + h of the current length, and an odd length carries its last
    element to the next step. Each output is one fixed tree of f32
    additions, independent of the leading shape and of the device —
    the sums a grid row and its one-point run share bit for bit."""
    if fused.routed(x):
        return _fused_sum(x)
    return _halve(x)


def _halve(x: torch.Tensor) -> torch.Tensor:
    """``tree_sum``'s plain version: the halving steps as PyTorch ops."""
    while x.shape[-1] > 1:
        length = x.shape[-1]
        h = length // 2
        y = x[..., :h] + x[..., h:2 * h]
        if length % 2:
            y = torch.cat([y, x[..., 2 * h:]], dim=-1)
        x = y
    return x[..., 0]


def _fused_sum(x: torch.Tensor, plus_zero: bool = False) -> torch.Tensor:
    """The sum kernel for a CUDA tensor, its plain twin for a CPU one."""
    if x.device.type == "cuda":
        return fused.tree_sum(x, plus_zero)
    return tree_sum_staged(x, plus_zero)


def _level(y: torch.Tensor, lengths: tuple) -> torch.Tensor:
    """Level ``len(lengths) - 1`` of rows ``y`` ([R, lengths[0]] -> [R,
    lengths[-1]]) as the kernel's threads compute it: position p is the
    pairwise tree, in the order of m, of the leaves p + sum of h_b over
    the set bits b of m; in the last position's tree leaf m (not all
    ones) is absent when level j's length is odd, j the highest zero bit
    of m, and a pair with one side absent passes the other on."""
    k = len(lengths) - 1
    if k == 0:
        return y
    m = torch.arange(1 << k)
    bits = (m[:, None] >> torch.arange(k)) & 1
    off = (bits * torch.tensor([n // 2 for n in lengths[:k]])).sum(1)
    idx = torch.arange(lengths[k])[:, None] + off
    odd = torch.tensor([n % 2 == 1 for n in lengths[:k]])
    top_zero = ((1 - bits) * torch.arange(k)).amax(1)
    present = torch.ones(idx.shape, dtype=torch.bool)
    present[-1] = (m == (1 << k) - 1) | ~odd[top_zero]
    v = y[:, torch.where(present, idx, 0).to(y.device)]
    pres = present.to(y.device).expand(v.shape)
    for _ in range(k):
        a, b = v[..., 0::2], v[..., 1::2]
        pa, pb = pres[..., 0::2], pres[..., 1::2]
        v = torch.where(pa & pb, a + b, torch.where(pa, a, b))
        pres = pa | pb
    return v[..., 0]


def _reverse(g: int, bits: int) -> int:
    return int(format(g, f"0{bits}b")[::-1], 2) if bits else 0


def _ranges(y: torch.Tensor, plan: fused.SumPlan) -> torch.Tensor:
    """Level ``plan.k`` of rows ``y`` (level ``plan.t``) as the kernel's
    CTAs compute it, range by range: a range [a, b) gathers the 2^j
    segments a + [0, b - a) + sum of h_b over the set bits of g (bit i
    for level t + i), segment g at slot bitreverse(g); each step halves
    the slots, and where the range holds the level's last position the
    last element of the first half takes its right side alone when the
    step's level is odd."""
    j, t = plan.j, plan.t
    if j == 0:
        return y
    hs = torch.tensor(plan.h[t:])
    g = torch.tensor([_reverse(r, j) for r in range(1 << j)])
    seg = (((g[:, None] >> torch.arange(j)) & 1) * hs).sum(1)
    out = []
    for a, b in plan.ranges():
        idx = (seg[:, None] + torch.arange(a, b)).reshape(-1)
        buf = y[:, idx.to(y.device)]
        for i in range(j):
            half = buf.shape[-1] // 2
            right = buf[:, half:]
            buf = buf[:, :half] + right
            if b == plan.nk and plan.lengths[t + i] % 2:
                buf[:, -1] = right[:, -1]
        out.append(buf)
    return torch.cat(out, -1)


def tree_sum_staged(x: torch.Tensor, plus_zero: bool = False) -> torch.Tensor:
    """The sum kernel's plain twin: ``tree_sum`` (plus +0.0 when
    ``plus_zero``) in the partials of ``fused.sum_plan``'s launch —
    level t by the threads' leaf trees, level k by the CTAs' ranges, then
    the fold of level k."""
    lead = tuple(x.shape[:-1])
    rows = math.prod(lead)
    plan = fused.sum_plan(rows, x.shape[-1])
    y = _level(x.reshape(rows, x.shape[-1]), plan.lengths[:plan.t + 1])
    y = _halve(_ranges(y, plan)).reshape(lead)
    return y + 0.0 if plus_zero else y


def row_sums(*xs: torch.Tensor) -> list:
    """Each ``[..., N]`` tensor summed over its last dim, kept as
    ``[..., 1]`` so it broadcasts back against the rows: the grid
    engine's population reducer (one stacked ``tree_sum``)."""
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    out = tree_sum(torch.stack([x.expand(shape) for x in xs]))
    return list(out.unsqueeze(-1))


def _block_partials(stack: torch.Tensor, blocks: int) -> torch.Tensor:
    """``[K, ..., L]`` -> ``[K, ..., blocks]`` contiguous-range partial
    sums (inner length L // blocks). Adding +0.0 turns a -0.0 partial
    into +0.0 and leaves every other value as it is, so a table summed
    with zero tables (the mesh's all-reduce) keeps every bit."""
    rows = stack.reshape(*stack.shape[:-1], blocks,
                         stack.shape[-1] // blocks)
    if fused.routed(rows):
        return _fused_sum(rows, plus_zero=True)
    return tree_sum(rows) + 0.0


class LaneReducer:
    """A lane reduction split at the block-table seam: ``partials``
    builds the ``[K, ..., LANE_BLOCKS]`` table (local work) and ``fold``
    turns it into the lane vector; calling the reducer runs both. The
    seam is the overlap schedule's: it carries the in-flight table and
    folds it one window late."""

    def partials(self, stack: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def fold(self, table: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gather_table(self, table: torch.Tensor) -> torch.Tensor:
        """The global block table from a local one (a checkpoint's
        capture of the overlap carry): the identity on one device."""
        raise NotImplementedError

    def fold_start(self, table: torch.Tensor):
        """Start ``fold(table)`` and return a handle for
        ``fold_finish``: the overlap schedule starts a window's fold
        before the next window's work and finishes it after. ``table``
        must not be written in between. On one device nothing is in
        flight."""
        return table

    def fold_finish(self, handle) -> torch.Tensor:
        return self.fold(handle)

    def __call__(self, stack: torch.Tensor) -> torch.Tensor:
        return self.fold(self.partials(stack))


class _SingleDeviceReducer(LaneReducer):
    """One device: ``[K, ..., L]`` -> ``[K, ..., blocks]`` -> ``[K, ...]``.

    ``blocks`` defaults to the digest-pinned ``LANE_BLOCKS``; other
    widths (registry.AUTOTUNE_LANE_BLOCKS) sum in another order, so
    their output conforms statistically, not bitwise."""

    def __init__(self, blocks: int = LANE_BLOCKS) -> None:
        self.blocks = blocks

    def partials(self, stack: torch.Tensor) -> torch.Tensor:
        return _block_partials(stack, self.blocks)

    def fold(self, table: torch.Tensor) -> torch.Tensor:
        return tree_sum(table)

    def gather_table(self, table: torch.Tensor) -> torch.Tensor:
        return table


#: the single-device reducer every caller passes by default
reduce_lanes_single = _SingleDeviceReducer()


class _MeshReducer(LaneReducer):
    """The lane reducer of one rank of a mesh: ``partials`` writes the
    rank's ``LANE_BLOCKS / scope_shards`` block partials into its own
    columns of a zero ``[K, LANE_BLOCKS]`` table, ``fold`` all-reduces
    the table over the scope's group (the window's one collective) and
    folds it as one device does. ``collectives`` is the mesh's counted
    collective layer (``sim/mesh.py``)."""

    def __init__(self, collectives, group, scope_index: int,
                 scope_shards: int):
        if LANE_BLOCKS % scope_shards:
            raise ValueError(
                f"device count {scope_shards} must divide "
                f"LANE_BLOCKS={LANE_BLOCKS}")
        self.coll = collectives
        self.group = group
        self.per = LANE_BLOCKS // scope_shards
        self.col0 = scope_index * self.per

    def partials(self, stack: torch.Tensor) -> torch.Tensor:
        part = _block_partials(stack, self.per)
        table = torch.zeros(part.shape[:-1] + (LANE_BLOCKS,),
                            dtype=torch.float32, device=part.device)
        table[..., self.col0:self.col0 + self.per] = part
        return table

    def gather_table(self, table: torch.Tensor) -> torch.Tensor:
        # each column has one owner and the others hold +0.0: the sum
        # places the owners' values exactly
        return self.coll.all_reduce_sum(table.clone(), self.group)

    def fold(self, table: torch.Tensor) -> torch.Tensor:
        return tree_sum(self.gather_table(table))

    def fold_start(self, table: torch.Tensor):
        return self.coll.all_reduce_sum(table.clone(), self.group,
                                        async_op=True)

    def fold_finish(self, handle) -> torch.Tensor:
        return tree_sum(handle.wait())


def mesh_lane_reducer(collectives, group, scope_index: int,
                      scope_shards: int) -> LaneReducer:
    """The lane reducer of one mesh rank (see ``_MeshReducer``):
    ``scope_shards`` ranks share the reduction scope (all of them for
    the global pool, one DC's for per-DC pools), and this rank is
    ``scope_index`` among them; the count must divide ``LANE_BLOCKS``."""
    return _MeshReducer(collectives, group, scope_index, scope_shards)


def seed_table(lanes0: torch.Tensor, shard_offset: int = 0) -> torch.Tensor:
    """A block table whose ``fold`` is exactly ``lanes0``: the overlap
    schedule's first in-flight carry. Only the shard at global offset 0
    holds the values, in column 0; every other entry is +0.0, so the
    mesh's sum and the fold add only exact zeros."""
    table = torch.zeros(lanes0.shape + (LANE_BLOCKS,), dtype=torch.float32,
                        device=lanes0.device)
    if shard_offset == 0:
        table[..., 0] = lanes0
    return table


def carry_table(table0: torch.Tensor, shard_offset: int = 0) -> torch.Tensor:
    """A checkpoint's global in-flight table for a resumed overlap scan:
    the shard at global offset 0 carries all of it, every other shard
    zeros, so the mesh's sum reassembles ``table0`` on any device count
    (one device: a copy)."""
    if shard_offset == 0:
        return table0.to(torch.float32).clone()
    return torch.zeros_like(table0, dtype=torch.float32)


# ------------------------------------------------------- lane consumers


def scalars_from_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """The stale population scalars (``[8, ...]``, round.N_SCALARS
    layout) from a reduced lane vector, floors applied after the
    reduction."""
    s = lanes[:_N_SC]
    floors = _floors.get(s.device)
    if floors is None:
        # made once per device: a copy from host memory makes the host
        # wait for the card
        floors = _floors[s.device] = torch.tensor(
            _FLOORS, dtype=torch.float32, device=s.device)
    return torch.maximum(s, floors.view((_N_SC,) + (1,) * (s.dim() - 1)))


_floors: dict = {}


def stats_delta_from_lanes(lanes: torch.Tensor) -> SimStats:
    """The window's SimStats delta from the reduced lane vector: the
    counter lanes as int32 (exact: sums of 0/1), latency a true f32
    sum."""
    d = lanes[STATS_SLICE]
    return SimStats(**{f: d[i] if i == _LAT else d[i].to(torch.int32)
                       for i, f in enumerate(STATS_FIELDS)})


def max_lh_from_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """Cluster max local health from the exceedance-count lanes."""
    return (lanes[_HIST_SLICE] > 0.0).to(torch.float32).sum(0)
