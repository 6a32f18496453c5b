"""The sharded lane engine on ``torch.distributed``.

The port of the JAX package's ``consul_tpu/sim/mesh.py``. The node axis
is cut into contiguous slices, one per rank, over a 2-D ("dc", "nodes")
layout of the ranks: rank r is DC ``r // nodes`` and node slot
``r % nodes``, and its rows are ``[r·L, (r+1)·L)`` of the pool, L the
rows per rank. "dc" models the WAN dimension and "nodes" the pool of
one datacenter.

Each rank runs the lane engine (``round._lane_scan``) on its slice with
a mesh lane reducer (``lanes.mesh_lane_reducer``): per-node draws are
keyed by the global node index (``shard_offset``) and each window's
reduction all-reduces one ``[N_REDUCE_LANES, LANE_BLOCKS]`` block table,
exactly (see ``sim/lanes.py``). So a sharded run equals the single-
device lane engine (``round.make_run_rounds_lanes``) bit for bit, on any
world size — the reference's own parity claim (its mesh.py:20-31).

Collectives go through one counted layer (``Collectives``): a run makes
the two staged ``init_lanes`` reductions, then exactly one all-reduce
per ``stale_k`` window and none on the rounds between; under
``overlap`` each window's all-reduce is started asynchronously before
the next window's rounds and waited on after them, and a drain fold
follows the loop. ``COLLECTIVES`` counts them by op, as the kernels'
``LAUNCHES`` count launches. On the card, gloo takes CUDA tensors for
every op the port uses (``all_reduce`` SUM/MAX, ``all_gather``,
``all_to_all_single``: torch 2.11), so nothing is staged through host
memory; ``COLLECTIVE_DEVICES`` records the device type each op ran on.

The caller starts the processes and the default process group;
``launch`` does both for a function of the mesh: ``spawn``ed ranks, a
``file://`` rendezvous in a temporary directory, one CPU thread per
rank, a join timeout, and on a rank's failure or timeout the other
ranks killed and that rank's traceback raised. NCCL takes one card per
rank, so on one card only a world of 1 runs on NCCL; gloo can put
several ranks on one card (a correctness check, not scaling).

Not ported: the reference's ``unroll`` (an HLO-audit knob; a Python
loop has nothing to unroll). The runners donate the rank's slice as the
single-device engines do (``graphs``' module doc).
"""

from __future__ import annotations

import collections
import datetime
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from consul_tpu_torch.faults import CompiledFaultPlan, shard_plan
from consul_tpu_torch.sim import lanes as lanes_mod
from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.round import _lane_scan, own_scalars
from consul_tpu_torch.sim.state import NODE_FIELDS, SimState, init_state
from consul_tpu_torch.utils.platform import DeviceLike, default_device

#: collectives issued by this process, by op (reset with
#: ``reset_collectives``)
COLLECTIVES: collections.Counter = collections.Counter()
#: op -> the device types of the tensors it ran on
COLLECTIVE_DEVICES: dict = collections.defaultdict(set)


def reset_collectives() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_DEVICES.clear()


class Collectives:
    """The port's collective layer: every collective of the mesh and
    the sharded views goes through here and is counted by op."""

    @staticmethod
    def _count(op: str, t: torch.Tensor) -> None:
        COLLECTIVES[op] += 1
        COLLECTIVE_DEVICES[op].add(t.device.type)

    def _all_reduce(self, t: torch.Tensor, red: str, group, async_op):
        """All-reduce ``t`` in place; returns ``t``, or under
        ``async_op`` a handle whose ``wait()`` returns it."""
        self._count(f"all_reduce_{red}", t)
        op = dist.ReduceOp.SUM if red == "sum" else dist.ReduceOp.MAX
        work = dist.all_reduce(t, op=op, group=group, async_op=async_op)
        return _Pending(t, work) if async_op else t

    def all_reduce_sum(self, t, group, async_op=False):
        return self._all_reduce(t, "sum", group, async_op)

    def all_reduce_max(self, t, group, async_op=False):
        return self._all_reduce(t, "max", group, async_op)

    def all_gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t`` in rank order. The
        bytes are gathered (``uint8``), so any dtype travels exactly —
        gloo and NCCL have no int16."""
        self._count("all_gather", t)
        flat = t.contiguous().reshape(-1)
        raw = flat.view(torch.uint8) if flat.dtype != torch.bool \
            else flat.to(torch.uint8)
        parts = [torch.empty_like(raw)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, raw, group=group)
        out = torch.stack(parts)
        out = out.view(t.dtype) if t.dtype != torch.bool else out.bool()
        return out.reshape((len(parts),) + tuple(t.shape))

    def all_to_all(self, t: torch.Tensor, group) -> torch.Tensor:
        """Split ``t``'s first dim into world equal blocks and send
        block j to rank j: row block i of the result came from rank i."""
        self._count("all_to_all", t)
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out


class _Pending:
    """An async collective in flight: ``wait()`` returns its tensor."""

    def __init__(self, t: torch.Tensor, work) -> None:
        self.t, self.work = t, work

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return self.t


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the ("dc", "nodes") layout: the world size,
    this rank, the DC count, this rank's device, the global group and
    this rank's DC's "nodes" group (``None`` is the default group), and
    the collective layer."""

    world: int
    rank: int
    dc: int
    device: torch.device
    group: Any
    nodes_group: Any
    coll: Collectives

    @property
    def nodes(self) -> int:
        return self.world // self.dc

    @property
    def coords(self) -> tuple:
        """(dc index, node slot) of this rank."""
        return divmod(self.rank, self.nodes)

    def rows(self, n: int) -> slice:
        """This rank's slice of an ``n``-row node axis."""
        if n % self.world:
            raise ValueError(f"n={n} rows do not split over "
                             f"{self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def _rank_device(device: DeviceLike, rank: int) -> torch.device:
    """A rank's device: ``device`` as given, a CUDA one without an index
    being ``cuda:(rank % device count)`` (made current)."""
    dev = default_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def make_mesh(dc: int = 1, device: DeviceLike = None) -> Mesh:
    """This rank's Mesh over the initialized default process group.
    Every rank creates the per-DC groups in the same order. ``device``
    is the card unless the caller names another; a CUDA device without
    an index is ``cuda:(rank % device count)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group, "
                           "or mesh.launch)")
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = str(dist.get_backend())
    if world % dc:
        raise ValueError(f"{world} ranks not divisible by dc={dc}")
    dev = _rank_device(device, rank)
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(
            f"NCCL takes one card per rank: world {world} on "
            f"{torch.cuda.device_count()} card(s); use gloo to put "
            "ranks on one card")
    nodes = world // dc
    nodes_group = None
    if dc > 1:
        for d in range(dc):
            g = dist.new_group(list(range(d * nodes, (d + 1) * nodes)))
            if d == rank // nodes:
                nodes_group = g
    return Mesh(world=world, rank=rank, dc=dc, device=dev, group=None,
                nodes_group=nodes_group, coll=Collectives())


def _make_mesh_run(p: SimParams, rounds: int, mesh: Mesh, per_dc: bool,
                   flight_every: Optional[int] = None,
                   plan: Optional[CompiledFaultPlan] = None,
                   overlap: bool = False, carry: bool = False,
                   resume: bool = False):
    """One factory for every mesh runner. ``per_dc=False`` is one global
    pool (the reduction scope is every rank); ``per_dc=True`` gives each
    DC its own pool (the scope is the DC's "nodes" group, and ``p.n`` is
    the pool of one DC) — the node offsets stay global either way.

    ``run(state, key, cp=None, lanes0=None, table0=None)`` takes this
    rank's slice of the state and the (replicated) base key, updates the
    slice in place and returns it — ``(state, trace)`` with
    ``flight_every``, the carry appended under ``carry=True`` (the lane
    vector; under overlap the undrained global table too, gathered by
    one all-reduce after the loop). ``resume=True`` makes the runner
    take such a carry back (``lanes0``; ``table0`` under overlap). The
    plan is the whole pool's; each rank reads its columns."""
    if p.collect_stats and per_dc:
        # every rank holds the stats; per-DC sums would leave per-DC
        # partial counters posing as global totals
        raise ValueError(
            "per-DC pools cannot carry global stats counters; build "
            "SimParams with collect_stats=False")
    if overlap and per_dc:
        # seed_table keys the init carry on GLOBAL shard offset 0; in a
        # per-DC scope the pools of DC >= 1 would fold an all-zero
        # scalar vector
        raise ValueError(
            "overlap is implemented for the global reduction scope "
            "only; per-DC/segment pools run the synchronous schedule")
    lanes_mod.check_schedule(p, rounds, flight_every, overlap)
    lanes_mod.check_pool(p.n)
    slot = mesh.coords[1]
    if per_dc:
        scope_shards, scope_index, group = mesh.nodes, slot, mesh.nodes_group
    else:
        scope_shards, scope_index, group = mesh.world, mesh.rank, mesh.group
    reducer = lanes_mod.mesh_lane_reducer(mesh.coll, group, scope_index,
                                          scope_shards)
    rows = p.n // scope_shards
    offset = mesh.rank * rows
    with_table = resume and overlap

    def run(state: SimState, key: torch.Tensor,
            cp: Optional[CompiledFaultPlan] = None, lanes0=None,
            table0=None):
        if (lanes0 is not None or table0 is not None) and not resume:
            raise ValueError("resume carries need a resume=True mesh "
                             "runner (the runner's carries are fixed at "
                             "build time)")
        if cp is not None and plan is None:
            raise ValueError("this runner was built without a fault "
                             "plan; rebuild with plan= to inject one")
        if resume and lanes0 is None:
            raise ValueError("resume=True mesh runners take the "
                             "checkpoint's lane vector (lanes0)")
        if table0 is not None and not with_table:
            # a checkpoint with an in-flight table came from an overlap
            # run: dropping it would lose the undrained window's stats
            raise ValueError("table0 is the overlap schedule's "
                             "in-flight carry; rebuild the mesh "
                             "runner with overlap=True (and resume=)")
        if with_table and table0 is None:
            raise ValueError("overlap resume needs the in-flight "
                             "table (table0)")
        if state.status.shape[-1] != rows:
            raise ValueError(
                f"rank {mesh.rank} holds {state.status.shape[-1]} rows; "
                f"this runner's slice is {rows} (init_sharded_state)")
        full_plan = cp if cp is not None else plan
        local_plan = None if full_plan is None else shard_plan(
            full_plan, offset, offset + rows)
        keys = prng.round_keys(key.to(mesh.device), state.round_idx, rounds)
        return _lane_scan(own_scalars(state), keys, local_plan, p, rounds,
                          flight_every, reducer, shard_offset=offset,
                          overlap=overlap, lanes0=lanes0, table0=table0,
                          return_carry=carry)

    return run


def make_sharded_run(p: SimParams, rounds: int, mesh: Mesh,
                     flight_every: Optional[int] = None,
                     plan: Optional[CompiledFaultPlan] = None,
                     overlap: bool = False, carry: bool = False,
                     resume: bool = False):
    """The mesh runner over ONE global pool of ``p.n`` nodes: one
    all-reduce per ``p.stale_k``-round window; with ``flight_every``
    the return is (state, trace), the rows built from the reduced lane
    vector (no extra collective). ``overlap`` folds each window's
    all-reduce one window late, in flight during the next window's
    rounds; ``carry``/``resume`` are the checkpoint seam (see
    ``_make_mesh_run``)."""
    return _make_mesh_run(p, rounds, mesh, False, flight_every=flight_every,
                          plan=plan, overlap=overlap, carry=carry,
                          resume=resume)


def make_multidc_run(p: SimParams, rounds: int, mesh: Mesh,
                     plan: Optional[CompiledFaultPlan] = None):
    """Per-DC independent LAN pools on the mesh's "dc" axis: the lanes
    reduce over each DC's "nodes" group only, so pools never couple.
    ``p.n`` is the PER-DC pool size; the state holds ``p.n * dc`` rows
    across the ranks."""
    return _make_mesh_run(p, rounds, mesh, True, plan=plan)


def make_segmented_run(p: SimParams, rounds: int, mesh: Mesh,
                       plan: Optional[CompiledFaultPlan] = None):
    """Network segments (isolated LAN pools within one datacenter) as
    the "dc" axis: mechanically ``make_multidc_run``, kept as its own
    entry point beside the framework's segment serfs. ``p.n`` is the
    PER-SEGMENT pool size."""
    return _make_mesh_run(p, rounds, mesh, True, plan=plan)


def init_sharded_state(n: int, mesh: Mesh) -> SimState:
    """This rank's rows of an ``n``-node initial state, built on its
    device: no rank ever holds the whole pool."""
    sl = mesh.rows(n)
    return init_state(sl.stop - sl.start, device=mesh.device)


def gather_state(state: SimState, mesh: Mesh) -> Optional[SimState]:
    """The whole state on rank 0 (``None`` on the others): the ranks'
    per-node tensors concatenated in rank order, the replicated scalars
    and stats as rank 0 holds them. Every rank must call it."""
    cols = {f: mesh.coll.all_gather(getattr(state, f), mesh.group)
            for f in NODE_FIELDS}
    if mesh.rank:
        return None
    return state._replace(**{f: c.reshape(-1) for f, c in cols.items()})


# ------------------------------------------------------------ launcher

#: seconds a rank may take, start-up included, unless the caller says
LAUNCH_TIMEOUT_S = 600.0


class LaunchError(RuntimeError):
    """A rank failed, died or timed out; the message names it and
    carries its traceback."""


def to_host(obj):
    """``obj`` with every tensor replaced by a numpy array (tuples,
    NamedTuples, lists and dicts walked): what a rank hands back."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_host(x) for x in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, backend: str, device, dc: int,
               init: str, timeout_s: float, fn, args, results) -> None:
    torch.set_num_threads(1)
    try:
        _rank_device(device, rank)
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException:  # noqa: BLE001 — every failure goes to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        out = fn(make_mesh(dc=dc, device=device), *args)
        results.put((rank, True, to_host(out)))
    except BaseException:  # noqa: BLE001
        # reported before the group is torn down: a peer may be waiting
        # in a collective, and the parent kills it
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def launch(world: int, fn: Callable, *, backend: str, device: DeviceLike,
           dc: int = 1, args: tuple = (),
           timeout: float = LAUNCH_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks and return
    their results in rank order (tensors as numpy arrays). ``fn`` must
    be a module-level function. The ranks rendezvous through a file in
    a temporary directory (never a fixed TCP port), run with one CPU
    thread, and must all report within ``timeout`` seconds; when a rank
    fails, dies or times out, the others are killed and ``LaunchError``
    carries that rank's traceback. The backend is the caller's: gloo or
    nccl; nothing retries on another."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="consul-mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, world, backend, device, dc, init, timeout, fn, args,
                  results)) for r in range(world)]
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            for pr in procs:
                pr.start()
        finally:
            if saved is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        out: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world)) - set(out))
                    raise LaunchError(
                        f"ranks {missing} of {world} gave no result "
                        f"within {timeout:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, pr in enumerate(procs):
                        if r not in out and not pr.is_alive():
                            raise LaunchError(
                                f"rank {r} of {world} exited with code "
                                f"{pr.exitcode} before reporting")
                    continue
                if not ok:
                    raise LaunchError(
                        f"rank {rank} of {world} failed:\n{payload}")
                out[rank] = payload
            for pr in procs:
                pr.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                pr.join()
    return [out[r] for r in range(world)]
