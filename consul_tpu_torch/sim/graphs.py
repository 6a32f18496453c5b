"""Whole-call CUDA graphs: the port's counterpart of one jitted program.

The JAX package runs every runner as one ``jax.jit(donate_argnums=0)``
program: one dispatch per call, with the seeds, the population scalars,
the plan's phase lookup, the recorders and the loop on the device. A
static-shape body captured once in a ``torch.cuda.CUDAGraph`` and
replayed is PyTorch's counterpart, and ``GraphCache`` is the unit that
does it:

* on first sight of a key (the runner's own static choices, the
  argument tree's structure, every tensor's shape, dtype and device and
  every non-tensor leaf) it runs the body eagerly on the caller's own
  tensors: that call is the warm-up (it fills the lazy caches: the
  kernels' library, per-device constants), its launches count as they
  happen, and a runner called once costs what the eager run costs;
* on second sight it captures the body into a graph, on a side stream,
  over static input buffers and in a memory pool the cache's graphs
  share, and replays it;
* on every later call it writes the arguments into the static buffers with
  ``copy_``, replays the graph, and clones the outputs out of the pool,
  as a jitted call returns fresh buffers: a caller who keeps call 1's
  stats or trace never sees call 2 overwrite them;
* the ``carry`` is the caller's state, donated (JAX's
  ``donate_argnums=0``): a tree of tensors (a ``SimState``, or a
  ``NamedTuple`` of one and named extras) that the body updates in
  place (``assign``), keyed as the arguments are. Its tensors are copied
  into the static buffers before the replay and back after it, so the
  caller's tensors hold the result. The cache keys on shapes, not on
  data pointers: a restored or resumed state (a checkpoint load, a twin
  chunk, a sweep point) arrives in new tensors, and a pointer key would
  capture anew for each, while the two copies move 2 x 15 B a node a
  call;
* ``counters`` (the kernel wrappers' launch counters; the draw and sum
  kernels' ``fused.LAUNCHES`` and the coordinate kernels'
  ``coord_kernel.LAUNCHES`` always) count what each call launches:
  the capture launches nothing, so its increments are taken back, and
  the captured launches are added on every replay;
* the key holds the ``fused.plain()`` switch: a body captured with the
  draw and sum kernels is not replayed where the plain versions were
  asked for;
* a body that opens a device span (``telemetry.span(..., device=True)``:
  the coordinate step and the quality row) is captured a second time as
  a run of graphs cut where it opens and closes one, its outputs copied
  into the first capture's. While a profiler records, a replay launches
  those parts, each captured inside such a span inside that span again,
  so the profiler annotates a replay's device time as it annotates an
  eager call's; otherwise it launches the one graph (each launch of a
  part costs the host tens of µs: 48 more a coordinates body cost its
  cell ~4-10% of its rate). The parts share the cache's pool and replay
  in the order of their capture, which is what makes the sharing safe.

Every runner whose reference donates holds one contract: the returned
state holds the caller's per-node tensors, updated in place; its clock,
round and counters are private copies the runner makes once a call, and
every other output is fresh. A caller that needs a state after passing
it clones it first, as a JAX caller must.

A failed capture or replay raises; nothing falls back to the eager
body: a body that syncs (a host read, a copy from pageable host memory)
fails its capture (a key's second call), which CUDA refuses. The CPU
runs the body eagerly, and so does the card inside ``eager()`` — the
explicit request the checks that hold a graph against its eager run
make.

``rehearse()`` is the capture rehearsal for the CPU: every body that a
cache would capture runs under a ``TorchDispatchMode`` that refuses each
host read (``.item()``, ``int()`` / ``float()`` / ``bool()`` of a
tensor, ``.tolist()``, ``.numpy()``, ``.cpu()``, the ops whose output
shape depends on the data) and records every op with its non-tensor
arguments. Two calls that differ in key, start round and phase must
dispatch the same op sequence with the same scalars: a Python int that
varies between calls and reaches a fill would be baked into a graph.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import time
import warnings
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from consul_tpu_torch.sim import coord_kernel, fused
from consul_tpu_torch.utils import telemetry

#: graphs a cache keeps; the least recently used is dropped beyond it
MAX_GRAPHS = 8

#: a cache key not seen yet (a key seen once maps to None)
_UNSEEN = object()

#: the name of a replay's groups of copies in a timeline's reading
COPIES = "sim.graph.copies"

#: captures since the process started: ``graphs`` and their ``ms``, so
#: a caller that times a run can report the capture apart from the
#: replays, as a JAX bench splits compile from dispatch
CAPTURES: collections.Counter = collections.Counter()

_eager = contextvars.ContextVar("consul_tpu_torch_graphs_eager",
                                default=False)
_rehearsal = contextvars.ContextVar("consul_tpu_torch_graphs_rehearsal",
                                    default=None)


@contextlib.contextmanager
def eager():
    """Run every captured runner's body eagerly inside this block, on
    the card too (the comparison of a graph with its eager run, the
    cost model's op count)."""
    token = _eager.set(True)
    try:
        yield
    finally:
        _eager.reset(token)


def captures(device: torch.device) -> bool:
    """Whether a body on ``device`` runs as a replayed graph."""
    return device.type == "cuda" and not _eager.get()


class pinned:
    """A key part that names an object by identity and keeps it alive
    while a graph keyed by it lives: a body that reads tensors it was
    not passed (a fault plan) bakes their pointers into the graph, so a
    call with other such tensors must capture anew."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, pinned) and other.obj is self.obj


def direct(key, body: Callable, carry, *args):
    """A ``GraphCache`` call that never captures: ``body(carry, *args)``
    (a mesh rank's collectives cannot be captured)."""
    return body(carry, *args)


def assign(dst, src) -> None:
    """Write the tensors of ``src`` into those of ``dst`` in place, leaf
    by leaf: a body's new value of its carry. A leaf that already is the
    carry's own tensor is left alone."""
    dl, sl = tree_leaves(dst), tree_leaves(src)
    if len(dl) != len(sl):
        raise ValueError(f"a carry of {len(dl)} leaves cannot take "
                         f"{len(sl)}")
    for d, x in zip(dl, sl):
        if isinstance(d, torch.Tensor) and d is not x:
            d.copy_(x)


def fresh(tree):
    """``tree`` with every tensor cloned: a caller's copy of a state it
    keeps (a runner that does not donate), or a call's outputs."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _tensors(leaves) -> list:
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _load(dst: list, src: list) -> None:
    for d, x in zip(dst, src):
        d.copy_(x)


class _Parts:
    """A body captured as a run of graphs, cut at each device span it
    opens or closes (``telemetry.cutting``; one graph where nothing
    cuts): ``(span, graph)`` parts, ``span`` the name of the innermost
    device span open while the part was captured (None outside any)."""

    def __init__(self, pool):
        self.pool = pool
        self.parts: list = []
        self._open: list = []
        self._graph = None

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self._graph = self._graph, None
        with warnings.catch_warnings():
            # two cuts in a row leave an empty part, which replays as
            # nothing
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            graph.capture_end()
        self.parts.append((self._open[-1] if self._open else None, graph))

    def abandon(self) -> None:
        """End a capture the body's error left open."""
        if self._graph is not None:
            with contextlib.suppress(RuntimeError):
                self._graph.capture_end()
            self._graph = None

    def cut(self, name: Optional[str]) -> None:
        """A device span opens (``name``) or closes (None)."""
        self.end()
        if name is None:
            self._open.pop()
        else:
            self._open.append(name)
        self.begin()

    def replay(self) -> None:
        for name, graph in self.parts:
            if name is None:
                graph.replay()
            else:
                with telemetry.span(name, device=True):
                    graph.replay()


def _nbytes(tensors) -> int:
    return sum(x.nbytes for x in tensors)


class _Entry:
    """One captured body: its graph and, for a body with device spans,
    its ``_Parts``; its static inputs (the carry's tensors first,
    ``donated`` of them) and outputs, the launches one replay makes,
    what the capture cost, and the bytes of a replay's three groups of
    copies (in, back, the outputs' clones) for a listening timeline."""

    __slots__ = ("graph", "parts", "inputs", "donated", "out", "launches",
                 "capture_ms", "pool_bytes", "replays", "in_bytes",
                 "back_bytes", "out_bytes")

    def __init__(self, graph, parts, inputs, donated, out, launches,
                 capture_ms, pool_bytes):
        self.graph = graph
        self.parts = parts
        self.inputs = inputs
        self.donated = donated
        self.out = out
        self.launches = launches
        self.capture_ms = capture_ms
        self.pool_bytes = pool_bytes
        self.replays = 0
        self.in_bytes = _nbytes(inputs)
        self.back_bytes = _nbytes(inputs[:donated])
        self.out_bytes = _nbytes(_tensors(tree_leaves(out)))


class GraphCache:
    """The captured bodies of one runner, keyed by its static choices
    and the arguments' specs (see the module's doc); at most
    ``MAX_GRAPHS`` keys, least recently used dropped first."""

    def __init__(self, counters: Sequence[collections.Counter] = ()):
        self.counters = tuple(counters) + (fused.LAUNCHES,
                                           coord_kernel.LAUNCHES)
        # key -> _Entry, or None for a key seen once (run eagerly)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # one memory pool for the cache's graphs: they replay one at a
        # time on one stream and every output is cloned out at once, so
        # no graph's live tensors sit in memory another graph writes
        self._pool = None

    def __call__(self, key, body: Callable, carry, *args):
        """``body(carry, *args)``: eager on a key's first call, captured
        on its second and replayed from then on, on the card; eager on
        the CPU and inside ``eager()``. ``key`` names the runner's
        static choices (hashable); the carry's tensors are updated in
        place; the outputs are fresh tensors. The call is the span
        ``sim.graph.call``; on the card it holds ``sim.graph.eager`` (a
        key's first call) or ``sim.graph.capture`` (its second), or
        ``sim.graph.prepare`` (the key, the copies into the static
        buffers), ``sim.graph.launch`` (the replay) and
        ``sim.graph.finish`` (the copies back, the outputs cloned); each
        group of copies is a ``telemetry.copying`` group (``COPIES``),
        and the spans declare their stretches (``GRAPH``, ``QUIET``,
        ``REPLAY``), so that a timeline's stretches are each one replay,
        one group of copies or host code that launches nothing."""
        with telemetry.span("sim.graph.call", stretch=telemetry.GRAPH):
            return self._call(key, body, carry, args)

    def _call(self, key, body, carry, args):
        # one tree, the carry's leaves first
        leaves, spec = tree_flatten((carry, args))
        tensors = _tensors(leaves)
        dev = tensors[0].device if tensors else None
        if dev is None or not captures(dev):
            rec = _rehearsal.get()
            if rec is None or (dev is not None and dev.type != "cpu"):
                return body(carry, *args)
            with rec.armed(self._key(key, leaves, spec)):
                return body(carry, *args)
        with telemetry.span("sim.graph.prepare", stretch=telemetry.QUIET):
            full_key = self._key(key, leaves, spec)
            entry = self._entries.get(full_key, _UNSEEN)
            if entry is not None and entry is not _UNSEEN:
                self._entries.move_to_end(full_key)
                with telemetry.copying(COPIES, entry.in_bytes):
                    _load(entry.inputs, tensors)
        if entry is _UNSEEN:
            self._remember(full_key, None)
            with telemetry.span("sim.graph.eager"):
                return body(carry, *args)
        if entry is None:
            with telemetry.span("sim.graph.capture"):
                entry = self._capture(body, leaves, spec,
                                      len(_tensors(tree_leaves(carry))))
                self._remember(full_key, entry)
                _load(entry.inputs, tensors)
        with telemetry.span("sim.graph.launch", stretch=telemetry.REPLAY):
            if entry.parts is not None and telemetry.annotating():
                entry.parts.replay()
            else:
                entry.graph.replay()
        with telemetry.span("sim.graph.finish", stretch=telemetry.QUIET):
            entry.replays += 1
            for c, d in zip(self.counters, entry.launches):
                c.update(d)
            with telemetry.copying(COPIES, entry.back_bytes):
                _load(tensors[:entry.donated], entry.inputs)
            with telemetry.copying(COPIES, entry.out_bytes):
                return fresh(entry.out)

    @staticmethod
    def _key(key, leaves, spec) -> tuple:
        """The full key: the runner's, the ``plain()`` switch, the tree
        of the carry and the arguments, and each leaf's spec."""
        return (key, fused.plain_active(), spec,
                tuple((tuple(x.shape), x.dtype, x.device)
                      if isinstance(x, torch.Tensor) else ("leaf", x)
                      for x in leaves))

    def _remember(self, key, entry) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > MAX_GRAPHS:
            self._entries.popitem(last=False)

    def _capture(self, body, leaves, spec, donated: int) -> _Entry:
        """Capture ``body`` over static buffers (filled by ``copy_``
        before each replay, so they start empty); the key's eager first
        call was the warm-up."""
        s_leaves = [torch.empty_like(x) if isinstance(x, torch.Tensor)
                    else x for x in leaves]
        s_carry, s_args = tree_unflatten(s_leaves, spec)
        inputs = _tensors(s_leaves)
        dev = inputs[0].device
        before = [collections.Counter(c) for c in self.counters]
        t0 = time.perf_counter()
        reserved0 = torch.cuda.memory_reserved(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        whole, parts, spans = _Parts(self._pool), None, []
        side = torch.cuda.Stream(dev)
        try:
            # capture_begin/end rather than the torch.cuda.graph context,
            # which also collects garbage and empties the allocator's
            # cache on entry (seconds after a large eager phase)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                out = self._record(whole, spans.append, body, s_carry,
                                   s_args)
                launches = [c - b for c, b in zip(self.counters, before)]
                if spans:
                    parts = _Parts(self._pool)
                    self._record(parts, parts.cut, lambda *a: assign(
                        out, body(*a)), s_carry, s_args)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
        finally:
            # the capture launched nothing: each replay counts its launches
            for c, b in zip(self.counters, before):
                c.clear()
                c.update(b)
        capture_ms = (time.perf_counter() - t0) * 1e3
        CAPTURES.update(graphs=1, ms=capture_ms)
        return _Entry(whole.parts[0][1], parts, inputs, donated, out,
                      launches, capture_ms,
                      torch.cuda.memory_reserved(dev) - reserved0)

    def _record(self, graph: _Parts, cut, body, s_carry, s_args):
        """``body``'s launches captured into ``graph``, each device span
        it opens or closes handed to ``cut``; returns its outputs."""
        graph.begin()
        try:
            with telemetry.cutting(cut):
                out = body(s_carry, *s_args)
        except BaseException:
            graph.abandon()
            # an invalidated capture leaves its pool recording: the
            # cache's next capture takes a new one
            self._pool = None
            raise
        graph.end()
        return out

    def stats(self) -> list:
        """Per captured graph: capture ms, the bytes
        the capture added to the cache's memory pool (its peak: the pool
        keeps its segments), the parts it was cut into, replays so far
        and the launches one replay counts."""
        return [{"capture_ms": e.capture_ms, "pool_bytes": e.pool_bytes,
                 "parts": len(e.parts.parts) if e.parts else 1,
                 "replays": e.replays,
                 "launches": [dict(d) for d in e.launches]}
                for e in self._entries.values() if e is not None]


# ------------------------------------------------------ host reads


class HostReadError(RuntimeError):
    """A body meant for capture read a device value on the host."""


#: ops that read a device value on the host, or whose output shape
#: depends on the data (the card would sync to size the output)
_HOST_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
    "aten::equal", "aten::nonzero", "aten::masked_select",
    "aten::_unique2", "aten::unique_consecutive", "aten::unique_dim",
    "aten::repeat_interleave"})


def _is_host_read(func, args, kwargs) -> bool:
    name = func._schema.name
    if name in _HOST_OPS:
        return not (name == "aten::repeat_interleave"
                    and not isinstance(args[0], torch.Tensor))
    if name in ("aten::index", "aten::index_put", "aten::index_put_"):
        # a boolean mask index is a nonzero
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in args[1] if i is not None)
    if name == "aten::copy_":
        return args[1].device.type == "cuda" and args[0].device.type == "cpu"
    if name == "aten::_to_copy":
        dst = (kwargs or {}).get("device")
        return (args[0].device.type == "cuda" and dst is not None
                and torch.device(dst).type == "cpu")
    return False


def _scalar_leaf(x) -> Any:
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, float):
        return ("float", x.hex())
    return x


class Rehearsal(TorchDispatchMode):
    """The record of a rehearsal: ``calls``, one ``(key, ops)`` entry per
    body run, ``ops`` one ``(op, args)`` entry per dispatched op, each
    tensor argument as its shape and dtype and every other argument as
    its value. Every host read raises ``HostReadError`` by name. (Only
    the CPU tests use a dispatch mode: its first use imports
    ``torch._dynamo``, seconds a process.)"""

    def __init__(self):
        super().__init__()
        self.calls: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        leaves, _ = tree_flatten((args, kwargs or {}))
        self.calls[-1][1].append((func._schema.name,
                                  tuple(_scalar_leaf(x) for x in leaves)))
        if _is_host_read(func, args, kwargs):
            raise HostReadError(
                f"{func._schema.name} reads the device from the host "
                "inside a body meant for a CUDA graph")
        return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def armed(self, key):
        """Run one body (its cache key ``key``) under the rehearsal."""
        self.calls.append((key, []))
        patched = {name: getattr(torch.Tensor, name)
                   for name in ("tolist", "numpy", "cpu")}

        def refuse(name):
            def read(*_a, **_k):
                raise HostReadError(
                    f"Tensor.{name}() inside a body meant for a CUDA "
                    "graph")
            return read

        try:
            for name in patched:
                setattr(torch.Tensor, name, refuse(name))
            with self:
                yield
        finally:
            for name, fn in patched.items():
                setattr(torch.Tensor, name, fn)


@contextlib.contextmanager
def rehearse():
    """Run every body a ``GraphCache`` would capture under a
    ``Rehearsal`` (CPU tensors only); yields it."""
    rec = Rehearsal()
    token = _rehearsal.set(rec)
    try:
        yield rec
    finally:
        _rehearsal.reset(token)


def first_difference(a: list, b: list) -> Optional[tuple]:
    """The first body run at which two lists of ``(key, ops)`` records
    differ — ``(index, a's, b's)`` — or None when they ran the same
    bodies with the same ops and scalars."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    if len(a) != len(b):
        i = min(len(a), len(b))
        return (i, a[i] if i < len(a) else None,
                b[i] if i < len(b) else None)
    return None
