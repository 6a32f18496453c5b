"""Checkpoint and resume for the simulation engines.

The port of the JAX package's ``consul_tpu/sim/checkpoint.py``. A run of
R rounds cut after r rounds, saved to a file, loaded in a new process
and finished is bit for bit the straight run — state, stats, flight
trace and black-box rings — on three engines:

* ``"lanes"`` — the exact lane engine (``round.make_run_rounds_lanes``,
  ``carry=True``): the cut carries the reduced lane vector;
* ``"xla"`` — the live engine (``round.run_rounds`` /
  ``run_rounds_flight``): the cut carries the black-box rings and the
  Vivaldi coordinates;
* ``"cuda"`` — the kernel runner (``cuda_round.make_run_rounds_cuda``,
  ``carry=True``): the cut carries the stale-scalar vector the next
  call consumes, in the file's ``scalars`` entry (the reference's
  Pallas runner seam).

Three things make it exact. The per-round keys and seeds are functions
of the base key and the ABSOLUTE round (``prng.round_keys`` /
``round_seeds`` read the offset from ``state.round_idx``). The cut
carries what the engines carry besides the state. And a cut lands only
where that carry is fresh: on a ``stale_k`` window end, on a flight
stride, and on the kernel runner's call boundary (``rounds_per_call``).

The file is the reference's, byte for byte in layout: ``MAGIC``, a
4-byte header length, a JSON header (``registry.
CHECKPOINT_HEADER_FIELDS``) and an npz payload whose sha256 the header
holds. The header binds ``registry.layout_digest()``, a digest of the
SimParams fields and the compiled plan's digest, so a stale layout,
changed params or another plan are refused by name. Either package
reads the other's files: the base key is stored as its two uint32 words
(the port's key is int64 ``[2]`` holding them), 0-d leaves stay 0-d,
and every array keeps the reference's dtype.

A mesh run (``sim/mesh.py``, ``carry=True``) is cut by
``snapshot_mesh``: the ranks' slices gathered on rank 0 and snapshotted
as the lane engine's; ``load`` on one device then finishes the straight
single-device run bit for bit.

``PreemptionGuard`` turns SIGTERM/SIGINT into a flag ``run_resumable``
polls between chunks; a preempted run saves and returns
``preempted=True``, and the benches exit with ``PREEMPTED_RC``.
``python -m consul_tpu_torch.sim.checkpoint --ckpt-dir D`` is the
smallest preemptible driver (``_selftest_main``), on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
import os
import signal
import threading
import time
from dataclasses import dataclass, field, fields as dc_fields
from typing import Any, Optional

import numpy as np
import torch

from consul_tpu_torch.faults import plan_digest as _plan_digest
from consul_tpu_torch.sim import registry
from consul_tpu_torch.sim.mesh import Mesh, gather_state
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import (SaturationError, SimState, SimStats,
                                        saturated_fields)
from consul_tpu_torch.utils.platform import DeviceLike, default_device

#: file magic: "consul-tpu checkpoint" + the format version byte
MAGIC = b"CTPUCKPT" + bytes([registry.CHECKPOINT_VERSION])
SUFFIX = ".ckpt"

#: process exit code of a run that was preempted and saved (EX_TEMPFAIL:
#: resumable, not failed)
PREEMPTED_RC = 75

ENGINES = ("lanes", "xla", "cuda")


class CheckpointError(ValueError):
    """A file that must not be loaded: torn or corrupt payload, stale
    layout, other params or plan. The message names the guard."""


class CheckpointMismatch(CheckpointError):
    """An intact file that must not resume under the caller's
    configuration (layout, params, plan, format version). ``latest``
    falls back past a torn file but refuses the whole directory on a
    mismatch: every older file would mismatch the same way."""


# ------------------------------------------------------------- digests


def params_fields(p: SimParams) -> dict[str, Any]:
    """The SimParams field dict a header embeds (JSON-portable)."""
    return {f.name: getattr(p, f.name) for f in dc_fields(SimParams)}


def params_digest(p: SimParams) -> str:
    """16 hex chars over every SimParams field, by name and value."""
    blob = json.dumps(params_fields(p), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _params_mismatch(saved: dict[str, Any], p: SimParams) -> list[str]:
    """Names of the fields whose saved value differs from ``p``'s."""
    cur = params_fields(p)
    names = sorted(set(saved) | set(cur))
    return [n for n in names if saved.get(n) != cur.get(n)]


# ------------------------------------------------------------ snapshot


def _np(x) -> np.ndarray:
    """A host copy of ``x`` that keeps its shape (0-d stays 0-d). The
    engines update their tensors in place, so the copy is taken now."""
    if isinstance(x, torch.Tensor):
        a = x.detach().to("cpu", copy=True).numpy()
    else:
        a = np.array(x, copy=True)
    return np.ascontiguousarray(a).reshape(a.shape)


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fresh contiguous tensor of ``a`` on ``device``."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


@dataclass
class Snapshot:
    """One consistent cut of a run: meta and a flat name -> ndarray
    payload (``state/<field>``, ``state/stats/<field>`` and any of
    ``registry.CHECKPOINT_CARRIES``: ``lanes``, ``scalars``, ``table``,
    ``flight``, ``blackbox/<field>``, ``coords/<field>``,
    ``topo/<field>``)."""

    engine: str
    round_cursor: int
    total_rounds: int
    base_key: np.ndarray               # uint32 key words
    params: dict[str, Any]
    plan_digest: Optional[str]
    arrays: dict[str, np.ndarray] = field(default_factory=dict)
    #: paths ``latest`` skipped as torn or corrupt before this one
    fallbacks: list[str] = field(default_factory=list)

    # ---- reconstruction on a device (the card unless given) ----------

    def state(self, device: DeviceLike = None) -> SimState:
        dev = default_device(device)
        st = SimStats(**{f: _tensor(self.arrays[f"state/stats/{f}"], dev)
                         for f in SimStats._fields})
        return SimState(stats=st, **{
            f: _tensor(self.arrays[f"state/{f}"], dev)
            for f in SimState._fields if f != "stats"})

    def key(self, device: DeviceLike = None) -> torch.Tensor:
        return torch.from_numpy(
            np.asarray(self.base_key, np.uint32).astype(np.int64)).to(
                default_device(device))

    def _opt(self, name: str, device: DeviceLike):
        a = self.arrays.get(name)
        return None if a is None else _tensor(a, default_device(device))

    def lanes(self, device: DeviceLike = None):
        return self._opt("lanes", device)

    def scalars(self, device: DeviceLike = None):
        return self._opt("scalars", device)

    def table(self, device: DeviceLike = None):
        return self._opt("table", device)

    def flight(self) -> Optional[np.ndarray]:
        return self.arrays.get("flight")

    def _tree(self, prefix: str, cls, device: DeviceLike):
        if not any(k.startswith(prefix + "/") for k in self.arrays):
            return None
        dev = default_device(device)
        return cls(**{f: _tensor(self.arrays[f"{prefix}/{f}"], dev)
                      for f in cls._fields})

    def blackbox(self, device: DeviceLike = None):
        from consul_tpu_torch.sim.blackbox import BlackboxState

        return self._tree("blackbox", BlackboxState, device)

    def coords(self, device: DeviceLike = None):
        from consul_tpu_torch.sim.coords import CoordState

        return self._tree("coords", CoordState, device)

    def topo(self, device: DeviceLike = None):
        from consul_tpu_torch.sim.topology import Topology

        return self._tree("topo", Topology, device)


def snapshot(p: SimParams, key: torch.Tensor, state: SimState, *,
             engine: str, total_rounds: int, lanes=None, scalars=None,
             table=None, flight=None, blackbox=None, coords=None,
             topo=None, plan=None, record_every: Optional[int] = None,
             rounds_per_call: int = 1,
             plan_digest: Optional[str] = None) -> Snapshot:
    """A Snapshot of a run's cut, copied to the host now (the engines
    update their tensors in place). The cut must land on a ``stale_k``
    window end, a flight stride (``record_every``) and a kernel call
    boundary (``rounds_per_call``), and no packed lane may be saturated:
    each is refused by name. ``plan_digest`` is ``faults.plan_digest(
    plan)`` when the caller has it: the digest hashes every byte of the
    plan (143 MB at 1M nodes), so a run that cuts often computes it
    once."""
    cursor = int(state.round_idx)
    if cursor % p.stale_k:
        raise ValueError(
            f"checkpoint cut at round {cursor} is not a super-round "
            f"boundary (stale_k={p.stale_k}): the carried lane vector "
            "is only reduction-fresh at window ends")
    if record_every and cursor % record_every:
        raise ValueError(
            f"checkpoint cut at round {cursor} is not a flight-stride "
            f"boundary (record_every={record_every}): segment traces "
            "would not concatenate into the straight trace")
    if cursor % rounds_per_call:
        raise ValueError(
            f"checkpoint cut at round {cursor} is not a kernel-call "
            f"boundary (rounds_per_call={rounds_per_call}): the carried "
            "scalars are only the next call's input at call ends")
    arrays: dict[str, np.ndarray] = {}
    for f in SimState._fields:
        if f != "stats":
            arrays[f"state/{f}"] = _np(getattr(state, f))
    saturated = saturated_fields(
        lambda f: int(arrays[f"state/{f}"].max(initial=0)))
    if saturated:
        raise SaturationError(
            f"refusing checkpoint at round {cursor}: packed lanes "
            f"{', '.join(saturated)} hit the int16 saturation cap "
            f"({registry.TICK_MAX}) — the snapshot would resume from "
            "clamped values")
    for f in SimStats._fields:
        arrays[f"state/stats/{f}"] = _np(getattr(state.stats, f))
    for name, val in (("lanes", lanes), ("scalars", scalars),
                      ("table", table), ("flight", flight)):
        if val is not None:
            arrays[name] = _np(val)
    for prefix, tree in (("blackbox", blackbox), ("coords", coords),
                         ("topo", topo)):
        if tree is not None:
            for f in type(tree)._fields:
                arrays[f"{prefix}/{f}"] = _np(getattr(tree, f))
    return Snapshot(
        engine=engine, round_cursor=cursor, total_rounds=total_rounds,
        base_key=_np(key).astype(np.uint32), params=params_fields(p),
        plan_digest=_plan_digest(plan) if plan_digest is None
        else plan_digest, arrays=arrays)


def snapshot_mesh(p: SimParams, key: torch.Tensor, state: SimState,
                  mesh: Mesh, **kw) -> Optional[Snapshot]:
    """A mesh run's cut: the ranks' slices gathered (``mesh.
    gather_state``), then ``snapshot`` of the whole state on rank 0 —
    ``None`` on the others. Every rank must call it. The carry a
    ``carry=True`` mesh runner returns is already global (the lane
    vector is an all-reduce's product; the overlap table is gathered),
    so the file is the single-device engine's and resumes on any device
    count, one device included, bit for bit."""
    whole = gather_state(state, mesh)
    if whole is None:
        return None
    return snapshot(p, key, whole, engine="lanes", **kw)


# --------------------------------------------------------- file format


def _ckpt_name(cursor: int) -> str:
    return f"ckpt-r{cursor:010d}{SUFFIX}"


def _fsync_dir(directory: str) -> None:
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # a platform without directory fsync


def save(path_or_dir: str, snap: Snapshot, keep_last: int = 3) -> str:
    """Write ``snap`` atomically: tmp file, flush and fsync, rename,
    directory fsync. A directory target names the file
    ``ckpt-r<cursor>.ckpt`` and, once it is durable, unlinks all but the
    newest ``keep_last``."""
    if os.path.isdir(path_or_dir) or path_or_dir.endswith(os.sep) \
            or not path_or_dir.endswith(SUFFIX):
        os.makedirs(path_or_dir, exist_ok=True)
        path = os.path.join(path_or_dir, _ckpt_name(snap.round_cursor))
        directory = path_or_dir
    else:
        path = path_or_dir
        directory = os.path.dirname(path) or "."

    payload = io.BytesIO()
    np.savez(payload, **snap.arrays)
    body = payload.getvalue()
    header = {
        "version": registry.CHECKPOINT_VERSION,
        "engine": snap.engine,
        "round_cursor": snap.round_cursor,
        "total_rounds": snap.total_rounds,
        "base_key": [int(w) for w in snap.base_key.reshape(-1)],
        "layout_digest": registry.layout_digest(),
        "params_digest": hashlib.sha256(json.dumps(
            snap.params, sort_keys=True).encode()).hexdigest()[:16],
        "params": snap.params,
        "plan_digest": snap.plan_digest,
        "arrays": {k: [str(v.dtype), list(v.shape)]
                   for k, v in sorted(snap.arrays.items())},
        "payload_sha256": hashlib.sha256(body).hexdigest(),
    }
    assert set(header) == set(registry.CHECKPOINT_HEADER_FIELDS), \
        "header schema drifted from registry.CHECKPOINT_HEADER_FIELDS"
    hb = json.dumps(header, sort_keys=True).encode()
    blob = MAGIC + len(hb).to_bytes(4, "big") + hb + body

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(directory)
    if keep_last and keep_last > 0:
        peers = sorted(f for f in os.listdir(directory)
                       if f.startswith("ckpt-r") and f.endswith(SUFFIX))
        for old in peers[:-keep_last]:
            try:
                os.unlink(os.path.join(directory, old))
            except OSError:
                pass
    return path


def load(path: str, p: Optional[SimParams] = None,
         plan=None) -> Snapshot:
    """Read and verify one file. Raises ``CheckpointError`` naming the
    guard: checksum (torn or corrupt), format version, layout digest,
    SimParams fields (by name), plan digest. ``p`` and ``plan`` arm
    their guards: pass what the resumed run will use."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC[:-1]):
        raise CheckpointError(f"{path}: not a consul-tpu checkpoint "
                              "(bad magic)")
    if len(blob) < len(MAGIC):
        raise CheckpointError(f"{path}: truncated before the format "
                              "version byte")
    if blob[:len(MAGIC)] != MAGIC:
        raise CheckpointMismatch(
            f"{path}: checkpoint format version "
            f"{blob[len(MAGIC) - 1]} != {registry.CHECKPOINT_VERSION} "
            "(refusing to guess a schema)")
    off = len(MAGIC)
    if len(blob) < off + 4:
        raise CheckpointError(f"{path}: truncated header length")
    hlen = int.from_bytes(blob[off:off + 4], "big")
    off += 4
    if len(blob) < off + hlen:
        raise CheckpointError(f"{path}: truncated header")
    try:
        header = json.loads(blob[off:off + hlen])
    except ValueError as e:
        raise CheckpointError(f"{path}: corrupt header JSON: {e}")
    missing = [k for k in registry.CHECKPOINT_HEADER_FIELDS
               if k not in header]
    if missing:
        raise CheckpointError(
            f"{path}: header missing {missing} "
            "(registry.CHECKPOINT_HEADER_FIELDS)")
    body = blob[off + hlen:]
    got = hashlib.sha256(body).hexdigest()
    if got != header["payload_sha256"]:
        raise CheckpointError(
            f"{path}: payload checksum mismatch (torn or corrupt "
            f"write): {got[:16]} != {header['payload_sha256'][:16]}")
    if header["layout_digest"] != registry.layout_digest():
        raise CheckpointMismatch(
            f"{path}: layout digest {header['layout_digest']} != "
            f"current registry {registry.layout_digest()} — the "
            "flight/lane/event layout changed since this checkpoint "
            "was written; its arrays no longer decode")
    if p is not None:
        bad = _params_mismatch(header["params"], p)
        if bad:
            raise CheckpointMismatch(
                f"{path}: SimParams mismatch on field(s) "
                f"{', '.join(bad)} — a checkpoint resumes only under "
                "the exact params that wrote it")
    if plan is not None or header.get("plan_digest"):
        want, have = header.get("plan_digest"), _plan_digest(plan)
        if want != have:
            raise CheckpointMismatch(
                f"{path}: fault-plan digest mismatch (checkpoint "
                f"{want}, resume {have}) — the plan's phase tensors "
                "are dynamics inputs; resume under the same compiled "
                "plan")
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return Snapshot(
        engine=header["engine"],
        round_cursor=int(header["round_cursor"]),
        total_rounds=int(header["total_rounds"]),
        base_key=np.asarray(header["base_key"], np.uint32),
        params=header["params"], plan_digest=header.get("plan_digest"),
        arrays=arrays)


def latest(directory: str, p: Optional[SimParams] = None,
           plan=None) -> Optional[Snapshot]:
    """The newest loadable checkpoint in ``directory``, or None. Walks
    newest first past torn or corrupt files (recorded on the returned
    Snapshot's ``fallbacks``); a ``CheckpointMismatch`` propagates, and
    a directory whose every file is torn is refused."""
    try:
        names = sorted((f for f in os.listdir(directory)
                        if f.startswith("ckpt-r") and f.endswith(SUFFIX)),
                       reverse=True)
    except FileNotFoundError:
        return None
    skipped: list[str] = []
    for name in names:
        path = os.path.join(directory, name)
        try:
            snap = load(path, p=p, plan=plan)
        except CheckpointMismatch:
            raise
        except CheckpointError:
            skipped.append(path)
            continue
        snap.fallbacks = skipped
        return snap
    if skipped:
        raise CheckpointError(
            f"{directory}: every checkpoint is torn/corrupt "
            f"({len(skipped)} file(s)) — refusing to silently start "
            "over; clear the directory to begin a fresh run")
    return None


# ---------------------------------------------------- preemption guard


class PreemptionGuard:
    """SIGTERM/SIGINT -> a flag the chunked driver polls between chunks.
    ``deadline_s`` bounds the save window once preempted."""

    def __init__(self, deadline_s: float = 30.0,
                 signals=(signal.SIGTERM, signal.SIGINT)):
        self.deadline_s = deadline_s
        self.signals = tuple(signals)
        self._evt = threading.Event()
        self._at: Optional[float] = None
        self._old: dict[int, Any] = {}

    def install(self) -> "PreemptionGuard":
        for sig in self.signals:
            self._old[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old.clear()

    def _handler(self, signum, frame) -> None:
        self.trip()

    def trip(self) -> None:
        """Mark preemption (the signal handler's body; tests call it)."""
        if not self._evt.is_set():
            self._at = time.monotonic()
        self._evt.set()

    @property
    def preempted(self) -> bool:
        return self._evt.is_set()

    @property
    def past_deadline(self) -> bool:
        return (self._at is not None
                and time.monotonic() - self._at > self.deadline_s)

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


# ------------------------------------------------------- chunked driver


@dataclass
class RunResult:
    """What ``run_resumable`` returns (None where the run has none)."""

    state: Optional[SimState]
    trace: Optional[np.ndarray]        # spliced flight rows (host)
    blackbox: Any = None               # final BlackboxState
    coords: Any = None                 # evolved CoordState (xla + flight)
    preempted: bool = False
    checkpoint_path: Optional[str] = None
    rounds_done: int = 0
    resumed_from: Optional[int] = None  # cursor the run restarted at
    fallbacks: list = field(default_factory=list)


def _chunk_for(p: SimParams, rounds: int, chunk: Optional[int],
               record_every: Optional[int],
               rounds_per_call: int = 1) -> int:
    """The chunk size: a multiple of lcm(stale_k, record_every,
    rounds_per_call), so every chunk boundary is a consistent cut."""
    align = math.lcm(p.stale_k, record_every or 1, rounds_per_call)
    if chunk is None:
        chunk = max(align, ((64 + align - 1) // align) * align)
    if chunk % align:
        raise ValueError(
            f"chunk={chunk} is not a consistent-cut cadence: needs a "
            f"multiple of lcm(stale_k={p.stale_k}, "
            f"record_every={record_every or 1}, "
            f"rounds_per_call={rounds_per_call}) = {align}")
    return min(chunk, rounds) if rounds else chunk


def run_resumable(p: SimParams, rounds: int, key=None, *, seed: int = 0,
                  engine: str = "lanes", plan=None,
                  flight_every: Optional[int] = None, tracked=None,
                  coords=None, topo=None, chunk: Optional[int] = None,
                  ckpt_dir: Optional[str] = None, keep_last: int = 3,
                  save_every: int = 1,
                  guard: Optional[PreemptionGuard] = None,
                  resume: bool = False, rounds_per_call: int = 1,
                  device: DeviceLike = None) -> RunResult:
    """Run ``rounds`` periods in consistent-cut chunks, bit for bit the
    one-call run. After each chunk it saves to ``ckpt_dir`` (every
    ``save_every`` chunks, keeping the last ``keep_last``) and polls
    ``guard``; a tripped guard saves the cut and returns
    ``preempted=True``. ``resume=True`` restarts from the newest
    loadable file in ``ckpt_dir`` (falling back past torn ones) and
    splices the flight trace and the rings, so the finished run equals
    an uninterrupted one.

    Engines (``ENGINES``): ``"lanes"`` (``make_run_rounds_lanes``:
    ``p.stale_k``, plan, flight), ``"xla"`` (``run_rounds`` /
    ``run_rounds_flight``: plan, flight, the black box on ``tracked``,
    coordinates) and ``"cuda"`` (``make_run_rounds_cuda`` at
    ``rounds_per_call``: plan at R = 1, flight, the black box). A file
    written by one engine is refused by another, by name. The run lives
    on ``device`` (the card unless the caller passes ``"cpu"``), as
    must ``key``, ``plan``, ``tracked``, ``coords`` and ``topo``.

    Each file holds the whole flight prefix recorded so far, so any one
    surviving file restores the full trace; for long recorded runs
    raise ``save_every`` or the chunk."""
    from consul_tpu_torch.sim import prng
    from consul_tpu_torch.sim import round as round_mod
    from consul_tpu_torch.sim.state import init_state

    if engine not in ENGINES:
        raise ValueError(f"unknown resumable engine {engine!r} "
                         f"(expected one of {ENGINES})")
    if coords is not None and (engine != "xla" or flight_every is None):
        raise ValueError("coords resumable runs need engine='xla' "
                         "with flight_every set (the coords update "
                         "rides the flight scan)")
    if rounds_per_call != 1 and engine != "cuda":
        raise ValueError("rounds_per_call is the kernel runner's knob — "
                         "pass engine='cuda' (the lane engine amortizes "
                         "through SimParams.stale_k)")
    if save_every < 1:
        raise ValueError(f"save_every must be >= 1: {save_every}")
    dev = default_device(device)
    if key is None:
        key = prng.key(seed, device=dev)
    R = rounds_per_call
    chunk = _chunk_for(p, rounds, chunk, flight_every, R)

    state = None
    lv = table = bb = sc = None
    flight_parts: list[np.ndarray] = []
    cursor = 0
    resumed_from = None
    fallbacks: list = []
    if resume:
        if not ckpt_dir:
            raise ValueError("resume=True needs ckpt_dir")
        snap = latest(ckpt_dir, p=p, plan=plan)
        if snap is not None:
            if snap.engine != engine:
                raise CheckpointError(
                    f"checkpoint engine {snap.engine!r} != {engine!r}")
            state = snap.state(dev)
            key = snap.key(dev)
            cursor = resumed_from = snap.round_cursor
            rounds = snap.total_rounds
            lv, table = snap.lanes(dev), snap.table(dev)
            sc, bb = snap.scalars(dev), snap.blackbox(dev)
            if coords is not None:
                coords = snap.coords(dev)
            fl = snap.flight()
            if fl is not None:
                flight_parts.append(fl)
            fallbacks = snap.fallbacks
    if state is None:
        state = init_state(p.n, device=dev)

    def trace():
        return np.concatenate(flight_parts) if flight_parts else None

    digest = _plan_digest(plan) if ckpt_dir else None

    def save_cut(st) -> Optional[str]:
        if not ckpt_dir:
            return None
        return save(ckpt_dir, snapshot(
            p, key, st, engine=engine, total_rounds=rounds, lanes=lv,
            scalars=sc, table=table, flight=trace(), blackbox=bb,
            coords=coords, topo=topo, plan=plan,
            record_every=flight_every, rounds_per_call=R,
            plan_digest=digest), keep_last=keep_last)

    runners: dict[tuple, Any] = {}

    def runner(n_rounds: int, with_bb: bool):
        k = (n_rounds, with_bb)
        if k not in runners:
            if engine == "lanes":
                runners[k] = round_mod.make_run_rounds_lanes(
                    p, n_rounds, flight_every=flight_every, plan=plan,
                    carry=True)
            else:
                from consul_tpu_torch.sim.cuda_round import (
                    make_run_rounds_cuda)

                runners[k] = make_run_rounds_cuda(
                    p, n_rounds, rounds_per_call=R, carry=True, plan=plan,
                    flight_every=flight_every, blackbox=with_bb)
        return runners[k]

    path = None
    chunk_i = 0
    while cursor < rounds:
        step = min(chunk, rounds - cursor)
        if guard is not None and guard.preempted:
            path = save_cut(state)
            return RunResult(state=state, trace=trace(), blackbox=bb,
                             coords=coords, preempted=True,
                             checkpoint_path=path, rounds_done=cursor,
                             resumed_from=resumed_from,
                             fallbacks=fallbacks)
        if engine == "lanes":
            out = runner(step, False)(state, key, lanes0=lv)
            if flight_every is not None:
                state, tr, lv = out
                flight_parts.append(_np(tr))
            else:
                state, lv = out
        elif engine == "cuda":
            with_bb = tracked is not None or bb is not None
            out = list(runner(step, with_bb)(
                state, key, scalars0=sc,
                tracked=tracked if bb is None else None, bb0=bb))
            state, sc = out[0], out[-1]
            if flight_every is not None:
                flight_parts.append(_np(out[1]))
            if with_bb:
                bb = out[2]
        elif flight_every is not None:
            out = list(round_mod.run_rounds_flight(
                state, key, p, step, record_every=flight_every, plan=plan,
                coords=coords, topo=topo,
                tracked=tracked if bb is None else None, bb0=bb))
            state = out.pop(0)
            if coords is not None:
                coords = out.pop(0)
            flight_parts.append(_np(out.pop(0)))
            if out:
                bb = out.pop(0)
        else:
            state, _ = round_mod.run_rounds(state, key, p, step, plan=plan)
        cursor += step
        chunk_i += 1
        if ckpt_dir and cursor < rounds and chunk_i % save_every == 0:
            path = save_cut(state)
    return RunResult(state=state, trace=trace(), blackbox=bb,
                     coords=coords, preempted=False, checkpoint_path=path,
                     rounds_done=cursor, resumed_from=resumed_from,
                     fallbacks=fallbacks)


# ----------------------------------------------------- bench progress


class ProgressManifest:
    """Suite-level resume for the benches: a small JSON record of the
    finished units (chaos classes, sweep topology classes) beside the
    checkpoints, rewritten atomically on each completion and bound to
    the invocation's configuration."""

    #: reserved key holding the writing invocation's configuration
    CONFIG_KEY = "__config__"

    def __init__(self, directory: str, name: str = "progress.json",
                 config: Optional[dict] = None):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, name)
        self._done: dict[str, Any] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self._done = json.load(f)
            except (OSError, ValueError):
                self._done = {}  # a torn manifest: redo, never crash
        if config is not None:
            saved = self._done.get(self.CONFIG_KEY)
            if saved is not None and saved != config:
                bad = sorted(k for k in set(saved) | set(config)
                             if saved.get(k) != config.get(k))
                raise ValueError(
                    f"{self.path}: progress manifest was written "
                    f"under a different configuration (mismatched: "
                    f"{', '.join(bad)}) — resume with the same flags "
                    "or point --ckpt-dir at a fresh directory")
            if saved is None:
                self._done[self.CONFIG_KEY] = config
                self._flush()

    def done(self, unit: str) -> bool:
        return unit != self.CONFIG_KEY and unit in self._done

    def result(self, unit: str) -> Any:
        return self._done.get(unit)

    def mark(self, unit: str, result: Any = True) -> None:
        self._done[unit] = result
        self._flush()

    def _flush(self) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self._done, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    @property
    def completed(self) -> list[str]:
        return sorted(k for k in self._done if k != self.CONFIG_KEY)


# ----------------------------------------------------- selftest driver


def state_digest(state: SimState) -> str:
    """16 hex chars over every tensor of the state, in field order."""
    from consul_tpu_torch.sim.state import _leaves

    h = hashlib.sha256()
    for leaf in _leaves(state):
        h.update(_np(leaf).tobytes())
    return h.hexdigest()[:16]


def _selftest_main(argv=None) -> int:
    """``python -m consul_tpu_torch.sim.checkpoint --ckpt-dir D [...]``:
    the smallest preemptible driver. It installs the guard, runs a
    lane-engine sim in checkpointed chunks, prints ONE JSON line and
    exits ``PREEMPTED_RC`` when a signal cut it short. ``--sleep``
    stretches each poll so a signal lands between chunks."""
    import argparse

    ap = argparse.ArgumentParser(prog="consul_tpu_torch.sim.checkpoint")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--stale-k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sleep", type=float, default=0.0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    p = SimParams(n=args.n, loss=0.05, tcp_fallback=False,
                  fail_per_round=0.01, rejoin_per_round=0.05,
                  stale_k=args.stale_k)
    guard = PreemptionGuard().install()
    if args.sleep > 0:
        orig = PreemptionGuard.preempted.fget

        def paced(self):
            time.sleep(args.sleep)
            return orig(self)

        type(guard).preempted = property(paced)  # type: ignore

    rr = run_resumable(
        p, args.rounds, seed=args.seed, engine="lanes", chunk=args.chunk,
        ckpt_dir=args.ckpt_dir, guard=guard, resume=args.resume,
        device=args.device)
    print(json.dumps({
        "preempted": rr.preempted,
        "rounds_done": rr.rounds_done,
        "rounds": args.rounds,
        "resumed_from": rr.resumed_from,
        "checkpoint": rr.checkpoint_path,
        "state_digest": state_digest(rr.state),
    }), flush=True)
    return PREEMPTED_RC if rr.preempted else 0


if __name__ == "__main__":  # pragma: no cover — subprocess surface
    import sys

    sys.exit(_selftest_main())
