"""consul_tpu_torch's checkpoints (sim/checkpoint.py) against the JAX
reference's contract (tests/test_checkpoint.py), on the CPU.

* A run cut, saved to a FILE, loaded and finished is bit for bit the
  straight run — state, stats, flight trace, black-box rings — on the
  live (xla), lane (stale_k 1 and 4, overlap) and kernel-runner (cuda)
  engines, under an armed FaultPlan mid-phase, and through the chunked
  driver ``run_resumable``. On the CPU the kernel runner takes the plain
  versions; a ``cuda``-marked test runs the kernels.
* Torn, corrupt, stale-layout, wrong-params, wrong-plan and
  wrong-version files are refused by name; keep-last-k rotation; the
  registry digest covers the header schema.
* Crash injection: ``python -m consul_tpu_torch.sim.checkpoint --device
  cpu`` is SIGKILLed (its newest file torn: the resume falls back and
  finishes bit for bit) or SIGTERMed (``PREEMPTED_RC`` and valid JSON).
* The file format is the reference's: the reference's ``load`` reads a
  port file into the same arrays and digests, the port's ``load`` a
  reference file, and ``params_digest`` agrees for the same SimParams.

The reference's mesh-restore test waits for the port's mesh.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from chip_smoke import TripAfter
from consul_tpu_torch import faults as tf
from consul_tpu_torch.sim import checkpoint as ck
from consul_tpu_torch.sim import cuda_round, prng, registry
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.blackbox import decode_timeline, default_tracked
from consul_tpu_torch.sim.params import SimParams
from test_torch_harness import ROOT, cuda, ref  # noqa: F401  (fixtures)

CPU = "cpu"
#: the reference test's full-model config (small: this file is tier-1)
P = SimParams(n=256, loss=0.05, tcp_fallback=False, fail_per_round=0.01,
              rejoin_per_round=0.05, slow_per_round=0.01)
KEY = prng.key(42)


def _init(n=P.n):
    return tstate.init_state(n, device=CPU)


def _eq(a, b, what=""):
    """Every tensor of two states (or tuples of tensors) equal, shapes
    and dtypes included."""
    la = list(tstate._leaves(a)) if isinstance(a, tstate.SimState) else a
    lb = list(tstate._leaves(b)) if isinstance(b, tstate.SimState) else b
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, \
            (what, x.shape, y.shape, x.dtype, y.dtype)
        assert torch.equal(x, y), what


def _differs(a, b) -> bool:
    return any(not torch.equal(x, y) for x, y in
               zip(tstate._leaves(a), tstate._leaves(b)))


# ------------------------------------------------- key-stream contract


def test_round_keys_segment_invariant():
    """Round keys and seeds are functions of (base key, ABSOLUTE round):
    any segmentation draws the same values, and the offset matters."""
    k = prng.key(7)
    full = prng.round_keys(k, 0, 20)
    assert torch.equal(full[5:], prng.round_keys(k, 5, 15))
    s_full = prng.round_seeds(k, 0, 20)
    assert torch.equal(s_full[12:], prng.round_seeds(k, 12, 8))
    assert bool((s_full >= 0).all())
    assert not torch.equal(full[:5], prng.round_keys(k, 5, 5))


# ------------------------------------------- bitwise resume, per engine


def test_xla_engine_file_roundtrip_bitwise(tmp_path):
    """run_rounds: straight 30 == 12 + save to a file + load + 18."""
    full, _ = tround.run_rounds(_init(), KEY, P, 30)
    seg, _ = tround.run_rounds(_init(), KEY, P, 12)
    snap = ck.snapshot(P, KEY, seg, engine="xla", total_rounds=30)
    path = ck.save(str(tmp_path), snap)
    loaded = ck.load(path, p=P)
    assert loaded.round_cursor == 12 and loaded.total_rounds == 30
    res, _ = tround.run_rounds(loaded.state(CPU), loaded.key(CPU), P, 18)
    _eq(full, res, "xla resume")


@pytest.mark.parametrize("stale_k", [1, 4])
def test_lanes_engine_file_roundtrip_bitwise(tmp_path, stale_k):
    """The lane engine: the file carries the reduced lane vector and the
    resume is the straight run; at stale_k=4, resuming from the state
    alone (init_lanes' live sums) diverges — the carry is needed."""
    p = P.with_(stale_k=stale_k)
    full = tround.make_run_rounds_lanes(p, 32)(_init(), KEY)
    r1 = tround.make_run_rounds_lanes(p, 16, carry=True)
    s, lv = r1(_init(), KEY)
    snap = ck.snapshot(p, KEY, s, engine="lanes", total_rounds=32,
                       lanes=lv)
    path = ck.save(str(tmp_path), snap)
    loaded = ck.load(path, p=p)
    s2, _ = r1(loaded.state(CPU), loaded.key(CPU),
               lanes0=loaded.lanes(CPU))
    _eq(full, s2, f"lanes stale_k={stale_k} resume")
    if stale_k == 4:
        bad, _ = r1(loaded.state(CPU), loaded.key(CPU))  # lanes0 dropped
        assert _differs(full, bad), \
            "dropping the lane carry should have diverged the run"


def test_overlap_engine_file_roundtrip_bitwise(tmp_path):
    """The overlap schedule's in-flight table rides the file; the
    resumed chain ends with drain_overlap and equals the straight run."""
    p = P.with_(stale_k=2)
    full = tround.make_run_rounds_lanes(p, 32, overlap=True)(_init(), KEY)
    r1 = tround.make_run_rounds_lanes(p, 16, overlap=True, carry=True)
    s, lv, table = r1(_init(), KEY)
    snap = ck.snapshot(p, KEY, s, engine="lanes", total_rounds=32,
                       lanes=lv, table=table)
    path = ck.save(str(tmp_path), snap)
    loaded = ck.load(path, p=p)
    s2, _, t2 = r1(loaded.state(CPU), loaded.key(CPU),
                   lanes0=loaded.lanes(CPU), table0=loaded.table(CPU))
    _eq(full, tround.drain_overlap(s2, t2, p), "overlap resume")


def _partition_plan(n, a_end):
    return tf.FaultPlan(phases=(
        tf.Phase(rounds=8, name="warmup"),
        tf.Phase(rounds=16, faults=(tf.Partition(a=(0, a_end),
                                                 b=(a_end, n)),),
                 name="cut"),
        tf.Phase(rounds=8, name="heal")))


def test_fault_plan_resume_mid_phase_bitwise(tmp_path):
    """A cut inside the plan's fault phase resumes bit for bit under the
    same compiled plan; another plan, or none, is refused by digest."""
    n = P.n
    cp = tf.compile_plan(_partition_plan(n, 32), n, CPU)
    p = P.with_(stale_k=2)
    full = tround.make_run_rounds_lanes(p, 32, plan=cp)(_init(n), KEY)
    r1 = tround.make_run_rounds_lanes(p, 16, plan=cp, carry=True)
    s, lv = r1(_init(n), KEY)
    assert tf.active_phase(cp, int(s.round_idx)) == 1
    snap = ck.snapshot(p, KEY, s, engine="lanes", total_rounds=32,
                       lanes=lv, plan=cp)
    path = ck.save(str(tmp_path), snap)
    loaded = ck.load(path, p=p, plan=cp)
    assert tf.active_phase(cp, int(loaded.state(CPU).round_idx)) == 1
    s2, _ = r1(loaded.state(CPU), loaded.key(CPU),
               lanes0=loaded.lanes(CPU))
    _eq(full, s2, "armed-plan resume")
    other = tf.compile_plan(_partition_plan(n, 64), n, CPU)
    with pytest.raises(ck.CheckpointError, match="fault-plan digest"):
        ck.load(path, p=p, plan=other)
    with pytest.raises(ck.CheckpointError, match="fault-plan digest"):
        ck.load(path, p=p, plan=None)


def test_flight_and_blackbox_resume_exact():
    """run_rounds_flight with rings armed: the spliced trace is the
    straight trace row for row, and bb0 keeps the rings so the decoded
    timelines are identical."""
    tracked = default_tracked(P.n, 16, CPU)
    sf, trf, bbf = tround.run_rounds_flight(_init(), KEY, P, 16,
                                            record_every=4,
                                            tracked=tracked)
    s1, tr1, bb1 = tround.run_rounds_flight(_init(), KEY, P, 8,
                                            record_every=4,
                                            tracked=tracked)
    s2, tr2, bb2 = tround.run_rounds_flight(s1, KEY, P, 8, record_every=4,
                                            bb0=bb1)
    assert torch.equal(trf, torch.cat([tr1, tr2]))
    _eq(sf, s2, "flight resume state")
    assert decode_timeline(bbf) == decode_timeline(bb2)


def test_run_resumable_chunked_equals_straight():
    """The chunked driver is bit for bit the one-call run, the flight
    splice included."""
    p = P.with_(stale_k=2)
    sf, trf = tround.run_rounds_flight(_init(), prng.key(0), p, 16,
                                       record_every=2)
    rr = ck.run_resumable(p, 16, prng.key(0), engine="xla",
                          flight_every=2, chunk=8, device=CPU)
    _eq(sf, rr.state, "run_resumable state")
    assert np.array_equal(trf.numpy(), rr.trace)
    assert rr.rounds_done == 16 and not rr.preempted


def _plan_for(kind, n, device=CPU):
    """A churn burst behind a partition, mid-run (None for no plan)."""
    if kind is None:
        return None
    return tf.compile_plan(tf.FaultPlan(phases=(
        tf.Phase(rounds=8, name="warmup"),
        tf.Phase(rounds=16, name="churn", faults=(
            tf.Partition(a=(0, n // 8), b=(n // 8, n)),
            tf.ChurnBurst(nodes=(0, n // 4), crash=0.05, rejoin=0.2))),
        tf.Phase(rounds=8, name="heal"))), n, device)


@pytest.mark.parametrize("rpc,plan", [(1, "churn"), (4, None)])
def test_cuda_engine_cut_save_load_resume_bitwise(tmp_path, rpc, plan):
    """The kernel runner as a resumable engine (plain versions on the
    CPU): cut after two chunks by a tripped guard, resumed from the file
    with its scalars carry — state, stats, trace and rings are the
    straight run's. A file of another engine is refused by name."""
    cp = _plan_for(plan, P.n)
    tracked = default_tracked(P.n, 16, CPU)
    run = cuda_round.make_run_rounds_cuda(P, 32, rounds_per_call=rpc,
                                          plan=cp, flight_every=4,
                                          blackbox=True)
    sf, trf, bbf = run(_init(), KEY, tracked=tracked)
    kw = dict(engine="cuda", plan=cp, flight_every=4, tracked=tracked,
              chunk=8, ckpt_dir=str(tmp_path), rounds_per_call=rpc,
              device=CPU)
    cut = ck.run_resumable(P, 32, KEY, guard=TripAfter(2), **kw)
    assert cut.preempted and cut.rounds_done == 16
    snap = ck.load(cut.checkpoint_path, p=P, plan=cp)
    assert snap.engine == "cuda" and snap.scalars(CPU).shape == (8,)
    rr = ck.run_resumable(P, 32, KEY, resume=True, **kw)
    assert rr.resumed_from == 16 and rr.rounds_done == 32
    _eq(sf, rr.state, f"cuda R={rpc} resume")
    assert np.array_equal(trf.numpy(), rr.trace)
    _eq(list(bbf), list(rr.blackbox), "rings")
    with pytest.raises(ck.CheckpointError, match="engine 'cuda'"):
        ck.run_resumable(P, 32, KEY, engine="xla", plan=cp,
                         flight_every=4, chunk=8, ckpt_dir=str(tmp_path),
                         resume=True, device=CPU)


def test_cuts_off_a_boundary_are_refused_by_name(tmp_path):
    s = tround.make_run_rounds_lanes(P, 3)(_init(), KEY)
    with pytest.raises(ValueError, match="super-round"):
        ck.snapshot(P.with_(stale_k=2), KEY, s, engine="lanes",
                    total_rounds=8)
    with pytest.raises(ValueError, match="flight-stride"):
        ck.snapshot(P, KEY, s, engine="xla", total_rounds=8,
                    record_every=2)
    with pytest.raises(ValueError, match="kernel-call"):
        ck.snapshot(P, KEY, s, engine="cuda", total_rounds=8,
                    rounds_per_call=2)
    with pytest.raises(ValueError, match="lcm"):
        ck.run_resumable(P, 16, KEY, engine="cuda", rounds_per_call=4,
                         flight_every=8, chunk=4, device=CPU)
    hot = s._replace(incarnation=torch.full_like(s.incarnation,
                                                 tstate.TICK_MAX))
    with pytest.raises(tstate.SaturationError, match="incarnation"):
        ck.snapshot(P, KEY, hot, engine="xla", total_rounds=8)
    for engine in ("lanes", "cuda"):
        with pytest.raises(ValueError, match="engine='xla'"):
            ck.run_resumable(P, 8, KEY, engine=engine, flight_every=1,
                             coords=object(), device=CPU)
    with pytest.raises(ValueError, match="engine='cuda'"):
        ck.run_resumable(P, 8, KEY, engine="lanes", rounds_per_call=8,
                         device=CPU)


def test_xla_coords_resume_bitwise(tmp_path):
    """Vivaldi coordinates ride the xla engine's file: the resumed
    coordinates and trace columns are the straight run's."""
    from consul_tpu_torch.sim.coords import init_coords
    from consul_tpu_torch.sim.topology import TopologyParams, make_topology

    p = P.with_(coords_timeout=True)
    topo = make_topology(TopologyParams(n=p.n, seed=0), CPU)
    sf, cf, trf = tround.run_rounds_flight(
        _init(), KEY, p, 16, record_every=2,
        coords=init_coords(p.n, device=CPU), topo=topo)
    kw = dict(engine="xla", flight_every=2, topo=topo, chunk=8,
              ckpt_dir=str(tmp_path), device=CPU)
    cut = ck.run_resumable(p, 16, KEY, coords=init_coords(p.n, device=CPU),
                           guard=TripAfter(1), **kw)
    assert cut.preempted and cut.rounds_done == 8
    rr = ck.run_resumable(p, 16, KEY, coords=init_coords(p.n, device=CPU),
                          resume=True, **kw)
    _eq(sf, rr.state, "coords resume state")
    _eq(list(cf), list(rr.coords), "coords")
    assert np.array_equal(trf.numpy(), rr.trace)


# --------------------------------------------- adversarial file cases


@pytest.fixture(scope="module")
def ckpt_dir_two(tmp_path_factory):
    """A directory with checkpoints at cursors 8 and 16 (tests that
    tamper copy the files into their own tmp_path)."""
    d = tmp_path_factory.mktemp("guards")
    r = tround.make_run_rounds_lanes(P, 8, carry=True)
    s, lv = r(_init(), KEY)
    ck.save(str(d), ck.snapshot(P, KEY, s, engine="lanes",
                                total_rounds=24, lanes=lv))
    s, lv = r(s, KEY, lanes0=lv)
    ck.save(str(d), ck.snapshot(P, KEY, s, engine="lanes",
                                total_rounds=24, lanes=lv))
    return d


def _copy_ckpts(src_dir, dst_dir):
    return [str(shutil.copy(os.path.join(src_dir, name), dst_dir))
            for name in sorted(os.listdir(src_dir))
            if name.endswith(ck.SUFFIX)]


def test_truncated_checkpoint_rejected_then_fallback(tmp_path,
                                                     ckpt_dir_two):
    p1, p2 = _copy_ckpts(ckpt_dir_two, tmp_path)
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) // 2)
    with pytest.raises(ck.CheckpointError, match="checksum|truncated"):
        ck.load(p2, p=P)
    snap = ck.latest(str(tmp_path), p=P)
    assert snap is not None and snap.round_cursor == 8
    assert snap.fallbacks == [p2]


def test_resume_never_silently_starts_over(tmp_path, ckpt_dir_two):
    """A mismatch propagates out of latest()/run_resumable instead of
    reading as a torn file; a directory of torn files is refused."""
    paths = _copy_ckpts(ckpt_dir_two, tmp_path)
    with pytest.raises(ck.CheckpointMismatch, match="loss"):
        ck.latest(str(tmp_path), p=P.with_(loss=0.2))
    with pytest.raises(ck.CheckpointMismatch, match="loss"):
        ck.run_resumable(P.with_(loss=0.2), 24, KEY, engine="lanes",
                         chunk=8, ckpt_dir=str(tmp_path), resume=True,
                         device=CPU)
    with open(paths[1], "r+b") as f:
        f.truncate(len(ck.MAGIC) - 1)
    snap = ck.latest(str(tmp_path), p=P)
    assert snap.round_cursor == 8 and snap.fallbacks == [paths[1]]
    with open(paths[0], "r+b") as f:
        f.truncate(4)
    with pytest.raises(ck.CheckpointError, match="every checkpoint"):
        ck.latest(str(tmp_path), p=P)


def test_corrupted_payload_rejected_by_checksum(tmp_path, ckpt_dir_two):
    path = _copy_ckpts(ckpt_dir_two, tmp_path)[0]
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ck.CheckpointError, match="checksum"):
        ck.load(path, p=P)


def test_params_mismatch_refused_by_name(ckpt_dir_two):
    path = os.path.join(ckpt_dir_two, sorted(os.listdir(ckpt_dir_two))[0])
    with pytest.raises(ck.CheckpointError) as ei:
        ck.load(path, p=P.with_(loss=0.2, stale_k=4))
    msg = str(ei.value)
    assert "loss" in msg and "stale_k" in msg


def test_stale_layout_digest_refused(tmp_path, ckpt_dir_two):
    path = _copy_ckpts(ckpt_dir_two, tmp_path)[0]
    blob = open(path, "rb").read()
    cur = registry.layout_digest().encode()
    assert blob.count(cur) == 1
    open(path, "wb").write(blob.replace(cur, b"0" * 16))
    with pytest.raises(ck.CheckpointError, match="layout digest"):
        ck.load(path, p=P)


def test_format_version_refused(tmp_path, ckpt_dir_two):
    path = _copy_ckpts(ckpt_dir_two, tmp_path)[0]
    blob = bytearray(open(path, "rb").read())
    blob[len(ck.MAGIC) - 1] = registry.CHECKPOINT_VERSION + 1
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ck.CheckpointMismatch, match="format version"):
        ck.load(path, p=P)


def test_keep_last_k_rotation(tmp_path):
    runner = tround.make_run_rounds_lanes(P, 4, carry=True)
    s, lv = runner(_init(), KEY)
    for _ in range(5):
        ck.save(str(tmp_path), ck.snapshot(P, KEY, s, engine="lanes",
                                           total_rounds=64, lanes=lv),
                keep_last=3)
        s, lv = runner(s, KEY, lanes0=lv)
    names = sorted(f for f in os.listdir(tmp_path)
                   if f.endswith(ck.SUFFIX))
    assert names == ["ckpt-r0000000012.ckpt", "ckpt-r0000000016.ckpt",
                     "ckpt-r0000000020.ckpt"]


def test_registry_digest_covers_checkpoint_schema(monkeypatch):
    base = registry.layout_digest()
    monkeypatch.setattr(registry, "CHECKPOINT_HEADER_FIELDS",
                        registry.CHECKPOINT_HEADER_FIELDS + ("extra",))
    assert registry.layout_digest() != base
    monkeypatch.undo()
    assert registry.layout_digest() == base
    monkeypatch.setattr(registry, "CHECKPOINT_VERSION", 99)
    assert registry.layout_digest() != base
    monkeypatch.undo()
    monkeypatch.setattr(registry, "CHECKPOINT_CARRIES",
                        registry.CHECKPOINT_CARRIES[1:])
    assert registry.layout_digest() != base


# ------------------------------------------------- crash injection


def _spawn(ckpt_dir, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "consul_tpu_torch.sim.checkpoint",
         "--device", "cpu", "--ckpt-dir", str(ckpt_dir), "--n", "256",
         "--rounds", "48", "--chunk", "12", "--stale-k", "2", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        cwd=str(ROOT))


def _wait_ckpts(ckpt_dir, k, proc, timeout=120.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        n = len([f for f in os.listdir(ckpt_dir)
                 if f.endswith(ck.SUFFIX)]) if os.path.isdir(ckpt_dir) \
            else 0
        if n >= k:
            return
        if proc.poll() is not None:
            raise AssertionError(
                f"driver exited rc={proc.returncode} before writing "
                f"{k} checkpoints")
        time.sleep(0.05)
    raise AssertionError("timed out waiting for checkpoints")


def _crash_params():
    return SimParams(n=256, loss=0.05, tcp_fallback=False,
                     fail_per_round=0.01, rejoin_per_round=0.05, stale_k=2)


@functools.lru_cache(maxsize=1)
def _straight_digest() -> str:
    p = _crash_params()
    final = tround.make_run_rounds_lanes(p, 48)(_init(p.n), prng.key(0))
    return ck.state_digest(final)


def test_crash_injection_sigkill_torn_fallback_bitwise(tmp_path):
    """SIGKILL a driver mid-run, tear its newest file, resume here: the
    loader falls back past the torn file and the finished state is the
    uninterrupted run's."""
    d = tmp_path / "ck"
    proc = _spawn(d, "--sleep", "0.3")
    try:
        _wait_ckpts(d, 2, proc)
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    names = sorted(f for f in os.listdir(d) if f.endswith(ck.SUFFIX))
    assert len(names) >= 2
    newest = os.path.join(d, names[-1])
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) * 2 // 3)
    rr = ck.run_resumable(_crash_params(), 48, seed=0, engine="lanes",
                          chunk=12, ckpt_dir=str(d), resume=True,
                          device=CPU)
    assert rr.fallbacks == [newest], "must fall back past the torn file"
    assert rr.resumed_from is not None \
        and rr.resumed_from < int(names[-1][6:16].lstrip("0") or 0) + 1
    assert rr.rounds_done == 48
    assert ck.state_digest(rr.state) == _straight_digest()


def test_crash_injection_sigterm_preempted_rc_and_resume(tmp_path):
    """SIGTERM: the guard saves at the next chunk boundary, the driver
    prints valid JSON with preempted=true and exits PREEMPTED_RC; a
    resume in this process (which never wrote the files) finishes with
    the straight run's digest."""
    d = tmp_path / "ck"
    proc = _spawn(d, "--sleep", "0.3")
    try:
        _wait_ckpts(d, 1, proc)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == ck.PREEMPTED_RC, out
    rep = json.loads(out.decode().strip().splitlines()[-1])
    assert rep["preempted"] is True
    assert rep["rounds_done"] < 48 and rep["checkpoint"]
    rr = ck.run_resumable(_crash_params(), 48, seed=0, engine="lanes",
                          chunk=12, ckpt_dir=str(d), resume=True,
                          device=CPU)
    assert rr.resumed_from == rep["rounds_done"]
    assert rr.rounds_done == 48
    assert ck.state_digest(rr.state) == _straight_digest()


# ------------------------------------------ the reference's file format


def _ref_params(rsim, p: SimParams):
    return rsim.SimParams(**ck.params_fields(p))


@pytest.mark.parametrize("p", [
    P, P.with_(stale_k=4, corroboration_k=2), SimParams(),
    SimParams(n=9, probe_interval=5.0, gossip_interval=0.5, loss=0.03,
              coords_timeout=True, fault_gain=0.5)])
def test_params_digest_equals_the_reference(ref, p):
    from consul_tpu.sim import checkpoint as rck

    rp = _ref_params(ref, p)
    assert ck.params_fields(p) == rck.params_fields(rp)
    assert json.dumps(ck.params_fields(p), sort_keys=True) == \
        json.dumps(rck.params_fields(rp), sort_keys=True)
    assert ck.params_digest(p) == rck.params_digest(rp)
    assert len(ck.params_fields(p)) == 28


def _port_snapshot_with_every_carry():
    """A cut of the xla engine at round 8 with flight, rings and
    coordinates, plus lanes, scalars and a plan: every carry the format
    knows."""
    from consul_tpu_torch.sim.coords import init_coords
    from consul_tpu_torch.sim.topology import TopologyParams, make_topology

    n = P.n
    cp = tf.compile_plan(_partition_plan(n, 32), n, CPU)
    topo = make_topology(TopologyParams(n=n, seed=0), CPU)
    s, c, tr, bb = tround.run_rounds_flight(
        _init(), KEY, P, 8, record_every=2, plan=cp,
        coords=init_coords(n, device=CPU), topo=topo,
        tracked=default_tracked(n, 16, CPU))
    lv = tround.init_lanes(s, P, tround.lanes_mod.reduce_lanes_single)
    return cp, ck.snapshot(P, KEY, s, engine="xla", total_rounds=32,
                           lanes=lv, scalars=tround.init_scalars(s, P),
                           flight=tr, blackbox=bb, coords=c, topo=topo,
                           plan=cp, record_every=2)


def test_reference_loads_the_port_file(ref, tmp_path):
    """The reference's load reads a port file into the same arrays
    (names, dtypes, shapes, values; 0-d leaves stay 0-d) under the same
    layout, params and plan digests, and rebuilds its own state and
    key from it."""
    import jax

    from consul_tpu import faults as rf
    from consul_tpu.sim import checkpoint as rck
    from test_torch_faults import _ref_plan

    cp, snap = _port_snapshot_with_every_carry()
    path = ck.save(str(tmp_path), snap)
    rcp = rf.compile_plan(_ref_plan(_partition_plan(P.n, 32)), P.n)
    assert rf.plan_digest(rcp) == snap.plan_digest
    got = rck.load(path, p=_ref_params(ref, P), plan=rcp)
    assert got.round_cursor == 8 and got.engine == "xla"
    assert np.array_equal(got.base_key, snap.base_key)
    assert got.base_key.dtype == np.uint32
    assert set(got.arrays) == set(snap.arrays)
    for k, a in snap.arrays.items():
        b = got.arrays[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    rs = got.state()
    assert rs.t.shape == () and rs.round_idx.shape == ()
    assert int(rs.round_idx) == 8
    assert np.array_equal(np.asarray(jax.random.key_data(got.key())),
                          snap.base_key)
    assert set(got.blackbox()._fields) == set(snap.blackbox(CPU)._fields)


def test_port_loads_the_reference_file(ref, tmp_path):
    """A reference run's file reads into the port: the same arrays and
    key, and a port state equal to the reference's leaf for leaf."""
    import jax

    from consul_tpu.sim import checkpoint as rck
    from consul_tpu.sim.round import run_rounds as ref_run_rounds

    rp = _ref_params(ref, P.with_(stale_k=2))
    rkey = jax.random.key(42)
    rs, _ = ref_run_rounds(ref.init_state(P.n), rkey, rp, 6)
    rsnap = rck.snapshot(rp, rkey, rs, engine="lanes", total_rounds=12,
                         lanes=np.arange(8, dtype=np.float32))
    path = rck.save(str(tmp_path), rsnap)
    got = ck.load(path, p=P.with_(stale_k=2))
    assert set(got.arrays) == set(rsnap.arrays)
    for k, a in rsnap.arrays.items():
        b = got.arrays[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert torch.equal(got.key(CPU), KEY)
    st = got.state(CPU)
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(rs)]
    port_leaves = [st.status, st.incarnation, st.informed, st.down_age,
                   st.susp_len, st.susp_ttl, st.susp_conf, st.local_health,
                   st.t, st.round_idx] + list(st.stats)
    for name, x in zip(rs._fields, ref_leaves[:10]):
        y = getattr(st, name)
        assert y.shape == x.shape and np.array_equal(y.numpy(), x), name
    for name in rs.stats._fields:
        x = np.asarray(getattr(rs.stats, name))
        y = getattr(st.stats, name)
        assert y.shape == x.shape and np.array_equal(y.numpy(), x), name
    assert len(port_leaves) == len(ref_leaves)
    assert torch.equal(got.lanes(CPU), torch.arange(8, dtype=torch.float32))


# -------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("rpc,plan", [(1, "churn"), (8, None)])
def test_cuda_engine_resume_on_the_card(cuda, tmp_path, rpc, plan):
    """The kernels through the resumable engine at 65,536 nodes: cut,
    saved, loaded, resumed — bit for bit the straight kernel run, with
    exactly one launch per call over both segments, and one
    ``flight_row`` launch a recorded row."""
    n, rounds = 65_536, 32
    p = P.with_(n=n)
    cp = _plan_for(plan, n, cuda)
    key = prng.key(5, device=cuda)
    run = cuda_round.make_run_rounds_cuda(p, rounds, rounds_per_call=rpc,
                                          plan=cp, flight_every=8)
    sf, trf = run(tstate.init_state(n, device=cuda), key)
    cuda_round.reset_launches()
    kw = dict(engine="cuda", plan=cp, flight_every=8, chunk=16,
              ckpt_dir=str(tmp_path), rounds_per_call=rpc, device=cuda)
    cut = ck.run_resumable(p, rounds, key, guard=TripAfter(1), **kw)
    assert cut.preempted and cut.rounds_done == 16
    rr = ck.run_resumable(p, rounds, key, resume=True, **kw)
    _eq(sf, rr.state, "card resume")
    assert np.array_equal(trf.cpu().numpy(), rr.trace)
    rows = cuda_round.LAUNCHES.pop("flight_row")
    assert rows == rounds // 8
    frames = cuda_round.LAUNCHES.pop("frame/in_place", 0)
    assert frames == (0 if cp is None else rounds)
    assert sum(cuda_round.LAUNCHES.values()) == rounds // rpc


# ------------------------------------------- chip_smoke's resume phase


def test_chip_smoke_resume_phase_on_the_plain_path(tmp_path):
    """``chip_smoke.py``'s resume phase, rehearsed on the CPU at small
    sizes (the wrappers take the plain versions and count nothing):
    every part bit for bit, the torn file fallen back past, the
    partition-heal signature."""
    import chip_smoke

    m = chip_smoke.modules()
    root = str(tmp_path)
    lanes, torn, bad = chip_smoke.resume_lanes(torch, m, CPU, root, n=1024,
                                               rounds=24, chunk=8)
    assert bad == [] and lanes["bitwise"] and torn["bitwise"]
    assert torn["fallbacks"] == ["ckpt-r0000000016.ckpt"]
    assert torn["resumed_from"] == 8
    assert lanes["file_bytes"] > lanes["state_bytes"]
    cuda, bad, launches = chip_smoke.resume_cuda(torch, m, CPU, root,
                                                 n=1024, rounds=16, chunk=8)
    assert bad == [] and launches == {}
    assert all(v["bitwise"] for v in cuda.values())
    chaos, bad, launches = chip_smoke.resume_chaos(torch, m, CPU, root,
                                                   n=1024)
    assert bad == [] and launches == {}
    assert all(v["report_equal"] and v["bitwise"] and v["cut_at"] == 32
               for v in chaos.values())
    heal, bad = chip_smoke.resume_partition(
        torch, m, CPU, lan_nodes_per_dc=512, partition_rounds=30)
    assert bad == [] and heal["detected_cross_dc_failures"] == 3


def test_chip_smoke_resume_fails_on_any_difference(tmp_path, monkeypatch):
    """A resumed run one bit off the straight run fails the phase."""
    import chip_smoke

    real = ck.run_resumable

    def off(*a, **kw):
        rr = real(*a, **kw)
        if kw.get("resume") and rr.state is not None:
            rr.state = rr.state._replace(t=rr.state.t + 1)
        return rr

    monkeypatch.setattr(ck, "run_resumable", off)
    m = chip_smoke.modules()
    _, _, bad = chip_smoke.resume_lanes(torch, m, CPU, str(tmp_path),
                                        n=1024, rounds=24, chunk=8)
    assert len(bad) == 2 and all("'t': 1" in b for b in bad), bad
    _, bad, _ = chip_smoke.resume_cuda(torch, m, CPU, str(tmp_path),
                                       n=1024, rounds=16, chunk=8)
    assert len(bad) == 2 and all("'t': 1" in b for b in bad), bad
