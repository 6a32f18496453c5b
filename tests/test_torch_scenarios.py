"""consul_tpu_torch's partition-heal scenario, checkpointed chaos runs,
the benches' --ckpt-dir/--resume and the coordinate sweep.

* ``partition_heal`` at the reference test's size (3 DCs x 3 servers,
  2,000 LAN nodes per DC, 60 partition rounds) against the reference's
  report: the live engine draws the same threefry stream, so the four
  int fields and ``healed_recovery_rounds`` are equal, and the report
  shows the reference test's signature.
* ``run_chaos`` through ``checkpoint.run_resumable(engine="cuda")``
  (the plain versions on the CPU), cut by a guard inside the fault
  phase and resumed from its files, gives the plain run's report;
  ``run_chaos_suite`` replays its manifest only under ``resume``.
* ``bench --chaos --smoke --ckpt-dir D``, preempted, returns
  ``PREEMPTED_RC`` with a JSON envelope naming the resume command; the
  ``--resume`` invocation finishes with the plain suite's reports.
* A 2-point coordinate sweep at n=256 against the reference's
  ``run_sweep(coords=True)`` (int lanes and counters exact,
  ``informed`` within ``ENGINE_ULPS``, trace within ``TRACE_ATOL``) and
  bit for bit against each point's one-point run.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from chip_smoke import TripAfter
from consul_tpu_torch import bench
from consul_tpu_torch.faults import compile_plan
from consul_tpu_torch.sim import checkpoint as ck
from consul_tpu_torch.sim import params as tparams
from consul_tpu_torch.sim import prng, sweep
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.scenarios import (chaos_plans, partition_heal,
                                            run_chaos, run_chaos_suite)
from consul_tpu_torch.sim.topology import TopologyParams, make_topology
from test_torch_faults import ENGINE_ULPS
from test_torch_harness import ref  # noqa: F401  (fixture)

CPU = "cpu"
#: the coordinate trace columns against the reference's (test_torch_coords)
TRACE_ATOL = 1e-4


# ------------------------------------------------------- partition-heal


def test_partition_heal_matches_the_reference(ref):
    from consul_tpu.sim.scenarios import partition_heal as ref_heal

    kw = dict(n_dcs=3, servers_per_dc=3, lan_nodes_per_dc=2000,
              partition_rounds=60)
    got = partition_heal(**kw, device=CPU)
    want = ref_heal(**kw)
    assert got.to_dict() == want.to_dict()
    # the reference test's signature
    assert got.detected_cross_dc_failures == got.servers_per_dc
    assert got.false_positives_during_partition == 0
    assert got.healed_recovery_rounds > 0
    assert got.lan_false_positives == 0


def test_partition_heal_refuses_a_tiny_wan_pool():
    with pytest.raises(ValueError, match="WAN pool too small"):
        partition_heal(n_dcs=2, servers_per_dc=2, device=CPU)


# ------------------------------------------------ checkpointed chaos


@pytest.mark.parametrize("name,blackbox", [("churn_burst", True),
                                           ("forged_acks", False)])
def test_checkpointed_run_chaos_equals_the_plain_run(tmp_path, name,
                                                     blackbox):
    """Cut at round 32 (inside the fault phase: rounds 10-70), resumed
    from the files: the report — phases, curves, rings — is the plain
    run's."""
    n = 4096
    plain = run_chaos(name, n=n, device=CPU, blackbox=blackbox)
    d = str(tmp_path / name)
    stub = run_chaos(name, n=n, device=CPU, blackbox=blackbox, ckpt_dir=d,
                     guard=TripAfter(2), chunk=16)
    assert stub == {"scenario": name, "n": n, "preempted": True,
                    "rounds_done": 32, "rounds": plain["rounds"],
                    "checkpoint": stub["checkpoint"]}
    cp = compile_plan(chaos_plans(n)[name], n, CPU)
    assert ck.load(stub["checkpoint"], plan=cp).engine == "cuda"
    done = run_chaos(name, n=n, device=CPU, blackbox=blackbox, ckpt_dir=d,
                     resume=True, chunk=16)
    assert done == plain


def test_chaos_suite_replays_its_manifest_only_under_resume(tmp_path):
    n = 1024
    d = str(tmp_path)
    cut = run_chaos_suite(n, device=CPU, ckpt_dir=d, guard=TripAfter(3))
    names = list(chaos_plans(n))
    # two polls a class (64-round chunks of 120): class 2 stopped at 64
    assert cut["preempted"] == names[1]
    assert cut[names[1]]["preempted"] and cut[names[1]]["rounds_done"] == 64
    manifest = ck.ProgressManifest(d)
    assert manifest.completed == [names[0]]
    # a marker in the finished class's record shows whether it replays
    rec = manifest.result(names[0])
    manifest.mark(names[0], {**rec, "replayed": True})
    full = run_chaos_suite(n, device=CPU, ckpt_dir=d, resume=True)
    assert full[names[0]]["replayed"] is True
    assert "preempted" not in full and set(full) == set(names)
    plain = run_chaos_suite(n, device=CPU)
    for k in names[1:]:
        assert full[k] == plain[k], k
    again = run_chaos_suite(n, device=CPU, ckpt_dir=d)
    assert "replayed" not in again[names[0]]
    assert again[names[0]] == plain[names[0]]
    with pytest.raises(ValueError, match="different configuration"):
        run_chaos_suite(n, seed=1, device=CPU, ckpt_dir=d)


# ---------------------------------------------------- bench --ckpt-dir


def _main(argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _json(x):
    return json.loads(json.dumps(x))


def test_bench_chaos_preempted_then_resumed(tmp_path, monkeypatch):
    """The bench's own guard trips on its sixth poll (class 3, round
    64): exit code PREEMPTED_RC and a valid envelope; ``--resume``
    finishes with the plain suite's reports and the defense sweep."""
    class Tripped(ck.PreemptionGuard):
        polls = 0

        @property
        def preempted(self):
            Tripped.polls += 1
            return Tripped.polls > 5

    d = str(tmp_path)
    monkeypatch.setattr(bench, "PreemptionGuard", Tripped)
    rc, env = _main(["--chaos", "--smoke", "--ckpt-dir", d])
    names = list(chaos_plans(bench.CHAOS_SMOKE_N))
    assert rc == ck.PREEMPTED_RC == 75
    assert env["preempted"] is True and env["preempted_class"] == names[2]
    assert env["completed"] == names[:2]
    assert env["resume"] == ("python -m consul_tpu_torch.bench --chaos "
                             f"--smoke --ckpt-dir {d} --resume")
    assert "corroboration_sweep" not in env
    monkeypatch.setattr(bench, "PreemptionGuard", ck.PreemptionGuard)
    rc, res = _main(["--chaos", "--smoke", "--ckpt-dir", d, "--resume"])
    assert rc == 0 and not res.get("preempted")
    assert res["metric"] == "chaos_detection_quality_smoke"
    plain = run_chaos_suite(bench.CHAOS_SMOKE_N, device=CPU)
    assert res["classes"] == _json(plain)
    sweep_k = res["corroboration_sweep"]
    assert sweep_k["best_k"] >= 1 and "run_s" in sweep_k
    # the finished invocation's units replay under a second resume
    rc, again = _main(["--chaos", "--smoke", "--ckpt-dir", d, "--resume"])
    assert rc == 0 and again["corroboration_sweep"] == sweep_k


def test_bench_sweep_preempts_between_classes_and_replays(tmp_path):
    d = str(tmp_path)
    guard = TripAfter(0)
    env = bench.run_sweep_bench(smoke=True, ckpt_dir=d, guard=guard)
    assert env["preempted"] and env["preempted_class"] == "lan"
    assert env["completed"] == [] and env["resume"].endswith(
        f"--sweep --smoke --ckpt-dir {d} --resume")
    n, rounds = bench.SWEEP_SMOKE_SIZE
    manifest = ck.ProgressManifest(d, config={
        "mode": "sweep", "smoke": True, "n": n, "rounds": rounds,
        "engine": "xla"})
    for t in ("lan", "wan", "lossy"):
        manifest.mark(t, {"class": t})
    res = bench.run_sweep_bench(smoke=True, ckpt_dir=d, resume=True,
                                guard=TripAfter(0))
    assert "preempted" not in res
    assert res["classes"] == {t: {"class": t} for t in ("lan", "wan",
                                                        "lossy")}


def test_bench_checkpoint_flags_are_checked():
    for argv in (["--ckpt-dir", "x"], ["--chaos", "--resume"],
                 ["--coords", "--ckpt-dir", "x"],
                 ["--chaos", "--profile", "--ckpt-dir", "x"]):
        with pytest.raises(SystemExit):
            with contextlib.redirect_stderr(io.StringIO()):
                bench.main(argv)


# ------------------------------------------------------ coords sweep


COORD_KW = dict(n=256, loss=0.01, tcp_fallback=False, coords_timeout=True)
COORD_GRID = [{"coord_timeout_mult": 0.5, "loss": 0.0},
              {"coord_timeout_mult": 3.0, "loss": 0.2}]
COORD_ROUNDS = 12


def test_coordinate_sweep_matches_the_reference_and_its_points(ref):
    import jax

    from consul_tpu.sim import sweep as rsweep
    from consul_tpu.sim.params import SimParams as RParams
    from consul_tpu.sim.topology import TopologyParams as RTopoParams
    from consul_tpu.sim.topology import make_topology as ref_topology

    p = tparams.SimParams(**COORD_KW)
    topo = make_topology(TopologyParams(n=p.n, seed=0), CPU)
    got = sweep.run_sweep(p, COORD_GRID, COORD_ROUNDS, key=prng.key(7),
                          flight_every=2, coords=True, topo=topo,
                          device=CPU)
    want = rsweep.run_sweep(RParams(**COORD_KW), COORD_GRID, COORD_ROUNDS,
                            key=jax.random.key(7), flight_every=2,
                            coords=True,
                            topo=ref_topology(RTopoParams(n=p.n, seed=0)))
    ws = jax.device_get(want.states)
    for f in tstate.NODE_FIELDS:
        x, y = getattr(got.states, f).numpy(), np.asarray(getattr(ws, f))
        assert x.dtype == y.dtype, f
        if f == "informed":
            spacing = np.maximum(np.abs(y) * 2.0 ** -23, 2.0 ** -149)
            assert (np.abs(x.astype(np.float64) - y) / spacing).max() \
                <= ENGINE_ULPS
        else:
            assert np.array_equal(x, y), f
    for f in tstate.SimStats._fields:
        assert np.array_equal(getattr(got.states.stats, f).numpy(),
                              np.asarray(getattr(ws.stats, f))), f
    tr = got.trace.numpy()
    np.testing.assert_allclose(tr, np.asarray(want.trace), rtol=0,
                               atol=TRACE_ATOL)
    coord = tr[..., -3:]
    assert (coord[:, -1, 0] > 0).all(), "coordinate columns filled"
    assert not np.array_equal(coord[0], coord[1]), \
        "the grid's points ran apart"
    for i in range(len(COORD_GRID)):
        st, trp = sweep.make_run_point(
            p, COORD_ROUNDS, flight_every=2, coords=True, topo=topo,
            device=CPU)(tparams.point_params(got.tp, i), prng.key(7))
        row = sweep.take_point(got.states, i)
        for a, b in zip(tstate._leaves(row), tstate._leaves(st)):
            assert torch.equal(a, b), i
        assert torch.equal(trp, got.trace[i]), i


def test_coordinate_sweep_refusals():
    p = tparams.SimParams(**COORD_KW)
    for engine in ("lanes", "cuda"):
        with pytest.raises(ValueError, match="XLA engine"):
            sweep.make_run_sweep(p, 4, engine=engine, coords=True,
                                 device=CPU)
    with pytest.raises(ValueError, match="topo"):
        sweep.make_run_sweep(p, 4, coords=True, device=CPU)
