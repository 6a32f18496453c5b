"""consul_tpu_torch's digital-twin soak (sim/twin.py) and its bench and
record seams against the JAX reference's (consul_tpu/sim/twin.py), on
the CPU.

* The plan, its compiled tensors and digest, and the sim's SimParams
  equal the reference's exactly at 4,096 and 1,048,576 nodes;
  ``jain_fairness`` and ``_perf_excerpt`` give the reference's outputs;
  ``_state_digest`` is the reference's on the same state, stable, and
  moved by one flipped lane.
* A soak at 4,096 (the reference test's plan: warmup 4, churn 8,
  partition 8, heal 12) drives the reference's real agent (its
  ``build_twin`` and ``TwinLoad``, passed in as ``build`` and ``load``)
  from the port's sim half: the view converges, the resume digest holds,
  the rung is a valid TWIN record for both packages, and its sim
  counters sit in the statistical tier against the reference's own rung
  (the kernels draw Philox, the reference threefry). A preempted soak
  resumed from its files ends on the uninterrupted ``sim_digest``, and
  the sim half chunked by 8 is bit for bit the straight kernel-runner
  run.
* ``latest_twin_guard``, ``latest_users_guard`` and
  ``latest_raft_guard`` equal the reference's over the root records and
  over synthetic ones; ``run_twin_bench(smoke=True)`` and
  ``check_twin_regression`` run once over a temporary record root.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from chip_smoke import TripAfter
from consul_tpu_torch import bench
from consul_tpu_torch import faults as tf
from consul_tpu_torch.sim import costmodel as tcm
from consul_tpu_torch.sim import cuda_round, prng, registry, twin
from consul_tpu_torch.sim import state as tstate
from test_torch_harness import ROOT, ref  # noqa: F401  (fixture)

CPU = "cpu"
N = 4096
SEED = 0
#: tests/test_twin.py's soak plan (32 rounds)
PLAN = dict(warmup=4, churn=8, partition=8, heal=12)
#: the statistical tier's counter band, and for a counter whose
#: reference count is under MIN_BAND_COUNT (rejoins: a handful at 4,096
#: nodes, where the band is narrower than one event's Poisson noise) the
#: difference of the two counts within 3 standard deviations of a
#: difference of two Poisson counts, 3·sqrt(a + b)
BAND = (0.8, 1.25)
MIN_BAND_COUNT = 20


@pytest.fixture(scope="module")
def rt(ref):  # noqa: F811
    """The reference's twin module (the shimmed package is live)."""
    from consul_tpu.sim import twin as rtwin

    return rtwin


@pytest.fixture(scope="module")
def agent_half(rt):
    """The reference's agent half as the port's ``build`` and ``load``;
    at most 2 load clients (the bench asks for 8), so that the test's
    RPC herd does not starve the suite's other workers."""
    def build(n, seed, serve_http):
        return rt.build_twin(n, seed=seed, serve_http=serve_http)

    def load(handle, clients):
        return rt.TwinLoad(handle.agent.server.rpc.addr,
                           clients=min(clients, 2))

    return build, load


@pytest.fixture(scope="module")
def ref_rung(rt, tmp_path_factory):
    """The reference's own rung at N (one per module)."""
    return rt.run_twin_soak(N, seed=SEED, plan=rt.twin_plan(N, **PLAN),
                            load_clients=2, serve_http=False,
                            ckpt_dir=str(tmp_path_factory.mktemp("rck")))


@pytest.fixture(scope="module")
def port_rung(agent_half, tmp_path_factory):
    build, load = agent_half
    return twin.run_twin_soak(N, build, load, seed=SEED,
                              plan=twin.twin_plan(N, **PLAN),
                              load_clients=2, serve_http=False,
                              ckpt_dir=str(tmp_path_factory.mktemp("pck")),
                              device=CPU)


# ------------------------------------------------------ straight copies


@pytest.mark.parametrize("n", [N, 1_048_576])
def test_plan_compiled_plan_and_digest_equal_the_reference(rt, n):
    from consul_tpu import faults as rf

    mine, theirs = twin.twin_plan(n), rt.twin_plan(n)
    assert [(p.name, p.rounds) for p in mine.phases] == \
        [(p.name, p.rounds) for p in theirs.phases]
    assert mine.total_rounds == theirs.total_rounds == 88
    assert mine.starts == list(theirs.starts)
    cp, rcp = tf.compile_plan(mine, n, CPU), rf.compile_plan(theirs, n)
    for name in tf.PLAN_LEAVES:
        a, b = getattr(cp, name), getattr(rcp, name, None)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        b = np.asarray(b)
        a = a.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tf.plan_digest(cp) == rf.plan_digest(rcp)


def test_gossip_config_and_params_equal_the_reference(rt):
    from consul_tpu.sim.params import SimParams as RParams

    mine, theirs = twin.twin_gossip_config(), rt.twin_gossip_config()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    p = twin.twin_params(N)
    rp = RParams.from_gossip_config(theirs, n=N, tcp_fallback=False)
    assert {f.name: getattr(p, f.name) for f in dataclasses.fields(p)} == \
        {f.name: getattr(rp, f.name) for f in dataclasses.fields(rp)}
    assert twin.TWIN_LADDER == rt.TWIN_LADDER
    assert twin.TWIN_SMOKE_N == rt.TWIN_SMOKE_N
    assert twin.CONVERGE_TOL == rt.CONVERGE_TOL


@pytest.mark.parametrize("xs", [[], [0, 0], [5, 5, 5], [1, 0, 0, 0],
                                [3, 7, 2, 9, 0], [1e6, 2.5]])
def test_jain_fairness_equals_the_reference(rt, xs):
    assert twin.jain_fairness(xs) == rt.jain_fairness(xs)


def test_perf_excerpt_equals_the_reference(rt):
    snaps = [{}, {"Stages": None, "Gauges": None}, {
        "Stages": {"rpc.e2e": {"Count": 3, "P50Ms": 0.1, "P99Ms": 2.0,
                               "Extra": 1},
                   "http.read": {"Count": 1},
                   "raft.apply": {"Count": 9, "P50Ms": 1.0}},
        "Gauges": {"rpc.workers.queue_depth": 0.0,
                   "rpc.blocking.parked": 2, "catalog.near_sort.k": 5,
                   "raft.commit": 1.0}}]
    for snap in snaps:
        assert twin._perf_excerpt(snap) == rt._perf_excerpt(snap)


def test_state_digest_is_the_reference_stable_and_sensitive(
        ref, rt):  # noqa: F811
    rs = ref.init_state(256)
    s = tstate.from_numpy(rs, device=CPU)
    d = twin._state_digest(s)
    assert d == rt._state_digest(rs) == twin._state_digest(s)
    flipped = s._replace(status=s.status.clone())
    flipped.status[17] = tstate.SUSPECT
    assert twin._state_digest(flipped) != d
    assert twin._state_digest(s) == d


# ------------------------------------------------------------- the soak


def _close(port: int, theirs: int) -> bool:
    if theirs >= MIN_BAND_COUNT:
        return BAND[0] <= port / theirs <= BAND[1]
    return abs(port - theirs) <= 3 * math.sqrt(port + theirs)


def test_soak_converges_resumes_and_is_a_valid_record(rt, port_rung):
    from consul_tpu.sim import costmodel as rcm

    r = port_rung
    assert r["member_view_err_post_heal"] <= twin.CONVERGE_TOL
    assert r["resume_digest_equal"] is True
    assert r["rumors_sent"] > 0
    assert r["sim_stats"]["crashes"] > 0
    assert r["converge_rounds"] <= r["rounds"] == 32
    assert r["plan_digest"] == tf.plan_digest(
        tf.compile_plan(twin.twin_plan(N, **PLAN), N, CPU))
    rec = {"metric": "twin_soak", "platform": "cpu", "ladder": [r],
           "smoke_guard": {"n": N, "rounds": 52, "converge_rounds": 4,
                           "samples": [4]}}
    tcm.validate_record("TWIN_r99.json", rec)
    rcm.validate_record("TWIN_r99.json", rec)
    assert set(registry.TWIN_RUNG_KEYS) <= set(r)


def test_soak_sim_counters_in_the_statistical_tier(port_rung, ref_rung):
    assert sorted(port_rung) == sorted(ref_rung)
    mine, theirs = port_rung["sim_stats"], ref_rung["sim_stats"]
    assert mine["false_positives"] == theirs["false_positives"] == 0
    off = {k: (mine[k], theirs[k]) for k in ("crashes", "rejoins", "refutes")
           if not _close(mine[k], theirs[k])}
    assert not off, off
    assert ref_rung["plan_digest"] == port_rung["plan_digest"]


def test_preempted_soak_resumes_to_the_uninterrupted_digest(
        agent_half, port_rung, tmp_path):
    build, load = agent_half
    kw = dict(seed=SEED, plan=twin.twin_plan(N, **PLAN), load_clients=2,
              serve_http=False, ckpt_dir=str(tmp_path), device=CPU)
    cut = twin.run_twin_soak(N, build, load, guard=TripAfter(3), **kw)
    assert cut == {"preempted": True, "n": N, "rounds_done": 24,
                   "rounds": 32}
    done = twin.run_twin_soak(N, build, load, resume=True, **kw)
    assert done["sim_digest"] == port_rung["sim_digest"]
    # resumed past the midpoint: the proof reloaded the cut saved under mid
    assert done["resume_digest_equal"] is True


def test_sim_half_chunked_is_the_straight_kernel_run():
    n = 1024
    plan = twin.twin_plan(n, **PLAN)
    sim = twin.SimHalf(n, plan, seed=3, chunk=8, device=CPU)
    cursors = [c for c, _ in sim.chunks()]
    assert cursors == [8, 16, 24, 32] and sim.mid_snap is not None
    assert sim.mid_snap.plan_digest == sim.plan_digest == \
        tf.plan_digest(sim.cp)
    straight = cuda_round.make_run_rounds_cuda(
        sim.p, plan.total_rounds, carry=True, plan=sim.cp)
    want, sc = straight(tstate.init_state(n, device=CPU),
                        prng.key(3, device=CPU))
    for f, a, b in zip(tstate.SimState._fields, want, sim.state):
        for x, y in zip(a if f == "stats" else (a,),
                        b if f == "stats" else (b,)):
            assert x.dtype == y.dtype and torch.equal(x, y), f
    assert torch.equal(sc, sim.scalars)
    assert twin.resume_digest_proof(sim.mid_snap, sim.p, sim.cp,
                                    twin._state_digest(want), device=CPU)


# ------------------------------------------------------------- records


def _synthetic_records() -> list:
    def rec(fam, rnd, data):
        return {"file": f"{fam}_r{rnd:02d}.json", "family": fam,
                "round": rnd, "data": data}

    rung = {"target_rps": 500, "achieved_rps": 498.5}
    return [
        rec("TWIN", 1, {"smoke_guard": {"n": 4096, "rounds": 52,
                                        "converge_rounds": 6,
                                        "samples": [6, 5, 7]}}),
        rec("TWIN", 3, {"smoke_guard": None}),
        rec("TWIN", 2, {"smoke_guard": {"n": 4096, "rounds": 52,
                                        "converge_rounds": 4,
                                        "samples": [4]}}),
        rec("USERS", 1, {"headline_rung": {"target_rps": 500},
                         "engine": {"users": 10}, "ladder": [rung]}),
        rec("USERS", 2, {"headline_rung": {"target_rps": 750},
                         "ladder": [{"target_rps": 750, "skipped": True},
                                    rung]}),
        rec("USERS", 4, {"ladder": [rung]}),
        rec("RAFT", 5, {"headline_rung": {"target_rps": 500},
                        "cluster": {"servers": 3}, "ladder": [rung]}),
        rec("RAFT", 6, {"headline_rung": {"target_rps": 500},
                        "cluster": {"servers": 5},
                        "ladder": [{**rung, "achieved_rps": 301.0}]}),
        rec("BENCH", 9, {"metric": "x", "value": 1.0}),
    ]


@pytest.mark.parametrize("which", ["root", "synthetic", "empty"])
def test_guard_readers_equal_the_reference(ref, which):  # noqa: F811
    from consul_tpu.sim import costmodel as rcm

    records = {"root": lambda: tcm.load_ledger(str(ROOT)),
               "synthetic": _synthetic_records,
               "empty": list}[which]()
    for name in ("latest_twin_guard", "latest_users_guard",
                 "latest_raft_guard"):
        got = getattr(tcm, name)(records)
        assert got == getattr(rcm, name)(records), name
        if which == "root":
            assert got is not None, name


def test_twin_bench_smoke_and_regression_guard(agent_half, tmp_path,
                                               monkeypatch, capsys):
    from consul_tpu.sim import costmodel as rcm

    build, load = agent_half
    root = tmp_path / "records"
    monkeypatch.setenv(bench.RECORD_ROOT_ENV, str(root))
    pay = bench.run_twin_bench(True, build, load, samples=1,
                               guard=TripAfter(10 ** 6))
    assert pay["metric"] == "twin_soak_smoke" and pay["smoke"] is True
    (rung,) = pay["ladder"]
    assert rung["n"] == twin.TWIN_SMOKE_N and rung["resume_digest_equal"]
    assert pay["smoke_guard"]["rounds"] == 52
    assert len(pay["smoke_guard"]["samples"]) == 1
    tcm.validate_record("TWIN_r01.json", pay)
    rcm.validate_record("TWIN_r01.json", pay)
    assert not root.exists()            # a smoke ladder is not recorded
    # no baseline yet: rc 2, before anything runs
    assert bench.check_twin_regression([], build, load, True) == 2
    assert bench.check_twin_regression([], build, load, True,
                                       metric="other") == 2
    path = bench._record_next("TWIN", pay)
    records = bench.load_records(str(root))
    assert [r["file"] for r in records] == ["TWIN_r01.json"]
    assert path.endswith("TWIN_r01.json")
    capsys.readouterr()
    rc = bench.check_twin_regression(records, build, load, True, samples=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 1
    verdict = json.loads(out[0])
    assert verdict["metric"] == bench.TWIN_METRIC
    assert verdict["verdict"] == "unstable"   # one sample cannot claim
    assert verdict["baseline_file"] == "TWIN_r01.json"
