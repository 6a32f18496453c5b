"""consul_tpu_torch's sharded lane engine (sim/mesh.py) on gloo worlds of
CPU ranks.

Each world is launched once (``run_world``) and runs every
configuration; the tests read its results. Worlds: 2 ranks with dc=1,
and 4 ranks with dc=2.

* ``make_sharded_run`` equals the single-device lane engine
  (``round.make_run_rounds_lanes``) bit for bit: stale_k 1 and 4 (30
  rounds, so the last window of 4 is partial), overlap, a fault plan,
  the flight trace — the reference's own claim (its
  tests/test_sim_mesh.py:42-130).
* Against the reference's ``make_sharded_run`` on as many virtual
  devices, same key and params: int lanes and counters exact,
  ``informed`` within ``ENGINE_ULPS``.
* Collectives per run: 2 staged ``init_lanes`` reductions + one per
  window (+ the drain under overlap), and nothing else — the counterpart
  of the reference's HLO audits.
* The reference's refusals, and the state updated in place.
* Per-DC pools (``make_multidc_run``) isolated.
* A mesh run cut with ``carry=True``, snapshotted (``checkpoint.
  snapshot_mesh``), saved and loaded on ONE device finishes the
  straight single-device run bit for bit (synchronous and overlap).
* ``bench --mesh --smoke`` at worlds 1 and 2 into a temporary record
  root, the record passing both packages' ``validate_record``; and
  ``graft_entry.dryrun_multichip(2)`` on the CPU.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from consul_tpu_torch import faults as tf
from consul_tpu_torch.sim import checkpoint as ck
from consul_tpu_torch.sim import flight, prng
from consul_tpu_torch.sim import lanes as tlanes
from consul_tpu_torch.sim import mesh as tmesh
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.params import SimParams
from test_torch_faults import ENGINE_ULPS, _assert_states_equal
from test_torch_harness import ref, run_world  # noqa: F401  (fixture)

CPU = "cpu"
ROUNDS = 30
KEY = 7
_P_EXACT = dict(n=512, loss=0.08, tcp_fallback=False, fail_per_round=0.005,
                rejoin_per_round=0.02, slow_per_round=0.002)
WORLDS = [(2, 1), (4, 2)]

#: name -> (SimParams overrides, runner options); every one runs ROUNDS
#: rounds from init_state(512) with KEY
CONFIGS = {
    "k1": ({}, {}),
    "k4": ({"stale_k": 4}, {}),
    "overlap": ({"stale_k": 2}, {"overlap": True}),
    "plan": ({}, {"plan": True}),
    "flight": ({"stale_k": 2}, {"flight_every": 10}),
}
#: a cut at round 16 of 32 (stale_k 2), checkpointed and restored
CUT, TOTAL = 16, 32


def _params(**kw) -> SimParams:
    return SimParams(**{**_P_EXACT, **kw})


def _plan(n: int) -> tf.FaultPlan:
    return tf.FaultPlan(phases=(
        tf.Phase(rounds=10, faults=(tf.Partition(a=(0, 128), b=(128, n)),),
                 name="cut"),
        tf.Phase(rounds=10, faults=(tf.ChurnBurst(nodes=(0, 64),
                                                  crash=0.05),),
                 name="burst"),
        tf.Phase(rounds=10, name="quiet")))


def _runner(p, opts, mesh=None, rounds=ROUNDS, **kw):
    """The mesh runner of a config (``mesh`` given), else the single-
    device lane engine."""
    opts = dict(opts, **kw)
    if opts.pop("plan", False):
        opts["plan"] = tf.compile_plan(_plan(p.n), p.n,
                                       mesh.device if mesh else CPU)
    if mesh is None:
        return tround.make_run_rounds_lanes(p, rounds, **opts)
    return tmesh.make_sharded_run(p, rounds, mesh, **opts)


# ------------------------------------------------------- the world


def _world_main(mesh, ckpt_dir: str) -> dict:
    """Every configuration on one world; rank 0's result carries the
    gathered states (the others carry their counts)."""
    out = {"coords": mesh.coords, "counts": {}, "states": {},
           "traces": {}, "in_place": {}}
    for name, (kw, opts) in CONFIGS.items():
        p = _params(**kw)
        run = _runner(p, opts, mesh)
        s0 = tmesh.init_sharded_state(p.n, mesh)
        ptrs = [x.data_ptr() for x in s0.node_arrays()]
        tmesh.reset_collectives()
        res = run(s0, prng.key(KEY, CPU))
        out["counts"][name] = dict(tmesh.COLLECTIVES)
        s = res if isinstance(res, tstate.SimState) else res[0]
        if s is not res:
            out["traces"][name] = res[1]
        out["in_place"][name] = ptrs == [x.data_ptr()
                                         for x in s.node_arrays()]
        out["states"][name] = tmesh.gather_state(s, mesh)
    out["refusals"] = _refusals(mesh)
    out["multidc"] = _multidc(mesh) if mesh.dc == 2 else None
    out["ckpt"] = {ov: _cut(mesh, ckpt_dir, ov) for ov in (False, True)}
    return out


def _refusals(mesh) -> dict:
    """The reference's refusals, each message as raised."""
    p = _params()
    msgs = {}

    def catch(name, fn):
        try:
            fn()
        except ValueError as e:
            msgs[name] = str(e)

    catch("stats_per_dc", lambda: tmesh.make_multidc_run(p, 8, mesh))
    catch("overlap_per_dc", lambda: tmesh._make_mesh_run(
        p.with_(collect_stats=False), 8, mesh, True, overlap=True))
    catch("uniform", lambda: tmesh.make_sharded_run(
        p.with_(stale_k=4), 6, mesh, overlap=True))
    catch("stride", lambda: tmesh.make_sharded_run(
        p.with_(stale_k=4), 8, mesh, flight_every=2))
    catch("awareness", lambda: tmesh.make_sharded_run(
        p.with_(awareness_max=12), 4, mesh, flight_every=2))
    catch("pool", lambda: tmesh.make_sharded_run(p.with_(n=500), 4, mesh))
    key = prng.key(0, CPU)

    def state():
        return tmesh.init_sharded_state(p.n, mesh)

    lanes0 = torch.zeros(tlanes.N_LANES)
    table0 = torch.zeros(tlanes.N_LANES, tlanes.LANE_BLOCKS)
    plain = tmesh.make_sharded_run(p, 4, mesh)
    catch("lanes0_no_resume", lambda: plain(state(), key, lanes0=lanes0))
    catch("cp_no_plan", lambda: plain(
        state(), key, cp=tf.compile_plan(_plan(p.n), p.n, CPU)))
    resumed = tmesh.make_sharded_run(p, 4, mesh, resume=True)
    catch("resume_no_lanes0", lambda: resumed(state(), key))
    catch("table0_sync", lambda: resumed(state(), key, lanes0=lanes0,
                                         table0=table0))
    ov = tmesh.make_sharded_run(p.with_(stale_k=2), 4, mesh, overlap=True,
                                resume=True)
    catch("overlap_no_table0", lambda: ov(state(), key, lanes0=lanes0))
    catch("rows", lambda: plain(tmesh.init_sharded_state(2 * p.n, mesh),
                                key))
    return msgs


def _multidc(mesh):
    """Per-DC pools of 512 nodes: 5 crashes in DC 0 only, 60 rounds."""
    p = SimParams(n=512, collect_stats=False)
    state = tmesh.init_sharded_state(p.n * mesh.dc, mesh)
    rows = mesh.rows(p.n * mesh.dc)
    kill = [i - rows.start for i in range(5) if rows.start <= i < rows.stop]
    if kill:
        state = tstate.with_crashed(state, torch.tensor(kill))
    tmesh.reset_collectives()
    out = tmesh.make_multidc_run(p, 60, mesh)(state, prng.key(0, CPU))
    return {"counts": dict(tmesh.COLLECTIVES),
            "state": tmesh.gather_state(out, mesh)}


def _cut(mesh, ckpt_dir: str, overlap: bool):
    """Rounds 0-16 of a 32-round run on the mesh with carry=True, cut
    and saved by rank 0; returns the file's path (rank 0)."""
    p = _params(stale_k=2)
    run = tmesh.make_sharded_run(p, CUT, mesh, overlap=overlap, carry=True)
    out = run(tmesh.init_sharded_state(p.n, mesh), prng.key(KEY, CPU))
    s, lv = out[0], out[1]
    table = out[2] if overlap else None
    snap = ck.snapshot_mesh(p, prng.key(KEY, CPU), s, mesh,
                            total_rounds=TOTAL, lanes=lv, table=table)
    if snap is None:
        return None
    return ck.save(f"{ckpt_dir}/{'overlap' if overlap else 'sync'}", snap)


@functools.lru_cache(maxsize=None)
def _single(name: str):
    kw, opts = CONFIGS[name]
    p = _params(**kw)
    return _runner(p, opts)(tstate.init_state(p.n, device=CPU),
                            prng.key(KEY, CPU))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(world: int, dc: int):
        if (world, dc) not in cache:
            d = tmp_path_factory.mktemp(f"mesh{world}x{dc}")
            cache[world, dc] = run_world(world, _world_main, str(d), dc=dc)
        return cache[world, dc]

    return get


def _equal_np(got, want: tstate.SimState) -> None:
    _assert_states_equal(got, tstate.to_numpy(want))
    assert int(got.round_idx) == int(want.round_idx)
    assert float(got.t) == float(want.t)


# ----------------------------------------------------------- tests


@pytest.mark.parametrize("world,dc", WORLDS)
@pytest.mark.parametrize("name", ["k1", "k4", "overlap", "plan"])
def test_sharded_bitwise_equals_single_device(worlds, world, dc, name):
    ranks = worlds(world, dc)
    assert [r["coords"] for r in ranks] == \
        [divmod(r, world // dc) for r in range(world)]
    want = _single(name)
    _equal_np(ranks[0]["states"][name], want)
    # and the run exercised the detector
    assert int(want.stats.suspicions) > 0 and int(want.stats.crashes) > 0
    if name == "plan":
        assert int(want.stats.crashes) > 30


@pytest.mark.parametrize("world,dc", WORLDS)
def test_sharded_flight_trace_exact(worlds, world, dc):
    ranks = worlds(world, dc)
    s1, tr1 = _single("flight")
    _equal_np(ranks[0]["states"]["flight"], s1)
    assert tr1.shape == (ROUNDS // 10, flight.N_COLS)
    for r in ranks:  # the rows come from the reduced lanes: replicated
        assert np.array_equal(r["traces"]["flight"], tr1.numpy())
    cols = flight.trace_columns(tr1)
    assert 0.5 < float(cols["live_frac"][-1]) <= 1.0
    assert float(cols["suspicions"].sum()) > 0


@pytest.mark.parametrize("world,dc", WORLDS)
def test_collectives_per_run(worlds, world, dc):
    """2 staged init reductions + one all-reduce per window (a partial
    final window has its own), + the drain under overlap; no other
    collective, on every rank."""
    want = {"k1": 2 + ROUNDS, "k4": 2 + 8, "overlap": 2 + ROUNDS // 2 + 1,
            "plan": 2 + ROUNDS, "flight": 2 + ROUNDS // 2}
    for r in worlds(world, dc):
        assert r["counts"] == {k: {"all_reduce_sum": v}
                               for k, v in want.items()}


@pytest.mark.parametrize("world,dc", WORLDS)
def test_runner_updates_the_state_in_place(worlds, world, dc):
    for r in worlds(world, dc):
        assert all(r["in_place"].values()), r["in_place"]


@pytest.mark.parametrize("world,dc", WORLDS)
def test_sharded_matches_reference_mesh(ref, devices8, worlds, world, dc):
    """The reference's make_sharded_run on ``world`` virtual devices,
    the same key and params: every int lane and counter exact,
    ``informed`` within ENGINE_ULPS."""
    import jax

    from consul_tpu.sim.mesh import init_sharded_state, make_mesh
    from consul_tpu.sim.mesh import make_sharded_run as ref_run
    from consul_tpu.sim.params import SimParams as RParams

    rp = RParams(**_P_EXACT)
    m = make_mesh(devices8[:world], dc=dc)
    want = ref_run(rp, ROUNDS, m)(init_sharded_state(rp.n, m),
                                  jax.random.key(KEY))
    _assert_states_equal(worlds(world, dc)[0]["states"]["k1"],
                         jax.device_get(want), ENGINE_ULPS)


@pytest.mark.parametrize("world,dc", WORLDS)
def test_refusals(worlds, world, dc):
    msgs = worlds(world, dc)[0]["refusals"]
    expect = {
        "stats_per_dc": "per-DC pools cannot carry global stats counters",
        "overlap_per_dc": "global reduction scope",
        "uniform": "uniform",
        "stride": "multiple of",
        "awareness": "awareness",
        "pool": "divide the 64-wide block",
        "lanes0_no_resume": "resume carries need a resume=True mesh runner",
        "cp_no_plan": "built without a fault plan",
        "resume_no_lanes0": "take the checkpoint's lane vector (lanes0)",
        "table0_sync": "rebuild the mesh runner with overlap=True",
        "overlap_no_table0": "overlap resume needs the in-flight table",
        "rows": "init_sharded_state",
    }
    assert set(msgs) == set(expect)
    for name, text in expect.items():
        assert text in msgs[name], (name, msgs[name])


def test_multidc_pools_are_isolated(worlds):
    """DC 0's five crashes are detected by DC 0's own pool, whose rows
    equal the single-device engine on that pool alone; DC 1 stays
    untouched; the per-DC reductions are the "nodes" group's."""
    ranks = worlds(4, 2)
    host = ranks[0]["multidc"]["state"]
    n = 512
    assert int((host.status[:n] == tstate.DEAD).sum()) == 5
    assert int((host.status[n:] == tstate.DEAD).sum()) == 0
    assert bool((host.down_age[n:] < 0).all())
    for r in ranks:
        assert r["multidc"]["counts"] == {"all_reduce_sum": 2 + 60}
    # DC 0's pool (global offset 0) is the single-device engine on it
    p = SimParams(n=n, collect_stats=False)
    dc0 = tround.make_run_rounds_lanes(p, 60)(
        tstate.with_crashed(tstate.init_state(n, device=CPU),
                            torch.arange(5)), prng.key(0, CPU))
    for f in tstate.NODE_FIELDS:
        np.testing.assert_array_equal(getattr(host, f)[:n],
                                      getattr(dc0, f).numpy(), err_msg=f)


@pytest.mark.parametrize("world,dc", WORLDS)
@pytest.mark.parametrize("overlap", [False, True])
def test_mesh_checkpoint_restores_on_single_device(worlds, world, dc,
                                                   overlap):
    """Cut on the mesh at round 16 of 32, restore on ONE device: bitwise
    the single-device straight run (the overlap cut carries the
    gathered in-flight table, and the chain ends with drain_overlap)."""
    p = _params(stale_k=2)
    full = tround.make_run_rounds_lanes(p, TOTAL, overlap=overlap)(
        tstate.init_state(p.n, device=CPU), prng.key(KEY, CPU))
    loaded = ck.load(worlds(world, dc)[0]["ckpt"][overlap], p=p)
    assert loaded.round_cursor == CUT and loaded.engine == "lanes"
    r2 = tround.make_run_rounds_lanes(p, TOTAL - CUT, overlap=overlap,
                                      carry=True)
    if overlap:
        s2, _, table = r2(loaded.state(CPU), loaded.key(CPU),
                          lanes0=loaded.lanes(CPU),
                          table0=loaded.table(CPU))
        s2 = tround.drain_overlap(s2, table, p)
    else:
        s2, _ = r2(loaded.state(CPU), loaded.key(CPU),
                   lanes0=loaded.lanes(CPU))
    _equal_np(tstate.to_numpy(s2), full)


def test_mesh_reducer_refuses_a_count_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        tlanes.mesh_lane_reducer(tmesh.Collectives(), None, 0, 3)


def test_seed_and_carry_tables_place_values_on_offset_zero():
    lanes0 = torch.arange(tlanes.N_LANES, dtype=torch.float32) - 3.0
    table0 = torch.rand(tlanes.N_LANES, tlanes.LANE_BLOCKS)
    assert torch.equal(tlanes.seed_table(lanes0)[:, 0], lanes0)
    assert not tlanes.seed_table(lanes0, 128).any()
    assert torch.equal(tlanes.carry_table(table0), table0)
    assert not tlanes.carry_table(table0, 64).any()
    # the fold of a seeded table is exactly lanes0
    assert torch.equal(tlanes.reduce_lanes_single.fold(
        tlanes.seed_table(lanes0)), lanes0)


def test_block_partials_hold_no_negative_zero():
    """A -0.0 partial would turn +0.0 in the mesh's zero-filled sum; the
    partials add +0.0 so none is written."""
    stack = -torch.zeros(3, 512)
    part = tlanes._block_partials(stack, tlanes.LANE_BLOCKS)
    assert not torch.signbit(part).any()


def test_launch_reports_a_failing_rank():
    with pytest.raises(tmesh.LaunchError, match="rank 1 of 2 failed"):
        run_world(2, _fail_on_rank_one, timeout=120)


def _fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank one fails on purpose")
    # rank 0 waits in a collective that never completes
    mesh.coll.all_reduce_sum(torch.ones(1), mesh.group)


def test_bench_mesh_smoke_records_multichip(ref, tmp_path, monkeypatch,
                                            capsys):
    from consul_tpu.sim import costmodel as rcost
    from consul_tpu_torch import bench
    from consul_tpu_torch.sim import costmodel

    monkeypatch.setenv(bench.RECORD_ROOT_ENV, str(tmp_path))
    monkeypatch.setattr(bench, "MESH_SMOKE_SIZES", (2048,))
    monkeypatch.setattr(bench, "MESH_TRIALS", 1)
    monkeypatch.setattr(bench, "MESH_SMOKE_WORLDS", (1, 2))
    rec = bench.run_mesh_bench(smoke=True)
    rows = rec["ladder"]
    assert [(r["devices"], r["stale_k"], r["overlap"]) for r in rows] == [
        (w, k, ov) for w in (1, 2) for k, ov in ((1, False), (4, False),
                                                 (4, True))]
    assert all(r["collectives"] == bench.mesh_windows(48, r["stale_k"],
                                                      r["overlap"])
               for r in rows)
    assert all(r["weak_scaling_efficiency"] == 1.0 for r in rows
               if r["devices"] == 1)
    path = tmp_path / "MULTICHIP_r01.json"
    payload = json.loads(path.read_text())
    costmodel.validate_record(path.name, payload)
    rcost.validate_record(path.name, payload)
    assert payload["metric"] == "mesh_weak_scaling_smoke"
    assert "MULTICHIP recorded" in capsys.readouterr().err


def test_dryrun_multichip_on_the_cpu():
    from consul_tpu_torch import graft_entry

    out = graft_entry.dryrun_multichip(2, device=CPU)
    assert [r["rank"] for r in out] == [0, 1]
    assert all(r["rounds"] == r["multidc_rounds"] == r["views_rounds"] == 2
               for r in out)
