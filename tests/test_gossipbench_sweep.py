"""The benchmark's sweep cell (``lan-grid-64x65536.sweep``) on the CPU:
the configuration and the traffic against the autotuner's constants and
grid, the driver's set-up against ``bench.run_sweep_class``', the
batched plain reference (``gossipbench/reference/sweep.py``) against
``model.lanes_call`` point by point, the program against the reference
within the cell's limits at a pool of 1,024, the seeded defects and the
bfloat16 control the limits catch, the grid's roofline count, and the
cell's readers."""

import ast
import functools
import pathlib

import pytest
import torch

import test_torch_harness  # noqa: F401  (one torch thread a worker)
from consul_tpu_torch import bench
from consul_tpu_torch.sim import costmodel, scenarios
from consul_tpu_torch.sim import sweep as sweep_mod
from consul_tpu_torch.sim.params import SweepAxes, grid_params
from consul_tpu_torch.sim.state import init_state
from gossipbench import check, grid, harness
from gossipbench.bounds import lane_round, lane_round_grid
from gossipbench.program import SIM_FIELDS
from gossipbench.reference import model
from gossipbench.reference import prng as rprng

CELL = "lan-grid-64x65536.sweep"
CPU = torch.device("cpu")
SPEC = harness.load_json("workloads", CELL)
CONFIG = harness.load_json("configs", SPEC["config"])
TRAFFIC = harness.load_json("traffic", SPEC["traffic"])
LIMITS = SPEC["limits"]
DRIVER = harness.load_module("drivers", "sweep")
REFERENCE = harness.load_module("reference", "sweep")
G = CONFIG["points"]
POOL = 1024
N = G * POOL


# ------------------------------------------------------ the configuration


def test_the_base_is_the_autotuners_lan_class():
    p = scenarios.autotune_params("lan", CONFIG["pool_n"])
    for f in SIM_FIELDS + ("stale_k",):
        assert CONFIG[f] == getattr(p, f), f
    assert CONFIG["pool_n"] == bench.SWEEP_SIZE[0] == 65536
    assert CONFIG["n"] == CONFIG["points"] * CONFIG["pool_n"] == 4194304
    assert CONFIG["reduced"] == [] and len(CONFIG["source"]) <= 200


def test_the_grid_is_the_autotuners():
    want = [(k, list(v)) for k, v in scenarios.AUTOTUNE_GRID.items()]
    assert list(TRAFFIC["grid"].items()) == want
    assert SweepAxes.of(**TRAFFIC["grid"]).size == G == 64
    assert REFERENCE.grid_points(TRAFFIC["grid"]) == \
        SweepAxes.of(**scenarios.AUTOTUNE_GRID).points()
    assert (TRAFFIC["stale_k"], TRAFFIC["rounds"]) == (1, 120)


def test_the_driver_builds_what_run_sweep_class_builds(monkeypatch):
    """The driver's parameters, grid and runner are the sweep bench's
    for the lan class on the lanes engine: ``autotune_params``,
    ``grid_params`` of ``AUTOTUNE_GRID``, ``make_run_sweep(p, rounds,
    engine="lanes")``."""
    built = []

    class Stop(Exception):
        pass

    def record(p, rounds, **kw):
        built.append((p, rounds, kw["engine"]))
        raise Stop

    d = DRIVER.Driver(CONFIG, TRAFFIC, CPU, 2 ** 31 + 3, N)
    monkeypatch.setattr(bench, "make_run_sweep", record)
    with pytest.raises(Stop):
        bench.run_sweep_class("lan", POOL, TRAFFIC["rounds"], CPU,
                              engine="lanes")
    (p, rounds, engine), = built
    assert d.p == p and (rounds, engine) == (TRAFFIC["rounds"], "lanes")
    tp, points = grid_params(p, SweepAxes.of(**scenarios.AUTOTUNE_GRID),
                             CPU)
    assert d.grid_points == points
    assert d.tp.leaves.keys() == tp.leaves.keys()
    for k, v in tp.leaves.items():
        assert torch.equal(d.tp.leaves[k], v), k
    monkeypatch.setattr(sweep_mod, "make_run_sweep", record)
    with pytest.raises(Stop):
        DRIVER.Driver(CONFIG, TRAFFIC, CPU, 5, N)
    assert built[-1] == (d.p, TRAFFIC["rounds"], "lanes")


# ------------------------------------------------------- the reference


def test_the_batched_reference_is_lanes_call_point_by_point():
    """Each row of the batched reference is ``model.lanes_call`` on that
    point's ``model.Params`` alone, bit for bit: lanes, clock, round and
    counters."""
    rounds = 8
    P = model.Params(CONFIG, n=N, stale_k=1)
    Q = REFERENCE.Grid(P, TRAFFIC["grid"])
    key = rprng.key(2 ** 31 + 11)
    s0 = model.init_state(POOL)
    lanes = tuple(a.unsqueeze(0).repeat(G, 1) for a in s0.lanes)
    lanes, t, r, stats = REFERENCE.sweep_call(lanes, key, Q, rounds)
    for i in (0, 21, 42, 63):
        one = model.lanes_call(s0, key, Q.points[i], rounds)
        for a, b in zip(lanes, one.lanes):
            assert torch.equal(a[i], b), i
        assert float(t[i]) == float(one.t) and int(r[i]) == rounds
        for a, b in zip(stats, one.stats):
            assert a[i].item() == b.item(), i
    assert float(stats[model.STATS_FIELDS.index("suspicions")].sum()) > 0


def _top_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_the_reference_imports_nothing_of_the_port():
    root = pathlib.Path(harness.__file__).resolve().parent
    for path in (root / "reference" / "sweep.py", root / "grid.py"):
        names = _top_names(path)
        assert not any(n.split(".")[0] in ("consul_tpu_torch", "consul_tpu",
                                           "jax") for n in names), path
        assert {n.split(".")[0] for n in names} <= {
            "torch", "__future__", "gossipbench"}, path
        assert {n for n in names if n.startswith("gossipbench")} <= {
            "gossipbench", "gossipbench.reference",
            "gossipbench.reference.model"}, path


# ------------------------------------------- program against reference


def _reference(seed: int, F=torch.float32):
    P = model.Params(CONFIG, n=N, stale_k=1)
    key = rprng.fold_in(rprng.key(seed), 0)
    return P, REFERENCE.call(model.init_state(N), key, P, TRAFFIC, None, F)


_reference_cached = functools.lru_cache(maxsize=None)(_reference)


def _judge(got: dict, seed: int, F=torch.float32):
    P, ref = _reference_cached(seed, F)
    return check.judge(check.readings([(got, ref)], P, TRAFFIC), LIMITS)


def _program(seed: int, hook=None) -> tuple:
    """(the outputs of a call, the winner its caller reads)."""
    d = DRIVER.Driver(CONFIG, TRAFFIC, CPU, seed, N)
    if hook is not None:
        hook(d)
    d.start()
    winner = d.fetch(d.call())
    return d.outputs(), winner


_program_cached = functools.lru_cache(maxsize=None)(_program)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_the_cell_reads_zero_and_its_control_fails(seed):
    res, info = harness.run_cell(CELL, seed, 0.05, False, device="cpu",
                                 n=N, control=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(LIMITS)
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    ok, _ = check.judge(info["control"], LIMITS)
    assert not ok, info["control"]


def test_the_program_reads_zero_on_another_seed():
    ok, checks = _judge(_program_cached(11)[0], 11)
    assert ok and all(c["value"] == 0.0 for c in checks.values()), checks


def test_the_points_differ_and_the_report_picks_a_winner():
    """The check has something to tell apart: the points' counters
    differ, and the caller's read is a winner of the grid."""
    got, winner = _program_cached(11)
    sc = got["scalars"]
    assert sc.shape == (grid.N_REPORT, G)
    # suspicions follow the shared draws; latencies the swept timers
    assert len(set(sc[model.LAT].tolist())) >= 4
    assert 0 <= winner["point"] < G and set(winner["params"]) == \
        set(TRAFFIC["grid"])


def _alter_suspicion_mult(d):
    """Point 37 runs another suspicion multiplier (its swept leaf and
    the constants derived from it)."""
    pts = SweepAxes.of(**TRAFFIC["grid"]).points()
    pts[37] = dict(pts[37], suspicion_mult=3.0)
    d.tp, _ = grid_params(d.p, pts, CPU)


def _swap_rows(d):
    """The engine returns points 0 and 63 in each other's rows."""
    run = d.run

    def swapped(tp, key):
        states, trace = run(tp, key)
        for x in [*states.node_arrays(), states.t, states.round_idx,
                  *states.stats]:
            x[[0, G - 1]] = x[[G - 1, 0]]
        return states, trace

    d.run = swapped


@pytest.mark.parametrize("defect", [_alter_suspicion_mult, _swap_rows])
def test_a_broken_program_fails(defect):
    ok, checks = _judge(_program(11, defect)[0], 11)
    assert not ok, checks


def test_the_control_fails_by_more_than_one_number():
    ok, checks = _judge(_program_cached(11)[0], 11, torch.bfloat16)
    assert not ok
    failed = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert len(failed) >= 2, checks


# ---------------------------------------------------- the roofline count


def test_the_grid_count_is_the_cost_models():
    """``bounds/lane_round_grid.py`` at the cell's n is the program's
    ``costmodel.lane_bound`` of one grid launch at stale_k 1: ``[G,
    pool]`` lanes, the pool's slot rows shared by every point, a
    constant row and 8 scalars a point."""
    n, pool = CONFIG["n"], CONFIG["pool_n"]
    vals = [torch.empty((G, pool), dtype=a.dtype, device="meta")
            for a in init_state(1, device=CPU).node_arrays()]
    u = torch.empty((4, pool), device="meta")
    want = costmodel.lane_bound(vals, u, None, "write", True)
    got = lane_round_grid.launch(CONFIG, n)
    assert got["bytes"] == want["bytes"]
    assert got["f32_ops"] == want["f32_ops"]
    assert got["bound_s"] == pytest.approx(want["bound_ms"] * 1e-3,
                                           rel=1e-12)
    assert lane_round_grid.bound_s(CONFIG, TRAFFIC, n) == got["bound_s"]


def test_the_pool_count_at_the_grids_n_reads_every_rows_slots():
    """``bounds/lane_round.py`` at the grid's n counts the slot rows of
    every agent-row and one table row: 16 (n - pool) bytes more and
    112 (G - 1) less than the grid launch, ~10% high; the sweep's
    reader takes the grid's count."""
    n, pool = CONFIG["n"], CONFIG["pool_n"]
    frozen = lane_round.launch(CONFIG, n, 4, "write", True)
    ours = lane_round_grid.launch(CONFIG, n)
    assert frozen["bytes"] - ours["bytes"] == \
        16 * (n - pool) - 4 * 28 * (G - 1)
    assert 0.09 < frozen["bytes"] / ours["bytes"] - 1 < 0.11
    dev = [(0.0, 300.0, "lane_round<false, false>(LaneArgs)")]
    ctx = harness.Context(dev=dev, cfg=CONFIG, traffic=TRAFFIC, n=n)
    read = harness.load_module("metrics", "lane_round_roofline.sweep").read
    assert read(ctx) == pytest.approx(100.0 * ours["bound_s"] / 300e-6)
    assert read(harness.Context(dev=[], cfg=CONFIG, traffic=TRAFFIC,
                                n=n)) is None


# ------------------------------------------------------------ the readers


def _mark(name, t):
    return (t, t, name)


def test_the_sweep_span_readers():
    """The prologue spans summed a call and the report span's mean;
    nothing where the program opens neither (the parent's sweep)."""
    host = sorted([
        _mark("sim.runner.call:b", 0.0), _mark("sim.sweep.prologue:b", 1.0),
        _mark("sim.sweep.prologue:e", 4.0), _mark("sim.graph.call:b", 5.0),
        _mark("sim.graph.call:e", 9.0), _mark("sim.runner.call:e", 10.0),
        _mark("sim.sweep.report:b", 11.0), _mark("sim.sweep.report:e", 17.0),
        _mark("sim.runner.call:b", 20.0), _mark("sim.sweep.prologue:b", 21.0),
        _mark("sim.sweep.prologue:e", 26.0), _mark("sim.runner.call:e", 30.0),
        _mark("sim.sweep.report:b", 31.0), _mark("sim.sweep.report:e", 33.0)])

    def reader(name):
        return harness.load_module("metrics", name).read

    ctx = harness.Context(host=host, traced_rounds=240)
    assert reader("sweep_prologue_us_per_call")(ctx) == 4.0
    assert reader("sweep_report_us_per_call")(ctx) == 4.0
    parent = harness.Context(host=[e for e in host if "sweep" not in e[2]],
                             traced_rounds=240)
    assert reader("sweep_prologue_us_per_call")(parent) is None
    assert reader("sweep_report_us_per_call")(parent) is None
    for name in ("graph_host_us_per_replay", "device_us_per_round"):
        assert reader(name + ".sweep")(ctx) == reader(name)(ctx)
