"""The benchmark's coordinates cell (``lan-1m.coords``) and fast-runner
cell (``lan-1m.fast``) on the CPU: the configuration against the port's
constants and the traffic's copies, the driver's set-up against
``scenarios.run_coords``', the plain reference's draws, latency map and
partition fold against the port's, the program against the reference
(``gossipbench/reference/coords.py``, ``fast.py``) within the cells'
limits, the bfloat16 control and the seeded defects the limits catch,
and the coordinate spans and counters.

At the cell's own constants two of the seeded defects cannot show: the
deadline ``max(0.5 s, min(3 x estimate, 1 s)) x (lh + 1)`` lies above
every round trip of the latency map (at most ~0.15 s), so no deadline
binds, and gravity's ``(x / 150)^3`` is below half an f32 ulp of every
coordinate under ~0.45 s, so it moves none. Those two are shown on
variants of the cell where the mechanism acts: a 10 ms probe timeout,
and the latency map scaled a thousandfold with the deadlines off."""

import dataclasses
import functools

import pytest
import torch

import test_torch_harness  # noqa: F401  (one torch thread a worker)
from consul_tpu_torch import faults
from consul_tpu_torch.sim import coords as coords_mod
from consul_tpu_torch.sim import prng, scenarios, topology
from consul_tpu_torch.sim import round as round_mod
from consul_tpu_torch.sim.state import init_state
from consul_tpu_torch.utils import telemetry
from gossipbench import check, harness
from gossipbench.reference import coords as rcoords
from gossipbench.reference import model
from gossipbench.reference import prng as rprng

CELL, FAST = "lan-1m.coords", "lan-1m.fast"
SIZES = (1024, 4096)
CPU = torch.device("cpu")
SPEC = harness.load_json("workloads", CELL)
CONFIG = harness.load_json("configs", SPEC["config"])
TRAFFIC = harness.load_json("traffic", SPEC["traffic"])
LIMITS = SPEC["limits"]
DRIVER = harness.load_module("drivers", "coords")
#: serf's names of ``sim/coords.py``'s constants
SERF = {"Dimensionality": "DIMENSION", "VivaldiErrorMax": "VIVALDI_ERROR_MAX",
        "VivaldiCE": "VIVALDI_CE", "VivaldiCC": "VIVALDI_CC",
        "AdjustmentWindowSize": "ADJUSTMENT_WINDOW",
        "HeightMin": "HEIGHT_MIN", "zeroThreshold": "ZERO_THRESHOLD",
        "GravityRho": "GRAVITY_RHO"}


# ------------------------------------------------------ the configuration


def test_the_coordinate_constants_are_the_ports():
    assert CONFIG["coordinates"] == {k: getattr(coords_mod, v)
                                     for k, v in SERF.items()}
    assert TRAFFIC["coordinates"] == CONFIG["coordinates"]


def test_the_traffic_carries_the_configurations_copies():
    assert CONFIG["threat"] == TRAFFIC["plan"]
    assert CONFIG["topology"] == TRAFFIC["topology"]
    for k in ("coords_timeout", "coord_timeout_mult"):
        assert CONFIG[k] == TRAFFIC[k], k
    assert CONFIG["reduced"] == [] and CONFIG["n"] == 2 ** 20


@pytest.mark.parametrize("n", SIZES + (2 ** 20,))
def test_the_threat_is_the_scenarios_plan(n):
    assert DRIVER.fault_plan(TRAFFIC["plan"], n) == \
        scenarios.coords_plan(n)


@pytest.mark.parametrize("n", SIZES)
def test_the_driver_builds_what_run_coords_builds(n, monkeypatch):
    """The driver's parameters, topology and compiled plan are
    ``run_coords``' own, and both come from ``coords_setup``."""
    built = []
    setup = scenarios.coords_setup

    def record(*a, **kw):
        built.append(setup(*a, **kw))
        return built[-1]

    monkeypatch.setattr(scenarios, "coords_setup", record)
    d = DRIVER.Driver(CONFIG, TRAFFIC, CPU, 2 ** 31 + 3, n)
    mine = scenarios.coords_setup(n, device=CPU)
    assert len(built) == 2
    assert d.p == mine.p == scenarios.coords_params(n)
    assert d.setup.plan == mine.plan
    assert faults.plan_digest(d.setup.cp) == faults.plan_digest(mine.cp)
    for a, b in zip(d.setup.topo, mine.topo):
        assert torch.equal(a, b)
    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    monkeypatch.setattr(scenarios, "run_rounds_flight", stop)
    with pytest.raises(Stop):
        scenarios.run_coords(n=n, device=CPU)
    assert len(built) == 3 and built[-1].p == d.p


# ---------------------------------------------- the reference's pieces


def test_the_draws_and_the_latency_map_are_the_programs():
    k, pk = rprng.key(2 ** 31 + 5), prng.key(2 ** 31 + 5)
    sub, psub = rprng.split(k, 4)[1], prng.split(pk, 4)[1]
    assert torch.equal(rcoords.normal(sub, (300, 4)),
                       prng.normal(psub, (300, 4)))
    assert torch.equal(rcoords.exponential(sub, (257,)),
                       prng.exponential(psub, (257,)))
    for lo, hi in ((1, 1024), (1, 2 ** 20), (0, 100)):
        assert torch.equal(rcoords.randint(sub, 513, lo, hi),
                           prng.randint(psub, (513,), lo, hi))
    assert torch.equal(rcoords.pairs(4096, sub),
                       topology.sample_pairs(4096, psub))
    assert torch.equal(rprng.fold_in(k, rcoords.COORD_FOLD),
                       prng.fold_in(pk, prng.COORD_FOLD))
    mine = rcoords.topology(TRAFFIC["topology"], 4096)
    theirs = topology.make_topology(
        DRIVER.topology_params(CONFIG["topology"], 4096), CPU)
    assert torch.equal(mine.pos, theirs.pos)
    assert torch.equal(mine.height, theirs.height)
    assert torch.equal(mine.sigma, theirs.jitter_sigma)


@pytest.mark.parametrize("n", SIZES)
def test_the_partition_fold_is_compile_plans(n):
    ref = rcoords.Plan(TRAFFIC["plan"], n)
    cp = faults.compile_plan(scenarios.coords_plan(n), n, CPU)
    assert ref.starts == cp.starts.tolist() and cp.attacked is None
    cut = n // 8
    for i, lanes in enumerate(ref.lanes):
        for name, lane in lanes.items():
            want = getattr(cp, name)[i]
            if name == "suspw" and i == 1:
                # the cut side's weights: residues of two near-equal
                # sums, whose last bits follow the sum's order
                assert (lane[:cut] < 1e-12).all()
                assert (want[:cut] < 1e-12).all()
                lane, want = lane[cut:], want[cut:]
            assert torch.equal(lane, want), (i, name)
    assert float(ref.lanes[1]["suspw"][-1]) > 0.5


# ------------------------------------------- program against reference


def _variant(name: str) -> tuple:
    """(configuration, traffic) of the cell or of a variant in which a
    seeded defect acts (the module's doc)."""
    cfg, tr = dict(CONFIG), dict(TRAFFIC)
    if name == "tight_deadline":
        cfg["probe_timeout"] = 0.01
    elif name == "wide_map":
        topo = dict(tr["topology"])
        for k in ("dc_spread_s", "intra_spread_s", "height_min_s",
                  "height_mean_s"):
            topo[k] *= 1000.0
        cfg["topology"] = tr["topology"] = topo
        cfg["coords_timeout"] = tr["coords_timeout"] = False
    return cfg, tr


def _program(variant: str, n: int, seed: int) -> dict:
    cfg, tr = _variant(variant)
    d = DRIVER.Driver(cfg, tr, CPU, seed, n)
    d.start()
    d.call()
    return d.outputs()


@functools.lru_cache(maxsize=None)
def _program_cached(variant: str, n: int, seed: int) -> dict:
    return _program(variant, n, seed)


@functools.lru_cache(maxsize=None)
def _reference(variant: str, n: int, seed: int, F=torch.float32):
    cfg, tr = _variant(variant)
    P = model.Params(cfg, n=n)
    key = rprng.fold_in(rprng.key(seed), 0)
    return P, rcoords.call(model.init_state(n), key, P, tr, None, F)


def _judge(got: dict, variant: str, n: int, seed: int, F=torch.float32):
    P, ref = _reference(variant, n, seed, F)
    return check.judge(check.readings([(got, ref)], P, TRAFFIC), LIMITS)


@pytest.mark.parametrize("n,seed", [(1024, 3), (1024, 2 ** 31 + 77),
                                    (1024, 11), (4096, 5)])
def test_the_program_reads_zero_against_the_reference(n, seed):
    ok, checks = _judge(_program_cached("cell", n, seed), "cell", n, seed)
    assert ok, checks
    assert set(checks) == set(LIMITS)
    assert all(c["value"] == 0.0 for c in checks.values()), checks


def test_the_trial_moves_lanes_and_coordinates():
    """The partition suspects, declares and refutes agents, and the
    coordinates converge: the check has lanes and columns to compare."""
    got = _program_cached("cell", 1024, 3)
    tr = got["trace"]
    assert tr.shape == (TRAFFIC["rounds"], 22)
    assert float(tr[:, 9].sum()) > 0          # suspicions
    assert float(tr[59, 19]) < float(tr[0, 19])   # median error falls
    assert (tr[:, 8] == torch.tensor([0.0] * 60 + [1.0] * 40
                                     + [2.0] * 40)).all()


def test_the_control_fails():
    got = _program_cached("cell", 1024, 3)
    ok, checks = _judge(got, "cell", 1024, 3, torch.bfloat16)
    assert not ok, checks


def _ring_never_written(monkeypatch, variant):
    step = coords_mod.vivaldi_step_plain

    def broken(coords, *a, **kw):
        return step(coords, *a, **kw)._replace(
            adj_samples=coords.adj_samples, adjustment=coords.adjustment)

    monkeypatch.setattr(coords_mod, "vivaldi_step_plain", broken)


def _gravity_off(monkeypatch, variant):
    monkeypatch.setattr(coords_mod, "ipow",
                        lambda x, y: torch.zeros_like(x))


def _deadline_from_truth(monkeypatch, variant):
    cfg, _ = _variant(variant)
    topo = topology.make_topology(
        DRIVER.topology_params(cfg["topology"], 1024), CPU)
    probe = coords_mod.probe_plain

    def broken(*a, **kw):
        # the deadlines' estimates (and only theirs) from the truth
        with monkeypatch.context() as m:
            m.setattr(coords_mod, "estimate_rtt",
                      lambda c, i, j: topology.true_rtt(topo, i, j))
            return probe(*a, **kw)

    monkeypatch.setattr(coords_mod, "probe_plain", broken)


@pytest.mark.parametrize("defect,variant", [
    (_ring_never_written, "cell"), (_gravity_off, "wide_map"),
    (_deadline_from_truth, "tight_deadline")])
def test_a_broken_program_fails(defect, variant, monkeypatch):
    seed = 3
    ok, checks = _judge(_program_cached(variant, 1024, seed), variant,
                        1024, seed)
    assert ok and all(c["value"] == 0.0 for c in checks.values()), checks
    defect(monkeypatch, variant)
    ok, checks = _judge(_program(variant, 1024, seed), variant, 1024, seed)
    assert not ok, checks


# --------------------------------------------------- the fast runner


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_the_fast_runner_reads_zero_and_its_control_fails(seed):
    res, info = harness.run_cell(FAST, seed, 0.05, False, device="cpu",
                                 n=1024, control=True)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    ok, _ = check.judge(info["control"],
                        harness.load_json("workloads", FAST)["limits"])
    assert not ok, info["control"]


def test_the_fast_runner_is_not_the_lane_engine_at_stale_k_1():
    """Why the fast cell has a reference of its own: on one key the lane
    engine at stale_k 1 draws another stream and sums in another order."""
    cfg = dict(harness.load_json("configs", "lan-1m"), n=1024)
    P = model.Params(cfg, n=1024)
    key = rprng.key(3)
    fast = harness.load_module("reference", "fast")
    a = fast.fast_call(model.init_state(1024), key, P, 8)
    b = model.lanes_call(model.init_state(1024), key, P, 8)
    assert any(not torch.equal(x, y) for x, y in zip(a.lanes, b.lanes))


# ------------------------------------------------- spans and counters


def _flight(n: int, rounds: int, p):
    su = scenarios.coords_setup(n, p=p, device=CPU)
    return round_mod.run_rounds_flight(
        init_state(n, device=CPU), prng.key(9), su.p, rounds, plan=su.cp,
        coords=coords_mod.init_coords(n, device=CPU), topo=su.topo)


@pytest.mark.parametrize("timeout,misses", [(0.5, False), (0.01, True)])
def test_the_coordinate_counters_are_published_once_a_call(timeout, misses,
                                                           monkeypatch):
    """``sim.coords.updates`` is every ring write (the cursors advance
    once a relaxation, and 8 periods do not wrap them);
    ``sim.coords.deadline_misses`` stays 0 at the LAN timeout and counts
    at a 10 ms one. Nothing is read unless a registry is armed."""
    p = dataclasses.replace(scenarios.coords_params(256),
                            probe_timeout=timeout)
    m = telemetry.Metrics()
    with telemetry.armed(m):
        _, c, _ = _flight(256, 8, p)
    counters = {x["Name"]: x["Count"] for x in m.snapshot()["Counters"]}
    assert counters["consul.sim.coords.updates"] == \
        float(c.adj_idx.sum()) > 0
    assert (counters["consul.sim.coords.deadline_misses"] > 0) == misses
    reads = []
    monkeypatch.setattr(telemetry, "count", reads.append)
    _flight(256, 2, p)
    assert reads == []


def test_the_spans_mark_a_traced_call():
    """Under a CPU profiler: the runner's call, prologue and epilogue as
    begin and end marks, the two coordinate spans as record functions
    held open, two steps and one quality row a period."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _flight(64, 3, scenarios.coords_params(64))
    names = [e.name for e in prof.events() if e.name.startswith("sim.")]
    assert names.count("sim.coords.step") == 6
    assert names.count("sim.coords.metrics") == 3
    for s in ("sim.runner.call", "sim.runner.prologue",
              "sim.runner.epilogue"):
        assert names.count(s + ":b") == names.count(s + ":e") == 1
    assert not any(n.startswith("sim.coords.") and ":" in n for n in names)


# ------------------------------------------------------------ the readers


def _ctx(dev, rounds=2):
    return harness.Context(dev=sorted(dev), traced_rounds=rounds)


def _reader(name):
    return harness.load_module("metrics", name).read


def test_the_readers_take_the_device_annotations():
    """Device time under each annotation is the operations' busy time
    inside it (gaps and the annotations themselves left out); the share
    is over the operations' busy time alone."""
    dev = [(0.0, 10.0, "sim.coords.step"), (1.0, 4.0, "vivaldi"),
           (6.0, 9.0, "gather"), (12.0, 20.0, "sim.coords.metrics"),
           (12.0, 18.0, "sort"), (21.0, 31.0, "round_body")]
    ctx = _ctx(dev)
    assert _reader("coords_us_per_round")(ctx) == 3.0
    assert _reader("coord_metrics_us_per_round")(ctx) == 3.0
    assert _reader("coords_share_pct")(ctx) == 100.0 * 12.0 / 22.0
    # a trace without the spans reads nothing
    bare = _ctx([e for e in dev if not e[2].startswith("sim.")])
    assert _reader("coords_us_per_round")(bare) is None
    assert _reader("coords_share_pct")(bare) is None
    assert _reader("coords_us_per_round")(_ctx([])) is None
