"""The benchmark's eclipse cell (``lan-1m.chaos``) on the CPU: the plain
reference's plan fold (``gossipbench/reference/plan.py``) against the
port's ``faults.compile_plan``, its faulted kernel-runner calls
(``gossipbench/reference/chaos.py``) against the port's chaos runner over
the whole 120-period plan, its faulted period against the round
kernel's plain version on byzantine frames of every lane, the cell's run
through the harness, and the seeded defects the cell's limits catch."""

import pytest
import torch

import test_torch_harness  # noqa: F401  (one torch thread a worker)
from consul_tpu_torch import faults
from consul_tpu_torch.sim import cuda_round, prng, scenarios
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import STATS_FIELDS, init_state
from gossipbench import check, harness
from gossipbench.drivers.chaos import fault_plan
from gossipbench.program import SIM_FIELDS
from gossipbench.reference import chaos, model
from gossipbench.reference import prng as rprng
from gossipbench.reference.plan import MASK_LANES, ROW_LANES, Plan

CELL = "lan-1m.chaos"
SIZES = (1024, 4096)
TRAFFIC = harness.load_json("traffic", "chaos")
LIMITS = harness.load_json("workloads", CELL)["limits"]
CONFIG = harness.load_json("configs",
                           harness.load_json("workloads", CELL)["config"])
ATTACK = ("attack_suspicions", "attack_false_positives")


def _configs(n: int) -> dict:
    """The LAN pool's constants, which the cell's deployment holds too,
    and the chaos suite's, as configuration dicts at ``n`` agents."""
    lan = dict(harness.load_json("configs", "lan-1m"), n=n)
    p = scenarios.chaos_params(n)
    return {"lan-1m": lan,
            "chaos_params": dict({f: getattr(p, f) for f in SIM_FIELDS},
                                 n=n)}


def test_the_cell_config_is_the_lan_pool_under_the_traffic_plan():
    """``lan-1m-eclipse`` is ``lan-1m``'s pool, constant for constant,
    under the attack the traffic runs, from a source of its own."""
    lan = harness.load_json("configs", "lan-1m")
    assert CONFIG["name"] == "lan-1m-eclipse"
    assert {f: CONFIG[f] for f in SIM_FIELDS + ("n", "precision")} == \
        {f: lan[f] for f in SIM_FIELDS + ("n", "precision")}
    assert CONFIG["threat"] == TRAFFIC["plan"]
    assert CONFIG["source"] != lan["source"]


@pytest.mark.parametrize("n", SIZES)
def test_the_traffic_plan_is_the_eclipse_class(n):
    assert fault_plan(TRAFFIC["plan"], n) == \
        scenarios.chaos_plans(n)["eclipse"]


@pytest.mark.parametrize("n", SIZES)
def test_plan_lanes_are_compile_plans(n):
    """Every f32 lane and mask of every phase equals the port's fold bit
    for bit (bound: 0 ulp), ``mid`` too; the attacked mask is the
    victims, [0, n/16)."""
    ref = Plan(TRAFFIC["plan"], n)
    cp = faults.compile_plan(scenarios.chaos_plans(n)["eclipse"], n, "cpu")
    assert ref.starts == cp.starts.tolist() and ref.byzantine
    for i, lanes in enumerate(ref.lanes):
        for name in ROW_LANES + MASK_LANES + ("mid",):
            want = getattr(cp, name)[i]
            assert lanes[name].dtype == want.dtype, name
            assert torch.equal(lanes[name], want), (i, name)
    attacked = ref.lanes[1]["attacked"]
    assert attacked[:n // 16].all() and not attacked[n // 16:].any()
    assert float(ref.lanes[1]["suspw"][0]) < 0.01
    assert not ref.lanes[0]["attacked"].any()


def test_the_fold_refuses_what_it_does_not_state():
    spec = {"phases": [{"name": "cut", "rounds": 4, "faults": [
        {"primitive": "Partition", "a": [0.0, 0.5], "b": [0.5, 1.0]}]}]}
    with pytest.raises(ValueError, match="Partition"):
        Plan(spec, 64)


def _port_run(cfg: dict, n: int, seed: int):
    """The port's chaos path (``run_chaos``'s run) on the eclipse plan."""
    p = SimParams(n=n, **{f: cfg[f] for f in SIM_FIELDS})
    return scenarios.chaos_outputs("eclipse", n=n, seed=seed, device="cpu",
                                   p=p)


@pytest.mark.parametrize("config", ["lan-1m", "chaos_params"])
@pytest.mark.parametrize("n", SIZES)
def test_the_port_runs_the_references_trial(config, n):
    """The whole 120-period plan from the all-live state: int lanes and
    all 10 counters exact, the two attack counters among them and
    nonzero, the flight rows within the cell's limits."""
    seed = 2 ** 31 + 91
    cfg = _configs(n)[config]
    state, trace, _ = _port_run(cfg, n, seed)
    P = model.Params(cfg)
    ref, rtrace, _ = chaos.call(model.init_state(n), rprng.key(seed), P,
                                TRAFFIC)
    for i in check.INT_LANES:
        assert torch.equal(state.node_arrays()[i], ref.lanes[i]), i
    stats = dict(zip(STATS_FIELDS, ref.stats))
    for f in STATS_FIELDS:
        assert float(getattr(state.stats, f)) == float(stats[f]), f
    for f in ATTACK:
        assert int(stats[f]) > 0, f
    got = {"lanes": state.node_arrays(), "t": state.t,
           "round_idx": state.round_idx,
           "stats": [getattr(state.stats, f) for f in STATS_FIELDS],
           "trace": trace}
    values = check.readings([(got, (ref, rtrace, None))], P, TRAFFIC)
    ok, checks = check.judge(values, LIMITS)
    assert ok, checks
    assert rtrace[:, 8].tolist() == [0.0] * 10 + [1.0] * 60 + [2.0] * 50


def _frame(n: int, kind: str) -> dict:
    """A byzantine frame whose lanes vary by agent: the eclipse phase's
    lanes with forged acks, forged suspicions, stale replays, forced
    slow agents and churn rates laid over them."""
    g = torch.Generator().manual_seed(
        ("forge", "spur", "replay", "all").index(kind) + 17)
    fx = dict(Plan(TRAFFIC["plan"], n).lanes[1])

    def u(scale):
        return torch.rand(n, generator=g) * scale

    if kind in ("forge", "all"):
        fx["forge_ack"] = u(0.9)
    if kind in ("spur", "all"):
        fx["spur_susp"] = u(2.0)
    if kind in ("replay", "all"):
        fx["replay"] = u(0.6)
    if kind == "all":
        fx["slow_f"] = torch.rand(n, generator=g) < 0.2
        fx["crash_p"], fx["rejoin_p"], fx["leave_p"] = u(0.05), u(0.3), \
            u(0.02)
    return fx


@pytest.mark.parametrize("kind", ["forge", "spur", "replay", "all"])
def test_a_faulted_period_is_the_kernels_plain_version(kind):
    """One period on a state 40 periods into a trial (the victims
    suspected, some declared), on byzantine frames whose forge,
    spurious-suspicion and replay lanes are not zero: the new lanes and
    the [blocks, 18] partial sums bit for bit."""
    n = 1024
    cfg = _configs(n)["lan-1m"]
    p = SimParams(n=n, **{f: cfg[f] for f in SIM_FIELDS})
    P = model.Params(cfg)
    cp = faults.compile_plan(scenarios.chaos_plans(n)["eclipse"], n, "cpu")
    state = cuda_round.make_run_rounds_cuda(p, 40, plan=cp)(
        init_state(n, device="cpu"), prng.key(2 ** 31 + 5, device="cpu"))
    arrays = state.node_arrays()
    scalars = cuda_round.init_scalars(state, p)
    seed = prng.round_seeds(prng.key(7, device="cpu"), 3, 1)[0]
    fx = _frame(n, kind)
    port_fx = faults.FaultFrame(**{f: fx[f] for f in
                                   faults.FaultFrame._fields})
    want, want_sums = cuda_round.block_round_ref(arrays, scalars, seed, p,
                                                 fx=port_fx)
    outs, lanes = chaos.period(arrays, scalars, P,
                               rprng.philox_slots(seed, n), fx, True)
    for i, (o, w) in enumerate(zip(outs, want)):
        assert torch.equal(o.to(w.dtype), w), i
    assert torch.equal(model.block_sums(lanes, n), want_sums)
    assert float(want_sums[:, 8 + STATS_FIELDS.index("refutes")].sum()) > 0


@pytest.mark.parametrize("rows,npt", [(1024, 2), (1000, 2), (4096, 4),
                                      (300_000, 2)])
def test_kernel_block_sums_take_the_kernels_order(rows, npt):
    """The partials as the round kernel's threads add them, against the
    same order written agent by agent: a thread's values tile by tile,
    warps folded by halves, warps in turn (several tiles a block past
    270,336 agents; a ragged last tile at 1,000)."""
    g = torch.Generator().manual_seed(rows + npt)
    lanes = [torch.rand(rows, generator=g) * 10 for _ in range(8)] + \
        [(torch.rand(rows, generator=g) < 0.1).float()] + [None] * 9
    got = chaos.kernel_block_sums(lanes, rows, npt)
    blocks = min(model.GRID_BLOCKS, -(-rows // model.TILE))
    threads = model.TILE // npt
    i = torch.arange(rows)
    walk = i // (blocks * model.TILE)
    block = (i // model.TILE) % blocks
    thread = (i % model.TILE) // npt
    x = torch.stack([torch.zeros(rows) if v is None else v for v in lanes])
    acc = torch.zeros(18, blocks, threads)
    for k in range(int(walk.max()) + 1):
        for j in range(npt):
            at = (walk == k) & (i % npt == j)
            acc[:, block[at], thread[at]] = acc[:, block[at], thread[at]] \
                + x[:, at]
    want = torch.zeros(18, blocks)
    for w in range(threads // 32):
        a = [acc[:, :, w * 32 + t] for t in range(32)]
        for off in (16, 8, 4, 2, 1):
            a = [a[t] + a[t + off] for t in range(off)]
        want = want + a[0]
    assert torch.equal(got, want.t())
    assert torch.allclose(got, model.block_sums(lanes, rows), rtol=1e-5)


def test_the_cell_runs_correct_on_the_cpu():
    res, info = harness.run_cell(CELL, 2 ** 31 + 404, 0.05, False,
                                 device="cpu", n=1024)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert set(res["checks"]) == set(LIMITS)


def _frame_dropped(driver):
    driver.run = cuda_round.make_run_rounds_cuda(
        driver.p, driver.rounds, flight_every=1)
    return driver


def _lanes_zeroed(driver):
    """The plan's byzantine lanes zeroed: nobody is attacked and nobody
    lies."""
    cp = driver.plan
    cp.rows[:, faults.ROW_LANES.index("forge_ack"):].zero_()
    cp.masks[:, faults.MASK_LANES.index("attacked")] = False
    return driver


@pytest.mark.parametrize("defect", ["frame_dropped", "byz_lanes_zeroed",
                                    "control_bfloat16"])
def test_a_seeded_defect_fails_a_limit(defect):
    hook = {"frame_dropped": _frame_dropped,
            "byz_lanes_zeroed": _lanes_zeroed}.get(defect)
    res, info = harness.run_cell(CELL, 2 ** 31 + 12, 0.05, False,
                                 device="cpu", n=1024, driver_hook=hook,
                                 control=defect == "control_bfloat16")
    if hook is None:
        assert res["correct"], res["checks"]
        ok, checks = check.judge(info["control"], LIMITS)
    else:
        ok, checks = res["correct"], res["checks"]
    assert not ok, checks


def test_a_call_starts_from_the_restored_state():
    """Two calls on different keys each run rounds 0-119 from the
    all-live state; the state a call starts from is what snapshot()
    gives."""
    drv = harness.load_module("drivers", "chaos").Driver(
        CONFIG, TRAFFIC, torch.device("cpu"), 5, 1024)
    drv.start()
    for c in range(2):
        snap = drv.snapshot()
        assert int(snap["round_idx"]) == 0 and float(snap["t"]) == 0.0
        assert all(int(s) == 0 for s in snap["stats"])
        live = init_state(1024, device="cpu").node_arrays()
        assert all(torch.equal(a, b) for a, b in zip(snap["lanes"], live))
        trace = drv.call()
        assert int(drv.state.round_idx) == 120 and trace.shape[0] == 120
        assert snap["call"] == c
