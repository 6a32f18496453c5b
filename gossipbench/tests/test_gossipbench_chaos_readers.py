"""The eclipse cell's frozen count and readers: ``bounds/round_kernel_byz.py``
equals the program's ``costmodel.kernel_bound`` for a byzantine-frame
launch at the cell's size, the four readers are silent on a trace without
what they read and read a synthetic one, and on the card one short run of
the cell is correct."""

import json
import subprocess
import sys

import pytest
import torch

from consul_tpu_torch import faults
from consul_tpu_torch.sim import costmodel, cuda_round, scenarios
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import init_state
from gossipbench import harness
from gossipbench.bounds import mega_kernel, round_kernel_byz
from gossipbench.program import SIM_FIELDS

CELL = "lan-1m.chaos"
CONFIG = harness.load_json("configs",
                           harness.load_json("workloads", CELL)["config"])
CHURN = ("fail_per_round", "rejoin_per_round", "leave_per_round")
BYZ = "round_kernel<true, true, false, 2, 2>(RoundParams, Arrays, FaultArr"
GATHER = "indexSelectSmallIndex<long, long, unsigned int, 2, 2, -2>(at::cu"


def _eclipse(cfg, n):
    """The churn-free configuration's params, the all-live state and the
    eclipse phase's frame at ``n`` agents."""
    cfg = dict(cfg, **{f: 0.0 for f in CHURN})
    p = SimParams(n=n, **{f: cfg[f] for f in SIM_FIELDS})
    cp = faults.compile_plan(scenarios.chaos_plans(n)["eclipse"], n, "cpu")
    return p, init_state(n, device="cpu").node_arrays(), \
        faults.fault_frame(cp, 10)


def test_byz_count_is_the_cost_models():
    """Without churn, the program's count of one eclipse period on the
    all-live state, given the plain version's output."""
    cfg = CONFIG
    n = cfg["n"]
    p, arrays, fx = _eclipse(cfg, n)
    assert fx.attacked is not None and fx.attacked.any()
    scal = cuda_round.init_scalars(init_state(n, device="cpu"), p)
    out, _ = cuda_round.block_round_ref(arrays, scal,
                                        torch.tensor(5, dtype=torch.int32),
                                        p, fx=fx)
    want = costmodel.kernel_bound(p, arrays, fx=fx, out=out)
    got = round_kernel_byz.launch(dict(cfg, **{f: 0.0 for f in CHURN}), n)
    for k in ("bytes", "int32_ops", "f32_ops", "bound_by"):
        assert got[k] == want[k], k
    assert got["bound_s"] == pytest.approx(want["bound_ms"] * 1e-3,
                                           rel=1e-12)


def test_churn_count_drops_the_acks():
    """Under churn, the program's count for a launch that leaves no agent
    live: every agent's churn and Poisson draws, no ack draw."""
    cfg = CONFIG
    n = cfg["n"]
    assert any(cfg[f] for f in CHURN)
    p, arrays, fx = _eclipse(cfg, n)
    dead = list(arrays)
    dead[3] = torch.zeros_like(dead[3])
    want = costmodel.kernel_bound(p, arrays, fx=fx, out=dead)
    got = round_kernel_byz.launch(cfg, n)
    for k in ("bytes", "int32_ops", "f32_ops"):
        assert got[k] == want[k], k
    tr = harness.load_json("traffic", "chaos")
    assert round_kernel_byz.bound_s(cfg, tr, n) == got["bound_s"]
    assert got["bytes"] > mega_kernel.launch(cfg, n, 1)["bytes"]


class Ctx:
    def __init__(self, dev, rounds=4):
        self.dev = sorted(dev)
        self.host = []
        self.traced_rounds = rounds
        self.busy_s = sum(e - s for s, e, _ in dev) * 1e-6
        self.window_s = 1.0
        self.n = 1 << 20
        self.cfg = CONFIG
        self.traffic = harness.load_json("traffic", "chaos")


READERS = ("round_kernel_byz_roofline", "fault_frame_us_per_round",
           "kernels_per_round.chaos", "device_us_per_round.chaos")


@pytest.mark.parametrize("metric", READERS)
def test_readers_are_silent_without_their_launches(metric):
    read = harness.load_module("metrics", metric).read
    assert read(Ctx([])) is None
    honest = [(0, 30, "round_kernel<true, false, false, 4, 4>(RoundParams"),
              (40, 45, "indexSelectLargeIndex<long, long, unsigned int, 2")]
    if metric in READERS[:2]:
        assert read(Ctx(honest)) is None
    else:
        assert read(Ctx(honest)) is not None


def test_readers_read_a_synthetic_trace():
    # 4 periods: a byz launch of 60 and of 40 us, two gathers of 10 and
    # 12 us a period, an honest launch and a large-index select
    dev = []
    for r in range(4):
        t = 1000 * r
        dev += [(t, t + 10, GATHER), (t + 10, t + 22, GATHER),
                (t + 30, t + (90 if r % 2 else 70), BYZ),
                (t + 100, t + 130, "round_kernel<true, false, false, 4, 4>"),
                (t + 140, t + 141, "indexSelectLargeIndex<long, long")]
    ctx = Ctx(dev)
    read = {m: harness.load_module("metrics", m).read(ctx) for m in READERS}
    least = round_kernel_byz.bound_s(ctx.cfg, ctx.traffic, ctx.n)
    assert read["round_kernel_byz_roofline"] == pytest.approx(
        100.0 * least / 50e-6)
    assert read["fault_frame_us_per_round"] == 22.0
    assert read["kernels_per_round.chaos"] == 5.0
    assert read["device_us_per_round.chaos"] == pytest.approx(
        (22 + 50 + 30 + 1) * 4 / 4)


@pytest.mark.cuda
def test_the_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "gossipbench.run", "--workload", CELL,
         "--seed", str(2 ** 31 + 404), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(READERS)
    assert 0 < res["metrics"]["round_kernel_byz_roofline"]["value"] < 100
