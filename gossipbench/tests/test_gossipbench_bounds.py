"""The frozen roofline counts equal the program's ``costmodel`` counts at
the shapes the cells run today."""

import pytest
import torch

from consul_tpu_torch.sim import costmodel
from consul_tpu_torch.sim.state import init_state
from consul_tpu_torch.sim.params import SimParams
from gossipbench import harness
from gossipbench.bounds import lane_round, mega_kernel, round_kernel
from gossipbench.program import SIM_FIELDS


CHURN = ("fail_per_round", "rejoin_per_round", "leave_per_round")


def _params(config, traffic, churn=True):
    cfg = harness.load_json("configs", config)
    if not churn:
        cfg.update({f: 0.0 for f in CHURN})
    tr = harness.load_json("traffic", traffic)
    p = SimParams(n=cfg["n"], stale_k=tr.get("stale_k", 1),
                  **{f: cfg[f] for f in SIM_FIELDS})
    return cfg, tr, p


@pytest.mark.parametrize("traffic,bound", [("long", mega_kernel),
                                           ("chunked", round_kernel)])
def test_kernel_bound_is_the_cost_models(traffic, bound):
    """Without churn, the program's count on the initial state."""
    cfg, tr, p = _params("lan-1m", traffic, churn=False)
    arrays = init_state(cfg["n"], device="cpu").node_arrays()
    want = costmodel.kernel_bound(p, arrays, rounds=tr["R"])
    got = mega_kernel.launch(cfg, cfg["n"], tr["R"])
    for k in ("bytes", "int32_ops", "f32_ops", "bound_by"):
        assert got[k] == want[k], k
    assert got["bound_s"] == pytest.approx(want["bound_ms"] * 1e-3,
                                           rel=1e-12)
    assert bound.bound_s(cfg, tr, cfg["n"]) == got["bound_s"]


@pytest.mark.parametrize("config", ["lan-1m", "wan-1m-churn5"])
@pytest.mark.parametrize("R", [1, 8])
def test_churn_count_adds_a_draw_and_drops_the_acks(config, R):
    """Under churn, the program's count for a churn-free launch on a
    state with no live node, plus every node's churn draw."""
    cfg = harness.load_json("configs", config)
    assert any(cfg[f] for f in CHURN)
    _, _, p = _params(config, "long", churn=False)
    n = cfg["n"]
    arrays = list(init_state(n, device="cpu").node_arrays())
    arrays[3] = torch.zeros_like(arrays[3])
    want = costmodel.kernel_bound(p, arrays, rounds=R)
    got = mega_kernel.launch(cfg, n, R)
    assert got["bytes"] == want["bytes"]
    assert got["f32_ops"] == want["f32_ops"]
    assert got["int32_ops"] == \
        want["int32_ops"] + R * n * mega_kernel.DRAW_INT_OPS


def test_lane_bound_is_the_cost_models():
    cfg, tr, p = _params("wan-1m-churn5", "lanes")
    n, k = cfg["n"], tr["stale_k"]
    vals = init_state(n, device="cpu").node_arrays()
    u = torch.empty(4, n)
    got = lane_round.window(cfg, n, k)
    for j, g in enumerate(got):
        stats = "add" if j else "write"
        want = costmodel.lane_bound(vals, u, None, stats, j == k - 1)
        assert g["bytes"] == want["bytes"]
        assert g["f32_ops"] == want["f32_ops"]
        assert g["bound_s"] == pytest.approx(want["bound_ms"] * 1e-3,
                                             rel=1e-12)
    assert lane_round.bound_s(cfg, tr, n) == pytest.approx(
        sum(g["bound_s"] for g in got) / k)
