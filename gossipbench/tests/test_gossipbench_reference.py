"""The frozen reference against the program's plain paths on the CPU at
small sizes: every cell's check reads exactly zero there, and the
reference's random streams are the program's word for word."""

import pytest
import torch

from consul_tpu_torch.sim import prng as port_prng
from gossipbench import harness
from gossipbench.reference import model
from gossipbench.reference import prng

N = 1024
CELLS = ("lan-1m.long", "lan-1m.chunked", "wan-1m-churn5.live",
         "wan-1m-churn5.lanes")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_cell_reads_zero_against_the_plain_program(cell, seed):
    res, info = harness.run_cell(cell, seed, 0.05, False, device="cpu",
                                 n=N)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert info["calls"] >= 1


def test_streams_are_the_programs():
    k = prng.key(2 ** 31 + 5)
    pk = port_prng.key(2 ** 31 + 5)
    assert torch.equal(k, pk)
    assert torch.equal(prng.round_keys(k, 7, 5),
                       port_prng.round_keys(pk, 7, 5))
    assert torch.equal(prng.round_seeds(k, 7, 5),
                       port_prng.round_seeds(pk, 7, 5))
    assert torch.equal(prng.fold_in(k, 3), port_prng.fold_in(pk, 3))
    sub = prng.split(k, 5)[2]
    assert torch.equal(prng.uniform(sub, 257),
                       port_prng.uniform(port_prng.split(pk, 5)[2], 257))
    assert torch.equal(prng.u01_global(sub, 257),
                       port_prng.u01_global(port_prng.split(pk, 5)[2], 0,
                                            257))
    seed = port_prng.round_seeds(pk, 0, 1)[0]
    ours, theirs = prng.philox_slots(seed, 300), \
        port_prng.philox_u01(seed, 300)
    for slot in range(5):
        assert torch.equal(ours(slot), theirs(slot))


@pytest.mark.parametrize("cell", CELLS)
def test_the_detector_works_in_every_call(cell):
    """Churn keeps the detector busy call after call: agents crash, are
    suspected and declared, and rejoin, in each call that follows the
    first, where a pool with no failures would sit at a fixed point."""
    spec = harness.load_json("workloads", cell)
    cfg = harness.load_json("configs", spec["config"])
    traffic = harness.load_json("traffic", spec["traffic"])
    P = model.Params(cfg, n=4096, stale_k=traffic.get("stale_k", 1))
    engine = harness.load_module("reference", traffic["reference"])
    key = prng.key(2 ** 31 + 9)
    s, _, sc = engine.call(model.init_state(4096), key, P, traffic)
    moved = []
    for c in (0, 1):
        before = [int(x) for x in s.stats]
        s, _, sc = engine.call(s, prng.fold_in(key, c + 1), P, traffic, sc)
        moved.append({f: int(x) - b for f, x, b in
                      zip(model.STATS_FIELDS, s.stats, before)})
    for d in moved:
        for f in ("crashes", "rejoins", "suspicions",
                  "true_deaths_declared"):
            assert d[f] > 0, (f, moved)
