"""consul_tpu_torch's live stages: ``sim/live_kernel.py`` and the
``live_round<STAGE>`` kernels of ``csrc/lane_kernels.cu`` (the live
engine's period as three launches around its population sums).

CPU half:

* The twin (each stage's evaluation in PyTorch, writing the buffers the
  sums read) inside ``fused.twins()`` equals the plain body bit for bit
  over 12 periods at 1,024 agents, through the live runner (which hands
  the stages its carry to write in place) and through
  ``run_rounds_stats`` (new lanes a period, the counters after each):
  ``wan-1m-churn5``'s and ``lan-1m``'s constants, Lifeguard off, the slow
  model on, counters off, no churn, corroboration_k 1. On the CPU both
  divide a tensor by a Python number; the card's reciprocal rule is held
  by the twin under that rule against the plain body with ATen's CUDA
  division emulated.
* Routing: coordinates, probe events, a grid, a fault frame, stale
  scalars, a wide state and ``fused.plain()`` each take the plain body;
  the honest live period takes the three stages (the live runner,
  ``run_rounds``, ``run_rounds_stats``, ``graft_entry.entry()``).
* ``into``: the stages write a runner's carry in place, and a caller's
  state is left as it was on both routes.
* The launch's arguments read back, the refusals, the padded rows, the
  live runner under ``graphs.rehearse()``, ``costmodel.live_bound``.

Card half (``cuda``): the kernels against ``fused.plain()`` for 48
periods at 1,048,576 and at 1,024 agents, captured in a graph and
eager, bit for bit on the lanes, the counters, the clock and the round;
three launches a period on the kernels; and the plain route's launch
count as it was before the stages.
"""

from __future__ import annotations

import ctypes
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from consul_tpu_torch import graft_entry
from consul_tpu_torch import faults as tfaults
from consul_tpu_torch.sim import coords as tcoords
from consul_tpu_torch.sim import costmodel, fused, graphs
from consul_tpu_torch.sim import lane_kernel as LK
from consul_tpu_torch.sim import live_kernel as LV
from consul_tpu_torch.sim import prng, topology
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim import sweep as tsweep
from consul_tpu_torch.sim.params import SimParams, SweepAxes, grid_params
from gossipbench.program import SIM_FIELDS
from test_torch_harness import cuda  # noqa: F401  (fixture)

CPU = torch.device("cpu")
N = 1024
ROUNDS = 12
CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "gossipbench" \
    / "configs"


def _config(name: str, n: int = N) -> SimParams:
    """A benchmark deployment's constants at ``n`` agents."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    return SimParams(n=n, **{f: cfg[f] for f in SIM_FIELDS})


def _variants(n: int = N) -> dict:
    wan, lan = _config("wan-1m-churn5", n), _config("lan-1m", n)
    return {
        "wan-1m-churn5": wan,
        "lan-1m": lan,
        "no lifeguard": wan.with_(lifeguard=False),
        "slow model": lan.with_(slow_per_round=0.01),
        "stats off": wan.with_(collect_stats=False),
        "no churn": lan.with_(fail_per_round=0.0, rejoin_per_round=0.0),
        "corroboration_k=1": lan.with_(corroboration_k=1),
    }


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _leaves(s: tstate.SimState) -> list:
    return list(s.node_arrays()) + [s.t, s.round_idx] + list(s.stats)


def _start(n: int = N, dev=CPU) -> tstate.SimState:
    """Every 53rd agent down two periods, every 131st slow."""
    s = tstate.init_state(n, device=dev)
    s = tstate.with_crashed(s, torch.arange(0, n, 53, device=dev), age=2)
    return tstate.with_slow(s, torch.arange(1, n, 131, device=dev))


def _count_stages(monkeypatch) -> list:
    """Record each twin stage run (0, 1, 2)."""
    seen = []
    twin = LV.twin_stage

    def spy(per, stage, sums, rule=LK.CPU_RULE):
        seen.append(stage)
        return twin(per, stage, sums, rule)

    monkeypatch.setattr(LV, "twin_stage", spy)
    return seen


def _live_runner(p, rounds):
    run = tround.make_run_rounds(p, rounds)

    def call(s, key):
        out = run(s, key)
        return _leaves(out)
    return call


def _stats_runner(p, rounds):
    def call(s, key):
        out, trace = tround.run_rounds_stats(s, key, p, rounds)
        return _leaves(out) + list(trace)
    return call


RUNNERS = {"make_run_rounds": _live_runner,
           "run_rounds_stats": _stats_runner}


@pytest.mark.parametrize("runner", list(RUNNERS))
@pytest.mark.parametrize("name", list(_variants()))
def test_twin_is_the_plain_body(monkeypatch, name, runner):
    """12 periods on the stages' twin against the plain body, bit for
    bit: lanes, clock, round and counters (after every period through
    ``run_rounds_stats``); three stages a period."""
    p = _variants()[name]
    seen = _count_stages(monkeypatch)
    outs = []
    for ctx in (fused.twins, fused.plain):
        with ctx():
            outs.append(RUNNERS[runner](p, ROUNDS)(_start(), prng.key(17)))
    assert seen == [0, 1, 2] * ROUNDS
    assert len(outs[0]) == len(outs[1])
    assert all(_same(a, b) for a, b in zip(*outs))
    # the periods moved the pool
    start = _leaves(_start())
    assert not all(_same(a, b) for a, b in zip(outs[0][:8], start[:8]))


@pytest.mark.parametrize("name", ["wan-1m-churn5", "lan-1m", "slow model"])
def test_twin_under_the_card_rule_divides_as_the_card(monkeypatch, name):
    """The stages' twin under the card's rule against the plain body with
    a tensor divided by a Python number as ATen's CUDA path divides it (a
    product with the f32 reciprocal), bit for bit, over 4 periods (the
    WAN divides by a 5 s interval, whose reciprocal is inexact in f32)."""
    p = _variants()[name]
    slots = tround.draw_slots(p)
    keys = prng.round_keys(prng.key(9), torch.tensor(0), 4)
    rows = [prng.threefry_u01(keys[r], N, slots) for r in range(4)]
    rows = [{s: u(s).clone() for s in slots} for u in rows]

    def run():
        s = _start()
        for r in range(4):
            s, _ = tround.round_core(s, None, p, rows[r].__getitem__)
        return _leaves(s)

    monkeypatch.setattr(LV, "twin_stage", functools.partial(
        LV.twin_stage, rule=LK.CARD_RULE))
    with fused.twins():
        card = run()
    monkeypatch.undo()
    true_div = torch.Tensor.__truediv__

    def div(x, other):
        if isinstance(other, (int, float)):
            return x * float(np.float32(1.0) / np.float32(other))
        return true_div(x, other)

    monkeypatch.setattr(torch.Tensor, "__truediv__", div)
    with fused.plain():
        want = run()
    monkeypatch.undo()
    assert all(_same(a, b) for a, b in zip(card, want))


def test_routing(monkeypatch):
    """Inside ``fused.twins()`` the honest live period of every caller
    takes the three stages; coordinates, probe events, a grid, a fault
    frame, stale scalars, a wide state and ``fused.plain()`` each take
    the plain body. Outside ``fused.twins()`` the CPU runs the plain
    body."""
    seen = _count_stages(monkeypatch)
    p = _variants()["wan-1m-churn5"]
    key = prng.key(1)

    def stages(fn):
        seen.clear()
        fn()
        return len(seen)

    assert stages(lambda: tround.run_rounds(_start(), key, p, 2)) == 0
    cp = tfaults.compile_plan(chip_smoke.check_plans(N)["fault"], N, "cpu")
    topo = topology.make_topology(topology.TopologyParams(n=N, seed=5),
                                  "cpu")
    c0 = tcoords.init_coords(N, device=CPU)
    tp, _ = grid_params(p, SweepAxes.of(gossip_nodes=(2.0, 3.0)), "cpu")
    with fused.twins():
        # the honest period
        assert stages(lambda: tround.make_run_rounds(p, 2)(_start(),
                                                           key)) == 6
        assert stages(lambda: tround.run_rounds(_start(), key, p, 2)) == 6
        assert stages(lambda: tround.run_rounds_stats(_start(), key, p,
                                                      2)) == 6
        fn, args = graft_entry.entry(CPU)
        assert stages(lambda: fn(*args)) == 3
        # the plain body's periods
        assert stages(lambda: tround.run_rounds(_start(), key, p, 2,
                                                plan=cp)) == 0
        assert stages(lambda: tround.run_rounds_coords(
            _start(), c0, topo, key, p, 2)) == 0
        assert stages(lambda: tround.run_rounds_flight(
            _start(), key, p, 2)) == 0
        assert stages(lambda: tround.gossip_round(_start(), key, p,
                                                  events=True)) == 0
        assert stages(lambda: tsweep.make_run_sweep(
            p, 2, engine="xla", device="cpu")(tp, key)) == 0
        assert stages(lambda: tround.make_run_rounds_fast(p, 2)(
            _start(), key)) == 0
        assert stages(lambda: tround.run_rounds(
            tstate.init_state(N, packed=False, device=CPU), key, p,
            2)) == 0
        with fused.plain():
            assert stages(lambda: tround.make_run_rounds(p, 2)(
                _start(), key)) == 0


@pytest.mark.parametrize("route", ["stages", "plain"])
def test_into_writes_the_carry_and_leaves_the_caller_state(route):
    """``into`` the state's own lanes: the period is written there, as
    the same period without it returns it; ``run_rounds`` leaves its
    caller's state as it was."""
    p = _variants()["lan-1m"]
    ctx = fused.twins if route == "stages" else fused.plain
    key = prng.key(4)
    with ctx():
        want = tround.gossip_round(_start(), key, p)
        s = _start()
        lanes = s.node_arrays()
        got = tround.gossip_round(s, key, p, into=lanes)
        before = _leaves(_start())
        s2 = _start()
        tround.run_rounds(s2, key, p, 3)
    assert all(a is b for a, b in zip(got.node_arrays(), lanes))
    assert all(_same(a, b) for a, b in zip(_leaves(got), _leaves(want)))
    assert all(_same(a, b) for a, b in zip(_leaves(s2), before))


def test_live_args_point_at_every_tensor():
    """A stage's ``LiveIO``: the lanes in and out, the table, each drawn
    slot's row (null where not drawn), the sums it reads, the sum rows,
    the counter rows, the padded row length and the stats switch."""
    p = _variants()["wan-1m-churn5"]
    slots = tround.draw_slots(p)
    n = 1000
    s = _start(n)
    u01 = prng.threefry_u01(prng.key(2), n, slots)
    per = LV.Period(s.node_arrays(), u01, slots, p, None)
    sums = [torch.sum(r) for r in per.rows] * 2
    for stage in range(3):
        io = LV.live_args(per, stage, sums[:4 * stage])
        for f, a in zip(tstate.NODE_FIELDS, s.node_arrays()):
            assert getattr(io, f) == a.data_ptr()
        for f, a in zip(tstate.NODE_FIELDS, per.outs):
            assert getattr(io, "o_" + f) == a.data_ptr()
        assert io.tab == per.tab.data_ptr()
        for slot, f in enumerate(LV._SLOT_FIELDS):
            want = per.u[slot].data_ptr() if slot in slots else None
            assert getattr(io, f) == want, f
        ptrs = [io.sums[k] for k in range(8)]
        assert ptrs == [x.data_ptr() for x in sums[:4 * stage]] \
            + [None] * (8 - 4 * stage)
        assert (io.rows, io.counts, io.lat) == (
            per.buf.data_ptr(), per.counts.data_ptr(), per.lat.data_ptr())
        assert (io.stride, io.stats) == (1024, 1)
    # 33 pointers, the stride, the switch and its padding
    assert ctypes.sizeof(LV.LiveIO) == 8 * 33 + 8 + 8
    # the counter lanes: churn's, none of the attack's
    lanes = per.counter_lanes()
    assert [x is None for x in lanes] == [False] * 8 + [True] * 2
    quiet = LV.Period(s.node_arrays(), u01, slots,
                      p.with_(fail_per_round=0.0, rejoin_per_round=0.0),
                      None)
    assert [x is None for x in quiet.counter_lanes()] == \
        [False] * 5 + [True] * 5


def test_rows_start_where_a_fresh_tensor_does():
    """Each sum row starts a whole number of ``ROW_ALIGN`` f32 after the
    buffer's (512 bytes: the caching allocator's alignment)."""
    assert LV.ROW_ALIGN * 4 == 512
    for n, want in ((1, 128), (128, 128), (129, 256), (1000, 1024),
                    (1 << 20, 1 << 20)):
        assert LV.padded(n) == want
    per = LV.Period(_start(1000).node_arrays(),
                    prng.threefry_u01(prng.key(2), 1000, (2, 3, 4)),
                    (2, 3, 4), _variants()["no churn"], None)
    base = per.buf.data_ptr()
    assert [r.data_ptr() - base for r in per.rows] == \
        [4 * 1024 * k for k in range(4)]
    assert all(r.is_contiguous() and r.shape == (1000,) for r in per.rows)


def test_period_refuses_what_the_stages_cannot_take():
    p = _variants()["wan-1m-churn5"]
    slots = tround.draw_slots(p)
    s = _start()
    u01 = prng.threefry_u01(prng.key(2), N, slots)
    wide = tstate.init_state(N, packed=False, device=CPU)
    assert not LV.takes(wide.node_arrays(), p)
    assert not LV.takes(s.node_arrays()[:7], p)
    tp, _ = grid_params(p, SweepAxes.of(gossip_nodes=(2.0, 3.0)), "cpu")
    assert not LV.takes(s.node_arrays(), tp)
    with pytest.raises(ValueError, match="packed layout"):
        LV.Period(wide.node_arrays(), u01, slots, p, None)
    with pytest.raises(ValueError, match="into takes"):
        LV.Period(s.node_arrays(), u01, slots, p, wide.node_arrays())
    with pytest.raises(ValueError, match="into takes"):
        LV.Period(s.node_arrays(), u01, slots, p,
                  _start(N // 2).node_arrays())
    with pytest.raises(ValueError, match="draws must be"):
        LV.Period(s.node_arrays(), lambda slot: torch.zeros(N // 2), slots,
                  p, None)


def test_live_runner_rehearses_without_host_reads():
    """The live runner's period on the stages' twin reads nothing on the
    host and dispatches the same ops on two calls that differ in key and
    start round."""
    p = _variants()["wan-1m-churn5"]
    run = tround.make_run_rounds(p, 2)
    with fused.twins():
        s = run(_start(), prng.key(0))
        recs = []
        for seed in (1, 2):
            with graphs.rehearse() as rec:
                s = run(s, prng.key(seed))
            recs.append(rec.calls)
    assert recs[0] and graphs.first_difference(*recs) is None


@pytest.mark.parametrize("stage,stats,churn,want", [
    (0, True, True, (3 + 4 + 20 * 4 / N, 16)),
    (1, True, True, (4 + 8 + (20 + 4) * 4 / N, 16)),
    (2, True, True, (15 + 16 + (20 + 8) * 4 / N, 15 + 32)),
    (2, False, True, (15 + 16 + (20 + 8) * 4 / N, 15)),
    (2, True, False, (15 + 16 + (20 + 8) * 4 / N, 15 + 20)),
])
def test_live_bound_counts_the_launch_bytes(stage, stats, churn, want):
    """Bytes an agent a stage reads and writes: the lanes and slot rows it
    needs, its sums and the table row; the sum rows, or the lanes and the
    counter rows it writes."""
    p = _variants()["wan-1m-churn5"]
    slots = tround.draw_slots(p)
    b = costmodel.live_bound(_start().node_arrays(), slots, stage, stats,
                             churn)
    assert slots == (0, 2, 3, 4)
    assert (b["read_bytes"] / N, b["written_bytes"] / N) == \
        pytest.approx(want)
    assert b["bound_by"] == "bytes"


# ------------------------------------------------------------- card half


def _card_run(p, n, dev, mode, plain):
    """48 periods of the live runner from ``_start``: (leaves, the
    live_round launches, every fused launch)."""
    run = tround.make_run_rounds(p, 48)
    fused.reset_launches()
    with (fused.plain() if plain else fused.twins()):
        if mode == "eager":
            with graphs.eager():
                out = run(_start(n, dev), prng.key(17, device=dev))
        else:
            # the first call runs its first body eagerly and captures the
            # second; every later body is a replay
            for _ in range(3):
                out = run(_start(n, dev), prng.key(17, device=dev))
    torch.cuda.synchronize()
    live = {k: fused.LAUNCHES.get(k, 0) for k in LV.NAMES}
    return _leaves(out), live, dict(fused.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["graph", "eager"])
@pytest.mark.parametrize("n", [1024, 1 << 20])
def test_stages_are_the_plain_body_on_the_card(cuda, n, mode):
    p = _config("wan-1m-churn5", n)
    got, live, _ = _card_run(p, n, cuda, mode, plain=False)
    want, plain_live, _ = _card_run(p, n, cuda, mode, plain=True)
    calls = 3 if mode == "graph" else 1
    assert live == {k: 48 * calls for k in LV.NAMES}
    assert plain_live == {k: 0 for k in LV.NAMES}
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_variants()))
def test_every_variant_is_the_plain_body_on_the_card(cuda, name):
    p = _variants(1 << 16)[name]
    got, live, _ = _card_run(p, 1 << 16, cuda, "graph", plain=False)
    want, _, _ = _card_run(p, 1 << 16, cuda, "graph", plain=True)
    assert live == {k: 48 * 3 for k in LV.NAMES}
    assert all(_same(a, b) for a, b in zip(got, want))


#: the aten ops a 2-period call of the live runner dispatches inside
#: ``fused.plain()`` at 1,024 agents: the tree before the stages counted
#: the periods' same ops, and besides them 8 clones of the lanes and a
#: copy onto itself of each counter a period leaves as it was, which the
#: donated carry does not make
PLAIN_OPS_2_PERIODS = {
    "wan-1m-churn5": 2483, "lan-1m": 2483, "no lifeguard": 2413,
    "slow model": 2797, "stats off": 2383, "no churn": 2079,
    "corroboration_k=1": 2533}


def _plain_ops(p, dev) -> int:
    run = tround.make_run_rounds(p, 2)
    s = tstate.init_state(p.n, device=dev)
    with fused.plain(), graphs.eager():
        with costmodel.OpCounter() as count:
            run(s, prng.key(3, device=dev))
    return count.calls


@pytest.mark.parametrize("name", list(PLAIN_OPS_2_PERIODS))
def test_plain_route_dispatches_as_before(name):
    """Inside ``fused.plain()`` the live runner's periods dispatch the
    plain body's ops, as before the stages, around the ops of its
    donated carry (and launch no kernel)."""
    fused.reset_launches()
    assert _plain_ops(_variants()[name], CPU) == PLAIN_OPS_2_PERIODS[name]
    assert not fused.LAUNCHES


@pytest.mark.cuda
def test_plain_route_launches_as_before_on_the_card(cuda):
    """On the card too: the ops the plain route dispatches, and its
    device operations (the profiler's, an eager 8-period call at 65,536
    agents) as the tree before the stages counted them, less the
    clones the donated carry does not make."""
    from torch.profiler import ProfilerActivity, profile

    for name, want in PLAIN_OPS_2_PERIODS.items():
        fused.reset_launches()
        assert _plain_ops(_variants()[name], cuda) == want, name
        assert not fused.LAUNCHES
    n = 1 << 16
    run = tround.make_run_rounds(_config("wan-1m-churn5", n), 8)
    with fused.plain(), graphs.eager():
        run(_start(n, cuda), prng.key(3, device=cuda))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(_start(n, cuda), prng.key(3, device=cuda))
            torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(ops) == PLAIN_DEVICE_OPS_8_PERIODS


#: the device operations of that call: as the tree before the stages
#: counted them on an H100, less the 8 clones of the lanes
PLAIN_DEVICE_OPS_8_PERIODS = 9468
