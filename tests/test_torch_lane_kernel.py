"""consul_tpu_torch's lane kernel: ``sim/lane_kernel.py`` and
``csrc/lane_kernels.cu`` (``lane_round``, the lane engine's period in one
launch).

CPU half:

* The twin (the kernel's evaluation in PyTorch, from the packed constant
  table) equals the plain body, ``round._round_body(..., lane_mode=True)``
  on stale scalars, bit for bit in every variant: stable, full, churn,
  no Lifeguard, the WAN config, an honest frame, a byzantine frame with
  corroboration_k 2 and 0, corroboration_k=1, a blended frame
  (fault_gain 0.5), a shard's offset, and window rounds j >= 1 with and
  without stats. On the CPU both divide a tensor by a Python number, so
  the twin runs under the CPU's rule here (the card's reciprocal rule is
  held on the card, by ``chip_smoke.py``'s lanes phase).
* The packing: the constant table's values as the plain body's operands
  round them, the launch's pointers read back, the refusals.
* Routing: the CPU runs the plain body, ``fused.twins()`` the twin (one
  run and a grid of constants alike), ``fused.plain()`` the plain body
  again; the lane engine takes one launch a round, in the window modes
  the kernel is given.
* Grids: the twin bit for bit the plain body on grids that sweep every
  kind of constant (a divided probe interval, a per-point k, a blended
  frame with a row a point, the Lifeguard and churn constants); the
  sweep's lanes engine and a point of it re-run alone.
* The lane engine on the kernel's route (the twin) bit for bit the
  plain engine, and against the JAX package's ``make_run_rounds_lanes``
  at ``tests/test_torch_lanes.py``'s tolerances; a lanes window under
  ``graphs.rehearse()``; chip_smoke's lanes phase rehearsed at 4,096.
* ``costmodel.lane_bound``: the bytes of one launch.

Card half (``cuda``): the kernel against the plain body on the card in
every variant and on every grid, and the lane engine on the kernel
against ``fused.plain()``, bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import pytest
import torch

import chip_smoke
from consul_tpu_torch import bench
from consul_tpu_torch import faults as tfaults
from consul_tpu_torch.config import GossipConfig
from consul_tpu_torch.sim import costmodel, fused, graphs
from consul_tpu_torch.sim import lane_kernel as LK
from consul_tpu_torch.sim import lanes as tlanes
from consul_tpu_torch.sim import prng, registry, scenarios
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.params import SimParams, SweepAxes, grid_params
from test_torch_harness import cuda, ref  # noqa: F401  (fixtures)

CPU = torch.device("cpu")
N = 4096
#: the frames' rounds in the check plans: the honest plan's flappers are
#: down there, the byzantine one attacks
FRAME_ROUND = chip_smoke.CHECK_ROUNDS


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _warm(p, n=N, dev=CPU, rounds=6):
    """A state with dead, slow, suspect and refuted rows and its lane
    vector, evolved by the plain lane engine."""
    s = tstate.init_state(n, device=dev)
    s = tstate.with_crashed(s, torch.arange(0, n, 97, device=dev), age=3)
    s = tstate.with_slow(s, torch.arange(1, n, 131, device=dev))
    with fused.plain():
        return tround.make_run_rounds_lanes(p, rounds, carry=True)(
            s, prng.key(3, device=dev))


def _frame(kind, n=N, dev=CPU, gain=1.0):
    if kind is None:
        return None
    cp = tfaults.compile_plan(chip_smoke.check_plans(n)[kind], n, dev)
    fx = tfaults.fault_frame(cp, FRAME_ROUND[kind])
    return tfaults.scale_frame(fx, gain) if gain != 1.0 else fx


def _variants(n=N):
    full, stable = bench.diag_params(n), bench.headline_params(n)
    chaos = scenarios.chaos_params(n)
    wan = SimParams.from_gossip_config(GossipConfig.wan(), n=n, loss=0.02,
                                       slow_per_round=0.001)
    return {
        "stable": (stable, None, 0),
        "full": (full, None, 0),
        "churn": (full.with_(fail_per_round=0.01, leave_per_round=0.003,
                             rejoin_per_round=0.05), None, 0),
        "no lifeguard": (full.with_(lifeguard=False), None, 0),
        "wan": (wan, None, 0),
        "honest frame": (chaos, "fault", 0),
        "honest frame slow+tcp": (full, "fault", 0),
        "byzantine frame k=2": (chaos.with_(corroboration_k=2), "byz", 0),
        "byzantine frame k=0": (chaos, "byz", 0),
        "corroboration_k=1": (full.with_(corroboration_k=1), None, 0),
        "shard offset": (full, None, 12_345),
    }


def _plain(s, sc, key, p, fx, offset):
    """The plain body's round: (the 8 narrowed lanes, the stack)."""
    with fused.plain():
        out, stack = tround._lane_contributions(s, sc, key, p, fx, offset)
    return out.node_arrays(), stack


def _kernel(s, sc, key, p, fx, offset, **kw):
    slots = tround.draw_slots(p, fx)
    u = prng.global_rows(key, offset, s.status.shape[0], slots)
    return LK.lane_round(s.node_arrays(), sc, u, slots, p, fx, **kw)


@pytest.mark.parametrize("name", list(_variants()))
def test_twin_equals_the_plain_body(name):
    p, kind, offset = _variants()[name]
    s, lv = _warm(p)
    sc = tlanes.scalars_from_lanes(lv)
    fx = _frame(kind)
    key = prng.key(9)
    want, want_stack = _plain(s, sc, key, p, fx, offset)
    got, stack = _kernel(s, sc, key, p, fx, offset)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert all(_same(stack[i], want_stack[i]) for i in range(LK.N_ROWS))
    # the round moved the state
    assert not torch.equal(got[0], s.status) or \
        not torch.equal(got[2], s.informed)


@pytest.mark.parametrize("name", ["wan", "honest frame", "full"])
def test_twin_under_the_card_rule_divides_as_the_card(monkeypatch, name):
    """The twin under the card's rule against the plain body with a
    tensor divided by a Python number as ATen's CUDA path divides it (a
    product with the f32 reciprocal), bit for bit (the WAN config divides
    by a 5 s interval, whose reciprocal is inexact in f32)."""
    p, kind, offset = _variants()[name]
    s, lv = _warm(p)
    sc = tlanes.scalars_from_lanes(lv)
    fx = _frame(kind)
    slots = tround.draw_slots(p, fx)
    u = prng.global_rows(prng.key(9), offset, N, slots)
    vals = s.node_arrays()
    card_stack = torch.empty((LK.N_ROWS, N))
    card = LK.twin(vals, sc, u, slots, LK.consts(p, (N,)),
                   LK.table(p, 1, CPU), fx, card_stack, rule=LK.CARD_RULE)
    true_div = torch.Tensor.__truediv__

    def div(x, other):
        if isinstance(other, (int, float)):
            return x * float(np.float32(1.0) / np.float32(other))
        return true_div(x, other)

    monkeypatch.setattr(torch.Tensor, "__truediv__", div)
    want, want_stack = _plain(s, sc, prng.key(9), p, fx, offset)
    monkeypatch.undo()
    assert all(_same(a, b) for a, b in zip(card, want))
    assert _same(card_stack, want_stack)


def test_twin_takes_a_blended_frame():
    """A plan blended by fault_gain 0.5: the frame is scaled before the
    launch (``scale_frame``), as the plain round scales it."""
    p = scenarios.chaos_params(N).with_(fault_gain=0.5, corroboration_k=2)
    s, lv = _warm(p)
    sc = tlanes.scalars_from_lanes(lv)
    key = prng.key(4)
    fx = _frame("byz")
    with fused.twins():
        got, stack = tround._lane_contributions(s, sc, key, p, fx)
    want, want_stack = _plain(s, sc, key, p, fx, 0)
    assert all(_same(a, b) for a, b in zip(got.node_arrays(), want))
    assert _same(stack, want_stack)


@pytest.mark.parametrize("stats,inst", [("add", True), ("add", False),
                                        ("skip", False), ("skip", True),
                                        ("write", False)])
@pytest.mark.parametrize("kind", [None, "byz"])
def test_window_round_onto_a_stack(stats, inst, kind):
    """A window round j >= 1: its counter rows added onto the stack's
    (the plain loop's ``pend + rows``) or left, its other rows written
    or left."""
    p = scenarios.chaos_params(N).with_(corroboration_k=2) if kind \
        else bench.diag_params(N)
    s, lv = _warm(p)
    sc = tlanes.scalars_from_lanes(lv)
    fx = _frame(kind)
    _, prev = _plain(s, sc, prng.key(2), p, fx, 0)
    _, rows = _plain(s, sc, prng.key(5), p, fx, 0)
    want = prev.clone()
    if stats == "add":
        want[tlanes.STATS_SLICE] = prev[tlanes.STATS_SLICE] \
            + rows[tlanes.STATS_SLICE]
    if inst:
        keep = torch.ones(LK.N_ROWS, dtype=torch.bool)
        keep[tlanes.STATS_SLICE] = False
        want[keep] = rows[keep]
    if stats == "write":
        want[tlanes.STATS_SLICE] = rows[tlanes.STATS_SLICE]
    _, stack = _kernel(s, sc, prng.key(5), p, fx, 0, stack=prev.clone(),
                       stats=stats, inst=inst)
    assert _same(stack, want)
    assert stats == "skip" or not torch.equal(
        stack[tlanes.STATS_SLICE], prev[tlanes.STATS_SLICE])


@pytest.mark.parametrize("name", ["full", "wan", "churn"])
def test_consts_round_as_the_plain_body_operands(name):
    """Each entry of the table is the f32 the body's operand rounds to
    (Python folds first in f64); the reciprocals are ATen's on the card,
    ``1.0f / f32(b)``; the switches follow the params."""
    p = _variants()[name][0]
    c = LK.consts(p, (N,))
    tab = LK.table(p, 1, CPU)
    f32 = np.float32
    assert (c.rows, c.row_len, c.points) == (N, N, 1)
    assert tuple(tab.shape) == (1, len(LK.COLUMNS))
    assert c.inv_n == f32(1.0 / p.n) and c.n_f == f32(p.n)
    assert c.recip_n == f32(1.0) / f32(p.n)
    assert c.recip_pi == f32(1.0) / f32(p.probe_interval)
    assert list(c.recip_k) == [f32(1.0) / f32(k) for k in range(1, 5)]
    want = {"probe_interval": p.probe_interval,
            "fail_p": p.fail_per_round, "leave_p": p.leave_per_round,
            "fail_leave_p": p.fail_per_round + p.leave_per_round,
            "rejoin_p": p.rejoin_per_round, "slow_p": p.slow_per_round,
            "slow_recover_p": p.slow_recover_per_round,
            "slow_factor": p.slow_factor,
            "one_minus_slow_factor": 1.0 - p.slow_factor,
            "p_direct": p.p_direct, "p_relay": p.p_relay,
            "p_tcp": p.p_tcp, "fanout_ticks": p.fanout_ticks,
            "one_minus_loss": p.one_minus_loss,
            "susp_max_s": p.suspicion_max_s, "shrink_r": p.shrink_r,
            "shrink_omr": p.shrink_omr,
            "confirmation_k": p.confirmation_k,
            "awareness_max": p.awareness_max,
            "corroboration_k": p.corroboration_k}
    assert set(want) == set(LK.COLUMNS)
    for name_, value in want.items():
        assert tab[0, LK.COL[name_]].item() == f32(value), name_
    assert (c.churn_on, c.slow_on, c.lifeguard, c.div_pi, c.gate_on) == (
        int(p.has_churn), int(p.slow_per_round > 0), int(p.lifeguard), 0,
        int(p.corroboration_k > 0))
    assert c.shrink_on == int(p.suspicion_max_s > p.suspicion_min_s)


def test_grid_table_takes_each_point_from_its_leaves():
    """A grid's table: a swept column is its leaf cast to f32, the
    others the f32 of the body's expression; a swept probe interval
    divides, a swept k gates every point."""
    p = scenarios.chaos_params(N)
    tp, pts = grid_params(p, SweepAxes.of(probe_interval=(1.0, 2.0),
                                           corroboration_k=(0.0, 2.0),
                                           slow_factor=(0.1, 0.3)), "cpu")
    tab = LK.table(tp, len(pts), CPU)
    c = LK.consts(tp, (len(pts), N))
    assert tuple(tab.shape) == (8, len(LK.COLUMNS))
    assert (c.points, c.row_len, c.div_pi, c.gate_on) == (8, N, 1, 1)
    for g, pt in enumerate(pts):
        one = LK.table(pt, 1, CPU)[0]
        for name_ in ("probe_interval", "corroboration_k", "slow_factor",
                      "susp_max_s", "p_direct", "fail_leave_p"):
            assert tab[g, LK.COL[name_]] == one[LK.COL[name_]], name_
    # a leaf's arithmetic is f32's: 1 - slow_factor of the leaf
    sf = tab[:, LK.COL["slow_factor"]]
    assert torch.equal(tab[:, LK.COL["one_minus_slow_factor"]], 1.0 - sf)
    with pytest.raises(ValueError, match="points"):
        LK.table(tp, 4, CPU)


@pytest.mark.parametrize("kind", [None, "fault", "byz"])
def test_lane_args_point_at_every_tensor(kind):
    p = scenarios.chaos_params(N)
    s, lv = _warm(p)
    sc = tlanes.scalars_from_lanes(lv)
    fx = _frame(kind)
    slots = tround.draw_slots(p, fx)
    u = prng.global_rows(prng.key(1), 0, N, slots)
    vals = s.node_arrays()
    outs = tuple(torch.empty_like(v) for v in vals)
    stack = torch.empty((LK.N_ROWS, N))
    tab = LK.table(p, 1, CPU)
    io, fr, k = LK.lane_args(vals, sc, u, slots, outs, stack, fx, "add",
                             False, tab)
    assert io.tab == tab.data_ptr() and io.frame_rows == 0
    assert k == LK.FRAME_KINDS[LK.frame_kind(fx)]
    for f, a, o in zip(tstate.NODE_FIELDS, vals, outs):
        assert getattr(io, f) == a.data_ptr()
        assert getattr(io, "o_" + f) == o.data_ptr()
    assert (io.scal, io.stack) == (sc.data_ptr(), stack.data_ptr())
    assert (io.stats_mode, io.write_inst) == (LK.STATS_MODES["add"], 0)
    for slot, field in enumerate(("u_churn", "u_slow", "u_ack", "u_pois",
                                  "u_hear", "u_replay")):
        ptr = getattr(io, field)
        if slot not in slots:
            assert ptr is None
            continue
        row = u[slots.index(slot)]
        assert ptr == row.data_ptr()
        # the row the kernel reads through the pointer is the slot's
        got = np.ctypeslib.as_array(
            (ctypes.c_float * N).from_address(ptr))
        assert np.array_equal(got, row.numpy())
    for f in tfaults.FRAME_ABI:
        t = None if fx is None else getattr(fx, f)
        assert getattr(fr, f) == (None if t is None else t.data_ptr())


def test_checks_refuse_what_the_kernel_cannot_take():
    p = bench.diag_params(N)
    s, lv = _warm(p)
    sc = tlanes.scalars_from_lanes(lv)
    slots = tround.draw_slots(p)
    u = prng.global_rows(prng.key(1), 0, N, slots)
    vals = s.node_arrays()
    wide = tstate.unpack(s).node_arrays()
    with pytest.raises(ValueError, match="packed layout"):
        LK.lane_round(wide, sc, u, slots, p)
    with pytest.raises(ValueError, match="scalars"):
        LK.lane_round(vals, sc[:4], u, slots, p)
    with pytest.raises(ValueError, match="slot rows"):
        LK.lane_round(vals, sc, u[:, :-1], slots, p)
    with pytest.raises(ValueError, match="lacks"):
        LK.lane_round(vals, sc, u[:2], slots[:2], p)
    with pytest.raises(ValueError, match="adds onto a given stack"):
        LK.lane_round(vals, sc, u, slots, p, stats="add")
    with pytest.raises(ValueError, match="stats"):
        LK.lane_round(vals, sc, u, slots, p, stats="sum")
    with pytest.raises(ValueError, match="stack"):
        LK.lane_round(vals, sc, u, slots, p,
                      stack=torch.empty((LK.N_ROWS - 1, N)))
    fx = _frame("byz")
    bad = fx._replace(replay=fx.replay.double())
    with pytest.raises(ValueError, match="replay"):
        LK.lane_round(vals, sc, prng.global_rows(
            prng.key(1), 0, N, tround.draw_slots(p, bad)),
            tround.draw_slots(p, bad), p, bad)
    # the plain body writes its own stack a round
    with pytest.raises(ValueError, match="new stack"):
        tround._lane_contributions(s, sc, prng.key(1), p,
                                   stack=torch.empty((LK.N_ROWS, N)))


def _count_twin(monkeypatch):
    """Record the stats mode and inst flag of every twin evaluation."""
    seen = []
    real = LK.twin

    def twin(*args):
        seen.append(args[8:10])
        return real(*args)

    monkeypatch.setattr(LK, "twin", twin)
    return seen


@pytest.mark.parametrize("collect,k", [(True, 4), (False, 4), (True, 1),
                                       (False, 3)])
def test_engine_takes_one_launch_a_round(monkeypatch, collect, k):
    """The lane engine's window: one launch a round, the first writing
    the counter rows (with stats) and later rounds adding onto them,
    every round but the last skipping the instantaneous rows; without
    stats only the last round writes the stack. A partial final window
    runs its own count."""
    seen = _count_twin(monkeypatch)
    p = bench.diag_params(1024).with_(collect_stats=collect, stale_k=k)
    rounds = 2 * k + (1 if k > 1 else 0)
    with fused.twins():
        tround.make_run_rounds_lanes(p, rounds)(
            tstate.init_state(1024, device=CPU), prng.key(3))
    assert len(seen) == rounds

    def window(count):
        if collect:
            return [("write" if j == 0 else "add", j == count - 1)
                    for j in range(count)]
        return [("write" if j == count - 1 else "skip", j == count - 1)
                for j in range(count)]

    want = window(k) * (rounds // k) + window(rounds % k) \
        if rounds % k else window(k) * (rounds // k)
    assert seen == want


def test_routing(monkeypatch):
    """The CPU runs the plain body, ``fused.twins()`` the twin (one run
    and a grid alike), ``fused.plain()`` inside it the plain body."""
    seen = _count_twin(monkeypatch)
    p = bench.diag_params(1024)
    tp, _ = grid_params(p, SweepAxes.of(gossip_nodes=(2.0, 3.0)), "cpu")
    run = tround.make_run_rounds_lanes(p, 2)
    run(tstate.init_state(1024, device=CPU), prng.key(1))
    assert seen == []
    with fused.twins():
        run(tstate.init_state(1024, device=CPU), prng.key(1))
        assert len(seen) == 2
        with fused.plain():
            run(tstate.init_state(1024, device=CPU), prng.key(1))
        assert len(seen) == 2
        from consul_tpu_torch.sim import sweep as tsweep

        tsweep.make_run_sweep(p, 3, engine="lanes", device="cpu")(
            tp, prng.key(0))
    assert len(seen) == 5


def _engine_outputs(out) -> list:
    if isinstance(out, tstate.SimState):
        out = (out,)
    leaves = []
    for x in out:
        if isinstance(x, tstate.SimState):
            leaves += list(x.node_arrays()) + [x.t, x.round_idx] \
                + list(x.stats)
        else:
            leaves.append(x)
    return leaves


ENGINE_CASES = {
    "full k=1": (dict(stale_k=1), {}, None),
    "full k=4 flight": (dict(stale_k=4), dict(flight_every=4), None),
    "full k=3 partial window flight": (dict(stale_k=3),
                                       dict(flight_every=3), None),
    "full k=2 overlap carry": (dict(stale_k=2),
                               dict(overlap=True, carry=True), None),
    "stable k=4": (dict(stale_k=4, collect_stats=False,
                        slow_per_round=0.0), {}, None),
    "honest plan k=2 flight": (dict(stale_k=2), dict(flight_every=2),
                               "fault"),
    "byz plan k=1 corroboration_k=2": (dict(corroboration_k=2), {}, "byz"),
    "byz plan gain 0.5 k=2": (dict(stale_k=2, fault_gain=0.5), {}, "byz"),
    "lane_blocks 32": (dict(stale_k=2), dict(lane_blocks=32), None),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_on_the_twin_is_the_plain_engine(name):
    """The lane engine's call on the kernel's route (the twin and the
    draw and sum kernels' twins) against the plain engine: state,
    stats, trace and carry bit for bit."""
    kw, opts, plan = ENGINE_CASES[name]
    n, rounds = 2048, 12
    p = bench.diag_params(n).with_(**kw)
    cp = None if plan is None else tfaults.compile_plan(
        chip_smoke.check_plans(n)[plan], n, "cpu")
    outs = []
    for ctx in (fused.twins, fused.plain):
        s = tstate.with_crashed(tstate.init_state(n, device=CPU),
                                torch.arange(0, n, 53), age=2)
        with ctx():
            outs.append(_engine_outputs(tround.make_run_rounds_lanes(
                p, rounds, plan=cp, **opts)(s, prng.key(17))))
    assert len(outs[0]) == len(outs[1])
    assert all(_same(a, b) for a, b in zip(*outs))


def test_window_with_a_shard_offset():
    """A mesh rank's window (its slice's global offset) on the twin and
    on the plain body."""
    p = bench.diag_params(N).with_(stale_k=3)
    s, lv = _warm(p)
    keys = prng.round_keys(prng.key(6), s.round_idx, 3)
    got = []
    for ctx in (fused.twins, fused.plain):
        with ctx():
            s2, stack = tround._lane_window(s, lv, keys, [None] * 3, p, 3,
                                            shard_offset=N * 3)
        got.append(list(s2.node_arrays()) + [stack])
    assert all(_same(a, b) for a, b in zip(*got))


#: grids whose every swept constant reaches the table: a divided probe
#: interval, a per-point k and a blended frame (a row a point); the
#: Lifeguard constants and the awareness ceiling; churn, loss and the
#: slow model; the fanout; churn with k = 2 on a byzantine frame; the
#: suspicion ceiling, recovery and gossip interval
GRIDS = {
    "probe_interval k fault_gain byz": (
        "chaos", dict(probe_interval=(1.0, 2.0), corroboration_k=(0, 2),
                      fault_gain=(0.5, 1.0)), "byz"),
    "lifeguard fault": ("chaos", dict(slow_factor=(0.1, 0.3),
                                      suspicion_mult=(4, 5),
                                      awareness_max=(4, 8)), "fault"),
    "churn loss slow": ("full", dict(fail_per_round=(0.0, 0.01),
                                     loss=(0.01, 0.05),
                                     slow_per_round=(0.0, 0.002)), None),
    "fanout": ("full", dict(gossip_nodes=(2.0, 3.0, 4.0),
                            probe_timeout=(0.3, 0.5)), None),
    "leave rejoin tcp byz k=2": ("chaos k=2", dict(
        leave_per_round=(0.0, 0.01), rejoin_per_round=(0.0, 0.05),
        tcp_fail=(0.0, 0.2)), "byz"),
    "timeouts fault": ("chaos", dict(suspicion_max_timeout_mult=(4, 6),
                                     slow_recover_per_round=(0.05, 0.2),
                                     gossip_interval=(0.2, 0.5)), "fault"),
}


def _grid_case(name, n=2048, dev=CPU):
    """A grid of ``GRIDS[name]`` at ``n`` nodes a point, warmed three
    rounds by the plain body (``chip_smoke.lane_grid_state``)."""
    base, axes, kind = GRIDS[name]
    p = {"chaos": scenarios.chaos_params(n),
         "chaos k=2": scenarios.chaos_params(n).with_(corroboration_k=2),
         "full": bench.diag_params(n)}[base]
    return chip_smoke.lane_grid_state(torch, chip_smoke.modules(), p, axes,
                                      kind, torch.device(dev))


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_twin_equals_the_plain_body(name):
    """A window of two rounds on a warmed grid of points, on the twin and
    on the plain body: every lane and stack row of every point bit for
    bit."""
    tp, s, lv, fx = _grid_case(name)
    keys = prng.round_keys(prng.key(6), 3, 2)
    outs = []
    for ctx in (fused.twins, fused.plain):
        with ctx():
            s2, stack = tround._lane_window(s, lv, keys, [fx] * 2, tp, 2)
        outs.append(list(s2.node_arrays()) + [s2.t, stack])
    assert all(_same(a, b) for a, b in zip(*outs))
    assert not torch.equal(outs[0][0], s.status)


@pytest.mark.parametrize("engine_opts", [dict(), dict(flight_every=2)])
def test_sweep_lanes_engine_on_the_twin(monkeypatch, engine_opts):
    """The sweep's lanes engine and one point of it re-run alone
    (``make_run_point``) on the kernel's route: one launch a round, bit
    for bit the plain engine, and the point bit for bit its grid row."""
    from consul_tpu_torch.sim import sweep as tsweep
    from consul_tpu_torch.sim.params import point_params

    seen = _count_twin(monkeypatch)
    n, rounds = 1024, 4
    p = scenarios.chaos_params(n).with_(stale_k=2)
    cp = tfaults.compile_plan(chip_smoke.check_plans(n)["byz"], n, "cpu")
    tp, pts = grid_params(p, SweepAxes.of(corroboration_k=(0, 2),
                                          fault_gain=(0.5, 1.0)), "cpu")
    outs = []
    for ctx in (fused.twins, fused.plain):
        with ctx():
            res = tsweep.make_run_sweep(p, rounds, engine="lanes",
                                        plan=cp, device="cpu",
                                        **engine_opts)(tp, prng.key(3))
        outs.append(res)
    assert len(seen) == rounds
    leaves = [torch.utils._pytree.tree_flatten(o)[0] for o in outs]
    assert all(_same(a, b) for a, b in zip(*leaves)
               if isinstance(a, torch.Tensor))
    with fused.twins():
        one, _ = tsweep.make_run_point(p, rounds, engine="lanes", plan=cp,
                                       device="cpu", **engine_opts)(
            point_params(tp, 3), prng.key(3))
    grid_states = outs[0][0] if isinstance(outs[0], tuple) else outs[0]
    row = tsweep.take_point(grid_states, 3)
    assert all(_same(a, b) for a, b in zip(one.node_arrays(),
                                           row.node_arrays()))


CASES = [(1024, 1, False), (1024, 4, True), (4096, 2, False)]


@pytest.mark.parametrize("n,stale_k,overlap", CASES)
def test_engine_on_the_kernel_route_matches_reference(ref, n, stale_k,
                                                      overlap):
    from test_torch_faults import _assert_states_equal
    from test_torch_lanes import ENGINE_ULPS, ROUNDS, _run_both

    with fused.twins():
        rs, ts = _run_both(n, ROUNDS, dict(stale_k=stale_k),
                           overlap=overlap)
    _assert_states_equal(tstate.to_numpy(ts), rs, informed_ulps=ENGINE_ULPS)
    assert int(ts.stats.suspicions) > 0 and int(ts.stats.crashes) > 0


@pytest.mark.parametrize("plan,stale_k", [("honest", 2), ("byz", 1)])
def test_engine_with_plan_on_the_kernel_route_matches_reference(
        ref, plan, stale_k):
    from test_torch_faults import PLANS, _assert_states_equal
    from test_torch_lanes import ENGINE_ULPS, _run_both

    kw = dict(stale_k=stale_k, corroboration_k=1 if plan == "byz" else 0)
    with fused.twins():
        rs, ts = _run_both(1024, 16, kw, plan=PLANS[plan](1024))
    _assert_states_equal(tstate.to_numpy(ts), rs, informed_ulps=ENGINE_ULPS)


def test_lanes_window_rehearses_without_host_reads():
    """A lanes runner's windows on the kernel's route under
    ``graphs.rehearse()``: no host read in the packing, and two calls
    that differ in key and start round dispatch the same ops."""
    n = 1024
    p = bench.diag_params(n).with_(stale_k=2)
    cp = tfaults.compile_plan(chip_smoke.check_plans(n)["byz"], n, "cpu")
    run = tround.make_run_rounds_lanes(p.with_(corroboration_k=2), 4,
                                       flight_every=2, plan=cp)
    with fused.twins():
        s, _ = run(tstate.init_state(n, device=CPU), prng.key(0))
        recs = []
        for seed in (1, 2):
            with graphs.rehearse() as rec:
                s, _ = run(bench.clone_state(s), prng.key(seed))
            recs.append(rec)
    a, b = recs
    assert a.calls and graphs.first_difference(a.calls, b.calls) is None


def _small_inputs(n=N):
    """chip_smoke's check inputs at ``n`` nodes: a warmed packed state,
    its scalars, seeds, and the check plans' frames."""
    p = bench.diag_params(n).with_(fail_per_round=0.002,
                                   rejoin_per_round=0.02)
    s, lv = _warm(p, n)
    frames = {k: _frame(k, n) for k in ("fault", "byz")}
    return (s.node_arrays(), tlanes.scalars_from_lanes(lv),
            prng.round_seeds(prng.key(11), 100, 8), frames)


def test_chip_smoke_lanes_phase_on_the_twin():
    """``chip_smoke.py``'s lanes phase rehearsed on the CPU at 4,096
    nodes with the twin in the kernel's place: every case compares; the
    timing cases' bounds are computed."""
    m = chip_smoke.modules()
    inputs = _small_inputs()
    with fused.twins():
        cases, bad = chip_smoke.lane_checks(
            torch, m, inputs, chip_smoke.lane_cases(m, inputs, offset=777))
    assert bad == [] and len(cases) == 13
    assert all(c["bitwise"] for c in cases)
    with fused.twins():
        grids = [chip_smoke.lane_grid_check(torch, m, CPU, g)
                 for g in chip_smoke.lane_grids(m, n=1024)]
    assert [g["bitwise"] for g in grids] == [True] * 3
    assert [g["points"] for g in grids] == [64, 16, 16]
    key = prng.key(43)
    timed = [(*c, inputs[0], inputs[1])
             for c in chip_smoke.lane_timing_cases(m, inputs)]
    for name, p, fx, stats, inst, vals, sc in timed + [
            chip_smoke.lane_grid_inputs(torch, m, CPU, n=256)]:
        slots = tround.draw_slots(p, fx)
        u = prng.global_rows(key, 0, vals[0].shape[-1], slots)
        b = costmodel.lane_bound(vals, u, fx, stats, inst)
        assert b["bound_ms"] > 0 and b["bound_by"] == "bytes", name
        with fused.twins():
            got = chip_smoke.lane_plain(torch, m, vals, sc, u, slots, p,
                                        fx)
            want = LK.lane_round(vals, sc, u, slots, p, fx)
        assert all(_same(a, b) for a, b in zip(got[0], want[0])), name
        assert _same(got[1], want[1]), name


@pytest.mark.parametrize("stats,inst,slots,frame,want", [
    ("write", True, 4, None, (31, 143)),
    ("add", False, 4, None, (31 + 40, 15 + 40)),
    ("skip", False, 4, None, (31, 15)),
    ("write", True, 3, None, (27, 143)),
    ("write", True, 5, "fault", (35 + 29, 143)),
    ("write", True, 6, "byz", (39 + 42, 143))])
def test_lane_bound_counts_the_launch_bytes(stats, inst, slots, frame,
                                            want):
    """Bytes a node of one launch at 1,048,576 nodes: 15 B of state and
    4 B a slot read, 15 B of state and 4 B a stack row written; the
    full model's round (4 slots) 31 B read and 143 B written, 182.5 MB
    in all (54.5 µs at 3.35 TB/s)."""
    n = 1 << 20
    meta = torch.device("meta")
    vals = tuple(torch.empty(n, dtype=dt, device=meta)
                 for dt in tstate.PACKED_DTYPES)
    u = torch.empty((slots, n), device=meta)
    fx = None
    if frame:
        lanes = {f: torch.empty(n, dtype=torch.bool
                                if f in tfaults.FRAME_MASKS
                                else torch.float32, device=meta)
                 for f in tfaults.FRAME_LANES + tfaults.BYZ_LANES}
        if frame == "fault":
            lanes.update(forge_ack=None, spur_susp=None, replay=None,
                         attacked=None)
        fx = tfaults.FaultFrame(mid=torch.empty((), device=meta), **lanes)
    b = costmodel.lane_bound(vals, u, fx, stats, inst)
    read, written = want
    extra = 4 * (8 + len(LK.COLUMNS)) + (4 if frame else 0)
    assert b["read_bytes"] == read * n + extra
    assert b["written_bytes"] == written * n
    if (stats, inst, slots, frame) == ("write", True, 4, None):
        assert b["bytes"] == 182_452_224 + 112
        assert math.isclose(b["bound_ms"], 0.05446, rel_tol=1e-3)
        assert b["bound_by"] == "bytes"


def test_stack_rows_follow_the_registry():
    assert LK.N_ROWS == len(registry.REDUCE_LANES) == 32
    assert LK.STATS_ROW == tlanes.STATS_SLICE.start
    assert LK.GAUGE_ROW == tlanes.STATS_SLICE.stop == \
        registry.LANE["up_sum"]
    assert registry.LANE["lh_ge_1"] == LK.GAUGE_ROW + 6


# ------------------------------------------------------------- card half


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_variants()))
def test_lane_kernel_equals_the_plain_body_on_the_card(cuda, name):
    n = 1 << 16
    p, kind, offset = _variants(n)[name]
    s, lv = _warm(p, n, cuda)
    sc = tlanes.scalars_from_lanes(lv)
    fx = _frame(kind, n, cuda)
    key = prng.key(9, device=cuda)
    want, want_stack = _plain(s, sc, key, p, fx, offset)
    fused.reset_launches()
    got, stack = _kernel(s, sc, key, p, fx, offset)
    assert fused.LAUNCHES[LK.NAME] == 1
    assert all(_same(a, b) for a, b in zip(got, want))
    assert _same(stack, want_stack)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_kernel_equals_the_plain_body_on_the_card(cuda, name):
    tp, s, lv, fx = _grid_case(name, 1 << 14, cuda)
    keys = prng.round_keys(prng.key(6, device=cuda), 3, 2)
    outs, launches = [], []
    for ctx in (fused.plain, _nothing):
        fused.reset_launches()
        with ctx():
            s2, stack = tround._lane_window(s, lv, keys, [fx] * 2, tp, 2)
        launches.append(fused.LAUNCHES[LK.NAME])
        outs.append(list(s2.node_arrays()) + [s2.t, stack])
    assert launches == [0, 2]
    assert all(_same(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_lane_engine_on_the_kernel_is_the_plain_engine_on_the_card(cuda,
                                                                   name):
    kw, opts, plan = ENGINE_CASES[name]
    n, rounds = 1 << 16, 12
    p = bench.diag_params(n).with_(**kw)
    cp = None if plan is None else tfaults.compile_plan(
        chip_smoke.check_plans(n)[plan], n, cuda)
    outs, launches = [], []
    for ctx in (fused.plain, _nothing):
        s = tstate.init_state(n, device=cuda)
        fused.reset_launches()
        with ctx():
            outs.append(_engine_outputs(tround.make_run_rounds_lanes(
                p, rounds, plan=cp, **opts)(s, prng.key(17, device=cuda))))
        launches.append(fused.LAUNCHES[LK.NAME])
    assert launches == [0, rounds]
    assert all(_same(a, b) for a, b in zip(*outs))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
