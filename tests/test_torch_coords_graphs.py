"""The flight runner's replayed bodies (``round.run_rounds_flight``).

CPU half: a coordinates run with the partition plan (its phases cut so
that a body of ``round.LIVE_REPLAY_ROUNDS`` periods spans a phase
change), 20 periods a call so that the last body is short, then a second
call that resumes from the first's state, coordinates and rings, held
bit for bit against a per-period loop built here from public pieces
(``gossip_round(coords=, topo=, events=True)`` on the host's fault
frames, ``flight.flight_row`` with ``coords.coord_metrics``,
``blackbox.record``): state, coordinates, trace, rings and the
coordinate counters. Under ``graphs.rehearse()`` two calls that differ
in key, start round and phase dispatch the same ops and read no host.

Card half (``cuda``; ``python -m pytest tests/test_torch_coords_graphs.py
--noconftest -m cuda`` on the chip): 140 periods of ``coords_plan`` at
2^16 agents, replayed, bit for bit the same run inside
``graphs.eager()``, counters included; a key's third call captures
nothing. A replayed call's coordinate kernels fall under their
``sim.coords.step`` and ``sim.coords.metrics`` annotations, as an eager
call's do: the body is also captured in parts cut at those spans,
which a replay launches while a profiler records.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils._pytree import tree_leaves

from consul_tpu_torch import faults
from consul_tpu_torch.sim import blackbox, flight, graphs, prng, scenarios
from consul_tpu_torch.sim import coords as C
from consul_tpu_torch.sim import round as R
from consul_tpu_torch.sim.state import init_state
from consul_tpu_torch.utils import telemetry
from test_torch_harness import cuda  # noqa: F401  (fixture)

N = 1024
ROUNDS = 20
#: the rings' length: 40 periods wrap them
RING = 8
CPU = torch.device("cpu")


def _plan(n: int) -> faults.FaultPlan:
    """``coords_plan``'s phases cut to 5 / 10 / 30 periods: the cuts at
    rounds 5 and 15 fall inside the first two bodies of a call from 0."""
    cut = n // 8
    return faults.FaultPlan(phases=(
        faults.Phase(rounds=5, name="warmup"),
        faults.Phase(rounds=10, name="partition", faults=(
            faults.Partition(a=(0, cut), b=(cut, n)),)),
        faults.Phase(rounds=30, name="heal")))


def _setup(n: int, dev):
    su = scenarios.coords_setup(n, device=dev)
    return su.p, faults.compile_plan(_plan(n), n, dev), su.topo


def _reference(state, coords, key, p, cp, topo, rounds, every, bb):
    """The run period by period: the host's frame and phase, the round's
    key, a row and the rings on each recorded period."""
    r0 = int(state.round_idx)
    keys = prng.round_keys(key, r0, rounds)
    sched = faults.plan_schedule(cp)
    trace = flight.empty_trace(rounds, every, state.status.device)
    prev, counts = state.stats, [0, 0]
    for i in range(rounds):
        fx = faults.fault_frame(cp, r0 + i, sched)
        ph = faults.active_phase(cp, r0 + i, sched)
        out = R.gossip_round(state, keys[i], p, fx, coords=coords,
                             topo=topo, events=True)
        if coords is None:
            s2, ev = out
        else:
            s2, coords, aux, ev = out
            late = aux.late if aux.late is not None \
                else torch.zeros_like(aux.relaxed)
            counts = [counts[0] + int(aux.relaxed.sum()),
                      counts[1] + int(late.sum())]
        if (i + 1) % every == 0 or i + 1 == rounds:
            crow = None if coords is None \
                else C.coord_metrics(coords, topo, aux)
            trace[min(i // every, trace.shape[0] - 1)] = flight.flight_row(
                up=s2.up, status=s2.status, informed=s2.informed,
                local_health=s2.local_health, incarnation=s2.incarnation,
                t=s2.t, stats_delta=flight.stats_delta(s2.stats, prev),
                phase=ph, coord_row=crow)
            if bb is not None:
                bb = blackbox.record(
                    bb, round_idx=r0 + i, phase=ph, status=s2.status,
                    incarnation=s2.incarnation, susp_conf=s2.susp_conf,
                    up=s2.up, probe=ev, indirect_checks=p.indirect_checks)
                # record's cumsum widens the count; a runner's carry keeps
                # BlackboxState's int32
                bb = bb._replace(count=bb.count.to(torch.int32))
            prev = s2.stats
        state = s2
    return state, coords, trace, bb, counts


def _run(state, coords, key, p, cp, topo, rounds, every, bb, tracked):
    """``run_rounds_flight`` with a registry armed: (state, coords,
    trace, rings, the two summed coordinate counters)."""
    m = telemetry.Metrics()
    with telemetry.armed(m):
        out = list(R.run_rounds_flight(
            state, key, p, rounds, record_every=every, plan=cp,
            coords=coords, topo=topo, tracked=tracked, ring_len=RING,
            bb0=bb))
    got = {x["Name"]: x["Count"] for x in m.snapshot()["Counters"]}
    counts = [got.get("consul." + name, 0.0)
              for name in R.COORD_COUNTERS[:2]]
    s = out.pop(0)
    c = out.pop(0) if coords is not None else None
    tr = out.pop(0)
    return s, c, tr, (out.pop(0) if out else None), counts


def _same(a, b) -> list:
    """The leaves of two trees that differ (by position)."""
    la, lb = (tree_leaves(x) for x in (a, b))
    assert len(la) == len(lb)
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if isinstance(x, torch.Tensor) and (
                x.dtype != y.dtype or not torch.equal(x, y))]


@pytest.mark.parametrize("every,with_bb,with_coords", [
    (1, False, True), (1, True, True), (3, False, True), (3, True, True),
    (2, True, False)])
def test_the_flight_runner_is_its_per_period_loop(every, with_bb,
                                                  with_coords):
    p, cp, topo = _setup(N, CPU)
    topo = topo if with_coords else None
    key = prng.key(7)
    tracked = blackbox.default_tracked(N, 16, CPU) if with_bb else None
    s = init_state(N, device=CPU)
    c = C.init_coords(N, device=CPU) if with_coords else None
    bb = blackbox.init_blackbox(s, tracked, RING) if with_bb else None
    want_s, want_c, want_bb = s, c, bb
    got_bb, phases = None, set()
    for call in range(2):
        k = prng.fold_in(key, call)
        s0, c0 = want_s, want_c
        want_s, want_c, want_tr, want_bb, want_n = _reference(
            want_s, want_c, k, p, cp, topo, ROUNDS, every,
            None if want_bb is None else graphs.fresh(want_bb))
        kept = [x.clone() for x in tree_leaves((s0, c0))
                if isinstance(x, torch.Tensor)]
        # the first call arms the rings from ids, the second resumes them
        got = _run(s0, c0, k, p, cp, topo, ROUNDS, every,
                   got_bb, tracked if got_bb is None and with_bb else None)
        assert _same(got[0], want_s) == []
        assert _same(got[1], want_c) == []
        assert torch.equal(got[2], want_tr)
        phases.update(want_tr[:, flight.COL["fault_phase"]].tolist())
        assert int(got[0].round_idx) == (call + 1) * ROUNDS
        if with_coords:
            assert got[4] == [float(x) for x in want_n] and want_n[0] > 0
        # the caller's state and coordinates are left as they were
        assert all(torch.equal(a, b) for a, b in zip(
            kept, [x for x in tree_leaves((s0, c0))
                   if isinstance(x, torch.Tensor)]))
        got_bb = got[3]
        if with_bb:
            assert _same(got_bb, want_bb) == []
    # the recorded rows saw every phase, and the rings wrapped
    assert phases == {0.0, 1.0, 2.0}
    if with_bb:
        assert int(want_bb.count.max()) > want_bb.ring.shape[1]


def test_calls_read_no_host_and_bake_no_call_value():
    """Three 12-period calls (a body of 8 and one of 4 each), the black
    box, the coordinates and an armed registry on: the second and the
    third start at rounds 12 and 24, in phases 1 and 2, on other keys;
    both run the same bodies with the same ops and scalars, and each key
    one op sequence."""
    p, cp, topo = _setup(N // 4, CPU)
    n = N // 4
    tracked = blackbox.default_tracked(n, 8, CPU)
    s, c, bb = init_state(n, device=CPU), C.init_coords(n, device=CPU), None
    recs = []
    with telemetry.armed(telemetry.Metrics()):
        for call in range(3):
            args = (s, prng.key(call), p, 12)
            kw = dict(record_every=3, plan=cp, coords=c, topo=topo,
                      tracked=tracked if bb is None else None, bb0=bb)
            if call:
                assert int(faults.phase_at(cp, s.round_idx)) == call
                with graphs.rehearse() as rec:
                    s, c, _, bb = R.run_rounds_flight(*args, **kw)
                recs.append(rec.calls)
            else:
                s, c, _, bb = R.run_rounds_flight(*args, **kw)
    assert len(recs[0]) == 2 and all(ops for _, ops in recs[0])
    assert graphs.first_difference(*recs) is None
    assert recs[0][0][0] != recs[0][1][0]


def test_the_record_pattern_and_the_plan_are_parts_of_the_key():
    """A body's key names which of its periods record, the plan and the
    topology: a call of 20 periods at stride 1 runs two bodies of one
    key and a third of another; at stride 3 its three bodies record at
    other positions."""
    p, cp, topo = _setup(N // 4, CPU)
    n = N // 4
    keys = {}
    for every in (1, 3):
        with graphs.rehearse() as rec:
            R.run_rounds_flight(init_state(n, device=CPU), prng.key(0), p,
                                ROUNDS, record_every=every, plan=cp,
                                coords=C.init_coords(n, device=CPU),
                                topo=topo)
        keys[every] = [k[0] for k, _ in rec.calls]
    one, three = keys[1], keys[3]
    assert [k[1] for k in one] == [(True,) * 8] * 2 + [(True,) * 4]
    assert [k[1] for k in three] == [
        (False, False, True) * 2 + (False, False),
        (True, False, False, True, False, False, True, False),
        (False, True, False, True)]
    assert one[0] == one[1] != one[2]
    assert graphs.pinned(cp) in one[0] and graphs.pinned(topo) in one[0]


# ------------------------------------------------------------ the card


def _coords_calls(dev, calls: int):
    """``calls`` 140-period trials of ``coords_plan`` at 2^16 agents
    from the all-live state on keys 0, 1, ..., a registry armed: each
    call's (outputs, counters, captures so far)."""
    n = 1 << 16
    su = scenarios.coords_setup(n, device=dev)
    outs = []
    for call in range(calls):
        m = telemetry.Metrics()
        with telemetry.armed(m):
            out = R.run_rounds_flight(
                init_state(n, device=dev), prng.key(call, device=dev), su.p,
                su.plan.total_rounds, plan=su.cp,
                coords=C.init_coords(n, device=dev), topo=su.topo)
        torch.cuda.synchronize(dev)
        outs.append((out, {x["Name"]: x["Count"]
                           for x in m.snapshot()["Counters"]},
                     graphs.CAPTURES["graphs"]))
    return outs


@pytest.mark.cuda
def test_the_replayed_coordinates_trial_is_its_eager_run(cuda):  # noqa: F811
    """Three trials replayed, each bit for bit the same trial inside
    ``graphs.eager()``: state, coordinates, trace and the coordinate
    counters (three kernel launches a period). The first call captures
    the 8-period body (its first body runs eagerly), the second the
    4-period one, the third only replays: 17 + 17 + 16 and 2 replays."""
    with graphs.eager():
        want = _coords_calls(cuda, 3)
    built0 = graphs.CAPTURES["graphs"]
    got = _coords_calls(cuda, 3)
    assert [g[2] - built0 for g in got] == [1, 2, 2]
    stats = R.FLIGHT_GRAPHS.stats()[-2:]
    assert [e["replays"] for e in stats] == [50, 2]
    # six cuts a period: the coordinate step twice, the quality row once
    assert [e["parts"] for e in stats] == [6 * 8 + 1, 6 * 4 + 1]
    for (w_out, w_counts, _), (g_out, g_counts, _) in zip(want, got):
        assert _same(g_out, w_out) == []
        assert g_counts == w_counts
        assert g_counts["consul.sim.coords.kernel_launches"] == 3 * 140
    assert _same(got[0][0], got[1][0]) != []


@pytest.mark.cuda
def test_a_replayed_trial_annotates_its_coordinate_spans(cuda):  # noqa: F811
    """A 16-period trial at 2^12 agents, its two bodies replayed under
    the profiler (from their parts): one ``sim.coords.step`` annotation
    a half period and one ``sim.coords.metrics`` a period, each holding
    that period's coordinate kernels, no eager run or capture in the
    call, and its outputs bit for bit the trial's eager run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n, rounds = 1 << 12, 16
    su = scenarios.coords_setup(n, device=cuda)

    def trial():
        return R.run_rounds_flight(
            init_state(n, device=cuda), prng.key(5, device=cuda), su.p,
            rounds, plan=su.cp, coords=C.init_coords(n, device=cuda),
            topo=su.topo)

    with graphs.eager():
        want = trial()
    trial()
    torch.cuda.synchronize()
    built = graphs.CAPTURES["graphs"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = trial()
        torch.cuda.synchronize()
    assert graphs.CAPTURES["graphs"] == built
    assert _same(got, want) == []
    host = {e.name for e in prof.events()
            if e.device_type == DeviceType.CPU}
    assert not {"sim.graph.eager:b", "sim.graph.capture:b"} & host
    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = {k: [(s, e) for s, e, name in dev if name == k]
             for k in ("sim.coords.step", "sim.coords.metrics")}
    assert [len(v) for v in marks.values()] == [2 * rounds, rounds]

    def under(k):
        return [name for s, e, name in dev if not name.startswith("sim.")
                and any(a <= s <= e <= b for a, b in marks[k])]

    step, metrics = under("sim.coords.step"), under("sim.coords.metrics")
    assert sum("coord_probe" in x for x in step) == rounds
    assert sum("vivaldi_relax" in x for x in step) == rounds
    assert sum("coord_quality" in x for x in metrics) == rounds
