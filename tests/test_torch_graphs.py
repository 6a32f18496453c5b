"""The captured runners: graphs.py's capture rehearsal on the CPU, the
device phase lookup and frames, and, on the card, every captured runner
against its eager run bit for bit.

CPU half: each runner's body — what ``graphs.GraphCache`` captures on
the card — runs under ``graphs.rehearse()`` on two calls that differ in
key, start round and fault phase. No body may read the host, and the two
calls must run the same bodies with the same ops and scalars (a value
of one call baked into a graph would differ); a windowed runner's
windows must all dispatch one op sequence. The rehearsal itself is held to
fail on a host read and on a baked value. The device phase lookup and
frames are held to ``active_phase`` and ``fault_frame`` on every round
of every chaos-class plan, and the seed streams from a tensor start to
those from an int start.

Card half (``cuda``; ``python -m pytest tests/test_torch_graphs.py
--noconftest -m cuda`` on the chip): every case runs four calls
eagerly (``graphs.eager()``) and four by default — a key's first call
eager, its second captured and replayed, the rest replays — each call
from a new state object at a later round: state, stats, trace, rings
and scalars bit for bit, a replayed call's kept result untouched by the
next, the launch counters equal; a body that syncs raises on its
capture.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils._pytree import tree_flatten

import chip_smoke
from consul_tpu_torch import bench
from consul_tpu_torch import faults as tfaults
from consul_tpu_torch.sim import blackbox as tbb
from consul_tpu_torch.sim import coords as tC
from consul_tpu_torch.sim import cuda_round as cr
from consul_tpu_torch.sim import graphs, prng
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import scenarios
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim import sweep as tsweep
from consul_tpu_torch.sim import topology as tT
from consul_tpu_torch.sim.params import SweepAxes, grid_params
from test_torch_harness import cuda  # noqa: F401  (fixture)

N = 2048
ROUNDS = 4


def _plan(name, dev):
    return tfaults.compile_plan(chip_smoke.check_plans(N)[name], N, dev)


def _kernel_case(p, rpc=1, plan=None, carry=False, flight_every=None,
                 blackbox=False, coords=False):
    def build(dev):
        cp = _plan(plan, dev) if plan else None
        run = cr.make_run_rounds_cuda(p, ROUNDS, rounds_per_call=rpc,
                                      carry=carry, plan=cp, coords=coords,
                                      flight_every=flight_every,
                                      blackbox=blackbox)
        topo = tT.make_topology(tT.TopologyParams(n=N, seed=0), dev) \
            if coords else None

        def call(state, seed, scalars=None):
            kw = {}
            if coords:
                kw.update(coo=tC.init_coords(N, device=dev), topo=topo)
            if blackbox:
                kw["tracked"] = tbb.default_tracked(N, 16, dev)
            if scalars is not None:
                kw["scalars0"] = scalars
            return run(state, prng.key(seed, device=dev), **kw)

        return call, run.graphs, carry
    return build


def _fast_case(build_plan):
    def build(dev):
        cp = _plan(build_plan, dev)
        run = tround.make_run_rounds_fast(scenarios.chaos_params(N), ROUNDS,
                                          carry=True)

        def call(state, seed, scalars=None):
            return run(state, prng.key(seed, device=dev), plan=cp,
                       scalars0=scalars)

        return call, run.graphs, True
    return build


def _live_case():
    def build(dev):
        run = tround.make_run_rounds(bench.diag_params(N), ROUNDS)

        def call(state, seed, scalars=None):
            return run(state, prng.key(seed, device=dev))

        return call, run.graphs, False
    return build


def _sweep_case(engine):
    """A grid run (its own states from round 0: the calls differ in
    key)."""
    def build(dev):
        p = scenarios.chaos_params(N).with_(stale_k=2)
        tp, _ = grid_params(p, SweepAxes((("gossip_nodes", (2.0, 3.0)),)),
                            dev)
        run = tsweep.make_run_sweep(p, ROUNDS, flight_every=2,
                                    plan=_plan("fault", dev), engine=engine,
                                    device=dev)

        def call(state, seed, scalars=None):
            return run(tp, prng.key(seed, device=dev))

        return call, run.graphs, False
    return build


def _lanes_case(overlap):
    def build(dev):
        p = bench.diag_params(N).with_(stale_k=2)
        cp = None if overlap else _plan("fault", dev)
        run = tround.make_run_rounds_lanes(
            p, ROUNDS, flight_every=None if overlap else 2, plan=cp,
            overlap=overlap)
        def call(state, seed, scalars=None):
            return run(state, prng.key(seed, device=dev))

        return call, run.graphs, False
    return build


CASES = {
    "kernel/stable": _kernel_case(bench.headline_params(N)),
    "kernel/full+flight+blackbox": _kernel_case(
        bench.diag_params(N), flight_every=2, blackbox=True),
    "kernel/mega+flight+carry": _kernel_case(
        bench.diag_params(N), rpc=2, flight_every=2, carry=True),
    "kernel/fault+flight+blackbox+carry": _kernel_case(
        scenarios.chaos_params(N), plan="fault", flight_every=1,
        blackbox=True, carry=True),
    "kernel/byz+flight+blackbox": _kernel_case(
        scenarios.chaos_params(N).with_(corroboration_k=2), plan="byz",
        flight_every=1, blackbox=True),
    "kernel/coords+flight": _kernel_case(
        bench.diag_params(N), coords=True, flight_every=2),
    "fast/fault+carry": _fast_case("fault"),
    "live/run_rounds": _live_case(),
    "lanes/fault+flight": _lanes_case(False),
    "lanes/overlap": _lanes_case(True),
    "sweep/xla": _sweep_case("xla"),
    "sweep/lanes": _sweep_case("lanes"),
}


def _state_of(out):
    return out if isinstance(out, tstate.SimState) else out[0]


def _scalars_of(out, carry):
    return out[-1] if carry else None


def _clone(state):
    return bench.clone_state(state)


def _leaves(out):
    return [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]


def _calls(build, dev, rehearse=False, seeds=(1, 2)):
    """A first call from round 0 (the runner makes its own scalars),
    then a call per seed, each from the previous call's round (phases of
    the plans apart) on another key, carrying the previous call's
    scalars where the runner carries them. Returns every call's outputs
    and, with ``rehearse``, the seeded calls' rehearsals."""
    call, _, carry = build(dev)
    s0 = tstate.init_state(N, device=dev)
    outs = [call(_clone(s0), 0)]
    recs = []
    for seed in seeds:
        prev = outs[-1]
        args = (_clone(_state_of(prev)), seed, _scalars_of(prev, carry))
        if rehearse:
            with graphs.rehearse() as rec:
                outs.append(call(*args))
            recs.append(rec)
        else:
            outs.append(call(*args))
    return outs, recs


@pytest.mark.parametrize("name", list(CASES))
def test_bodies_read_no_host_and_bake_no_call_value(name):
    _, (a, b) = _calls(CASES[name], "cpu", rehearse=True)
    assert a.calls and all(ops for _, ops in a.calls)
    assert graphs.first_difference(a.calls, b.calls) is None
    # a windowed runner replays one graph per key: its windows must
    # dispatch one op sequence
    by_key: dict = {}
    for key, ops in a.calls:
        assert by_key.setdefault(key, ops) == ops, key


def test_grid_bodies_read_no_host_and_bake_no_call_value():
    p = scenarios.chaos_params(256).with_(stale_k=2)
    cp = tfaults.compile_plan(chip_smoke.check_plans(256)["fault"], 256,
                              "cpu")
    grid = SweepAxes((("gossip_nodes", (2.0, 3.0)),))
    for engine in ("xla", "lanes"):
        tp, _ = grid_params(p, grid, "cpu")
        run = tsweep.make_run_sweep(p, 6, flight_every=2, plan=cp,
                                    engine=engine, device="cpu")
        run(tp, prng.key(0))
        recs = []
        for seed in (1, 2):
            with graphs.rehearse() as rec:
                run(tp, prng.key(seed))
            recs.append(rec.calls)
        assert recs[0] and graphs.first_difference(*recs) is None
        by_key: dict = {}
        for key, ops in recs[0]:
            assert by_key.setdefault(key, ops) == ops, (engine, key)


def test_rehearsal_refuses_host_reads_and_finds_baked_values():
    cache = graphs.GraphCache()
    x = torch.zeros(4)
    reads = {
        "item": lambda d: d[0] + int(d[0].sum()),
        "tolist": lambda d: d[0] + len(d[0].tolist()),
        "cpu": lambda d: d[0].cpu(),
        "mask": lambda d: d[0][d[0] > 0],
        "nonzero": lambda d: torch.nonzero(d[0]),
    }
    for name, body in reads.items():
        with graphs.rehearse():
            with pytest.raises(graphs.HostReadError):
                cache(name, body, (x,))
    # a Python int of the call reaching a fill: the old int(round_idx)
    # seeds (prng._on) against the device start
    key = prng.key(3)
    recs = {}
    for start in (0, 7):
        for kind in ("int", "tensor"):
            r = start if kind == "int" else torch.tensor(start,
                                                          dtype=torch.int32)
            with graphs.rehearse() as rec:
                cache(kind, lambda d, k, s: prng.round_seeds(k, s, 4), (x,),
                      key, r)
            recs[kind, start] = rec.calls
    assert graphs.first_difference(recs["int", 0], recs["int", 7])
    assert graphs.first_difference(recs["tensor", 0],
                                   recs["tensor", 7]) is None
    # outside a rehearsal the CPU runs the body as it stands
    assert not graphs.captures(torch.device("cpu"))
    assert int(cache("item", reads["item"], (x,))[0]) == 0


def test_a_body_gets_its_state_carry_by_name_and_updates_it_in_place():
    """A ``GraphCache`` body gets the carry as the caller's tree (a
    ``SimState``, read by name) and writes its new value into the
    caller's tensors with ``graphs.assign``; the call is keyed by the
    carry's structure, and two calls run the same ops."""
    cache = graphs.GraphCache()
    s = tround.own_scalars(tstate.init_state(64, device="cpu"))
    lanes = s.node_arrays()

    def body(c, step):
        assert isinstance(c, tstate.SimState)
        graphs.assign(c, c._replace(informed=c.informed * 0.5,
                                    t=c.t + step,
                                    round_idx=c.round_idx + 1))
        return c.t * 2.0

    with graphs.rehearse() as rec:
        for _ in range(2):
            out = cache("halve", body, s, torch.tensor(1.5))
        cache("halve", lambda c, step: c[0] * step, (s.informed,),
              torch.tensor(1.5))
    assert all(a is b for a, b in zip(s.node_arrays(), lanes))
    assert torch.all(s.informed == 0.25)
    assert float(s.t) == 3.0 and int(s.round_idx) == 2
    assert float(out) == 6.0
    (k1, ops1), (k2, ops2), (k3, _) = rec.calls
    assert k1 == k2 and ops1 == ops2 and k3 != k1
    with pytest.raises(ValueError, match="leaves"):
        graphs.assign(s, s.node_arrays())


def test_seeds_from_a_device_start_equal_an_int_start():
    k = prng.key(11)
    for start in (0, 5, 2**20 + 3):
        t = torch.tensor(start, dtype=torch.int32)
        assert torch.equal(prng.round_seeds(k, t, 9),
                           prng.round_seeds(k, start, 9))
        assert torch.equal(prng.round_keys(k, t, 9),
                           prng.round_keys(k, start, 9))
        assert torch.equal(prng.fold_in(k, t), prng.fold_in(k, start))
        assert torch.equal(prng.u01_global(k, t, 64),
                           prng.u01_global(k, start, 64))


def _all_plans(n):
    plans = dict(scenarios.chaos_plans(n))
    plans.update({f"check/{k}": v for k, v in
                  chip_smoke.check_plans(n).items()})
    return plans


@pytest.mark.parametrize("name", sorted(_all_plans(256)))
def test_device_phase_and_frames_equal_the_host_lookup(name):
    plan = _all_plans(256)[name]
    cp = tfaults.compile_plan(plan, 256, "cpu")
    sched = tfaults.plan_schedule(cp)
    # the plan's host flags name the rewrites its phases hold
    assert (cp.any_flap, cp.any_release) == (any(sched.flaps),
                                             any(sched.releases))
    for gain in (1.0, 0.5):
        cpg = cp if gain == 1.0 else tfaults.scale_plan(cp, gain)
        assert (cpg.any_flap, cpg.any_release) == (cp.any_flap,
                                                   cp.any_release)
        for r in range(plan.total_rounds + 3):
            rt = torch.tensor(r, dtype=torch.int32)
            assert int(tfaults.phase_at(cpg, rt)) == \
                tfaults.active_phase(cpg, r, sched)
            want = tfaults.fault_frame(cpg, r, sched, gain)
            got = tfaults.frame_at(cpg, rt, gain)
            for f in tfaults.FaultFrame._fields:
                a, b = getattr(want, f), getattr(got, f)
                assert (a is None) == (b is None), (r, f)
                if a is not None:
                    assert a.dtype == b.dtype and torch.equal(a, b), (r, f)
                    assert b.is_contiguous()
    # a mesh rank's columns, at bounds no int64 word divides: the gather
    # goes element by element there
    sh = tfaults.shard_plan(cp, 3, 250)
    for r in range(plan.total_rounds + 1):
        want = tfaults.fault_frame(sh, r, sched)
        got = tfaults.frame_at(sh, torch.tensor(r, dtype=torch.int32))
        for f in tfaults.FaultFrame._fields:
            a, b = getattr(want, f), getattr(got, f)
            assert (a is None) == (b is None), (r, f)
            if a is not None:
                assert torch.equal(a, b) and b.is_contiguous(), (r, f)
    # the grid's [G] rounds share one phase
    g = torch.full((3,), plan.total_rounds - 1, dtype=torch.int32)
    assert int(tfaults.phase_at(cp, g)) == \
        tfaults.active_phase(cp, plan.total_rounds - 1)


def test_plan_frames_step_the_device_round():
    """One call's frames (``faults.frames_at``: the phases looked up
    for all its rounds at once) across every phase of the flapping plan,
    from a start round that is a device tensor."""
    plan = scenarios.chaos_plans(256)["flapping"]
    cp = tfaults.compile_plan(plan, 256, "cpu")
    s = tstate.init_state(256, device="cpu")._replace(
        round_idx=torch.tensor(3, dtype=torch.int32))
    rounds = plan.total_rounds + 2
    for r, fx in enumerate(tround.plan_frames(cp, s, rounds)):
        want = tfaults.fault_frame(cp, 3 + r)
        for f in tfaults.FaultFrame._fields:
            a, b = getattr(want, f), getattr(fx, f)
            assert (a is None) == (b is None), (r, f)
            if a is not None:
                assert torch.equal(a, b), (r, f)


# ------------------------------------------------------------ the card


def _equal(a, b) -> list:
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(x, y)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_captured_runner_is_its_eager_run_on_the_card(cuda, name):
    # four calls: a runner that carries scalars gets a new key on its
    # second call, so its third is a capture and its fourth a replay
    seeds = (1, 2, 3)
    cr.reset_launches()
    with graphs.eager():
        eager_outs, _ = _calls(CASES[name], cuda, seeds=seeds)
    eager_launches = dict(cr.LAUNCHES)
    cr.reset_launches()
    outs, _ = _calls(CASES[name], cuda, seeds=seeds)
    torch.cuda.synchronize()
    assert dict(cr.LAUNCHES) == eager_launches
    for want, got in zip(eager_outs, outs):
        assert _equal(want, got) == [], name


@pytest.mark.cuda
def test_captured_results_are_fresh_and_the_cache_is_reused(cuda):
    build = CASES["kernel/fault+flight+blackbox+carry"]
    call, cache, _ = build(cuda)
    s0 = tstate.init_state(N, device=cuda)
    # eager, captured and replayed, replayed
    outs = [call(_clone(s0), seed) for seed in (1, 2, 3)]
    kept = [x.clone() for x in _leaves(outs[1])]
    fourth = call(_clone(_state_of(outs[2])), 4)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_leaves(outs[1]), kept))
    assert len(cache.stats()) == 1 and cache.stats()[0]["replays"] == 3
    assert int(_state_of(fourth).round_idx) == 2 * ROUNDS
    # the donated state is the caller's: updated in place
    s = _clone(s0)
    out = call(s, 1)
    assert _state_of(out).status.data_ptr() == s.status.data_ptr()
    assert torch.equal(_state_of(out).status, _state_of(outs[0]).status)


@pytest.mark.cuda
def test_a_body_that_syncs_raises_on_the_card(cuda):
    cache = graphs.GraphCache()
    x = torch.zeros(4, device=cuda)
    bodies = {
        "item": lambda d: d[0] + float(d[0].sum()),
        "cpu": lambda d: d[0].cpu(),
        "h2d": lambda d: d[0] + torch.tensor([1.0, 2.0, 3.0, 4.0],
                                             device=cuda)}
    for name, body in bodies.items():
        cache(name, body, (x,))        # a key's first call: eager
        # its second is the capture, and CUDA refuses a sync inside it
        with pytest.raises(RuntimeError):
            cache(name, body, (x,))
    # the card still captures after a refused body
    y = torch.ones(4, device=cuda)
    for _ in range(3):
        out = cache("ok", lambda d, y: d[0] + y, (x,), y)
    assert torch.equal(out, y) and cache.stats()[-1]["replays"] == 2


def test_chip_smoke_graphs_phase_on_the_plain_path():
    """``chip_smoke.py``'s graphs phase, rehearsed on the CPU at small
    sizes (the profiler's busy shares left out: each trace costs seconds
    on the CPU): every case runs, compares and reports."""
    m = chip_smoke.modules()
    out, bad, launches = chip_smoke.graphs_parts(
        torch, m, "cpu", profile=False, n=1024, call_rounds=(8, 16),
        grid_n=256)
    assert bad == [] and launches == {}
    cases = [k for k in out if k != "eager_call_trace"]
    assert len(cases) == 11
    for label in cases:
        rep = out[label]
        assert rep["bit_diffs"] == [] and rep["rounds"] > 0, label
        assert rep["captured"]["us_per_round"] > 0, label
    assert out["eager_call_trace"]["host_self_ms_by_op"]
