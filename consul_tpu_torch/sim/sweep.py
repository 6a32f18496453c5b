"""Parameter-sweep engine: the whole simulation over a grid of constants.

The port of the JAX package's ``consul_tpu/sim/sweep.py``. There, a
``vmap`` over the sweep leaves runs G parameterizations as one compiled
program; here the grid is an explicit leading dimension: ``grid_params``
(``sim/params.py``) lifts the swept constants into ``[G, 1]`` leaves, the
state is ``[G, N]``, and the unmodified round body broadcasts. One runner
runs the whole grid, with no Python loop over its points.

Exactness: every grid point is bit for bit its one-point run
(``make_run_point``, the same code on a grid of one), on the host and on
the card. The key stream is shared (each round's ``[N]`` draws broadcast
to every point), swept constants enter only elementwise arithmetic, and
every population sum goes through ``lanes.tree_sum``, a fixed tree of
f32 additions whatever G is.

Spans (``utils/telemetry.py``): a call of the grid runner (and of the
one-point runner) runs under ``sim.runner.call``, its start (the ``[G]``
initial state, the copy the engine runs on, the key stream) under
``sim.sweep.prologue``.

Engines:

* ``"xla"`` — the live engine (``round.round_core``) with per-row sums,
  the flight recorder (one trace per point), a fault plan shared by
  the grid, whose intensity a swept ``fault_gain`` scales per point,
  and Vivaldi coordinates (``coords=True``): one coordinate set per
  point over a shared ground-truth ``topo``, the trace's coordinate
  columns ``coords.coord_metrics`` per grid row, and
  ``coord_timeout_mult`` / ``probe_timeout`` real axes under
  ``coords_timeout``;
* ``"lanes"`` — the lane engine's loop (``round._lane_scan``) at the
  grid-wide ``p.stale_k``;
* ``"cuda"`` — the counterpart of the JAX ``"pallas"`` engine: a loop
  over the concrete points, each through ``cuda_round.
  make_run_rounds_cuda(rounds_per_call=R)`` (``mega_kernel`` for R > 1,
  ``round_kernel`` for R = 1) from a fresh state on the same key,
  results stacked ``[G]``, each point run eagerly (a point's runner is
  new and called once, and a graph is captured on a key's second call). The kernels
  take no swept leaves, so it exists to put kernel schedules in the
  same reports, not for grid throughput. It refuses fault plans (the
  megakernel freezes its inputs per call) and coordinates, as the JAX
  engine does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from consul_tpu_torch.faults import (CompiledFaultPlan, frame_at,
                                     phase_at)
from consul_tpu_torch.sim import coords as coords_mod
from consul_tpu_torch.sim import flight, graphs, prng
from consul_tpu_torch.sim import lanes as lanes_mod
from consul_tpu_torch.sim.params import (GridSpec, SimParams, TracedParams,
                                         _point_param, grid_params,
                                         point_params)
from consul_tpu_torch.sim.round import (_lane_scan, _param_inputs,
                                        _params_from, draw_slots,
                                        round_core)
from consul_tpu_torch.sim.state import SimState, SimStats, init_state
from consul_tpu_torch.utils import telemetry
from consul_tpu_torch.utils.platform import DeviceLike, default_device

ENGINES = ("xla", "lanes", "cuda")


class GridCarry(NamedTuple):
    """The live grid's carry: the state, its coordinates (with
    ``coords``) and the counters at the last flight row (with a
    recorder)."""

    state: SimState
    coords: Optional[coords_mod.CoordState] = None
    prev: Optional[SimStats] = None


def _xla_scan(state: SimState, tp, keys: torch.Tensor, rounds: int,
              flight_every: Optional[int], cp, cache, coords=None,
              topo=None):
    """A grid's run on the live engine: ``round_core`` with the per-row
    reducer, and a flight row per point where a stride closes (as
    ``round.run_rounds_flight`` records). ``coords`` (``[G, N, ...]``
    CoordState) relaxes over ``topo`` each round and fills the rows'
    coordinate columns. Each round is one call of ``cache`` (a
    ``graphs.GraphCache``: one captured grid round, replayed ``rounds``
    times, its key an input, its frame and phase looked up on the device
    from the carried round) on a ``GridCarry`` of ``state`` and
    ``coords``, both updated in place."""
    rows = state.status.shape[-1]
    pkey, pleaves = _param_inputs(tp)
    buf = flight.empty_trace(rounds, flight_every, state.status.device,
                             lead=tuple(state.status.shape[:-1])) \
        if flight_every is not None else None
    c = GridCarry(state, coords, SimStats(*[x.clone() for x in state.stats])
                  if flight_every is not None else None)

    def grid_round(c, key_i, leaves, record):
        pp = _params_from(tp, leaves)
        s = c.state
        fx = frame_at(cp, s.round_idx) if cp is not None else None
        u01 = prng.threefry_u01(key_i, rows, draw_slots(pp, fx))
        aux = c2 = None
        if coords is None:
            s2, _ = round_core(s, None, pp, u01, fx,
                               reduce=lanes_mod.row_sums)
        else:
            s2, _, c2, aux, _ = round_core(s, None, pp, u01, fx,
                                           coords=c.coords, topo=topo,
                                           key=key_i,
                                           reduce=lanes_mod.row_sums)
        row = None
        if record:
            ph = phase_at(cp, s2.round_idx - 1) if cp is not None else -1
            crow = coords_mod.coord_metrics(c2, topo, aux) \
                if coords is not None else None
            row = flight.grid_flight_row(
                up=s2.up, status=s2.status, informed=s2.informed,
                local_health=s2.local_health, incarnation=s2.incarnation,
                t=s2.t, stats_delta=flight.stats_delta(s2.stats, c.prev),
                phase=ph, coord_row=crow)
        graphs.assign(c, GridCarry(s2, c2, s2.stats if record else c.prev))
        return row

    plan_key = graphs.pinned(cp) if cp is not None else None
    for i in range(rounds):
        record = flight_every is not None and (
            (i + 1) % flight_every == 0 or i + 1 >= rounds)
        row = cache(("grid", pkey, plan_key, record), grid_round, c,
                    keys[i], pleaves, record)
        if record:
            flight.record_row(buf, row, i, flight_every)
    return c.state, buf


def _make_solo(p: SimParams, rounds: int, flight_every: Optional[int],
               engine: str, coords: bool = False, topo=None):
    """The grid runner ``(state, tp, keys, cp) -> (state, trace|None)``:
    ONE function serves the grid and the one-point run; with ``coords``
    every point starts from ``init_coords`` and relaxes over ``topo``.
    It updates ``state`` in place and returns it: the caller hands it a
    copy (``_grid_call``; the reference's sweep does not donate)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown sweep engine {engine!r} "
                         f"(expected one of {ENGINES})")
    if coords and engine != "xla":
        raise ValueError("coords sweeps run on the XLA engine only")
    if coords and topo is None:
        raise ValueError("coords=True needs the ground-truth topo "
                         "(sim/topology.make_topology)")
    if engine == "cuda":
        raise ValueError(
            "the cuda engine runs each point through make_run_rounds_cuda "
            "on its concrete SimParams (no swept leaves reach a kernel); "
            "that runner is its oracle")
    cache = graphs.GraphCache()
    if engine == "lanes":
        lanes_mod.check_pool(p.n)
        lanes_mod.check_flight_config(p, flight_every)

        def solo(state, tp, keys, cp):
            out = _lane_scan(state, keys, cp, tp, rounds, flight_every,
                             lanes_mod.reduce_lanes_single, cache=cache)
            return out if flight_every is not None else (out, None)

        solo.graphs = cache
        return solo

    def solo(state, tp, keys, cp):
        c0 = None
        if coords:
            lead = tuple(state.status.shape[:-1])
            c0 = coords_mod.CoordState(*[
                x.repeat(lead + (1,) * x.dim()) for x in
                coords_mod.init_coords(p.n, device=state.status.device)])
        return _xla_scan(state, tp, keys, rounds, flight_every, cp, cache,
                         coords=c0, topo=topo)

    solo.graphs = cache
    return solo


def _broadcast_state(p: SimParams, g: int, device) -> SimState:
    """``init_state`` materialized G times (``[G, N]`` lanes, ``[G]``
    clock, round and counters): every runner updates its state, so the
    points must not share storage as an ``expand`` would."""
    s0 = init_state(p.n, device=device)

    def rep(x):
        return x.unsqueeze(0).repeat((g,) + (1,) * x.dim())

    return SimState(*[rep(a) for a in s0.node_arrays()], t=rep(s0.t),
                    round_idx=rep(s0.round_idx),
                    stats=SimStats(*[rep(x) for x in s0.stats]))


def _grid_call(solo, p: SimParams, rounds: int, g: int, tp, key, plan,
               dev):
    """One call of a ``g``-point runner under ``sim.runner.call``: its
    start under ``sim.sweep.prologue`` (``init_state`` G times, the copy
    the engine runs on, the absolute-round key stream from round 0: the
    keys every engine draws from a fresh state), then the engine."""
    with telemetry.span("sim.runner.call"):
        with telemetry.span("sim.sweep.prologue"):
            states = graphs.fresh(_broadcast_state(p, g, dev))
            keys = prng.round_keys(key.to(dev), 0, rounds)
        return solo(states, tp, keys, plan)


def take_point(states: SimState, i: int) -> SimState:
    """Grid point ``i`` of a ``[G]``-batched state."""
    return SimState(*[a[i] for a in states.node_arrays()], t=states.t[i],
                    round_idx=states.round_idx[i],
                    stats=SimStats(*[x[i] for x in states.stats]))


def _stack_states(states: list) -> SimState:
    return SimState(*[torch.stack(xs) for xs in zip(*[s.node_arrays()
                                                       for s in states])],
                    t=torch.stack([s.t for s in states]),
                    round_idx=torch.stack([s.round_idx for s in states]),
                    stats=SimStats(*[torch.stack(xs) for xs in
                                     zip(*[s.stats for s in states])]))


def _points_of(tp: TracedParams) -> list:
    """The concrete SimParams of each grid point, rebuilt from the
    leaves (one host read; f32 leaves round f64 axis values, so callers
    that hold ``grid_params``' point list pass it instead)."""
    fields = {name: leaf.reshape(-1).tolist()
              for name, leaf in tp.leaves.items()
              if name in SimParams.__dataclass_fields__}
    g = tp.grid_shape[0]
    return [_point_param(tp.static, {k: v[i] for k, v in fields.items()})
            for i in range(g)]


def _make_cuda_sweep(p: SimParams, rounds: int, flight_every: Optional[int],
                     rounds_per_call: int, device: DeviceLike):
    """The kernel engine: a loop over the concrete points, each through
    ``make_run_rounds_cuda(rounds_per_call=R)`` from a fresh
    ``init_state`` on the same key; the results stacked ``[G]``. The
    block shape is the kernels' own (any pool size); the runner's
    refusals surface here for the base params and again for every point
    before any point runs."""
    from consul_tpu_torch.sim.cuda_round import make_run_rounds_cuda

    dev = default_device(device)
    make_run_rounds_cuda(p, rounds, rounds_per_call=rounds_per_call,
                         flight_every=flight_every)

    def run(tp: TracedParams, key: torch.Tensor, points=None):
        if not tp.grid_shape:
            raise ValueError("expected [G]-leaved grid TracedParams "
                             "(build with grid_params)")
        g = tp.grid_shape[0]
        if points is not None and len(points) != g:
            raise ValueError(f"points list ({len(points)}) does not match "
                             f"the grid ({g})")
        pts = list(points) if points is not None else _points_of(tp)
        runners = [make_run_rounds_cuda(pp, rounds,
                                        rounds_per_call=rounds_per_call,
                                        flight_every=flight_every)
                   for pp in pts]
        states, traces = [], []
        for pp, runner in zip(pts, runners):
            # a point's runner is new and called once: its one call is
            # a key's first, which runs eagerly (no capture a point)
            out = runner(init_state(pp.n, device=dev), key.to(dev))
            if flight_every is not None:
                out, tr = out
                traces.append(tr)
            states.append(out)
        return (_stack_states(states),
                torch.stack(traces) if traces else None)

    run.per_point = True
    return run


def make_run_sweep(p: SimParams, rounds: int, *,
                   flight_every: Optional[int] = None,
                   plan: Optional[CompiledFaultPlan] = None,
                   engine: str = "xla", coords: bool = False, topo=None,
                   rounds_per_call: int = 1, device: DeviceLike = None):
    """The grid runner: ``run(tp, key) -> (states, trace)``, ``tp`` a
    ``[G]``-leaved TracedParams (``grid_params``), ``states`` the
    ``[G]``-batched final state, ``trace`` ``[G, rows, flight.N_COLS]``
    (None without ``flight_every``). Every point starts from
    ``init_state`` on the SAME key stream, so point g is bit for bit the
    ``make_run_point`` run of ``point_params(tp, g)``. The state lives on
    ``device`` (the card unless the caller passes ``"cpu"``), as must
    ``tp``, ``key`` and ``plan``.

    ``coords=True`` (xla engine) threads Vivaldi coordinates, one set
    per point, over the ground-truth ``topo``; ``engine="lanes"``
    honours ``p.stale_k`` (grid-wide); ``engine="cuda"`` runs the
    kernels at ``rounds_per_call`` point by point (``run(tp, key,
    points=None)``)."""
    dev = default_device(device)
    if engine == "cuda":
        if coords:
            raise ValueError("coords sweeps run on the XLA engine only")
        if plan is not None:
            raise ValueError(
                "the megakernel freezes its inputs per call; run fault "
                "plans on engine='xla'/'lanes'")
        return _make_cuda_sweep(p, rounds, flight_every, rounds_per_call,
                                dev)
    if rounds_per_call != 1:
        raise ValueError(
            "rounds_per_call is the kernels' knob — pass engine='cuda' "
            "(the xla/lanes engines amortize via SimParams.stale_k "
            "instead)")
    if flight_every is not None and not p.collect_stats:
        raise ValueError("flight recording rides the SimStats "
                         "counters; build SimParams with "
                         "collect_stats=True")
    solo = _make_solo(p, rounds, flight_every, engine, coords, topo)

    def run(tp: TracedParams, key: torch.Tensor):
        if not tp.grid_shape:
            raise ValueError("expected [G]-leaved grid TracedParams "
                             "(build with grid_params); for a single "
                             "point use make_run_point")
        return _grid_call(solo, p, rounds, tp.grid_shape[0], tp, key, plan,
                          dev)

    run.graphs = solo.graphs
    return run


def make_run_point(p: SimParams, rounds: int, *,
                   flight_every: Optional[int] = None,
                   plan: Optional[CompiledFaultPlan] = None,
                   engine: str = "xla", coords: bool = False, topo=None,
                   device: DeviceLike = None):
    """The one-point runner: ``run(tp_point, key) -> (state, trace)`` for
    ``point_params(tp, i)``: the grid runner's code on a grid of one,
    returned unbatched (``[N]`` lanes, ``[rows, N_COLS]`` trace) — the
    bit-for-bit oracle of a grid row."""
    dev = default_device(device)
    solo = _make_solo(p, rounds, flight_every, engine, coords, topo)

    def run(tp: TracedParams, key: torch.Tensor):
        if tp.grid_shape or not tp.point:
            raise ValueError("expected one-point params "
                             "(params.point_params)")
        state, trace = _grid_call(solo, p, rounds, 1, tp, key, plan, dev)
        return take_point(state, 0), (None if trace is None else trace[0])

    return run


class SweepResult(NamedTuple):
    """One sweep's results on the device plus the host-side grid."""

    states: SimState                   # [G]-batched
    trace: Optional[torch.Tensor]      # [G, rows, flight.N_COLS] or None
    tp: TracedParams                   # the [G]-leaved grid
    points: list                       # G concrete SimParams
    rounds: int
    flight_every: Optional[int]


def run_sweep(p: SimParams, grid: GridSpec, rounds: int,
              key: Optional[torch.Tensor] = None, seed: int = 0, *,
              flight_every: Optional[int] = None,
              plan: Optional[CompiledFaultPlan] = None,
              engine: str = "xla", coords: bool = False, topo=None,
              rounds_per_call: int = 1,
              device: DeviceLike = None) -> SweepResult:
    """Build the grid (``grid_params``), check every point's lane
    preconditions, run the whole grid through one runner (point by point
    on the cuda engine, on the exact concrete point list), return the
    batched results."""
    dev = default_device(device)
    tp, points = grid_params(p, grid, dev)
    if engine == "lanes" and flight_every is not None:
        for pp in points:
            lanes_mod.check_flight_config(pp, flight_every)
    run = make_run_sweep(p, rounds, flight_every=flight_every, plan=plan,
                         engine=engine, coords=coords, topo=topo,
                         rounds_per_call=rounds_per_call, device=dev)
    if key is None:
        key = prng.key(seed, device=dev)
    if engine == "cuda":
        states, trace = run(tp, key, points=points)
    else:
        states, trace = run(tp, key)
    return SweepResult(states=states, trace=trace, tp=tp, points=points,
                       rounds=rounds, flight_every=flight_every)


def point_trace(result: SweepResult, i: int):
    """Grid point i's flight trace (``flight.trace_columns`` decodes
    it)."""
    if result.trace is None:
        return None
    return result.trace[i]


def solo_reference(result: SweepResult, i: int, p: SimParams,
                   key: torch.Tensor, *,
                   plan: Optional[CompiledFaultPlan] = None,
                   engine: str = "xla", device: DeviceLike = None):
    """Re-run grid point i alone (the conformance oracle)."""
    run = make_run_point(p, result.rounds,
                         flight_every=result.flight_every, plan=plan,
                         engine=engine, device=device)
    return run(point_params(result.tp, i), key)
