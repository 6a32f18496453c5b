"""The simulation's spans (``utils/telemetry.py``) and the registry's
samples.

* With no profiler recording and no registry armed, ``span`` returns the
  shared ``OFF`` context and a runner's call makes no ``Span``.
* An armed registry takes every span's duration as a sample; the
  samples snapshot as go-metrics' aggregate; ``armed`` nests.
* Under a CPU ``torch.profiler`` every runner's call is one
  ``sim.runner.call`` tree (paired from its marks by the benchmark's
  ``gossipbench/spans.py``) holding its prologue, its ``GraphCache``
  calls and its epilogue, properly nested; the marks enclose no op.
* The CLI's default mode arms ``telemetry.default``: its snapshot holds
  a ``sim.runner.call`` sample a chunk, and stderr prints them.
* A sweep's call (the ``xla`` and ``lanes`` grid engines) is one
  ``sim.runner.call`` opening with ``sim.sweep.prologue`` (the lane
  engine's own prologue and epilogue nested after it), its report one
  ``sim.sweep.report``; an armed registry takes their samples, and
  nothing is counted, armed or not.
* A device span cuts a capture (``telemetry.cutting``) whoever
  listens, and a body captured so replays each part inside the device
  span it was captured in (``graphs._Parts``, on a stand-in graph).
* On the card (``cuda``): a ``GraphCache`` call's parts, and no device
  event named after a span; a replayed body's device span annotated as
  an eager one is, from its parts while a profiler records and from one
  graph otherwise, with the same outputs.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from consul_tpu_torch import cli
from consul_tpu_torch.sim import cuda_round, graphs, prng
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import sweep
from consul_tpu_torch.sim.metrics import sweep_report
from consul_tpu_torch.sim.params import (SimParams, SweepAxes, grid_params,
                                         point_params)
from consul_tpu_torch.sim.state import SimState, init_state
from consul_tpu_torch.utils import telemetry
from gossipbench import spans as bspans
from test_torch_harness import cuda  # noqa: F401  (fixture)

CPU = torch.device("cpu")
N = 1024
ROUNDS = 8

#: every runner that opens a ``sim.runner.call``, by label
RUNNERS = {
    "kernel_r1_flight": lambda p: cuda_round.make_run_rounds_cuda(
        p, ROUNDS, carry=True, flight_every=1),
    "kernel_r8": lambda p: cuda_round.make_run_rounds_cuda(
        p, ROUNDS, rounds_per_call=8),
    "live": lambda p: tround.make_run_rounds(p, ROUNDS),
    "fast": lambda p: tround.make_run_rounds_fast(p, ROUNDS),
    "lanes": lambda p: tround.make_run_rounds_lanes(
        p.with_(stale_k=4), ROUNDS),
    "flight": lambda p: tround.make_run_rounds_flight(p, ROUNDS),
}


def _params() -> SimParams:
    return SimParams(n=N, loss=0.01, fail_per_round=1e-3,
                     rejoin_per_round=1e-2)


def _calls(run, calls: int, dev=CPU):
    """``calls`` calls of ``run`` from an initial state; returns the
    last result."""
    state, key = init_state(N, device=dev), prng.key(5, device=dev)
    res = None
    for c in range(calls):
        res = run(state, prng.fold_in(key, c))
        state = res if isinstance(res, SimState) else res[0]
    return res


def _samples(reg: telemetry.Metrics) -> dict:
    return {s["Name"].removeprefix("consul."): s
            for s in reg.snapshot()["Samples"]}


def test_span_is_the_shared_no_op_when_nobody_listens(monkeypatch):
    assert telemetry.span("sim.runner.call") is telemetry.OFF
    with telemetry.span("sim.graph.call") as sp:
        assert sp is telemetry.OFF

    def refuse(name):
        raise AssertionError(f"a Span {name!r} was made with no listener")

    monkeypatch.setattr(telemetry, "Span", refuse)
    reg = telemetry.default
    before = reg.snapshot()["Samples"]
    for make in RUNNERS.values():
        _calls(make(_params()), 2)
    assert reg.snapshot()["Samples"] == before


def test_samples_snapshot_as_go_metrics_aggregates():
    reg = telemetry.Metrics()
    for v in (1.0, 3.0, 2.0):
        reg.sample("sim.x", v)
    t0 = telemetry.time.perf_counter()
    reg.measure_since("sim.y", t0)
    got = _samples(reg)
    assert got["sim.x"] == {"Name": "consul.sim.x", "Count": 3, "Sum": 6.0,
                            "Min": 1.0, "Max": 3.0, "Mean": 2.0,
                            "Labels": {}}
    assert got["sim.y"]["Count"] == 1 and got["sim.y"]["Min"] >= 0.0
    reg.reset()
    assert reg.snapshot()["Samples"] == []


def test_an_armed_registry_takes_each_span_of_three_calls():
    reg = telemetry.Metrics()
    run = cuda_round.make_run_rounds_cuda(_params(), ROUNDS)
    with telemetry.armed(reg):
        _calls(run, 3)
    got = _samples(reg)
    for name in ("sim.runner.call", "sim.runner.prologue",
                 "sim.graph.call", "sim.runner.epilogue"):
        assert got[name]["Count"] == 3, name
    call = got["sim.runner.call"]
    assert call["Sum"] >= call["Max"] >= call["Mean"] >= call["Min"] > 0.0
    # the graph cache's call lies inside the runner's
    assert got["sim.graph.call"]["Sum"] < call["Sum"]
    assert telemetry.span("sim.runner.call") is telemetry.OFF


def test_armed_nests_and_a_span_knows_its_parent():
    a, b = telemetry.Metrics(), telemetry.Metrics()
    seen = {}
    with telemetry.armed(a):
        with telemetry.armed(a), telemetry.armed(b):
            with telemetry.span("sim.outer") as outer:
                with telemetry.span("sim.inner") as inner:
                    worker = threading.Thread(
                        target=lambda: seen.update(
                            other=telemetry.span("sim.other")
                            .__enter__()))
                    worker.start()
                    worker.join(10)
        assert not worker.is_alive()
        with telemetry.span("sim.still") as still:
            assert still is not telemetry.OFF
    assert telemetry.span("sim.off") is telemetry.OFF
    assert inner.parent is outer and outer.parent is None
    # a span on another thread nests in nothing of this one
    assert seen["other"].parent is None
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert _samples(a)["sim.inner"]["Count"] == 2
    assert _samples(b)["sim.inner"]["Count"] == 1
    assert _samples(a)["sim.still"]["Count"] == 1


def test_a_device_span_cuts_a_capture_whoever_listens():
    """Inside ``cutting(cut)`` each device span calls ``cut(name)`` as it
    opens and ``cut(None)`` as it closes, with no profiler or registry;
    a plain span calls nothing, and outside the block nothing is
    called."""
    cuts = []
    with telemetry.span("sim.coords.step", device=True) as sp:
        assert sp is telemetry.OFF
    with telemetry.cutting(cuts.append):
        with telemetry.span("sim.runner.call") as plain:
            with telemetry.span("sim.coords.step", device=True) as sp:
                with telemetry.span("sim.coords.metrics", device=True):
                    pass
        assert plain is telemetry.OFF and sp is not telemetry.OFF
    with telemetry.span("sim.coords.step", device=True):
        pass
    assert cuts == ["sim.coords.step", "sim.coords.metrics", None, None]


class _StandInGraph:
    """A ``torch.cuda.CUDAGraph`` on the host: what it captured is the
    list of tags written between its ``capture_begin`` and
    ``capture_end``, and a replay writes them again."""

    log: list = []

    def __init__(self):
        self.tags = None

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.tags = []
        _StandInGraph.log = self.tags

    def capture_end(self):
        _StandInGraph.log = []

    def replay(self):
        _StandInGraph.log.extend(self.tags)


def test_a_captured_body_replays_its_parts_inside_their_spans(monkeypatch):
    """``graphs._Parts`` cuts a body where it opens and closes a device
    span, and a replay launches the parts in order, each inside the
    span it was captured in (an armed registry samples each span once a
    replay); a body with no device span is one part."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)

    def launch(tag):
        _StandInGraph.log.append(tag)

    def body():
        launch("draws")
        with telemetry.span("sim.coords.step", device=True):
            launch("probe")
        launch("ack")
        with telemetry.span("sim.coords.step", device=True):
            launch("relax")
        with telemetry.span("sim.coords.metrics", device=True):
            launch("quality")
        launch("row")

    parts = graphs._Parts(pool=None)
    parts.begin()
    with telemetry.cutting(parts.cut):
        body()
    parts.end()
    assert [(name, g.tags) for name, g in parts.parts] == [
        (None, ["draws"]), ("sim.coords.step", ["probe"]), (None, ["ack"]),
        ("sim.coords.step", ["relax"]), (None, []),
        ("sim.coords.metrics", ["quality"]), (None, ["row"])]
    replayed, reg = [], telemetry.Metrics()
    _StandInGraph.log = replayed
    with telemetry.armed(reg):
        parts.replay()
    assert replayed == ["draws", "probe", "ack", "relax", "quality", "row"]
    got = _samples(reg)
    assert got["sim.coords.step"]["Count"] == 2
    assert got["sim.coords.metrics"]["Count"] == 1
    whole = graphs._Parts(pool=None)
    whole.begin()
    with telemetry.cutting(whole.cut):
        launch("all")
    whole.end()
    assert [(name, g.tags) for name, g in whole.parts] == [(None, ["all"])]
    # an error inside a device span leaves the capture where it stands
    broken = graphs._Parts(pool=None)
    broken.begin()
    with pytest.raises(ZeroDivisionError):
        with telemetry.cutting(broken.cut):
            with telemetry.span("sim.coords.step", device=True):
                launch("probe")
                1 / 0
    assert [g.tags for _, g in broken.parts] == [[]]
    assert broken._graph.tags == ["probe"]
    broken.abandon()
    assert broken._graph is None


def _nested(sp) -> bool:
    """Every child lies inside its parent and after its elder sibling."""
    last = sp.start
    for c in sp.children:
        if not (last <= c.start <= c.end <= sp.end) or not _nested(c):
            return False
        last = c.end
    return True


@pytest.mark.parametrize("label", sorted(RUNNERS))
def test_runner_calls_under_the_cpu_profiler(label):
    run = RUNNERS[label](_params())
    _calls(run, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _calls(run, 2)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CPU)
    roots = bspans.tree(host)
    assert [r.name for r in roots] == ["sim.runner.call"] * 2
    for r in roots:
        kids = [c.name for c in r.children]
        assert kids[0] == "sim.runner.prologue", kids
        assert kids[-1] == "sim.runner.epilogue", kids
        assert "sim.graph.call" in kids
        assert set(kids) == {"sim.runner.prologue", "sim.graph.call",
                             "sim.runner.epilogue"}, kids
        assert _nested(r)
        # on the CPU a cache call holds its eager body alone
        assert all(not c.children for c in r.children
                   if c.name == "sim.graph.call")
    # a mark encloses no op
    marks = [(s, e) for s, e, name in host if name.startswith("sim.")]
    assert len(marks) == 2 * sum(1 for r in roots for _ in r.walk())
    ops = [s for s, _, name in host if name.startswith("aten::")]
    assert not any(s < o < e for s, e in marks for o in ops)
    assert telemetry.span("sim.runner.call") is telemetry.OFF


def test_cli_default_mode_samples_each_chunk(monkeypatch):
    reg = telemetry.default
    reg.reset()
    lines = []
    timeline = telemetry.timeline

    @contextlib.contextmanager
    def keep(*a, **k):
        with timeline(*a, **k) as line:
            lines.append(line)
            yield line

    monkeypatch.setattr(telemetry, "timeline", keep)
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["agent", "-dev", "-gossip-sim", "cpu",
                       "-gossip-sim-nodes", str(N)])
    assert rc == 0
    got = _samples(reg)
    line = json.loads(err.getvalue().strip().splitlines()[-1])
    printed = line["span_ms"]
    chunks = cli.SIM_ROUNDS // cli.SIM_CHUNK
    for name in ("sim.runner.call", "sim.runner.prologue",
                 "sim.graph.call", "sim.runner.epilogue"):
        assert got[name]["Count"] == chunks, name
        # the timeline's device fields are null on the CPU
        assert printed[f"consul.{name}"] == {
            **{k: got[name][k] for k in ("Count", "Mean", "Max")},
            "device_ms": None, "wait_ms": None}, name
    assert line["idle_pct"] is None
    # the timeline ran the chunks again on its own, unarmed: the timed
    # run's samples carry none of its cost
    (own,) = lines
    assert own.read()["spans"]["sim.runner.call"]["count"] == chunks
    assert telemetry.span("sim.runner.call") is telemetry.OFF
    assert telemetry._line is None
    reg.reset()


def test_cli_coords_mode_prints_spans_and_counters(monkeypatch):
    """The coordinates mode's span line: the armed trial's samples with
    the device fields (null on the CPU) of a second trial that ran under
    the timeline, unarmed, and the coordinate counters."""
    lines = []
    timeline = telemetry.timeline

    @contextlib.contextmanager
    def keep(*a, **k):
        with timeline(*a, **k) as line:
            lines.append(line)
            yield line

    monkeypatch.setattr(telemetry, "timeline", keep)
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["agent", "-dev", "-gossip-sim", "cpu",
                       "-gossip-sim-nodes", "256", "-gossip-sim-coords"])
    assert rc == 0
    line = json.loads(err.getvalue().strip().splitlines()[-1])
    calls = line["span_ms"]["consul.sim.runner.call"]
    assert calls["device_ms"] is None and calls["wait_ms"] is None
    assert line["idle_pct"] is None
    assert line["counters"]["consul.sim.coords.updates"] > 0
    (own,) = lines
    assert own.read()["spans"]["sim.runner.call"]["count"] == \
        calls["Count"]
    assert telemetry._line is None


#: a 2 x 2 grid of the autotuner's axes
SWEEP_GRID = {"gossip_nodes": (2.0, 4.0), "suspicion_mult": (2.0, 6.0)}
#: graph-cache calls a sweep call makes: a window (stale_k 4) or a round
SWEEP_WINDOWS = {"lanes": ROUNDS // 4, "xla": ROUNDS}


def _sweep(engine: str):
    """(the runner, its grid, the grid's points) of a 4-point sweep."""
    p = _params().with_(stale_k=4 if engine == "lanes" else 1)
    tp, points = grid_params(p, SweepAxes.of(**SWEEP_GRID), CPU)
    return (sweep.make_run_sweep(p, ROUNDS, engine=engine, device=CPU), tp,
            points)


def _report(states, tp, points) -> dict:
    return sweep_report(sweep.SweepResult(
        states=states, trace=None, tp=tp, points=points, rounds=ROUNDS,
        flight_every=None))


@pytest.mark.parametrize("engine", sorted(SWEEP_WINDOWS))
def test_a_sweep_call_and_its_report_under_the_cpu_profiler(engine):
    run, tp, points = _sweep(engine)
    key = prng.key(5, device=CPU)
    run(tp, key)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        states, _ = run(tp, key)
        _report(states, tp, points)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CPU)
    roots = bspans.tree(host)
    assert [r.name for r in roots] == ["sim.runner.call", "sim.sweep.report"]
    call = roots[0]
    kids = [c.name for c in call.children]
    assert kids[0] == "sim.sweep.prologue", kids
    assert kids.count("sim.graph.call") == SWEEP_WINDOWS[engine]
    if engine == "lanes":
        # the lane engine's prologue and epilogue, inside the call
        assert kids[1] == "sim.runner.prologue", kids
        assert kids[-1] == "sim.runner.epilogue", kids
        assert set(kids) == {"sim.sweep.prologue", "sim.runner.prologue",
                             "sim.graph.call", "sim.runner.epilogue"}
    else:
        assert set(kids) == {"sim.sweep.prologue", "sim.graph.call"}
    assert _nested(call) and call.end <= roots[1].start
    assert not roots[1].children
    assert telemetry.span("sim.runner.call") is telemetry.OFF


@pytest.mark.parametrize("engine", sorted(SWEEP_WINDOWS))
def test_an_armed_sweep_samples_its_spans(engine, monkeypatch):
    """Two grid calls, their report and a one-point run land as span
    samples (a call and a prologue each, one report); armed or not, the
    sweep counts nothing."""
    run, tp, points = _sweep(engine)
    key = prng.key(5, device=CPU)
    reg = telemetry.Metrics()
    with telemetry.armed(reg):
        for c in range(2):
            states, _ = run(tp, prng.fold_in(key, c))
        _report(states, tp, points)
        sweep.make_run_point(tp.static, ROUNDS, engine=engine,
                             device=CPU)(point_params(tp, 1), key)
    assert _counters(reg) == {}
    samples = _samples(reg)
    for name, count in (("sim.runner.call", 3), ("sim.sweep.prologue", 3),
                        ("sim.sweep.report", 1)):
        assert samples[name]["Count"] == count, name
    reads = []
    monkeypatch.setattr(telemetry, "count", reads.append)
    run(tp, key)
    assert reads == []


@pytest.mark.cuda
def test_graph_cache_parts_on_the_card(cuda):  # noqa: F811
    cache = graphs.GraphCache()
    x = torch.zeros(1024, device=cuda)
    reg = telemetry.Metrics()

    def body(d, y):
        d[0].add_(y)
        return d[0] * 2

    y = torch.ones(1024, device=cuda)
    with telemetry.armed(reg):
        for _ in range(3):
            out = cache("k", body, (x,), y)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 3.0))
    assert torch.equal(out, torch.full_like(x, 6.0))
    counts = {k: v["Count"] for k, v in _samples(reg).items()}
    assert counts == {"sim.graph.call": 3, "sim.graph.prepare": 3,
                      "sim.graph.eager": 1, "sim.graph.capture": 1,
                      "sim.graph.launch": 2, "sim.graph.finish": 2}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            cache("k", body, (x,), y)
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    assert dev and not [n for n in dev if "sim." in n]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CPU)
    roots = bspans.tree(host)
    assert [r.name for r in roots] == ["sim.graph.call"] * 3
    assert all([c.name for c in r.children] == [
        "sim.graph.prepare", "sim.graph.launch", "sim.graph.finish"]
        for r in roots)


@pytest.mark.cuda
def test_a_device_span_is_annotated_on_the_card(cuda):  # noqa: F811
    """``span(name, device=True)`` held open across its launches: the
    profiler gives its device time an event named after it, which
    holds the launches' operations, while a plain span's marks get
    none."""
    x = torch.randn(1 << 20, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with telemetry.span("sim.runner.call"):
            with telemetry.span("sim.coords.step", device=True):
                y = (x * 2).sum()
            z = y + 1
        torch.cuda.synchronize()
    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [(s, e) for s, e, n in dev if n == "sim.coords.step"]
    assert len(marks) == 1 and float(z) == float(y) + 1
    ops = [(s, e) for s, e, n in dev if not n.startswith("sim.")]
    inside = [o for o in ops if marks[0][0] <= o[0] <= o[1] <= marks[0][1]]
    assert len(inside) >= 2 and len(inside) < len(ops)
    assert not [n for _, _, n in dev if n.startswith("sim.runner")]


@pytest.mark.cuda
def test_a_replayed_device_span_is_annotated_on_the_card(cuda):  # noqa: F811
    """A ``GraphCache`` body with a device span, replayed: the profiler
    gives the span's part an event named after it that holds its
    operations and no other, as an eager call's span gets. Unprofiled,
    a replay launches the one graph, with the same carry and outputs."""
    cache = graphs.GraphCache()
    x0 = torch.randn(1 << 20, device=cuda)

    def body(d):
        y = d[0] * 3
        with telemetry.span("sim.coords.step", device=True):
            # an integer scan: a float one on the card may add in
            # another order from one launch to the next
            z = (y.sin() * y * 64).to(torch.int32).cumsum(0)
        d[0].copy_(z / z.abs().max())
        return z[-1] + 1

    for _ in range(2):
        cache("k", body, (x0.clone(),))
    x = x0.clone()
    whole = cache("k", body, (x,))
    torch.cuda.synchronize()
    by_parts = x0.clone()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = cache("k", body, (by_parts,))
        torch.cuda.synchronize()
    assert [e["parts"] for e in cache.stats()] == [3]
    assert torch.equal(by_parts, x) and torch.equal(out, whole)
    host = [e.name for e in prof.events()
            if e.device_type == DeviceType.CPU]
    assert host.count("cudaGraphLaunch") == 3
    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [(s, e) for s, e, n in dev if n == "sim.coords.step"]
    assert len(marks) == 1
    ops = [(s, e, n) for s, e, n in dev if not n.startswith("sim.")]
    inside = [n for s, e, n in ops if marks[0][0] <= s <= e <= marks[0][1]]
    assert any("sin" in n for n in inside)
    assert any("Scan" in n for n in inside)
    assert not [n for n in inside if "reduce" in n]
    assert len(inside) < len(ops)


def _coords_flight(dev, n: int, rounds: int):
    from consul_tpu_torch.sim import coords, scenarios

    su = scenarios.coords_setup(n, device=dev)
    return tround.run_rounds_flight(
        init_state(n, device=dev), prng.key(9, device=dev), su.p, rounds,
        plan=su.cp, coords=coords.init_coords(n, device=dev), topo=su.topo)


def _counters(m: telemetry.Metrics) -> dict:
    return {x["Name"]: x["Count"] for x in m.snapshot()["Counters"]}


def test_an_armed_coordinates_run_publishes_its_kernel_launches():
    """``sim.coords.kernel_launches`` rides the coordinate counters, once
    a call: 0 on the CPU, where the plain versions run."""
    m = telemetry.Metrics()
    with telemetry.armed(m):
        _coords_flight(torch.device("cpu"), 128, 3)
    got = _counters(m)
    assert tround.COORD_COUNTERS[-1] == "sim.coords.kernel_launches"
    assert got["consul.sim.coords.kernel_launches"] == 0.0
    assert got["consul.sim.coords.updates"] > 0


@pytest.mark.cuda
def test_the_coordinate_kernels_fall_under_their_spans(cuda):  # noqa: F811
    """On the card each period's ``coord_probe`` and ``vivaldi_relax``
    fall under a ``sim.coords.step`` annotation and its
    ``coord_quality`` under ``sim.coords.metrics``, with no ATen row or
    element gather under either; an armed run counts three launches a
    recorded period."""
    n, rounds = 4096, 3
    _coords_flight(cuda, n, rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _coords_flight(cuda, n, rounds)
        torch.cuda.synchronize()
    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {k: [(s, e) for s, e, name in dev if name == k]
             for k in ("sim.coords.step", "sim.coords.metrics")}
    assert [len(v) for v in spans.values()] == [2 * rounds, rounds]

    def under(k):
        return [name for s, e, name in dev if not name.startswith("sim.")
                and any(a <= s <= e <= b for a, b in spans[k])]

    step, metrics = under("sim.coords.step"), under("sim.coords.metrics")
    assert sum("coord_probe" in x for x in step) == rounds
    assert sum("vivaldi_relax" in x for x in step) == rounds
    assert sum("coord_quality" in x for x in metrics) == rounds
    assert not [x for x in step + metrics
                if "gather" in x or "index_elementwise" in x]
    m = telemetry.Metrics()
    with telemetry.armed(m):
        _coords_flight(cuda, n, rounds)
    assert _counters(m)["consul.sim.coords.kernel_launches"] == 3 * rounds
