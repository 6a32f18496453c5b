"""The span helper (``spans.py``) and its ten readers: the marks paired
into trees, the idle split on synthetic traces, the host ops, the parts'
host time and the set-up calls, the readers' silence where the program
has no spans, a traced CPU run of every cell, and on the card a traced
run of every cell."""

import pytest

from gossipbench import harness, spans, trace

CELLS = ("lan-1m.long", "wan-1m-churn5.live", "lan-1m.chunked",
         "wan-1m-churn5.lanes")
METRICS = ("idle_in_graph_pct", "idle_in_runner_pct", "idle_in_caller_pct",
           "graph_host_us_per_replay", "host_ops_per_round",
           "runner_prologue_us_per_call", "runner_epilogue_us_per_call",
           "graph_prepare_us_per_replay", "graph_finish_us_per_replay",
           "graph_builds_in_window")
#: what a traced CPU run cannot read: no device event, no replay
NO_CPU = ("idle_in_graph_pct", "idle_in_runner_pct", "idle_in_caller_pct",
          "graph_host_us_per_replay", "graph_prepare_us_per_replay",
          "graph_finish_us_per_replay")


def _marks(name, s, e):
    """A span's two marks: it runs from ``s`` to ``e``."""
    return [(s - 1, s, f"{name}:b"), (e, e + 1, f"{name}:e")]


def _call(t0):
    """One runner call at ``t0``: prologue 10-20, a replayed cache call
    30-90 (prepare 32-40, launch 50-60, finish 70-88), epilogue 100-110,
    the call 0-120 (all after ``t0``; in a trace no two marks start at
    once)."""
    host = []
    for name, s, e in (("sim.runner.call", 0, 120),
                       ("sim.runner.prologue", 10, 20),
                       ("sim.graph.call", 30, 90),
                       ("sim.graph.prepare", 32, 40),
                       ("sim.graph.launch", 50, 60),
                       ("sim.graph.finish", 70, 88),
                       ("sim.runner.epilogue", 100, 110)):
        host += _marks(name, t0 + s, t0 + e)
    return host


class Ctx:
    def __init__(self, dev, host, rounds=1):
        self.dev, self.host = sorted(dev), sorted(host)
        self.traced_rounds = rounds


def test_marks_pair_into_one_tree_a_call():
    host = _call(0) + _call(200) + [(5, 6, "aten::add"),
                                    (400, 401, "sim.graph.call:e"),
                                    (500, 501, "sim.graph.call:b")]
    roots = spans.tree(sorted(host))
    assert [r.name for r in roots] == ["sim.runner.call"] * 2
    r = roots[1]
    assert (r.start, r.end) == (200, 320)
    assert [c.name for c in r.children] == [
        "sim.runner.prologue", "sim.graph.call", "sim.runner.epilogue"]
    assert [c.name for c in r.children[1].children] == [
        "sim.graph.prepare", "sim.graph.launch", "sim.graph.finish"]


def test_idle_shares_partition_the_extent_idle_exactly():
    host = _call(0) + _call(200) + [(-50, -40, "aten::fill_")]
    # busy 0-45, 52-58, 120-150, 205-300; the extent runs -50 to 321
    dev = [(0, 45, "k"), (52, 58, "k"), (120, 150, "k"), (205, 300, "k")]
    ctx = Ctx(dev, host)
    r = spans.reading(ctx)["idle"]
    assert r["extent_us"] == 371
    assert r["idle_us"] == 371 - (45 + 6 + 30 + 95)
    assert r["graph_us"] + r["runner_us"] + r["caller_us"] == r["idle_us"]
    # idle in the graph call: 45-50 prepare's end to launch, 50-52 and
    # 58-60 in the launch, 60-90 finish; in the second call's 230-290
    # nothing
    assert r["graph_us"] == 5 + 2 + 2 + 30
    # the first call's 90-120, the second's 200-205 and 300-320
    assert r["runner_us"] == 30 + 5 + 20
    # before the first call (-50 to 0), between calls (150-200) and
    # after the last (320-321)
    assert r["caller_us"] == 50 + 50 + 1
    total = sum(harness.load_module("metrics", f"idle_in_{p}_pct").read(ctx)
                for p in ("graph", "runner", "caller"))
    assert total == pytest.approx(100.0 * r["idle_us"] / r["extent_us"],
                                  abs=1e-9)


def test_a_gap_in_a_launch_is_graph_and_outside_every_span_caller():
    # the extent starts at the first call's begin mark, at -1
    ctx = Ctx([(-1, 52, "k"), (58, 400, "k")], _call(0))
    r = spans.reading(ctx)["idle"]
    assert (r["graph_us"], r["runner_us"], r["caller_us"]) == (6, 0, 0)
    ctx = Ctx([(-1, 120, "k"), (130, 140, "k")], _call(0))
    r = spans.reading(ctx)["idle"]
    assert (r["graph_us"], r["runner_us"], r["caller_us"]) == (0, 0, 10)
    ctx = Ctx([(-1, 12, "k"), (18, 140, "k")], _call(0))
    r = spans.reading(ctx)["idle"]
    assert (r["graph_us"], r["runner_us"], r["caller_us"]) == (0, 6, 0)


def test_host_ops_count_the_outermost_outside_a_launch():
    host = _call(0) + [
        (12, 18, "aten::to"), (13, 17, "aten::_to_copy"),    # 1, nested 0
        (32, 38, "aten::copy_"),                             # prepare: 1
        (52, 55, "aten::copy_"),                             # launch: 0
        (72, 80, "aten::clone"), (73, 79, "aten::copy_"),    # finish: 1
        (95, 97, "cudaLaunchKernel"),                        # not aten
        (130, 135, "aten::cat")]                             # caller: 0
    ctx = Ctx([(0, 200, "k")], host, rounds=2)
    assert spans.reading(ctx)["host_ops_per_round"] == 3 / 2
    assert harness.load_module("metrics", "host_ops_per_round").read(ctx) \
        == 1.5
    assert harness.load_module(
        "metrics", "graph_host_us_per_replay").read(ctx) == 60


@pytest.mark.parametrize("metric", METRICS)
def test_readers_are_silent_without_spans(metric):
    dev = [(0, 10, "k"), (20, 30, "k")]
    host = [(0, 5, "aten::add"), (15, 16, "cudaLaunchKernel")]
    read = harness.load_module("metrics", metric).read
    assert read(Ctx(dev, host, rounds=4)) is None
    # spans, but no device event (the CPU's)
    cpu = Ctx([], _call(0), rounds=4)
    want = {"graph_host_us_per_replay": 60, "host_ops_per_round": 0.0,
            "runner_prologue_us_per_call": 10,
            "runner_epilogue_us_per_call": 10,
            "graph_prepare_us_per_replay": 8,
            "graph_finish_us_per_replay": 18, "graph_builds_in_window": 0}
    assert read(cpu) == want.get(metric)


def test_parts_sum_a_call_and_average_over_replays():
    # a lane-engine call: its own prologue and the scan's, and the
    # scan's epilogue and its own, around a replay (30-90) and a key's
    # first call (130-150) and its capture (160-190); a second call
    # replays once
    host = []
    for name, s, e in (("sim.runner.call", 0, 210),
                       ("sim.runner.prologue", 2, 6),
                       ("sim.runner.prologue", 10, 20),
                       ("sim.graph.call", 30, 90),
                       ("sim.graph.prepare", 32, 40),
                       ("sim.graph.launch", 50, 60),
                       ("sim.graph.finish", 70, 88),
                       ("sim.graph.call", 128, 152),
                       ("sim.graph.prepare", 129, 131),
                       ("sim.graph.eager", 133, 150),
                       ("sim.graph.call", 158, 192),
                       ("sim.graph.prepare", 159, 161),
                       ("sim.graph.capture", 163, 190),
                       ("sim.runner.epilogue", 195, 200),
                       ("sim.runner.epilogue", 202, 208)):
        host += _marks(name, s, e)
    host += _call(300)
    ctx = Ctx([(0, 400, "k")], host, rounds=2)
    r = spans.reading(ctx)
    assert r["prologue_us_per_call"] == (4 + 10 + 10) / 2
    assert r["epilogue_us_per_call"] == (5 + 6 + 10) / 2
    # the eager call and the capture are no replay
    assert r["prepare_us_per_replay"] == 8
    assert r["finish_us_per_replay"] == 18
    assert r["graph_us_per_replay"] == 60
    read = harness.load_module("metrics", "graph_builds_in_window").read
    assert read(ctx) == 2
    assert read(Ctx([(0, 400, "k")], _call(0) + _call(300))) == 0


def _short(monkeypatch):
    """The cell's traffic in calls of at most 16 periods, two traced
    after the first (the files' traced stretches and 512-period calls
    take minutes on the CPU)."""
    load = harness.load_json

    def short(kind, name):
        d = load(kind, name)
        if kind == "traffic":
            d.update(rounds=min(d["rounds"], 16), trace_after=1,
                     trace_calls=2)
        return d

    monkeypatch.setattr(harness, "load_json", short)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reports_host_ops(cell, monkeypatch):
    _short(monkeypatch)
    res, _ = harness.run_cell(cell, 2 ** 31 + 29, 0.01, True, device="cpu",
                              n=1024)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["host_ops_per_round"]["value"] > 0
    assert got["host_ops_per_round"]["unit"] == "ops/period"
    assert got["runner_prologue_us_per_call"]["value"] > 0
    assert got["runner_epilogue_us_per_call"]["value"] > 0
    # on the CPU a cache call runs its body: no set-up call is seen
    assert got["graph_builds_in_window"]["value"] == 0
    # the CPU has no device events and no replays
    assert not set(got) & set(NO_CPU)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card(card, cell, monkeypatch):
    seen = {}
    events, split = trace.events, spans.idle_split

    def keep_events(prof):
        seen["dev"], host = events(prof)
        return seen["dev"], host

    def keep_split(*a):
        seen["split"] = split(*a)
        return seen["split"]

    monkeypatch.setattr(trace, "events", keep_events)
    monkeypatch.setattr(spans, "idle_split", keep_split)
    res, _ = harness.run_cell(cell, 2 ** 31 + 31, 1.0, True)
    assert res["correct"], res["checks"]
    assert seen["dev"] and not [n for _, _, n in seen["dev"]
                                if n.startswith("sim.")]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(METRICS) <= set(got), sorted(got)
    assert got["graph_builds_in_window"] == 0
    assert got["graph_prepare_us_per_replay"] \
        + got["graph_finish_us_per_replay"] \
        < got["graph_host_us_per_replay"]
    r = seen["split"]
    idle = 100.0 * r["idle_us"] / r["extent_us"]
    assert abs(sum(got[m] for m in METRICS[:3]) - idle) < 0.1
    assert abs(idle - got["device_idle_pct"]) < 5.0
