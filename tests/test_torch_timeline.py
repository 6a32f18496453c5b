"""The spans on the device's clock (``utils/telemetry.py``: ``timeline``,
``Timeline``, ``account``, ``copying``).

* ``account`` on synthetic markers with a fake clock: one call holds an
  eager prologue, a ``GraphCache`` call's stretches that launch
  nothing, a copy group and a replay; busy, ``eager_us`` and the three
  waits sum to the extent exactly, the gap between two calls lands in
  ``caller``, a drained replay's open charges only its launch's host
  time, a copy group is busy for its bytes, and each span and call gets
  its host and device time; the reading goes by the stretch each span
  declares (``span(name, stretch=...)``), never by its name.
* With nobody listening ``span`` and ``copying`` are the shared ``OFF``
  and no marker is recorded; on the CPU a timeline records host times
  only (its device fields None), one at a time, on its own thread.
* On the card (``cuda``): nothing is recorded inside a capture, and a
  replayed ``GraphCache`` call's reading adds up.
"""

from __future__ import annotations

import threading

import pytest
import torch

from consul_tpu_torch.sim import cuda_round, graphs, prng
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import SimState, init_state
from consul_tpu_torch.utils import telemetry
from consul_tpu_torch.sim.graphs import COPIES
from consul_tpu_torch.utils.telemetry import (CLOSE_MARK, COPY, EAGER, GRAPH,
                                              OPEN_MARK, QUIET, REPLAY)
from test_torch_harness import cuda  # noqa: F401  (fixture)

CPU = torch.device("cpu")
N = 1024
ROUNDS = 8
LAM = 5.0
RATE = 10.0  # bytes a ns

#: (host ns, kind, name, bytes, device ns): one call: an eager prologue
#: the device falls behind in, a GraphCache call (its key, a copy group
#: of 500 bytes, a replay whose open the stream had drained at), an
#: epilogue
CALL = [
    (100, OPEN_MARK, "sim.runner.call", 0, 102),
    (110, OPEN_MARK, "sim.runner.prologue", 0, 112),
    (150, CLOSE_MARK, "sim.runner.prologue", 0, 300),
    (160, OPEN_MARK, "sim.graph.call", 0, 301),
    (170, OPEN_MARK, "sim.graph.prepare", 0, 302),
    (400, OPEN_MARK, COPIES, 500, 402),
    (500, CLOSE_MARK, COPIES, 500, 502),
    (510, CLOSE_MARK, "sim.graph.prepare", 0, 512),
    (520, OPEN_MARK, "sim.graph.launch", 0, 524),
    (540, CLOSE_MARK, "sim.graph.launch", 0, 1000),
    (550, OPEN_MARK, "sim.graph.finish", 0, 1001),
    (560, CLOSE_MARK, "sim.graph.finish", 0, 1002),
    (570, CLOSE_MARK, "sim.graph.call", 0, 1003),
    (580, OPEN_MARK, "sim.runner.epilogue", 0, 1004),
    (590, CLOSE_MARK, "sim.runner.epilogue", 0, 1005),
    (1100, CLOSE_MARK, "sim.runner.call", 0, 1102),
]


#: the stretches ``GraphCache`` declares for its spans and copy groups;
#: every other span is ``EAGER``
STRETCH = {"sim.graph.call": GRAPH, "sim.graph.prepare": QUIET,
           "sim.graph.finish": QUIET, "sim.graph.launch": REPLAY,
           COPIES: COPY}


def _marks(rows, stretch=STRETCH):
    return [(t, k, n, b, stretch.get(n, EAGER)) for t, k, n, b, _ in rows]


def _account(rows, lam=LAM, rate=RATE, stretch=STRETCH):
    return telemetry.account(_marks(rows, stretch), [r[4] for r in rows],
                             lam, rate)


def _params() -> SimParams:
    return SimParams(n=N, loss=0.01, fail_per_round=1e-3,
                     rejoin_per_round=1e-2)


def _calls(run, calls: int, dev=CPU):
    state, key = init_state(N, device=dev), prng.key(5, device=dev)
    for c in range(calls):
        res = run(state, prng.fold_in(key, c))
        state = res if isinstance(res, SimState) else res[0]
    return state


def test_the_stretches_sum_to_the_extent_exactly():
    r = _account(CALL)
    w = r["wait_us"]
    assert r["extent_us"] == pytest.approx(1.0, abs=1e-12)
    total = r["busy_us"] + r["eager_us"] + sum(w.values()) + r["self_us"]
    assert total == pytest.approx(r["extent_us"], abs=1e-12)
    assert r["self_us"] == 0.0
    # no caller's gap in one call; the prologue's open
    assert w["caller"] == 0.0
    assert w["runner"] == pytest.approx(0.010, abs=1e-12)
    # the key's stretches, the copies past their bytes, the launch's
    # host time
    assert w["graph"] == pytest.approx(0.196, abs=1e-12)
    # the copies' 500 bytes at 10 a ns, the replay less its launch
    assert r["busy_us"] == pytest.approx(0.050 + 0.456, abs=1e-12)
    # the prologue the device fell behind in, and what follows it
    # until a drained marker
    assert r["eager_us"] == pytest.approx(0.288, abs=1e-12)
    assert r["markers"] == len(CALL)


def test_a_drained_replay_charges_only_its_launch_host_time():
    r = _account(CALL)
    launch = r["spans"]["sim.graph.launch"]
    assert launch["host_us"] == pytest.approx(0.020, abs=1e-12)
    assert launch["wait_us"] == pytest.approx(0.020, abs=1e-12)
    assert launch["device_us"] == pytest.approx(0.476, abs=1e-12)
    # an open the device reached past λ charges the launch's host time
    # after that (10 of 20 ns); one it reached after the launch returned,
    # nothing
    late = [row if row[2] != "sim.graph.launch" or row[1] != OPEN_MARK
            else (520, OPEN_MARK, "sim.graph.launch", 0, 530)
            for row in CALL]
    assert _account(late)["spans"]["sim.graph.launch"]["wait_us"] == \
        pytest.approx(0.010, abs=1e-12)
    later = [row if row[2] != "sim.graph.launch" or row[1] != OPEN_MARK
             else (520, OPEN_MARK, "sim.graph.launch", 0, 560)
             for row in CALL]
    assert _account(later)["spans"]["sim.graph.launch"]["wait_us"] == 0.0


def test_a_caller_gap_lands_in_caller():
    # a second call 300 ns after the first, both ends drained: all of
    # the gap in caller
    second = [(t + 1300, k, n, b, d + 1300) for t, k, n, b, d in CALL]
    r = _account(CALL + second)
    assert r["wait_us"]["caller"] == pytest.approx(0.3, abs=1e-12)
    assert len(r["calls"]) == 2


def test_a_copy_group_is_busy_for_its_bytes_then_waits():
    r = _account(CALL)
    copies = r["spans"][COPIES]
    assert copies == {"count": 1, "host_us": pytest.approx(0.1),
                      "device_us": pytest.approx(0.1),
                      "wait_us": pytest.approx(0.05)}
    # a close the device reached late: the whole group busy
    slow = [row if row[2] != COPIES or row[1] != CLOSE_MARK
            else (500, CLOSE_MARK, COPIES, 500, 511) for row in CALL]
    assert _account(slow)["spans"][COPIES]["wait_us"] == 0.0


def test_each_span_and_call_gets_its_host_and_device_time():
    r = _account(CALL)
    pro = r["spans"]["sim.runner.prologue"]
    assert (pro["count"], pro["host_us"], pro["device_us"]) == \
        (1, pytest.approx(0.040), pytest.approx(0.188))
    assert r["replays"] == {"count": 1, "host_us": pytest.approx(0.410),
                            "device_us": pytest.approx(0.702)}
    (call,) = r["calls"]
    assert call["name"] == "sim.runner.call"
    assert call["host_us"] == pytest.approx(1.0)
    assert call["device_us"] == pytest.approx(1.0)
    assert call["busy_us"] == pytest.approx(0.506)
    assert call["wait_us"] == pytest.approx(0.01 + 0.196)


def test_the_timelines_own_host_time_leaves_the_waits():
    # 3 ns of the timeline's own before each marker's time, 2 after:
    # 5 ns inside each stretch, taken from its wait where it has one
    r = telemetry.account(_marks(CALL), [row[4] for row in CALL],
                          LAM, RATE, [(3, 2)] * len(CALL))
    total = r["busy_us"] + r["eager_us"] + sum(r["wait_us"].values()) \
        + r["self_us"]
    assert total == pytest.approx(r["extent_us"], abs=1e-12)
    # ten stretches wait, three of them 1 ns; the prologue's open waits
    # 10 ns, 5 of them on the timeline
    assert r["self_us"] == pytest.approx(0.034, abs=1e-12)
    assert r["wait_us"]["runner"] == pytest.approx(0.005, abs=1e-12)
    assert r["wait_us"]["graph"] == pytest.approx(0.196 - 0.029,
                                                  abs=1e-12)
    # a span's host time is net of the timeline's inside it (the
    # call holds fifteen stretches)
    assert r["spans"]["sim.runner.prologue"]["host_us"] == \
        pytest.approx(0.035, abs=1e-12)
    assert r["calls"][0]["host_us"] == pytest.approx(1.0 - 0.075,
                                                     abs=1e-12)


def test_the_reading_goes_by_the_declared_stretch_not_the_name():
    # every span renamed, each keeping its stretch: the same reading
    names = {n: f"span{i}" for i, n in enumerate(dict.fromkeys(
        row[2] for row in CALL))}
    renamed = [(t, k, names[n], b, d) for t, k, n, b, d in CALL]
    stretch = {names[n]: s for n, s in STRETCH.items()}
    r, same = _account(CALL), _account(renamed, stretch=stretch)
    for k in ("busy_us", "eager_us", "self_us", "wait_us", "replays"):
        assert same[k] == r[k], k
    # the key's stretches declared eager: no longer all wait
    eager = _account(CALL, stretch={**STRETCH, "sim.graph.prepare": EAGER})
    assert eager["wait_us"]["graph"] < r["wait_us"]["graph"]


def test_a_span_records_the_stretch_it_declares():
    with telemetry.timeline(CPU) as line:
        with telemetry.span("sim.graph.prepare", stretch=QUIET):
            with telemetry.copying(COPIES, 64):
                pass
        with telemetry.span("sim.runner.epilogue"):
            pass
        _calls(cuda_round.make_run_rounds_cuda(_params(), ROUNDS), 1)
    assert [m[1:] for m in line.marks[:6]] == [
        (OPEN_MARK, "sim.graph.prepare", 0, QUIET),
        (OPEN_MARK, COPIES, 64, COPY), (CLOSE_MARK, COPIES, 64, COPY),
        (CLOSE_MARK, "sim.graph.prepare", 0, QUIET),
        (OPEN_MARK, "sim.runner.epilogue", 0, EAGER),
        (CLOSE_MARK, "sim.runner.epilogue", 0, EAGER)]
    # the runner's cache call declares itself a graph call
    assert {m[4] for m in line.marks if m[2] == "sim.graph.call"} == {GRAPH}


def test_a_quiet_marker_is_reached_after_the_one_before():
    # no event: the host's record plus the latency, or the marker
    # before it where the device is behind
    assert telemetry.infer([0, 10, 20, 30, 40], [3, None, 100, None, None],
                           2.0) == [3, 12, 100, 100, 100]
    assert telemetry.infer([0, 10, 200], [3, None, None], 2.0) == \
        [3, 12, 202]


def test_host_times_alone_leave_every_device_field_none():
    r = telemetry.account(_marks(CALL), None)
    assert r["extent_us"] is r["busy_us"] is r["eager_us"] is None
    assert set(r["wait_us"].values()) == {None}
    assert r["spans"]["sim.runner.prologue"]["host_us"] == \
        pytest.approx(0.040)
    assert r["spans"]["sim.runner.prologue"]["device_us"] is None
    assert r["calls"][0]["host_us"] == pytest.approx(1.0)


def test_a_body_run_inside_its_graph_call_is_eager():
    # on the CPU or in graphs.eager() the body launches inside the
    # sim.graph.call itself: undecided, not a wait
    rows = [(0, OPEN_MARK, "sim.graph.call", 0, 1),
            (100, CLOSE_MARK, "sim.graph.call", 0, 400)]
    r = _account(rows)
    assert r["eager_us"] == pytest.approx(0.399) and r["busy_us"] == 0.0


def test_nothing_is_recorded_without_a_listener(monkeypatch):
    assert telemetry.span("sim.runner.call") is telemetry.OFF
    assert telemetry.copying(COPIES, 1024) is telemetry.OFF
    assert telemetry._line is None

    def refuse(*a, **k):
        raise AssertionError("a marker was recorded with no listener")

    monkeypatch.setattr(telemetry.Timeline, "mark", refuse)
    _calls(cuda_round.make_run_rounds_cuda(_params(), ROUNDS), 2)
    _calls(tround.make_run_rounds(_params(), ROUNDS), 2)


def test_a_cpu_timeline_records_host_times_only():
    run = cuda_round.make_run_rounds_cuda(_params(), ROUNDS)
    with telemetry.timeline(CPU) as line:
        assert telemetry.span("sim.runner.call") is not telemetry.OFF
        _calls(run, 3)
    assert telemetry.span("sim.runner.call") is telemetry.OFF
    r = line.read()
    assert r["extent_us"] is None and r["overflow"] == 0
    assert len(r["calls"]) == 3 and r["calls"][0]["device_us"] is None
    for name in ("sim.runner.call", "sim.runner.prologue",
                 "sim.graph.call", "sim.runner.epilogue"):
        assert r["spans"][name]["count"] == 3, name
        assert r["spans"][name]["host_us"] > 0, name
    # the CPU runs a cache call's body: no replay, no copy group
    assert r["replays"]["count"] == 0 and COPIES not in r["spans"]
    # one marker a span's open and close
    assert r["markers"] == 2 * sum(s["count"] for s in r["spans"].values())


def test_one_timeline_at_a_time_on_its_own_thread():
    with telemetry.timeline() as line:
        with pytest.raises(RuntimeError):
            with telemetry.timeline():
                pass
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            line.mark(OPEN_MARK, "sim.runner.call")))
        t.start()
        t.join()
        assert seen == [False] and line.marks == []
        with telemetry.span("sim.runner.call"):
            pass
    assert len(line.marks) == 2
    # a closed timeline records nothing more
    assert not line.mark(OPEN_MARK, "sim.runner.call")


@pytest.mark.cuda
def test_no_marker_inside_a_capture(cuda):  # noqa: F811
    """A body's own span records markers on its eager call and none on
    its capture; a replay holds its copy groups and its launch."""
    cache = graphs.GraphCache()
    x = torch.zeros(1 << 20, device=cuda)
    y = torch.ones(1 << 20, device=cuda)

    def body(d, z):
        with telemetry.span("sim.runner.prologue"):
            d[0].add_(z)
        return d[0] * 2

    names = []
    with telemetry.timeline(cuda) as line:
        for _ in range(3):
            before = len(line.marks)
            cache("k", body, (x,), y)
            names.append([m[2] for m in line.marks[before:]])
        side = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        before = len(line.marks)
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph, stream=side):
                with telemetry.span("sim.runner.epilogue"):
                    y.mul_(1.0)
        assert len(line.marks) == before
        torch.cuda.synchronize()
    eager, capture, replay = names
    assert eager.count("sim.runner.prologue") == 2
    assert "sim.runner.prologue" not in capture
    assert "sim.graph.capture" in capture
    assert "sim.runner.prologue" not in replay
    assert replay.count(COPIES) == 6 and replay.count("sim.graph.launch") == 2
    r = line.read()
    assert r["overflow"] == 0 and r["lambda_us"] > 0
    assert r["dtod_bytes_per_us"] > 0
    total = r["busy_us"] + r["eager_us"] + sum(r["wait_us"].values()) \
        + r["self_us"]
    assert total == pytest.approx(r["extent_us"], rel=1e-9)
    # the capture call replays too, once captured
    assert r["replays"]["count"] == 2
    assert all(s["device_us"] >= 0 for s in r["spans"].values())
    assert torch.equal(x, torch.full_like(x, 3.0))


@pytest.mark.cuda
def test_a_full_pool_leaves_the_device_fields_none(cuda):  # noqa: F811
    with telemetry.timeline(cuda, events=4) as line:
        for _ in range(3):
            with telemetry.span("sim.runner.call"):
                pass
    r = line.read()
    assert r["overflow"] == 2 and r["extent_us"] is None
    assert r["spans"]["sim.runner.call"]["count"] == 3
