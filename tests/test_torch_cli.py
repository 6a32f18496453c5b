"""consul_tpu_torch's command line (cli.py), flight publisher, debug
trace capture and graft entry against the JAX reference's, on the CPU.

* ``agent -dev -gossip-sim cpu -gossip-sim-nodes 4096`` in this process
  against the reference's ``_run_gossip_sim`` on its own dev config: the
  same report keys, no false positive on either side, suspicions and
  refutes per node-round within 0.85-1.15x (both sides report none in
  this configuration: TCP fallback on, no slow nodes, so the band is
  checked only where the reference counted some), and the telemetry
  registry's ``sim.*`` totals and ``sim.fd.*`` gauges equal to the
  report.
* The structured errors (unknown platform, ``tpu``, unknown chaos
  class, bad sweep suffix, ``gpu`` with no card) give exit code 1 and
  one JSON line; the watchdog ends a run past its deadline the same way.
* Chaos, coords and sweep modes at small n: the reference's report keys,
  phase names and ``sim.sweep.*`` gauges, and ``coords_publish_error``
  on both sides (the reference's dev agent made unavailable).
* ``FlightPublisher`` and ``publish_report`` put the same values into
  the reference's ``telemetry.Metrics`` and the port's copy.
* ``capture_flight_trace(64, 20)``: columns equal, counter columns and
  the black-box report exact, the f32 gauge columns within 64 ulp (plus
  1e-6, the rows' 6-decimal rounding).
* ``graft_entry.entry()``'s round against the reference's ``entry()``:
  int lanes exact, ``informed`` within 64 ulp.
* A rehearsal of ``chip_smoke.py``'s ``seams`` phase at small sizes.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from consul_tpu_torch import cli, graft_entry
from consul_tpu_torch.sim import flight, twin
from consul_tpu_torch.sim.metrics import fd_report
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import STATS_FIELDS, from_numpy, init_state
from consul_tpu_torch.utils import telemetry
from test_torch_harness import ROOT, ref  # noqa: F401  (fixture)

CPU = torch.device("cpu")
N = 4096
FD_BAND = (0.85, 1.15)
ULPS = 64


def _split(text: str) -> dict:
    """A report printed after its ``==>`` header line, or an error line."""
    if text.startswith("==>"):
        text = text.split("\n", 1)[1]
    return json.loads(text)


def _port(argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _ref_run(overrides: dict) -> tuple:
    from consul_tpu import cli as rcli
    from consul_tpu import config as rconfig

    cfg = rconfig.load(dev=True, overrides={"gossip_sim": "cpu",
                                            **overrides})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = rcli._run_gossip_sim(cfg)
    return rc, _split(buf.getvalue())


def _argv(*extra) -> list:
    return ["agent", "-dev", "-gossip-sim", "cpu", *extra]


@pytest.fixture(scope="module")
def ref_default(ref):  # noqa: F811
    rc, rep = _ref_run({"gossip_sim_nodes": N})
    assert rc == 0
    return rep


@pytest.fixture
def no_ref_agent(ref, monkeypatch):  # noqa: F811
    """The reference's dev agent made unavailable, as on a host where
    it cannot start: its coords publish records the error."""
    import consul_tpu.agent as ragent

    def unavailable(*a, **kw):
        raise RuntimeError("no dev agent in this test")

    monkeypatch.setattr(ragent, "Agent", unavailable)


# --------------------------------------------------------- default mode


def _rates(rep: dict) -> dict:
    node_rounds = rep["n"] * rep["rounds"]
    return {k: rep[k] / node_rounds for k in ("suspicions", "refutes")}


def test_default_mode_matches_the_reference(ref_default):
    telemetry.default.reset()
    rc, text = _port(_argv("-gossip-sim-nodes", str(N)))
    assert rc == 0 and text.startswith("==> gossip-sim=cpu: 4096 virtual")
    rep = _split(text)
    assert sorted(rep) == sorted(ref_default)
    assert rep["rounds"] == ref_default["rounds"] == cli.SIM_ROUNDS
    assert rep["false_positives"] == ref_default["false_positives"] == 0
    mine, theirs = _rates(rep), _rates(ref_default)
    for k, v in theirs.items():
        if v:
            assert FD_BAND[0] <= mine[k] / v <= FD_BAND[1], (k, mine, theirs)
        else:
            assert mine[k] == 0, (k, mine)
    assert rep["live_fraction"] == ref_default["live_fraction"] == 1.0
    snap = telemetry.default.snapshot()
    counters = {c["Name"]: c["Count"] for c in snap["Counters"]}
    gauges = {g["Name"]: g["Value"] for g in snap["Gauges"]}
    for k in ("false_positives", "refutes", "suspicions",
              "true_deaths_declared", "crashes", "rejoins", "leaves"):
        assert counters.get(f"consul.sim.{k}", 0.0) == rep[k], k
    for k, v in rep.items():
        if k != "rounds_per_sec":
            assert gauges[f"consul.sim.fd.{k}"] == float(v), k
    assert gauges["consul.sim.live_frac"] == 1.0


def test_flag_spellings_and_the_module_entry():
    rc, text = _port(["agent", "-dev", "-gossip-sim=cpu",
                      "-gossip-sim-nodes=256", "-server", "-node", "x",
                      "-http-port", "8500"])
    assert rc == 0 and _split(text)["n"] == 256
    assert _port(["agent", "-dev"]) == (2, "")
    out = subprocess.run(
        [sys.executable, "-m", "consul_tpu_torch.cli", "agent", "-dev",
         "-gossip-sim", "cpu", "-gossip-sim-nodes", "64"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert _split(out.stdout)["n"] == 64


# ----------------------------------------------------------- the errors


@pytest.mark.parametrize("argv,platform", [
    (["agent", "-dev", "-gossip-sim", "quantum"], "quantum"),
    (["agent", "-dev", "-gossip-sim", "tpu"], "tpu"),
    (_argv("-gossip-sim-chaos", "meteor"), "cpu"),
    (_argv("-gossip-sim-sweep", "lan:-3"), "cpu"),
    (_argv("-gossip-sim-sweep", "lan:x"), "cpu"),
    (_argv("-gossip-sim-sweep", "moon"), "cpu"),
])
def test_structured_errors(argv, platform):
    rc, text = _port(argv)
    lines = text.strip().splitlines()
    assert rc == 1 and len(lines) == 1, text
    err = json.loads(lines[0])
    assert set(err) == {"gossip_sim_error", "platform"}
    assert err["platform"] == platform


def test_gpu_without_a_card_never_runs_on_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*a, **kw):
        raise AssertionError("ran without the card")

    for mode in ("_default", "_chaos", "_coords", "_sweep"):
        monkeypatch.setattr(cli, mode, ran)
    rc, text = _port(["agent", "-dev", "-gossip-sim", "gpu",
                      "-gossip-sim-nodes", str(N)])
    lines = text.strip().splitlines()
    assert rc == 1 and len(lines) == 1
    err = json.loads(lines[0])
    assert err["platform"] == "gpu"
    assert "backend init failed" in err["gossip_sim_error"]


def test_watchdog_ends_a_run_past_its_deadline():
    out = subprocess.run(
        [sys.executable, "-m", "consul_tpu_torch.cli", "agent", "-dev",
         "-gossip-sim", "cpu", "-gossip-sim-nodes", "262144"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "CONSUL_TPU_TORCH_SIM_RUN_TIMEOUT": "0.5"})
    assert out.returncode == 1
    err = json.loads(out.stdout.strip().splitlines()[-1])
    assert err["platform"] == "cpu"
    assert "exceeded" in err["gossip_sim_error"]


# ------------------------------------------------------ the other modes


def test_chaos_mode_matches_the_reference(no_ref_agent):
    rc, rep = _ref_run({"gossip_sim_nodes": 1024,
                        "gossip_sim_chaos": "churn_burst"})
    prc, text = _port(_argv("-gossip-sim-nodes", "1024",
                            "-gossip-sim-chaos", "churn_burst"))
    mine = _split(text)
    assert rc == prc == 0
    assert sorted(mine) == sorted(rep)
    assert [p["phase"] for p in mine["phases"]] == \
        [p["phase"] for p in rep["phases"]] == \
        ["warmup", "churn_burst", "recover"]
    assert sorted(mine["phases"][1]) == sorted(rep["phases"][1])
    assert sorted(mine["blackbox"]) == sorted(rep["blackbox"])
    assert mine["phases"][1]["crashes"] > 0 and rep["phases"][1]["crashes"]


def test_coords_mode_matches_the_reference(no_ref_agent):
    rc, rep = _ref_run({"gossip_sim_nodes": 256, "gossip_sim_coords": True})
    prc, text = _port(_argv("-gossip-sim-nodes", "256",
                            "-gossip-sim-coords"))
    mine = _split(text)
    assert rc == prc == 0
    assert sorted(mine) == sorted(rep)
    assert "coords_publish_error" in mine and "coords_publish_error" in rep
    assert [p["phase"] for p in mine["phases"]] == \
        [p["phase"] for p in rep["phases"]] == \
        ["warmup", "partition", "heal"]
    assert not any("curve" in p for p in mine["phases"])


def test_sweep_mode_matches_the_reference(ref):  # noqa: F811
    from consul_tpu.utils import telemetry as rtel

    rtel.default.reset()
    telemetry.default.reset()
    rc, rep = _ref_run({"gossip_sim_nodes": 64,
                        "gossip_sim_sweep": "lan:10"})
    prc, text = _port(_argv("-gossip-sim-nodes", "64",
                            "-gossip-sim-sweep", "lan:10"))
    mine = _split(text)
    assert rc == prc == 0
    assert sorted(mine) == sorted(rep)
    assert mine["rounds"] == rep["rounds"] == 10
    assert mine["grid_size"] == rep["grid_size"] == 64
    assert sorted(mine["chosen"]) == sorted(rep["chosen"])
    assert all(sorted(a) == sorted(b) for a, b in
               zip(mine["pareto"], rep["pareto"][:1]))

    def sweep_gauges(m):
        return sorted(g["Name"] for g in m.snapshot()["Gauges"]
                      if ".sim.sweep." in g["Name"])

    assert sweep_gauges(telemetry.default) == sweep_gauges(rtel.default)
    assert len(sweep_gauges(telemetry.default)) >= 5


# ------------------------------------------------------------ publisher


def _traces() -> list:
    rng = np.random.default_rng(7)
    a = rng.random((6, flight.N_COLS)).astype(np.float32)
    a[:, [flight.COL[c] for c in flight.COORD_COLUMNS]] = 0.0
    a[:, flight.COL["refutes"]] = 0.0          # a zero sum: not published
    b = (rng.random((3, flight.N_COLS)) * 50).astype(np.float32)
    return [a, b, np.zeros((0, flight.N_COLS), np.float32)]


def test_publisher_and_report_match_the_reference(ref):  # noqa: F811
    from consul_tpu.sim import flight as rflight
    from consul_tpu.utils import telemetry as rtel

    mine, theirs = telemetry.Metrics(), rtel.Metrics()
    pub = flight.FlightPublisher(mine)
    rpub = rflight.FlightPublisher(theirs)
    for tr in _traces():
        pub.publish_trace(torch.from_numpy(tr))
        rpub.publish_trace(tr)
    p = SimParams(n=64, loss=0.05)
    rep = fd_report(init_state(64, device=CPU), p)
    flight.publish_report(rep, mine)
    rflight.publish_report(rep, theirs)
    a, b = mine.snapshot(), theirs.snapshot()
    assert a["Counters"] == b["Counters"] and a["Gauges"] == b["Gauges"]
    names = {g["Name"] for g in a["Gauges"]}
    assert "consul.sim.rtt_err_med" in names
    assert "consul.sim.refutes" in {c["Name"] for c in a["Counters"]}
    # the default registry is the port's own
    assert flight.FlightPublisher().metrics is telemetry.default


# ----------------------------------------------------- trace and entry


def test_capture_flight_trace_matches_the_reference(ref):  # noqa: F811
    from consul_tpu import cli as rcli

    mine = cli.capture_flight_trace(64, 20, device="cpu")
    theirs = rcli._capture_flight_trace(64, 20)
    assert mine["columns"] == theirs["columns"]
    assert (mine["n"], mine["rounds"]) == (theirs["n"], theirs["rounds"])
    assert mine["blackbox"] == theirs["blackbox"]
    a, b = np.asarray(mine["rows"]), np.asarray(theirs["rows"])
    assert a.shape == b.shape == (20, flight.N_COLS)
    counters = [flight.COL[f] for f in STATS_FIELDS
                if f != "detect_latency_sum"]
    assert np.array_equal(a[:, counters], b[:, counters])
    rest = [i for i in range(flight.N_COLS) if i not in counters]
    tol = ULPS * np.spacing(np.abs(b[:, rest]).astype(np.float32)) + 1e-6
    assert np.all(np.abs(a[:, rest] - b[:, rest]) <= tol)


def test_graft_entry_matches_the_reference(ref):  # noqa: F811
    import jax

    import __graft_entry__ as rentry

    fn, (state, key) = graft_entry.entry(device="cpu")
    rfn, (rstate, rkey) = rentry.entry()
    assert state.status.shape == rstate.status.shape == (65_536,)
    assert np.array_equal(key.numpy().astype(np.uint32),
                          np.asarray(jax.random.key_data(rkey)))
    out = fn(from_numpy(rstate, device=CPU), key)
    want = jax.device_get(rfn(rstate, rkey))
    assert int(out.round_idx) == int(want.round_idx) == 1
    for f in ("status", "incarnation", "down_age", "susp_len", "susp_ttl",
              "susp_conf", "local_health"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(want, f))), f
    inf, rinf = out.informed.numpy(), np.asarray(want.informed)
    assert np.all(np.abs(inf - rinf) <= ULPS * np.spacing(np.abs(rinf)))
    for f in STATS_FIELDS:
        if f != "detect_latency_sum":
            assert int(getattr(out.stats, f)) == \
                int(getattr(want.stats, f)), f


# --------------------------------------------- chip_smoke's seams phase


def test_chip_smoke_seams_phase_on_the_plain_path(tmp_path):
    """``chip_smoke.py``'s seams phase, rehearsed on the CPU at small
    sizes (the wrappers take the plain versions and count nothing)."""
    import chip_smoke

    m = chip_smoke.modules()
    parts = {
        "cli": chip_smoke.seams_cli(torch, m, CPU, n=N),
        "chaos": chip_smoke.seams_chaos(torch, m, CPU, n=1024),
        "twin": chip_smoke.seams_twin(torch, m, CPU, str(tmp_path),
                                      n=1024),
        "entry": chip_smoke.seams_entry(torch, m, CPU),
        "trace": chip_smoke.seams_trace(torch, m, CPU)}
    for name, (rep, bad, launches) in parts.items():
        assert bad == [] and launches == {}, (name, bad)
    tw = parts["twin"][0]
    assert tw["rounds"] == 88 and tw["mid_cursor"] == 40
    assert tw["resume_digest_equal"] is True
    assert len(tw["host_copy_ms"]) == 11 and sum(tw["transitions_per_chunk"])
    assert parts["entry"][0]["round_idx"] == 1
    assert parts["trace"][0]["rows"] == 20
    json.dumps({k: v[0] for k, v in parts.items()})   # the phase's line


def test_chip_smoke_seams_fails_on_a_broken_part(tmp_path, monkeypatch):
    import chip_smoke

    m = chip_smoke.modules()
    monkeypatch.setattr(twin, "resume_digest_proof", lambda *a, **k: False)
    _, bad, _ = chip_smoke.seams_twin(torch, m, CPU, str(tmp_path), n=1024)
    assert len(bad) == 1 and "resume proof False" in bad[0]
    monkeypatch.setattr(cli, "publish_report", lambda *a, **k: None)
    _, bad, _ = chip_smoke.seams_cli(torch, m, CPU, n=256)
    assert len(bad) == 1 and "registry differs" in bad[0]
