"""The simulation modes of the agent command line.

    python -m consul_tpu_torch.cli agent -dev -gossip-sim gpu \\
        -gossip-sim-nodes N [-gossip-sim-chaos C | -gossip-sim-coords |
                             -gossip-sim-sweep T[:R]]

The port of the ``-gossip-sim`` half of the JAX package's
``consul_tpu/cli.py``: the same flag spelling (so a command line carries
over by changing the module name; the agent's other flags are accepted
and configure nothing here) and the same JSON reports, on this package's
engines and kernels. The modes:

* default — 100 rounds in 5 chunks of 20 (chunk key ``prng.fold_in(key,
  c)``) through the kernel runner with the flight recorder at stride 1
  (``round_kernel`` full variant); each chunk's trace goes through
  ``flight.FlightPublisher`` into ``utils.telemetry.default`` as
  ``sim.*`` counters and gauges, and the report — ``fd_report`` plus
  ``rounds_per_sec`` — through ``publish_report`` as ``sim.fd.*``; the
  registry is armed for the run (``telemetry.armed``), so its
  ``Samples`` carry the runner's spans a chunk (``sim.runner.call``,
  ``sim.graph.launch`` ...) in milliseconds; then the same chunks run
  again, untimed and unpublished, under a ``telemetry.timeline``, which
  puts each span on the device's clock (so ``rounds_per_sec`` and the
  samples carry none of its cost). Both go to stderr as one
  ``{"span_ms": {name: {"Count", "Mean", "Max", "device_ms",
  "wait_ms"}}, "idle_pct": ...}`` line (stdout keeps the reference's
  report; the device fields are null on the CPU);
* ``-gossip-sim-chaos C`` — ``scenarios.run_chaos(C, blackbox=True)``
  (kernel runner: fault or byz variant);
* ``-gossip-sim-coords`` — ``scenarios.run_coords`` (live engine, built
  by ``scenarios.coords_setup``), the per-round curves trimmed; the
  report carries ``coords_publish_error`` because no agent runs here to
  publish the coordinates into; a registry of its own is armed for the
  run, then the trial runs again under a timeline (so ``wall_s``
  carries none of its cost), and the spans, their device fields and
  the coordinate counters (``sim.coords.updates``,
  ``sim.coords.deadline_misses``, ``sim.coords.kernel_launches``) go
  to stderr as one ``{"span_ms": ..., "idle_pct": ..., "counters":
  ...}`` line;
* ``-gossip-sim-sweep T[:R]`` — ``scenarios.run_autotune(T, rounds=R)``
  (120 by default), published as ``sim.sweep.*`` gauges, the grid
  trimmed to the winner, the chosen constants and the Pareto rows.

``-gossip-sim cpu`` runs on the host through the plain versions; ``gpu``
runs on the card, and without one exits 1 with a
``{"gossip_sim_error": ..., "platform": ...}`` line — it never falls
back to the host; ``tpu`` and anything else get the same error line.
``-dev`` takes the development gossip timing
(``GossipConfig.local()``), as the agent's dev mode does; without it
the LAN timing. A watchdog (``$CONSUL_TPU_TORCH_SIM_RUN_TIMEOUT``
seconds, 600 by default) turns a hung run into that error line and
exit 1.

``capture_flight_trace`` is the debug bundle's sample: a small
flight-recorded, black-box-traced run of the live engine.

Running a real agent (no ``-gossip-sim``) is the control plane's
(``python -m consul_tpu.cli agent``); this command refuses it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np

from consul_tpu_torch.config import GossipConfig
from consul_tpu_torch.sim import blackbox, prng, scenarios
from consul_tpu_torch.sim.cuda_round import make_run_rounds_cuda
from consul_tpu_torch.sim.flight import (FLIGHT_COLUMNS, FlightPublisher,
                                         publish_report)
from consul_tpu_torch.sim.metrics import blackbox_report, fd_report
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.round import init_scalars, run_rounds_flight
from consul_tpu_torch.sim.state import init_state
from consul_tpu_torch.utils import telemetry
from consul_tpu_torch.utils.platform import DeviceLike, default_device

#: the run's deadline in seconds: a hung kernel or compile ends in the
#: structured error line instead of a stuck process
_SIM_RUN_TIMEOUT_S = float(
    os.environ.get("CONSUL_TPU_TORCH_SIM_RUN_TIMEOUT", "600"))

_SIM_PLATFORMS = ("cpu", "tpu", "gpu")

#: default mode: rounds, in chunks of
SIM_ROUNDS, SIM_CHUNK = 100, 20
SWEEP_ROUNDS = 120


def _sim_error(msg: str, platform: str) -> int:
    """One parseable JSON error line on stdout, exit code 1."""
    print(json.dumps({"gossip_sim_error": msg, "platform": platform}),
          flush=True)
    return 1


def _arm(budget: float, platform: str) -> threading.Timer:
    def fire() -> None:
        print(json.dumps({
            "gossip_sim_error": f"simulation run exceeded {budget:.0f}s "
                                "(device absent or hung)",
            "platform": platform}), flush=True)
        os._exit(1)

    t = threading.Timer(budget, fire)
    t.daemon = True
    t.start()
    return t


def publish_sim_sweep(rep: dict) -> None:
    """The sweep winner as ``sim.sweep.*`` gauges in
    ``utils.telemetry.default``: grid size, Pareto points, the chosen
    constants and the winner's quality numbers."""
    m = telemetry.default
    m.gauge("sim.sweep.grid_size", float(rep["grid_size"]))
    m.gauge("sim.sweep.pareto_points", float(len(rep["pareto"])))
    for k, v in rep["chosen"].items():
        m.gauge(f"sim.sweep.chosen.{k}", float(v))
    w = rep["winner"]
    for k in ("mean_detect_latency_s", "fp_per_node_hour", "msg_load"):
        if w.get(k) is not None:
            m.gauge(f"sim.sweep.winner.{k}", float(w[k]))


def _sweep(spec: str, n: int, platform: str, dev) -> int:
    topology, _, rounds_s = spec.partition(":")
    if topology not in scenarios.AUTOTUNE_TOPOLOGIES:
        return _sim_error(
            f"unknown sweep topology class {topology!r} (expected one of "
            f"{', '.join(scenarios.AUTOTUNE_TOPOLOGIES)}, with an optional "
            ":rounds suffix)", platform)
    try:
        rounds = int(rounds_s) if rounds_s else SWEEP_ROUNDS
        if rounds <= 0:
            raise ValueError(rounds)
    except ValueError:
        return _sim_error(f"bad sweep rounds suffix in {spec!r} (expected "
                          "a positive integer)", platform)
    print(f"==> gossip-sim={platform} sweep={topology}: {n} virtual "
          f"members x 64-point grid, {rounds} rounds on {dev.type}")
    t0 = time.perf_counter()
    rep = scenarios.run_autotune(topology, n=n, rounds=rounds, device=dev)
    rep["wall_s"] = round(time.perf_counter() - t0, 2)
    publish_sim_sweep(rep)
    rep["pareto"] = [rep["points"][i] for i in rep["pareto"]]
    rep.pop("points", None)
    print(json.dumps(rep, indent=2))
    return 0


def _coords(n: int, platform: str, dev) -> int:
    print(f"==> gossip-sim={platform} coords: {n} virtual members on "
          f"{dev.type}")
    t0 = time.perf_counter()
    with telemetry.armed(telemetry.Metrics()) as m:
        rep, _ = scenarios.run_coords(n=n, device=dev)
    rep["wall_s"] = round(time.perf_counter() - t0, 2)
    with telemetry.timeline(dev) as line:
        scenarios.run_coords(n=n, device=dev)
    fl = rep.pop("flight", None)
    if fl:
        rep["phases"] = [{k: v for k, v in ph.items() if k != "curve"}
                         for ph in fl["phases"]]
    rep["coords_publish_error"] = (
        "dev agent unavailable: this command runs no agent; publish "
        "coordinates with the control plane's agent")
    print(json.dumps(rep, indent=2))
    _print_spans(m, line, counters=True)
    return 0


def _print_spans(m: telemetry.Metrics, line: telemetry.Timeline,
                 counters: bool = False) -> None:
    """The armed registry's spans (and, with ``counters``, its counters)
    as one JSON line on stderr: stdout keeps the reference's report.
    Beside each span's host ``Mean`` / ``Max`` (ms), the timeline's mean
    ``device_ms`` (the device's time between the span's markers) and
    ``wait_ms`` (the device's waits while it was open), and its run's
    ``idle_pct``: null off the card and for a span the timeline did not
    mark (a device span)."""
    snap = m.snapshot()
    r = line.read()
    out = {"span_ms": {}, "idle_pct": telemetry.idle_pct(r)}
    for s in snap["Samples"]:
        sp = r["spans"].get(s["Name"].removeprefix(m.prefix + "."))
        on = sp is not None and sp["device_us"] is not None
        out["span_ms"][s["Name"]] = {
            **{k: s[k] for k in ("Count", "Mean", "Max")},
            "device_ms": sp["device_us"] / sp["count"] * 1e-3 if on
            else None,
            "wait_ms": sp["wait_us"] / sp["count"] * 1e-3 if on else None}
    if counters:
        out["counters"] = {c["Name"]: c["Count"]
                           for c in snap["Counters"]}
    print(json.dumps(out), file=sys.stderr)


def _chaos(name: str, n: int, platform: str, dev) -> int:
    classes = scenarios.chaos_plans(max(n, 16))
    if name not in classes:
        return _sim_error(f"unknown chaos class {name!r} (expected one of "
                          f"{', '.join(sorted(classes))})", platform)
    print(f"==> gossip-sim={platform} chaos={name}: {n} virtual members "
          f"on {dev.type}")
    t0 = time.perf_counter()
    rep = scenarios.run_chaos(name, n=n, blackbox=True, device=dev)
    rep["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(rep, indent=2))
    return 0


def default_run(p: SimParams, dev, pub: Optional[FlightPublisher] = None):
    """The default mode's run: ``SIM_ROUNDS`` rounds of the kernel runner
    in chunks of ``SIM_CHUNK`` with the flight recorder at stride 1, the
    stale scalars carried across chunks (made once up front, so every
    chunk replays one CUDA graph) and each chunk's trace handed to
    ``pub`` (one host read a chunk). Returns (state, traces, seconds):
    the run's wall from its initial state to the device's end of the
    last chunk (the runner, key and state are made before the clock)."""
    run = make_run_rounds_cuda(p, SIM_CHUNK, carry=True, flight_every=1)
    key = prng.key(0, device=dev)
    state = init_state(p.n, device=dev)
    t0 = time.perf_counter()
    sc = init_scalars(state, p)
    traces = []
    for c in range(SIM_ROUNDS // SIM_CHUNK):
        state, trace, sc = run(state, prng.fold_in(key, c), scalars0=sc)
        if pub is not None:
            pub.publish_trace(trace)
        traces.append(trace)
    int(state.round_idx)           # the run has ended on the device
    return state, traces, time.perf_counter() - t0


def _default(gossip: GossipConfig, n: int, platform: str, dev) -> int:
    p = SimParams.from_gossip_config(gossip, n=n, loss=0.01)
    print(f"==> gossip-sim={platform}: {n} virtual members, {SIM_ROUNDS} "
          f"rounds on {dev.type}")
    with telemetry.armed(telemetry.default):
        state, _, dt = default_run(p, dev, FlightPublisher())
    with telemetry.timeline(dev) as line:
        default_run(p, dev)
    rep = fd_report(state, p)
    publish_report(rep)
    print(json.dumps({"rounds_per_sec": round(SIM_ROUNDS / dt, 1),
                      **rep.to_dict()}, indent=2))
    _print_spans(telemetry.default, line)
    return 0


def run_gossip_sim(platform: str, n: int, gossip: GossipConfig,
                   chaos: str = "", coords: bool = False,
                   sweep: str = "") -> int:
    """``agent -gossip-sim <platform>``: run the mode the flags select and
    print its report; returns the exit code."""
    platform = platform.lower()
    if platform not in _SIM_PLATFORMS:
        return _sim_error(
            f"unknown -gossip-sim platform {platform!r} (expected one of "
            f"{', '.join(_SIM_PLATFORMS)})", platform)
    if platform == "tpu":
        return _sim_error("this build runs on a CUDA card or the CPU; "
                          "use -gossip-sim gpu or cpu", platform)
    try:
        dev = default_device("cpu" if platform == "cpu" else None)
    except Exception as e:  # noqa: BLE001 — no card
        return _sim_error(f"backend init failed: {e}", platform)
    watchdog = _arm(_SIM_RUN_TIMEOUT_S, platform)
    try:
        if sweep:
            return _sweep(sweep, n, platform, dev)
        if coords:
            return _coords(n, platform, dev)
        if chaos:
            return _chaos(chaos, n, platform, dev)
        return _default(gossip, n, platform, dev)
    except Exception as e:  # noqa: BLE001 — build or run errors
        return _sim_error(f"simulation failed: {e}", platform)
    finally:
        watchdog.cancel()


def capture_flight_trace(nodes: int, rounds: int,
                         device: DeviceLike = None) -> dict:
    """A small flight-recorded, black-box-traced live-engine run (20%
    loss, TCP fallback off, the default tracked sample): the debug
    bundle's proof that the recorders work, with its rows and decoded
    rings."""
    dev = default_device(device)
    p = SimParams(n=nodes, loss=0.2, tcp_fallback=False)
    tracked = blackbox.default_tracked(nodes, min(p.blackbox_k, nodes), dev)
    state, trace, bb = run_rounds_flight(
        init_state(nodes, device=dev), prng.key(0, device=dev), p, rounds,
        tracked=tracked)
    return {
        "n": nodes, "rounds": rounds,
        "columns": list(FLIGHT_COLUMNS),
        "rows": np.asarray(trace.cpu().numpy(), np.float64).round(6)
        .tolist(),
        "blackbox": blackbox_report(bb, p, trace=trace),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="consul_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ag = sub.add_parser("agent")
    ag.add_argument("-dev", action="store_true", dest="dev")
    # the agent's own flags, accepted so a command line carries over
    ag.add_argument("-server", action="store_true")
    ag.add_argument("-node", default=None)
    ag.add_argument("-datacenter", "-dc", default=None)
    ag.add_argument("-bootstrap-expect", type=int, default=0)
    ag.add_argument("-join", "-retry-join", action="append", default=[])
    ag.add_argument("-data-dir", default=None)
    ag.add_argument("-encrypt", default=None)
    ag.add_argument("-config-file", "-config-dir", action="append",
                    default=[])
    for flag in ("-http-port", "-dns-port", "-serf-port", "-server-port",
                 "-serf-wan-port"):
        ag.add_argument(flag, type=int, default=None)
    ag.add_argument("-gossip-sim", default=None, dest="gossip_sim",
                    help="cpu (the host) or gpu (the CUDA card)")
    ag.add_argument("-gossip-sim-nodes", type=int, default=1000,
                    dest="gossip_sim_nodes")
    ag.add_argument("-gossip-sim-chaos", default="", dest="gossip_sim_chaos",
                    help="run a named chaos FaultPlan (e.g. "
                         "asym_partition, per_node_loss, gc_pause, "
                         "flapping, churn_burst)")
    ag.add_argument("-gossip-sim-sweep", default="", dest="gossip_sim_sweep",
                    help="run the parameter-sweep auto-tuner for a "
                         "topology class (lan, wan, lossy; optional "
                         ":rounds suffix, e.g. lossy:120)")
    ag.add_argument("-gossip-sim-coords", action="store_true",
                    dest="gossip_sim_coords",
                    help="run the network-coordinate scenario")
    return ap


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.gossip_sim:
        print("consul_tpu_torch.cli runs the -gossip-sim modes only; a "
              "real agent is the control plane's (python -m "
              "consul_tpu.cli agent)", file=sys.stderr)
        return 2
    gossip = GossipConfig.local() if args.dev else GossipConfig.lan()
    return run_gossip_sim(args.gossip_sim, args.gossip_sim_nodes, gossip,
                          chaos=args.gossip_sim_chaos,
                          coords=args.gossip_sim_coords,
                          sweep=args.gossip_sim_sweep)


if __name__ == "__main__":
    sys.exit(main())
