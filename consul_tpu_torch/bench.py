"""The port's headline: SWIM rounds per second at 1,048,576 nodes.

    python -m consul_tpu_torch.bench            # on the CUDA card
    python -m consul_tpu_torch.bench --profile  # + the roofline ladder
    python -m consul_tpu_torch.bench --smoke    # 65,536 nodes, CPU plain path
    python -m consul_tpu_torch.bench --chaos [--smoke]
    python -m consul_tpu_torch.bench --coords [--smoke]
    python -m consul_tpu_torch.bench --sweep [--smoke]
    python -m consul_tpu_torch.bench --chaos|--sweep [--smoke] \
        --ckpt-dir D [--resume]
    python -m consul_tpu_torch.bench --autotune [--smoke]
    python -m consul_tpu_torch.bench --mesh [--smoke]
    python -m consul_tpu_torch.bench --history
    python -m consul_tpu_torch.bench --check-regression [--smoke] \
        [--family BENCH|PROFILE] [--metric NAME]

The timed configuration is the JAX bench's (bench.py's
``gossip_rounds_per_sec_1M_nodes``): ``GossipConfig.lan()`` at 1% loss,
TCP fallback off, no stats — the STABLE kernel variant. It is timed two
ways: the per-round runner (``round_kernel``, 500-round calls) and the
R=8 megakernel runner (``mega_kernel``, 512-round calls), best of three
trials, each ending in ``torch.cuda.synchronize()`` and a fetched
checksum. The full-model diagnostic (stats + slow-node model, the FULL
variant) runs through both runners too, and its ``fd_report`` gives
false positives, suspicions and refutes per node-round. The full-model
per-round runner is then timed in turns bare, with the flight recorder
at ``flight.DEFAULT_RECORD_EVERY`` (``flight``) and with the black box
on top (``blackbox``: ``default_tracked(n, p.blackbox_k)`` agents, ring
``p.blackbox_ring``): rounds per second of each and its
``overhead_frac`` against the bare runner over matched windows.

``--chaos`` runs the nine chaos classes of ``sim/scenarios.py`` (five
honest FaultPlans, four byzantine) at 1,048,576 nodes through the fault
and byz variants of ``round_kernel``: per class the per-phase detection
report, the host seconds ``compile_plan`` took and the run's rounds per
second (``--smoke``: 4,096 nodes on the CPU).

``--chaos`` also runs the corroboration_k defense sweep
(``scenarios.run_byzantine_defense``) at the JAX bench's size: 4,096
nodes, 200 rounds (``--smoke``: 1,024 and 100).

``--sweep`` runs the sweep engine (``sim/sweep.py``) at the JAX bench's
grid and sizes: ``scenarios.AUTOTUNE_GRID`` (64 points) over the lan,
wan and lossy classes at 65,536 nodes, 300 rounds, xla engine
(``--smoke``: 1,024 nodes, 100 rounds, on the CPU). Per class: the end-
to-end seconds of the first call, the steady seconds (best of 2 more),
scenarios and scenario-rounds per second, the peak device memory, the
chosen constants and the Pareto front.

``--chaos`` and ``--sweep`` take ``--ckpt-dir D [--resume]``: SIGTERM or
SIGINT saves (the chaos class in flight at its last chunk, finished
classes and the defense sweep in ``ProgressManifest`` records under D)
and prints a ``"preempted": true`` JSON envelope with the ``resume``
command, exiting ``checkpoint.PREEMPTED_RC``; ``--resume`` replays the
finished units and resumes the one in flight, bit for bit.

``--coords`` runs ``scenarios.run_coords`` (cold-start Vivaldi
convergence through a partition and heal, RTT-aware probe deadlines, on
the live engine) at 65,536 nodes on the card (``--smoke``: 4,096 on the
CPU).

``--profile`` (the headline only, on the card) also runs the roofline ladder
(``costmodel.roofline_table``: xla, fast, lanes at stale_k 1/2/4, overlap
and the kernel runner at R 1/4/8 on the full-model configuration, 24
rounds, best of 3, against a measured copy/triad peak) and records the
envelope as the next ``PROFILE_r<NN>.json`` when at least 6 rows
measured.

``--autotune`` times the autotuner's 15 points (``sim/autotune.py``) on
the headline configuration at 1,048,576 nodes, 48 rounds, best of 3
(``--smoke``: 65,536 nodes, 24 rounds, on the CPU, where the kernel
runner's points are skipped), records the payload as the next
``TUNE_r<NN>.json`` and caches the winner under ``{device type}/n{n}``.
The headline then times the cached winner next to its fixed runners,
names it under ``"tuned"`` and headlines the faster; a corrupt cache is
an error. ``--history`` prints one row per record; ``--check-regression``
re-measures the headline (``--family BENCH``) or the newest PROFILE's
best-utilisation row (``--family PROFILE``) and holds five samples
against the latest record under the median+IQR refusal band: exit 0 for
pass or unstable, 1 for a regression, 2 when no record exists.

``--mesh`` times the sharded lane engine (``sim/mesh.py``) on the
headline configuration at a fixed population per rank, over worlds of
launched ranks, each rung ``MESH_ROUNDS`` rounds a call, best of 3 after
a warm-up, timed inside every rank and set by the slowest: on the card,
a world of 1 on NCCL at 131,072 and 1,048,576 nodes with the stale_k
ladder {1, 2, 4, 8} and overlap at 8, and gloo worlds of 1 and 2 (both
ranks on the one card: ``"shared_card": true`` — a correctness layout,
not a scaling figure) at stale_k 1 and 4 (``--smoke``: gloo on the CPU
at worlds 1, 2 and 4, 8,192 nodes per rank). Each row's
``weak_scaling_efficiency`` is its rounds/s over the world-1 row of the
same backend, size and schedule, as measured; ``collectives`` is the
run's count (2 + one per window, + 1 under overlap), asserted. The
payload is recorded as the next MULTICHIP record.

The digital twin has two library functions and no flag, because its
agent half is the control plane's and the caller builds it:
``run_twin_bench`` runs the soak ladder (``sim/twin.py``) and records a
full run as the next TWIN record, and ``check_twin_regression`` re-runs
the newest TWIN record's smoke guard under the same band.

Records and the winner cache live in ``consul_tpu_torch/records/``, or
in ``$CONSUL_TPU_TORCH_RECORD_ROOT``; never in the repository's root,
whose ``*_r*.json`` records are the JAX package's.

Prints one JSON object on stdout. Without a card (and without
``--smoke``) it raises rather than running on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
from typing import Optional

import torch

from consul_tpu_torch.config import GossipConfig
from consul_tpu_torch.faults import compile_plan
from consul_tpu_torch.sim import autotune as autotune_mod
from consul_tpu_torch.sim import costmodel, graphs, prng, registry
from consul_tpu_torch.sim import mesh as mesh_mod
from consul_tpu_torch.sim import scenarios
from consul_tpu_torch.sim import twin as twin_mod
from consul_tpu_torch.sim.blackbox import default_tracked
from consul_tpu_torch.sim.checkpoint import (PREEMPTED_RC, PreemptionGuard,
                                             ProgressManifest)
from consul_tpu_torch.sim.cuda_round import (LAUNCHES, make_run_rounds_cuda,
                                             reset_launches)
from consul_tpu_torch.sim.flight import DEFAULT_RECORD_EVERY
from consul_tpu_torch.sim.metrics import fd_report
from consul_tpu_torch.sim.metrics import sweep_report
from consul_tpu_torch.sim.params import SimParams, SweepAxes, grid_params
from consul_tpu_torch.sim.scenarios import (AUTOTUNE_GRID,
                                            AUTOTUNE_TOPOLOGIES,
                                            autotune_params, chaos_plans,
                                            run_byzantine_defense, run_chaos,
                                            run_coords)
from consul_tpu_torch.sim.sweep import SweepResult, make_run_sweep
from consul_tpu_torch.sim.state import SimState, init_state
from consul_tpu_torch.utils.platform import default_device, device_name

HEADLINE_N = 1_048_576
SMOKE_N = 65_536
CHAOS_SMOKE_N = 4_096
COORDS_N = 65_536
COORDS_SMOKE_N = 4_096
MEGA_RPC = 8
#: the JAX bench's sweep and defense sizes (its bench.py:1231-1233,
#: :1370-1372): (nodes, rounds), then the --smoke sizes
SWEEP_SIZE, SWEEP_SMOKE_SIZE = (65_536, 300), (1_024, 100)
DEFENSE_SIZE, DEFENSE_SMOKE_SIZE = (4_096, 200), (1_024, 100)


def headline_params(n: int) -> SimParams:
    """The timed configuration (stable kernel variant)."""
    return SimParams.from_gossip_config(GossipConfig.lan(), n=n, loss=0.01,
                                        tcp_fallback=False,
                                        collect_stats=False)


def diag_params(n: int) -> SimParams:
    """The full-model diagnostic configuration (full kernel variant)."""
    return headline_params(n).with_(collect_stats=True,
                                    slow_per_round=0.001)


def clone_state(s: SimState) -> SimState:
    """A deep copy (the runners update their input state in place)."""
    return SimState(*[x.clone() for x in s[:-1]],
                    stats=type(s.stats)(*[x.clone() for x in s.stats]))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_of(run, state, key, base, iters, trials, dev):
    """Best wall time of `trials` trials of `iters` runner calls, each
    ending in a device sync and a fetched checksum."""
    best = float("inf")
    for trial in range(trials):
        t0 = time.perf_counter()
        for i in range(iters):
            state = run(state, prng.fold_in(key, base + 10 * trial + i))
        _sync(dev)
        checksum = float(state.informed.sum())
        best = min(best, time.perf_counter() - t0)
        if not checksum > 0:
            raise RuntimeError(f"checksum {checksum} after a timed trial")
    return best, state


def _first_calls(run, state, key, dev) -> tuple:
    """The runner's first two calls apart from the timed ones, as the JAX
    bench splits compile from dispatch: the first (eager: the kernels'
    build and lazy caches) and, on the card, the second (its CUDA
    graph's capture, then a replay): (state, {first_call_ms,
    second_call_ms, capture_ms})."""
    c0 = graphs.CAPTURES["ms"]
    ms = []
    for i in range(2):
        t0 = time.perf_counter()
        state = run(state, prng.fold_in(key, i))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, {"first_call_ms": ms[0], "second_call_ms": ms[1],
                   "capture_ms": graphs.CAPTURES["ms"] - c0}


def recorder_runners(p: SimParams, rounds: int, n: int, dev):
    """The full-model per-round runner bare, with the flight recorder at
    the default stride, and with the black box on top, each as
    ``run(state, key) -> state``; and the tracked ids."""
    bare = make_run_rounds_cuda(p, rounds)
    fl = make_run_rounds_cuda(p, rounds, flight_every=DEFAULT_RECORD_EVERY)
    bb = make_run_rounds_cuda(p, rounds, flight_every=DEFAULT_RECORD_EVERY,
                              blackbox=True)
    tracked = default_tracked(n, p.blackbox_k, dev)
    return {"bare": bare,
            "flight": lambda s, k: fl(s, k)[0],
            "blackbox": lambda s, k: bb(s, k, tracked=tracked)[0]}, tracked


def _best_in_turns(runners: dict, state, key, base, iters, trials, dev):
    """Best wall time of each runner over ``trials`` turns of ``iters``
    calls (bare, flight, blackbox, bare, ...), each ending in a sync
    and a fetched checksum: matched windows in one process."""
    best = {name: float("inf") for name in runners}
    for trial in range(trials):
        for j, (name, run) in enumerate(runners.items()):
            dt, state = _best_of(run, state, key,
                                 base + 100 * trial + 10 * j, iters, 1, dev)
            best[name] = min(best[name], dt)
    return best, state


def run_headline(device=None, smoke: bool = False,
                 root: Optional[str] = None) -> dict:
    """Time both runners on both configurations; returns the result
    dict (rates are rounds per second of the whole cluster). When the
    winner cache under ``root`` (the record root by default) holds a
    winner for this device type and n, it is timed too (``"tuned"``)
    and headlines if faster; ``kernel`` names the runner that set the
    headline."""
    dev = torch.device("cpu") if smoke else default_device(device)
    n = SMOKE_N if smoke else HEADLINE_N
    p, p_diag = headline_params(n), diag_params(n)
    chunk, iters, trials = (10, 1, 2) if smoke else (500, 6, 3)
    mega_chunk = 16 if smoke else 512
    diag_chunk, mega_diag_chunk, diag_iters = \
        (10, 16, 1) if smoke else (200, 240, 5)
    key = prng.key(0, device=dev)
    out = {"device": device_name(dev), "n": n, "smoke": smoke}

    state = init_state(n, device=dev)
    run = make_run_rounds_cuda(p, chunk)
    # warm-up: the kernels' build and the graph's capture
    state, first = _first_calls(run, state, prng.fold_in(key, 1), dev)
    dt, state = _best_of(run, state, key, 10, iters, trials, dev)
    rounds = chunk * iters
    out["per_round"] = {"kernel": "round_kernel/stable", "chunk": chunk,
                        "rounds_per_sec": rounds / dt,
                        "us_per_round": dt / rounds * 1e6,
                        "launches_per_round": 1.0, **first}

    mega = make_run_rounds_cuda(p, mega_chunk, rounds_per_call=MEGA_RPC)
    mstate, first = _first_calls(mega, clone_state(state),
                                 prng.fold_in(key, 3000), dev)
    mdt, mstate = _best_of(mega, mstate, key, 3001, iters, trials, dev)
    rounds = mega_chunk * iters
    out["mega"] = {"kernel": "mega_kernel/stable", "chunk": mega_chunk,
                   "rounds_per_call": MEGA_RPC,
                   "rounds_per_sec": rounds / mdt,
                   "us_per_round": mdt / rounds * 1e6,
                   "launches_per_round": 1.0 / MEGA_RPC, **first}

    # the full model: stats lanes + slow-node model
    diag = make_run_rounds_cuda(p_diag, diag_chunk)
    dstate = diag(clone_state(state), prng.fold_in(key, 998))
    _sync(dev)
    fdt, dstate = _best_of(diag, dstate, key, 1000, diag_iters, 2, dev)
    rounds = diag_chunk * diag_iters
    out["full_per_round"] = {"kernel": "round_kernel/full",
                             "rounds_per_sec": rounds / fdt,
                             "us_per_round": fdt / rounds * 1e6}
    mdiag = make_run_rounds_cuda(p_diag, mega_diag_chunk,
                                 rounds_per_call=MEGA_RPC)
    mdstate = mdiag(clone_state(dstate), prng.fold_in(key, 3100))
    _sync(dev)
    mfdt, mdstate = _best_of(mdiag, mdstate, key, 3101, diag_iters, 2,
                             dev)
    rounds = mega_diag_chunk * diag_iters
    out["full_mega"] = {"kernel": "mega_kernel/full",
                        "rounds_per_sec": rounds / mfdt,
                        "us_per_round": mfdt / rounds * 1e6}

    # the flight recorder and the black box on the full-model per-round
    # runner, in turns with the bare one
    runners, tracked = recorder_runners(p_diag, diag_chunk, n, dev)
    rstate = clone_state(dstate)
    for j, run in enumerate(runners.values()):
        rstate = run(rstate, prng.fold_in(key, 4000 + j))   # warm-up
    _sync(dev)
    best, _ = _best_in_turns(runners, rstate, key, 4100, diag_iters, 3, dev)
    rounds = diag_chunk * diag_iters
    out["full_per_round"]["rounds_per_sec_in_turns"] = \
        rounds / best["bare"]
    out["flight"] = {"record_every": DEFAULT_RECORD_EVERY,
                     "rounds_per_sec": rounds / best["flight"],
                     "overhead_frac": best["flight"] / best["bare"] - 1.0}
    out["blackbox"] = {"tracked": int(tracked.shape[0]),
                       "ring_len": p_diag.blackbox_ring,
                       "record_every": DEFAULT_RECORD_EVERY,
                       "rounds_per_sec": rounds / best["blackbox"],
                       "overhead_frac": best["blackbox"] / best["bare"]
                       - 1.0}

    # FD quality of the per-round full-model run: its stats began at
    # zero when the diagnostic started
    diag_rounds = int(dstate.round_idx) - int(state.round_idx)
    rep = fd_report(dstate, p_diag)
    node_rounds = float(n) * diag_rounds
    out["fd"] = {"rounds": diag_rounds,
                 "fp_per_node_round": rep.false_positives / node_rounds,
                 "suspicions_per_node_round": rep.suspicions / node_rounds,
                 "refutes_per_node_round": rep.refutes / node_rounds,
                 "live_fraction": rep.live_fraction,
                 "mean_informed": rep.mean_informed}
    best = max((out["per_round"]["rounds_per_sec"], "round_kernel/stable"),
               (out["mega"]["rounds_per_sec"],
                f"mega_kernel/stable-x{MEGA_RPC}"))
    tuned = tuned_tier(p, state, key, chunk, iters, trials, dev,
                       root or _record_root())
    if tuned is not None:
        out["tuned"] = tuned
        best = max(best, (tuned["rounds_per_sec"],
                          f"tuned-{tuned['config']}"))
    out["rounds_per_sec"], out["kernel"] = best
    out.update(metric=("gossip_rounds_per_sec_smoke" if smoke
                       else "gossip_rounds_per_sec_1M_nodes"),
               value=out["rounds_per_sec"], unit="rounds/s",
               vs_baseline=None, platform=dev.type)
    return out


def tuned_tier(p: SimParams, state: SimState, key, chunk: int, iters: int,
               trials: int, dev, root: str) -> Optional[dict]:
    """The cached autotune winner for (device type, n), timed like the
    fixed runners from a copy of ``state``: {config, source,
    rounds_per_sec}, or None when this pair was never tuned. A corrupt
    cache raises ``AutotuneCacheError``."""
    winner = autotune_mod.cached_winner(root, dev.type, p.n)
    if winner is None:
        return None
    cadence = max(int(winner["stale_k"]), int(winner["rounds_per_call"]))
    tchunk = chunk if chunk % cadence == 0 \
        else cadence * max(1, chunk // cadence)
    run = autotune_mod.tuned_runner(p, winner, tchunk)
    tstate = run(clone_state(state), prng.fold_in(key, 5000))
    _sync(dev)
    dt, _ = _best_of(run, tstate, key, 5001, iters, trials, dev)
    return {"config": winner["config"],
            "source": autotune_mod.cache_key(dev.type, p.n),
            "rounds_per_sec": tchunk * iters / dt}


def _resume_cmd(mode: str, smoke: bool, ckpt_dir: str) -> str:
    return (f"python -m consul_tpu_torch.bench --{mode}"
            f"{' --smoke' if smoke else ''} --ckpt-dir {ckpt_dir} --resume")


def _preempted(out: dict, mode: str, at: str, ckpt_dir: str) -> dict:
    """The envelope of a preempted invocation: what finished, where it
    stopped and the command that finishes it."""
    done = [k for k, v in out["classes"].items()
            if not (isinstance(v, dict) and v.get("preempted"))]
    return {**out, "preempted": True, "preempted_class": at,
            "completed": done,
            "resume": _resume_cmd(mode, out["smoke"], ckpt_dir)}


def run_chaos_suite(device=None, smoke: bool = False,
                    ckpt_dir: Optional[str] = None,
                    guard: Optional[PreemptionGuard] = None,
                    resume: bool = False) -> dict:
    """Every chaos class at ``HEADLINE_N`` nodes (``smoke``:
    ``CHAOS_SMOKE_N`` on the CPU). Per class: ``run_chaos``'s report,
    the host seconds ``compile_plan`` took, and the rounds per second
    of the run (runner calls and report reads, ending in a sync). Each
    class runs twice from the same seed, which gives the same report:
    the first run builds the kernels and loads PyTorch's, and only the
    second is timed. A run builds its own runner and calls it once, so
    it runs eagerly (a CUDA graph is captured on a key's second call).

    With ``ckpt_dir`` (or a ``guard``) the suite is
    ``scenarios.run_chaos_suite``'s checkpointed run instead: one
    untimed run per class, preemptible; a preempted suite returns the
    ``_preempted`` envelope."""
    dev = torch.device("cpu") if smoke else default_device(device)
    n = CHAOS_SMOKE_N if smoke else HEADLINE_N
    out = {"device": device_name(dev), "n": n, "smoke": smoke,
           "classes": {}}
    if ckpt_dir or guard is not None:
        suite = scenarios.run_chaos_suite(n, device=dev, ckpt_dir=ckpt_dir,
                                          guard=guard, resume=resume)
        at = suite.pop("preempted", None)
        out["classes"] = suite
        return _preempted(out, "chaos", at, ckpt_dir) if at else out
    for name, plan in chaos_plans(n).items():
        t0 = time.perf_counter()
        cp = compile_plan(plan, n, dev)
        _sync(dev)
        compile_s = time.perf_counter() - t0
        run_chaos(name, n=n, device=dev, cp=cp)
        _sync(dev)
        t1 = time.perf_counter()
        rep = run_chaos(name, n=n, device=dev, cp=cp)
        _sync(dev)
        run_s = time.perf_counter() - t1
        rep.update(compile_plan_s=compile_s, run_s=run_s,
                   rounds_per_sec=rep["rounds"] / run_s)
        out["classes"][name] = rep
        del cp
    return out


def run_chaos_bench(smoke: bool = False, ckpt_dir: Optional[str] = None,
                    guard: Optional[PreemptionGuard] = None,
                    resume: bool = False) -> dict:
    """``--chaos``: the chaos suite, then the defense sweep under
    ``"corroboration_sweep"``. With ``ckpt_dir`` the defense sweep is
    the ``byz_defense`` unit of the bench's own manifest
    (``bench.json`` under ``ckpt_dir``), replayed under ``resume``."""
    res = run_chaos_suite(smoke=smoke, ckpt_dir=ckpt_dir, guard=guard,
                          resume=resume)
    if res.get("preempted"):
        return res
    manifest = ProgressManifest(
        ckpt_dir, name="bench.json",
        config={"mode": "chaos", "smoke": smoke, "n": res["n"]}) \
        if ckpt_dir else None
    if manifest is not None and resume and manifest.done("byz_defense"):
        res["corroboration_sweep"] = manifest.result("byz_defense")
    elif guard is not None and guard.preempted:
        return _preempted(res, "chaos", "byz_defense", ckpt_dir)
    else:
        res["corroboration_sweep"] = run_defense_bench(smoke=smoke)
        if manifest is not None:
            manifest.mark("byz_defense", res["corroboration_sweep"])
    return res


def run_defense_bench(device=None, smoke: bool = False) -> dict:
    """``run_byzantine_defense`` at ``DEFENSE_SIZE`` (``smoke``:
    ``DEFENSE_SMOKE_SIZE`` on the CPU), with its wall time."""
    dev = torch.device("cpu") if smoke else default_device(device)
    n, rounds = DEFENSE_SMOKE_SIZE if smoke else DEFENSE_SIZE
    t0 = time.perf_counter()
    rep = run_byzantine_defense(n=n, rounds=rounds, device=dev)
    _sync(dev)
    rep["run_s"] = time.perf_counter() - t0
    return rep


def run_sweep_class(topology: str, n: int, rounds: int, dev,
                    engine: str = "xla"):
    """One topology class of the sweep bench: the grid built, one call
    (``end_to_end_s``, its CUDA graphs' capture ``capture_s`` apart),
    two more on new keys (``steady_s``, the best),
    each ending in a sync; the peak device memory over the three.
    Returns (report, the last call's SweepResult, its key)."""
    dev = torch.device(dev)
    p = autotune_params(topology, n)
    tp, points = grid_params(p, SweepAxes.of(**AUTOTUNE_GRID), dev)
    run = make_run_sweep(p, rounds, engine=engine, device=dev)
    key = prng.key(0, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    c0 = graphs.CAPTURES["ms"]
    t0 = time.perf_counter()
    states, trace = run(tp, key)
    _sync(dev)
    e2e_s = time.perf_counter() - t0
    capture_s = (graphs.CAPTURES["ms"] - c0) / 1e3
    steady_s = float("inf")
    for trial in range(2):
        k = prng.fold_in(key, trial + 1)
        t0 = time.perf_counter()
        states, trace = run(tp, k)
        _sync(dev)
        steady_s = min(steady_s, time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    result = SweepResult(states=states, trace=trace, tp=tp, points=points,
                         rounds=rounds, flight_every=None)
    rep = sweep_report(result)
    g = rep["grid_size"]
    out = {"grid_size": g, "engine": engine,
           "end_to_end_s": e2e_s, "capture_s": capture_s,
           "steady_s": steady_s,
           "scenarios_per_sec": g / steady_s,
           "scenario_rounds_per_sec": g * rounds / steady_s,
           "peak_memory_bytes": peak,
           "chosen": rep["winner"]["params"],
           "winner": {k: rep["winner"][k] for k in
                      ("point", "mean_detect_latency_s",
                       "fp_per_node_hour", "msg_load")},
           "pareto": [{k: v for k, v in rep["points"][i].items()
                       if k in ("point", "params", "mean_detect_latency_s",
                                "fp_per_node_hour", "msg_load")}
                      for i in rep["pareto"]]}
    return out, result, k


def run_sweep_bench(device=None, smoke: bool = False, engine: str = "xla",
                    classes=AUTOTUNE_TOPOLOGIES,
                    ckpt_dir: Optional[str] = None,
                    guard: Optional[PreemptionGuard] = None,
                    resume: bool = False) -> dict:
    """The sweep bench: ``run_sweep_class`` for each topology class at
    ``SWEEP_SIZE`` (``smoke``: ``SWEEP_SMOKE_SIZE`` on the CPU). With
    ``ckpt_dir`` each class is a unit of a ``ProgressManifest``
    (replayed under ``resume``), and a tripped ``guard`` stops between
    classes with the ``_preempted`` envelope."""
    dev = torch.device("cpu") if smoke else default_device(device)
    n, rounds = SWEEP_SMOKE_SIZE if smoke else SWEEP_SIZE
    out = {"device": device_name(dev), "n": n, "rounds": rounds,
           "smoke": smoke, "engine": engine,
           "grid": {k: list(v) for k, v in AUTOTUNE_GRID.items()},
           "objectives": ["mean_detect_latency_s", "fp_per_node_hour",
                          "msg_load"],
           "classes": {}}
    manifest = ProgressManifest(
        ckpt_dir, config={"mode": "sweep", "smoke": smoke, "n": n,
                          "rounds": rounds, "engine": engine}) \
        if ckpt_dir else None
    for t in classes:
        if manifest is not None and resume and manifest.done(t):
            out["classes"][t] = manifest.result(t)
            continue
        if guard is not None and guard.preempted:
            return _preempted(out, "sweep", t, ckpt_dir)
        out["classes"][t] = run_sweep_class(t, n, rounds, dev, engine)[0]
        if manifest is not None:
            manifest.mark(t, out["classes"][t])
    return out


def run_coords_bench(device=None, smoke: bool = False) -> dict:
    """``run_coords`` at ``COORDS_N`` nodes on the card (``smoke``:
    ``COORDS_SMOKE_N`` on the CPU), with its wall time."""
    dev = torch.device("cpu") if smoke else default_device(device)
    n = COORDS_SMOKE_N if smoke else COORDS_N
    t0 = time.perf_counter()
    report, coords = run_coords(n=n, device=dev)
    _sync(dev)
    run_s = time.perf_counter() - t0
    return {"device": device_name(dev), "n": n, "smoke": smoke,
            "run_s": run_s, "rounds_per_sec": report["rounds"] / run_s,
            "scenarios": {"coords": report}}


def _short_kernel_name(name: str) -> str:
    for noise in ("(anonymous namespace)::", "at::native::"):
        name = name.replace(noise, "")
    return name.removeprefix("void ")[:96]


def profile_call(fn, rounds: int, dev: torch.device):
    """One call of ``fn`` under ``torch.profiler``, closed by a device
    sync: (fn's result, its report). The report holds the wall µs per
    round (inflated by the profiler's own host cost), the device
    kernels per round and ``device_breakdown`` of the device intervals
    by short kernel name. On the CPU only host activity is traced, and
    the breakdown says the device was not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end,
                    _short_kernel_name(e.name))
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    return result, {"rounds": rounds,
                    "wall_us_per_round": wall / rounds * 1e6,
                    "kernels_per_round": len(spans) / rounds,
                    **device_breakdown(spans, rounds)}


def device_breakdown(spans, rounds: int) -> dict:
    """Busy time (the union of the device intervals), the span from the
    first start to the last end, and device µs per round by name, from
    ``(start_us, end_us, name)`` tuples sorted by start."""
    if not spans:
        return {"device": "not measured: the trace holds no device events"}
    by_name: dict = {}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e, k in spans:
        by_name[k] = by_name.get(k, 0.0) + (e - s)
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in spans) - spans[0][0]
    return {
        "device_span_us": span, "device_busy_us": busy,
        "busy_share": busy / span if span > 0 else None,
        "device_us_per_round_by_kernel": {
            k: v / rounds for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])},
    }


# --------------------------------------------------- records and modes

#: where records and the winner cache go unless the environment says
RECORD_ROOT_ENV = "CONSUL_TPU_TORCH_RECORD_ROOT"
#: the families --check-regression can measure again
GUARDED_FAMILIES = ("BENCH", "PROFILE")
#: the roofline ladder's and the autotuner's depths, (rounds, reps)
ROOFLINE_DEPTH = (24, 3)
AUTOTUNE_DEPTH, AUTOTUNE_SMOKE_DEPTH = (48, 3), (24, 3)
REGRESSION_SAMPLES = 5


def _record_root() -> str:
    """``$CONSUL_TPU_TORCH_RECORD_ROOT``, else ``consul_tpu_torch/records``
    — never the repository's root, whose records the JAX package loads."""
    return os.environ.get(RECORD_ROOT_ENV) or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "records")


def load_records(root: str) -> list:
    """``costmodel.load_ledger`` of ``root``; a root not made yet holds
    no records."""
    return costmodel.load_ledger(root) if os.path.isdir(root) else []


def _record_next(family: str, payload: dict,
                 root: Optional[str] = None) -> Optional[str]:
    """Record ``payload`` as the next ``<family>_r<NN>.json`` under
    ``root`` (the record root by default) — the one writer of every
    family. It validates first (a payload the ledger would refuse is
    reported on stderr, not written: returns None), then writes
    atomically (tmp + rename)."""
    root = root or _record_root()
    os.makedirs(root, exist_ok=True)
    taken = [int(m.group(1)) for fn in os.listdir(root)
             for m in [re.match(rf"{family}_r(\d+)\.json$", fn)] if m]
    name = f"{family}_r{max(taken, default=0) + 1:02d}.json"
    try:
        costmodel.validate_record(name, payload)
    except costmodel.LedgerError as e:
        print(f"{family} NOT recorded (would fail the ledger): {e}",
              file=sys.stderr)
        return None
    path = os.path.join(root, name)
    fd, tmp = tempfile.mkstemp(dir=root, prefix=name + ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    print(f"{family} recorded: {path}", file=sys.stderr)
    return path


def run_history(root: Optional[str] = None) -> int:
    """``--history``: one trajectory row per record under ``root``. Exit
    code 0, 1 when a record fails validation (named), 2 when there is
    none."""
    root = root or _record_root()
    try:
        records = load_records(root)
    except costmodel.LedgerError as e:
        print(f"recorded-artifact validation failed: {e}", file=sys.stderr)
        return 1
    if not records:
        print(f"no recorded *_r*.json artifacts under {root}",
              file=sys.stderr)
        return 2
    print(costmodel.format_history(costmodel.history_rows(records)))
    print(f"\n{len(records)} records, "
          f"{len({r['family'] for r in records})} families (root: {root})")
    return 0


def _loadavg_1m():
    try:
        return round(os.getloadavg()[0], 2)
    except OSError:
        return None


def headline_samples(smoke: bool) -> list:
    """Fresh headline samples for ``--check-regression --family BENCH``:
    ``REGRESSION_SAMPLES`` turns of one call each of the per-round and
    the R=8 runner on the headline configuration (their chunks), each
    sample the faster turn's rounds/s — the headline's own rule, one
    sample per turn, not best-of."""
    dev = torch.device("cpu") if smoke else default_device()
    n = SMOKE_N if smoke else HEADLINE_N
    p = headline_params(n)
    runs = ((make_run_rounds_cuda(p, 10 if smoke else 500), 10 if smoke
             else 500),
            (make_run_rounds_cuda(p, 16 if smoke else 512,
                                  rounds_per_call=MEGA_RPC),
             16 if smoke else 512))
    key = prng.key(0, device=dev)
    state = init_state(n, device=dev)
    for run, _ in runs:
        state = run(state, prng.fold_in(key, 1))   # warm-up
    _sync(dev)
    samples = []
    for trial in range(REGRESSION_SAMPLES):
        rates = []
        for j, (run, rounds) in enumerate(runs):
            dt, state = _best_of(run, state, key, 100 * trial + 10 * j,
                                 1, 1, dev)
            rates.append(rounds / dt)
        samples.append(max(rates))
    return samples


def profile_samples(base: dict, smoke: bool) -> tuple:
    """Fresh utilisation samples (percent) for ``--check-regression
    --family PROFILE``: the recorded best-utilisation row's config on
    the full-model configuration, ``REGRESSION_SAMPLES`` reps against a
    fresh bandwidth peak. Returns (samples, bandwidth)."""
    dev = torch.device("cpu") if smoke else default_device()
    n = SMOKE_N if smoke else HEADLINE_N
    p = diag_params(n)
    engine = base["engine"]
    if engine in ("lanes", "overlap"):
        p = p.with_(stale_k=int(base["stale_k"]))
    cadence = max(int(base["stale_k"]), int(base["rounds_per_call"]))
    rounds = ROOFLINE_DEPTH[0]
    if rounds % cadence:
        rounds = cadence * max(1, rounds // cadence)
    bw = costmodel.measure_bandwidth(device=dev)
    row = costmodel.measure_config(
        p, rounds=rounds, engine=engine,
        rounds_per_call=int(base["rounds_per_call"]),
        lane_blocks=base["lane_blocks"] if engine == "lanes" else None,
        reps=REGRESSION_SAMPLES, peak_gbps=bw["peak_gbps"],
        return_samples=True, device=dev)
    bytes_eff = row["bytes_measured"] or row["bytes_model"]
    return ([bytes_eff / (ms / 1e3) / 1e9 / bw["peak_gbps"] * 100.0
             for ms in row["samples_ms_per_round"]], bw)


def run_check_regression(smoke: bool, family: str = "BENCH",
                         metric: Optional[str] = None,
                         root: Optional[str] = None) -> int:
    """``--check-regression``: fresh samples against the latest record
    of the metric under ``costmodel.check_regression``'s band. Returns
    the exit code: 0 pass or unstable, 1 regression (or a broken
    record), 2 no record to compare with (checked before measuring) or
    a metric this family does not measure."""
    root = root or _record_root()
    try:
        records = load_records(root)
    except costmodel.LedgerError as e:
        print(f"recorded-artifact validation failed: {e}", file=sys.stderr)
        return 1
    if family == "PROFILE":
        if metric not in (None, "roofline_best_util_pct"):
            print(f"--family PROFILE measures 'roofline_best_util_pct', "
                  f"not {metric!r}", file=sys.stderr)
            return 2
        metric = "roofline_best_util_pct"
        base = costmodel.latest_profile_util(records)
        if base is None:
            print(f"--check-regression --family PROFILE: no recorded "
                  f"roofline utilisation under {root}; a baseline is "
                  "never fabricated", file=sys.stderr)
            return 2
        if base["smoke"] != smoke:
            print(f"the recorded roofline ({base['file']}) was measured "
                  f"{'with' if base['smoke'] else 'without'} --smoke; "
                  "run the same workload", file=sys.stderr)
            return 2
        samples, bw = profile_samples(base, smoke)
        res = costmodel.check_regression(samples, base["util"] * 100.0)
        res = {"metric": metric, "config": base["config"],
               "platform": bw["platform"], "device": bw["device"],
               "peak_gbps": bw["peak_gbps"], **res}
    else:
        expected = ("gossip_rounds_per_sec_smoke" if smoke
                    else "gossip_rounds_per_sec_1M_nodes")
        if metric not in (None, expected):
            print(f"--family BENCH {'with' if smoke else 'without'} "
                  f"--smoke measures {expected!r}; it cannot compare "
                  f"that with {metric!r}", file=sys.stderr)
            return 2
        metric = expected
        base = costmodel.latest_metric(records, metric)
        if base is None:
            print(f"--check-regression: no recorded value of {metric!r} "
                  f"under {root}; a baseline is never fabricated",
                  file=sys.stderr)
            return 2
        res = {"metric": metric,
               **costmodel.check_regression(headline_samples(smoke),
                                            base["value"])}
    print(json.dumps({**res, "baseline_file": base["file"],
                      "loadavg_1m": _loadavg_1m()}))
    return 1 if res["verdict"] == "regression" else 0


def run_autotune(smoke: bool, root: Optional[str] = None) -> dict:
    """``--autotune``: the autotuner's 15 points on the headline
    configuration at ``HEADLINE_N`` (``smoke``: ``SMOKE_N`` on the CPU),
    the ladder on stderr, the payload recorded as the next TUNE record
    and the winner cached under ``{device type}/n{n}``."""
    dev = torch.device("cpu") if smoke else default_device()
    n = SMOKE_N if smoke else HEADLINE_N
    rounds, reps = AUTOTUNE_SMOKE_DEPTH if smoke else AUTOTUNE_DEPTH
    metric = ("autotune_rounds_per_sec_smoke" if smoke
              else "autotune_rounds_per_sec_1M_nodes")
    rec = autotune_mod.autotune(headline_params(n), rounds=rounds,
                                reps=reps, metric=metric, device=dev)
    rec.update(device=device_name(dev), loadavg_1m=_loadavg_1m())
    for row in rec["rows"]:
        print(f"  {row['config']:<14} " + (
            f"skipped: {row['skipped'][:60]}" if "skipped" in row else
            f"{row['rounds_per_sec']:>11,.1f} r/s "
            f"({row['ms_per_round']:.4f} ms/round)"), file=sys.stderr)
    root = root or _record_root()
    _record_next("TUNE", rec, root)
    path = autotune_mod.save_winner(root, rec["platform"], n,
                                    rec["winner"])
    print(f"winner {rec['winner']['config']} cached: {path} "
          f"[{autotune_mod.cache_key(rec['platform'], n)}]",
          file=sys.stderr)
    return rec



#: --family TWIN's metric: 1000 / converge_rounds of the smoke guard
TWIN_METRIC = "twin_converge_speed"
#: wall seconds a full-ladder twin rung may take (projected from the
#: rung before it, linear in n) before it is skipped
TWIN_BUDGET_ENV = "CONSUL_TPU_TORCH_TWIN_RUNG_BUDGET_S"


def run_twin_bench(smoke: bool, build, load, ckpt_dir: Optional[str] = None,
                   resume: bool = False, samples: int = 3,
                   guard: Optional[PreemptionGuard] = None) -> dict:
    """The digital-twin soak ladder (``sim/twin.py``) for a caller who
    can build the agent half (``build``, ``load``: see
    ``twin.run_twin_soak``). The ladder is ``twin.TWIN_LADDER`` on the
    card (``smoke``: ``TWIN_SMOKE_N`` on the CPU); a rung projected from
    the last measured one to exceed the rung budget (120 s smoke, else
    ``$CONSUL_TPU_TORCH_TWIN_RUNG_BUDGET_S`` or 900 s) is an honest
    skip naming why, as is one that runs out of memory. Then
    ``samples`` smoke-guard soaks give the ``smoke_guard`` envelope the
    TWIN regression guard compares with.

    With ``ckpt_dir`` each rung checkpoints under ``ckpt_dir/n<N>`` and
    a ``ProgressManifest`` keeps the finished rungs; a tripped guard
    (``guard``, else a SIGTERM/SIGINT guard installed here) returns
    ``{"preempted": True, ...}`` and ``resume`` finishes the ladder. A
    full (not smoke) payload with a measured rung is recorded as the
    next TWIN record under the record root."""
    dev = torch.device("cpu") if smoke else default_device()
    metric = "twin_soak" + ("_smoke" if smoke else "")
    ladder = [twin_mod.TWIN_SMOKE_N] if smoke else list(twin_mod.TWIN_LADDER)
    budget_s = 120.0 if smoke else float(
        os.environ.get(TWIN_BUDGET_ENV, "900"))
    own_guard = guard is None
    if own_guard:
        guard = PreemptionGuard().install()
    manifest = ProgressManifest(
        ckpt_dir, name="twin-progress.json",
        config={"smoke": smoke, "ladder": ladder}) if ckpt_dir else None
    rungs: list = []
    prev: Optional[dict] = None   # the last MEASURED rung
    preempted_at = None
    try:
        for n in ladder:
            unit = f"n{n}"
            if manifest is not None and manifest.done(unit):
                rungs.append(manifest.result(unit))
                if not rungs[-1].get("skipped"):
                    prev = rungs[-1]
                continue
            if guard.preempted:
                preempted_at = n
                break
            if prev is not None:
                used = prev.get("join_s", 0) + prev.get("soak_wall_s", 0)
                projected = used * (n / max(prev["n"], 1))
                if projected > budget_s:
                    rung = {"n": n, "skipped": True,
                            "reason": f"projected {projected:.0f}s wall "
                                      f"from the n={prev['n']} rung's "
                                      f"{used:.0f}s exceeds the "
                                      f"{budget_s:.0f}s rung budget"}
                    rungs.append(rung)
                    if manifest is not None:
                        manifest.mark(unit, rung)
                    print(f"twin rung n={n}: SKIPPED ({rung['reason']})",
                          file=sys.stderr)
                    continue
            try:
                rung = twin_mod.run_twin_soak(
                    n, build, load, seed=0, guard=guard,
                    ckpt_dir=os.path.join(ckpt_dir, unit) if ckpt_dir
                    else None, resume=resume, device=dev,
                    progress=lambda msg: print(f"twin {msg}",
                                               file=sys.stderr))
            except (MemoryError, torch.cuda.OutOfMemoryError):
                rung = {"n": n, "skipped": True,
                        "reason": "out of memory building the twin"}
            if rung.get("preempted"):
                preempted_at = n
                break
            rungs.append(rung)
            if manifest is not None and not rung.get("skipped"):
                manifest.mark(unit, rung)
            if not rung.get("skipped"):
                prev = rung
    finally:
        if own_guard:
            guard.uninstall()
    if preempted_at is not None:
        return {"metric": metric, "preempted": True,
                "preempted_rung": preempted_at, "ladder": rungs}
    print("twin: measuring the smoke-guard envelope", file=sys.stderr)
    payload = {
        "metric": metric, "platform": dev.type,
        "device": device_name(dev), "loadavg_1m": _loadavg_1m(),
        "smoke": smoke, "ladder": rungs,
        "smoke_guard": twin_mod.smoke_guard_samples(
            build, load, samples=samples,
            n=min(twin_mod.TWIN_SMOKE_N, min(ladder)), device=dev)}
    # a smoke ladder checks the workflow; only full runs are records
    if not smoke and any(not r.get("skipped") for r in rungs):
        _record_next("TWIN", payload)
    return payload


def check_twin_regression(records: list, build, load, smoke: bool,
                          samples: int = 3,
                          metric: Optional[str] = None) -> int:
    """The TWIN regression guard: re-run the newest TWIN record's
    smoke-guard workload (same n and rounds) ``samples`` times and hold
    its convergence speed (``TWIN_METRIC``, higher is better) against
    the record under ``costmodel.check_regression``'s band. Prints one
    JSON line; returns 0 pass or unstable, 1 regression (a sample that
    never converged is one), 2 no baseline, a workload that no longer
    matches it, or another metric."""
    if metric not in (None, TWIN_METRIC):
        print(f"--family TWIN guards {TWIN_METRIC!r} (1000/converge_rounds "
              f"of the recorded smoke-guard workload); it cannot measure "
              f"{metric!r}", file=sys.stderr)
        return 2
    base = costmodel.latest_twin_guard(records)
    if base is None:
        print("--family TWIN: no recorded TWIN record with a smoke_guard; "
              "a baseline is never fabricated", file=sys.stderr)
        return 2
    plan = twin_mod.smoke_guard_plan(base["n"])
    if plan.total_rounds != base["rounds"]:
        print(f"--family TWIN: the recorded smoke_guard ran "
              f"{base['rounds']} rounds but today's guard plan has "
              f"{plan.total_rounds}; the workloads no longer match",
              file=sys.stderr)
        return 2
    dev = torch.device("cpu") if smoke else default_device()
    speeds = []
    for i in range(samples):
        rung = twin_mod.run_twin_soak(base["n"], build, load, seed=100 + i,
                                      plan=plan, load_clients=2,
                                      serve_http=False, device=dev)
        if rung["member_view_err_post_heal"] > twin_mod.CONVERGE_TOL:
            print(json.dumps({
                "metric": TWIN_METRIC, "verdict": "regression",
                "reason": "fresh sample never converged (view err "
                          f"{rung['member_view_err_post_heal']})",
                "baseline_file": base["file"]}))
            return 1
        speeds.append(1000.0 / max(rung["converge_rounds"], 1))
    res = costmodel.check_regression(
        speeds, 1000.0 / max(base["converge_rounds"], 1))
    print(json.dumps({"metric": TWIN_METRIC, "platform": dev.type,
                      "loadavg_1m": _loadavg_1m(),
                      "baseline_file": base["file"], **res}))
    return 1 if res["verdict"] == "regression" else 0


#: --mesh: per-rank populations, rounds a call, and the rungs each
#: (backend, world) launch runs as (stale_k, overlap)
MESH_SIZES, MESH_SMOKE_SIZES = (131_072, 1_048_576), (8_192,)
MESH_ROUNDS, MESH_SMOKE_ROUNDS = 96, 48
MESH_KS = tuple((k, False) for k in registry.STALE_KS) + (
    (registry.STALE_KS[-1], True),)
MESH_SHARED_KS = ((1, False), (4, False))
MESH_SMOKE_WORLDS = (1, 2, 4)
MESH_TRIALS = 3


def mesh_windows(rounds: int, k: int, overlap: bool) -> int:
    """Collectives of one mesh run: the two staged init reductions, one
    per window (a partial last window has its own), and the drain under
    overlap."""
    return 2 + -(-rounds // k) + (1 if overlap else 0)


def _mesh_rungs(mesh, rungs, rounds: int, trials: int) -> list:
    """One launched rank of ``--mesh``: for each (n per rank, stale_k,
    overlap) rung, a warm-up call and ``trials`` timed calls of the
    sharded runner on the headline configuration; returns per rung the
    best wall seconds (a sync and a fetched checksum end each call) and
    the collectives of one call."""
    dev = mesh.device
    key = prng.key(0, dev)
    out = []
    for n_rank, k, overlap in rungs:
        n = n_rank * mesh.world
        p = headline_params(n).with_(stale_k=k)
        run = mesh_mod.make_sharded_run(p, rounds, mesh, overlap=overlap)
        state = mesh_mod.init_sharded_state(n, mesh)
        state = run(state, prng.fold_in(key, 1))
        _sync(dev)
        mesh_mod.reset_collectives()
        best, state = _best_of(run, state, key, 10, 1, trials, dev)
        out.append({"wall_s": best, "collectives":
                    sum(mesh_mod.COLLECTIVES.values()) // trials})
    return out


def run_mesh_bench(smoke: bool = False) -> dict:
    """``--mesh``: the sharded engine's ladder (see the module
    docstring); records the payload as the next MULTICHIP record."""
    if smoke:
        dev = torch.device("cpu")
        sizes, rounds = MESH_SMOKE_SIZES, MESH_SMOKE_ROUNDS
        launches = [("gloo", w, False, ((1, False), (4, False), (4, True)))
                    for w in MESH_SMOKE_WORLDS]
    else:
        dev = default_device()
        sizes, rounds = MESH_SIZES, MESH_ROUNDS
        launches = [("nccl", 1, False, MESH_KS),
                    ("gloo", 1, False, MESH_SHARED_KS),
                    ("gloo", 2, True, MESH_SHARED_KS)]
    rows = []
    for backend, world, shared, ks in launches:
        rungs = [(n, k, ov) for n in sizes for k, ov in ks]
        ranks = mesh_mod.launch(world, _mesh_rungs, backend=backend,
                                device=dev.type, args=(rungs, rounds,
                                                       MESH_TRIALS))
        for i, (n, k, ov) in enumerate(rungs):
            walls = [r[i]["wall_s"] for r in ranks]
            coll = ranks[0][i]["collectives"]
            want = mesh_windows(rounds, k, ov)
            if coll != want:
                raise RuntimeError(f"{backend} world {world} n {n} k {k} "
                                   f"overlap {ov}: {coll} collectives a "
                                   f"run, want {want}")
            worst = max(walls)
            rows.append({
                "devices": world, "n": n * world, "n_per_rank": n,
                "backend": backend, "shared_card": shared,
                "stale_k": k, "overlap": ov, "loadavg_1m": _loadavg_1m(),
                "rounds_per_sec": rounds / worst,
                "ms_per_round": worst / rounds * 1e3,
                "dev_ms_min": min(walls) / rounds * 1e3,
                "dev_ms_max": worst / rounds * 1e3,
                "dev_skew": worst / min(walls),
                "collectives": coll})
    for row in rows:
        base = next(r for r in rows if r["devices"] == 1
                    and r["backend"] == row["backend"]
                    and r["n_per_rank"] == row["n_per_rank"]
                    and r["stale_k"] == row["stale_k"]
                    and r["overlap"] == row["overlap"])
        row["weak_scaling_efficiency"] = \
            row["rounds_per_sec"] / base["rounds_per_sec"]
        print(f"  {row['backend']:<4} x{row['devices']} "
              f"{row['n_per_rank']:>9,}/rank k={row['stale_k']}"
              f"{'+ov' if row['overlap'] else '   '} "
              f"{row['rounds_per_sec']:>9,.1f} r/s "
              f"eff {row['weak_scaling_efficiency']:.3f}"
              + (" (shared card)" if row["shared_card"] else ""),
              file=sys.stderr)
    rec = {"metric": "mesh_weak_scaling" + ("_smoke" if smoke else ""),
           "platform": dev.type, "device": device_name(dev),
           "rounds_per_chunk": rounds, "trials": MESH_TRIALS,
           "ladder": rows}
    _record_next("MULTICHIP", rec)
    return rec


def print_roofline(roofline: dict) -> None:
    """The roofline ladder as a table on stderr."""
    bw = roofline["bandwidth"]
    print(f"roofline peak: {bw['peak_gbps']} GB/s (copy {bw['copy_gbps']}, "
          f"triad {bw['triad_gbps']}; {bw['mbytes']} MB f32, "
          f"{bw['device']})", file=sys.stderr)
    for r in roofline["rows"]:
        if "skipped" in r:
            print(f"  {r['config']:<12} skipped: {r['skipped'][:64]}",
                  file=sys.stderr)
            continue
        meas = ("-" if r["bytes_measured"] is None
                else f"{r['bytes_measured'] / 1e6:.2f}")
        util = "-" if r["util"] is None else f"{r['util']:.1%}"
        print(f"  {r['config']:<12} {r['ms_per_round']:>9.4f} ms "
              f"{r['bytes_model'] / 1e6:>9.2f} MB model {meas:>9} MB "
              f"counted {r['achieved_gbps']:>8.2f} GB/s {util:>6}"
              + (" FLAGGED" if r["flagged"] else ""), file=sys.stderr)


def profile_record(headline: dict, roofline: dict) -> dict:
    """The PROFILE envelope of a headline run and its roofline ladder;
    it claims the schema version only when at least 6 rows measured."""
    env = {k: headline[k] for k in ("metric", "value", "unit",
                                    "vs_baseline", "kernel", "platform",
                                    "device", "n")}
    env.update(loadavg_1m=_loadavg_1m(),
               full_model_rounds_per_sec=headline["full_per_round"][
                   "rounds_per_sec"],
               profile={"roofline": roofline})
    if sum(1 for r in roofline["rows"] if "skipped" not in r) >= 6:
        env["schema"] = registry.PROFILE_SCHEMA_VERSION
    return env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SWIM rounds/s of consul_tpu_torch at 1,048,576 nodes")
    ap.add_argument("--smoke", action="store_true",
                    help="65,536 nodes on the CPU through the plain path")
    ap.add_argument("--profile", action="store_true",
                    help="also run the roofline ladder and record "
                         "PROFILE; the headline only, on the card")
    ap.add_argument("--chaos", action="store_true",
                    help="run the nine chaos classes (fault and byz "
                         "kernel variants) instead of the headline")
    ap.add_argument("--coords", action="store_true",
                    help="run the coordinates scenario (Vivaldi "
                         "convergence through a partition and heal)")
    ap.add_argument("--sweep", action="store_true",
                    help="run the 64-point gossip-constant sweep over the "
                         "lan, wan and lossy classes")
    ap.add_argument("--ckpt-dir", default=None,
                    help="with --chaos or --sweep: checkpoint and progress "
                         "directory; SIGTERM/SIGINT saves and exits "
                         f"{PREEMPTED_RC}")
    ap.add_argument("--resume", action="store_true",
                    help="with --ckpt-dir: finish a preempted invocation")
    ap.add_argument("--autotune", action="store_true",
                    help="time the autotuner's 15 runner configs, record "
                         "TUNE and cache the winner")
    ap.add_argument("--mesh", action="store_true",
                    help="time the sharded lane engine over launched "
                         "worlds and record MULTICHIP")
    ap.add_argument("--history", action="store_true",
                    help="print one row per record under the record root")
    ap.add_argument("--check-regression", action="store_true",
                    help="measure again and compare with the latest "
                         "record (exit 1 on a regression, 2 without one)")
    ap.add_argument("--family", default=None,
                    help="with --check-regression: "
                         + " or ".join(GUARDED_FAMILIES))
    ap.add_argument("--metric", default=None,
                    help="with --check-regression: the recorded metric")
    args = ap.parse_args(argv)
    modes = [m for m in ("chaos", "coords", "sweep", "autotune", "mesh",
                         "history", "check_regression")
             if getattr(args, m)]
    if len(modes) > 1:
        ap.error(f"--{' and --'.join(modes)} are modes of their own: "
                 "run one at a time".replace("_", "-"))
    if args.ckpt_dir and not (args.chaos or args.sweep):
        ap.error("--ckpt-dir applies to --chaos and --sweep")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    if args.smoke and args.profile:
        ap.error("--profile traces the card; it cannot run with --smoke")
    if args.profile and modes:
        ap.error("--profile applies to the headline only")
    if (args.family or args.metric) and not args.check_regression:
        ap.error("--family and --metric apply to --check-regression only")
    if args.family not in (None,) + GUARDED_FAMILIES:
        ap.error(f"--family must be one of {'/'.join(GUARDED_FAMILIES)}, "
                 f"got {args.family!r}")
    if args.history:
        return run_history()
    if args.check_regression:
        return run_check_regression(args.smoke, args.family or "BENCH",
                                    args.metric)
    reset_launches()
    guard = PreemptionGuard().install() if args.ckpt_dir else None
    ck = dict(ckpt_dir=args.ckpt_dir, guard=guard, resume=args.resume)
    if args.autotune:
        res = run_autotune(args.smoke)
    elif args.mesh:
        res = run_mesh_bench(args.smoke)
    elif args.sweep:
        res = run_sweep_bench(smoke=args.smoke, **ck)
        res["metric"] = "param_sweep" + ("_smoke" if args.smoke else "")
    elif args.coords:
        res = run_coords_bench(smoke=args.smoke)
        res["metric"] = ("coords_convergence_smoke" if args.smoke
                         else "coords_convergence_65k_nodes")
    elif args.chaos:
        res = run_chaos_bench(smoke=args.smoke, **ck)
        res["metric"] = ("chaos_detection_quality_smoke" if args.smoke
                         else "chaos_detection_quality_1M_nodes")
    else:
        res = run_headline(smoke=args.smoke)
    if guard is not None:
        guard.uninstall()
    res["launches"] = dict(LAUNCHES)
    roofline = None
    if args.profile:
        rounds, reps = ROOFLINE_DEPTH
        roofline = costmodel.roofline_table(
            diag_params(HEADLINE_N), rounds=rounds, reps=reps)
        print_roofline(roofline)
    print(json.dumps(res))
    if roofline is not None:
        env = profile_record(res, roofline)
        if "schema" in env:
            _record_next("PROFILE", env)
        else:
            print("PROFILE not recorded: fewer than 6 roofline rows "
                  "measured", file=sys.stderr)
    return PREEMPTED_RC if res.get("preempted") else 0


if __name__ == "__main__":
    sys.exit(main())
