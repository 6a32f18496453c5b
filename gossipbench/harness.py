"""One run of one cell: set-up, the measured window, the traced reading,
the check against the reference, the result line.

Everything that belongs to one configuration, traffic mix, driver or
metric sits in a file of its own, found by the name ``BENCHMARK.json``
or a cell file gives:

* ``configs/<config>.json`` — the deployment's sizes and constants;
* ``traffic/<traffic>.json`` — how calls are issued: the driver, periods
  a call, R, flight stride, carried scalars, the call's key, what the
  caller reads, warm-up calls, the calls traced and those before them;
* ``workloads/<cell>.json`` — the cell: configuration, traffic, chips
  and the limits of the check;
* ``drivers/<driver>.py`` — a ``Driver`` over the program;
* ``reference/<engine>.py`` — the reference's ``call`` for that engine;
* ``metrics/<metric>.py`` — a ``read(ctx)`` for each metric (None where
  it finds nothing to read);
* ``bounds/<kernel>.py`` — a kernel's frozen count (``trace.roofline``).

The window is a closed loop of one caller: a call is issued, its result
read to the host, then the next is issued, until ``seconds`` have
passed. The check holds the window's first call (from the initial
state, which the reference makes itself) and one later call drawn from
the seed (from the program's state before it, cloned) to the reference,
once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import random
import sys
import time
from typing import Optional

import torch

from gossipbench import check, trace
from gossipbench.reference import model
from gossipbench.reference import prng as rprng

HERE = pathlib.Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
#: top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "consul_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    mod_name = f"gossipbench_{kind}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, section: str) -> list:
    """The ``BENCHMARK.json`` metrics of ``section`` (``end_to_end`` or
    ``per_layer``) that the cell reports."""
    with open(BENCHMARK) as f:
        bench = json.load(f)
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def _quantiles(xs) -> dict:
    """5th, 50th and 95th percentile (nearest rank) and the largest of
    seconds ``xs``, in milliseconds."""
    ordered = sorted(xs)
    at = {q: ordered[max(0, -(-q * len(ordered) // 100) - 1)] * 1e3
          for q in (5, 50, 95)}
    return {"p5": at[5], "p50": at[50], "p95": at[95],
            "max": ordered[-1] * 1e3}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a metric reads. The window: ``calls``, each call's wall
    (``call_s``) and host (``host_s``) seconds, ``wall_s``, ``setup_s``,
    ``n`` and ``rounds`` a call. The traced window (``--trace 1``):
    device and host spans, ``window_s``, ``busy_s``, ``traced_rounds``,
    and the host milliseconds of the untraced calls after it
    (``host_ms``)."""

    def __init__(self, **kw):
        self.dev, self.host, self.host_ms = [], [], []
        self.window_s = self.busy_s = 0.0
        self.traced_rounds = 0
        self.__dict__.update(kw)


def window(driver, seconds: float, seed: int, trace_calls: int,
           trace_after: int, dev: torch.device) -> dict:
    """The measured window: returns the calls' times, the checked calls'
    states and, when traced, the profile and its extent: the
    ``trace_calls`` calls after the first ``trace_after``, the same for
    every seed, so that the traced stretch is past the window's first
    calls, where the caching allocator still grows (a traced window
    runs on until they are done)."""
    rng = random.Random(seed)
    call_s, host_s = [], []
    first = picked = None
    prof, traced = None, None
    t0 = time.perf_counter()
    i = 0
    while True:
        if trace_calls and i == trace_after:
            prof = trace.profiler(dev)
            prof.__enter__()
            tt = time.perf_counter()
        pick = i > 0 and rng.random() < 1.0 / i
        before = driver.snapshot() if pick else None
        ts = time.perf_counter()
        out = driver.call()
        th = time.perf_counter()
        driver.fetch(out)
        te = time.perf_counter()
        call_s.append(te - ts)
        host_s.append(th - ts)
        if i == 0:
            first = driver.outputs()
        elif pick:
            picked = (before, driver.outputs())
        i += 1
        if prof is not None and i == trace_after + trace_calls:
            prof.__exit__(None, None, None)
            traced = (tt, te, trace_after, trace_calls)
            prof_done, prof = prof, None
        if te - t0 >= seconds and (not trace_calls or traced):
            break
    res = {"call_s": call_s, "host_s": host_s, "wall_s": te - t0,
           "calls": i, "first": first, "picked": picked}
    if traced is not None:
        res["profile"] = prof_done
        res["traced"] = traced
    return res


def _as_outputs(ref) -> dict:
    """A reference engine's return in the form of a driver's
    ``outputs``."""
    s, trace_rows, scalars = ref
    out = {"lanes": s.lanes, "t": s.t, "round_idx": s.round_idx,
           "stats": s.stats}
    if trace_rows is not None:
        out["trace"] = trace_rows
    if scalars is not None:
        out["scalars"] = scalars
    return out


def reference_pairs(w: dict, cfg: dict, traffic: dict, seed: int, n: int,
                    dev: torch.device, F=torch.float32) -> tuple:
    """The reference's outputs beside the program's for the checked
    calls: the first from the reference's own initial state, the drawn
    one from the program's state before it."""
    P = model.Params(cfg, n=n, stale_k=traffic.get("stale_k", 1))
    engine = load_module("reference", traffic["reference"])
    base = rprng.key(seed, device=dev)

    def key_of(c: int):
        return rprng.fold_in(base, c) if traffic["key"] == "fold_in" \
            else base

    pairs = []
    got = w["first"]
    ref = engine.call(model.init_state(n, dev), key_of(0), P, traffic,
                      None, F)
    pairs.append((got, ref))
    if w["picked"] is not None:
        before, got = w["picked"]
        s0 = model.State(before["lanes"], before["t"], before["round_idx"],
                         before["stats"])
        ref = engine.call(s0, key_of(before["call"]), P, traffic,
                          before.get("scalars"), F)
        pairs.append((got, ref))
    return pairs, P


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", n: Optional[int] = None,
             t_start: Optional[float] = None, driver_hook=None,
             control: bool = False) -> tuple:
    """One run of ``cell``; returns (the result object, a line of
    information: calls, the checked calls, the reference's seconds).
    ``n`` overrides the configuration's size (the CPU tests);
    ``driver_hook`` wraps the driver (the tests' broken paths);
    ``control`` also reads the check's numbers for the control, the
    reference in bfloat16 from the same starts, into the information's
    ``control``."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_json("workloads", cell)
    cfg = load_json("configs", spec["config"])
    traffic = load_json("traffic", spec["traffic"])
    n = n or cfg["n"]
    dev = torch.device(device)
    drv_cls = load_module("drivers", traffic["driver"]).Driver
    t_driver = time.perf_counter()
    driver = drv_cls(cfg, traffic, dev, seed, n)
    if driver_hook is not None:
        driver = driver_hook(driver)
    t_warm = time.perf_counter()
    driver.start()
    for _ in range(traffic["warm_calls"]):
        driver.fetch(driver.call())
    # the window holds up to four states cloned for the check at once: the
    # caching allocator gets their memory now, not inside the window
    held = [driver.snapshot() for _ in range(3)] + [driver.outputs()]
    del held
    driver.start()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    setup_parts = {"imports": t_driver - t_start,
                   "driver": t_warm - t_driver, "warm": t_end - t_warm}

    w = window(driver, seconds, seed,
               traffic["trace_calls"] if traced else 0,
               traffic.get("trace_after", 0), dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    driver.close()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx = Context(cfg=cfg, traffic=traffic, n=n, rounds=traffic["rounds"],
                  calls=w["calls"], call_s=w["call_s"], host_s=w["host_s"],
                  wall_s=w["wall_s"], setup_s=setup_s)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        t0, te, a, k = w["traced"]
        ctx.dev, ctx.host = trace.events(w["profile"])
        ctx.window_s = te - t0
        ctx.busy_s = trace.busy(ctx.dev)[0] * 1e-6
        ctx.traced_rounds = k * traffic["rounds"]
        ctx.host_ms = [h * 1e3 for h in w["host_s"][a + k:]]
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        breakdown = trace.breakdown(ctx.dev, ctx.host)
        del w["profile"]
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(cell, section):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    info = {"cell": cell, "seed": seed, "calls": w["calls"],
            "call_samples": len(w["call_s"]),
            "rounds_per_call": traffic["rounds"], "wall_s": w["wall_s"],
            "setup_parts": setup_parts,
            "call_ms": _quantiles(w["call_s"]),
            "host_ms": _quantiles(w["host_s"]),
            "checked_calls": [0] + ([w["picked"][0]["call"]]
                                    if w["picked"] else [])}
    t_ref = time.perf_counter()
    pairs, P = reference_pairs(w, cfg, traffic, seed, n, dev)
    info["reference_s"] = time.perf_counter() - t_ref
    values = check.readings(pairs, P, traffic)
    if control:
        ctrl, _ = reference_pairs(w, cfg, traffic, seed, n, dev,
                                  torch.bfloat16)
        info["control"] = check.readings(
            [(_as_outputs(c[1]), r) for c, (_, r) in zip(ctrl, pairs)], P,
            traffic)
    correct, checks = check.judge(values, spec.get("limits", {}))
    result = {"correct": correct, "attempted": w["calls"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, info
