#!/usr/bin/env python3
"""Time the round kernels, the sum kernel, the draw kernel or the lane
kernel of two checkouts of this repository on one card.

    python3 kernel_ab.py [--sums | --draws | --lanes] OLD NEW

OLD and NEW are repository roots (for example a ``git archive`` of the
parent commit unpacked under ``build/``, and ``.``). They run in the
order OLD, NEW, NEW, OLD, every run in a process of its own that
imports that root's ``consul_tpu_torch`` and builds its kernels. Every
run times each variant of ``chip_smoke.timing_cases`` by
``chip_smoke.launch_times`` of this file's directory: the device's time
per launch (CUDA-graph replay), CUDA events around back-to-back calls,
and the host's time per wrapper call, so both checkouts are measured
one way. The inputs are ``chip_smoke.check_inputs``, each root's own
plain path warming the state.

With ``--sums`` every run times the sum kernel instead: each
``tree_sum`` shape of ``chip_smoke.draw_timing_cases`` by
``chip_smoke._graph_ms`` (device time), beside ``torch.sum(x, -1)``
timed the same way and the launches a sum, each shape again for every
``SUM_GROUPS_TRIED`` (the float4 groups a thread of a cut row's CTA,
``fused.SUM_GROUPS``, where the checkout has it), and each engine of
``chip_smoke.engine_cases`` on the kernels under the profiler: its
device µs a round and the sum kernel's share of them.

With ``--draws`` every run times the draw kernel instead: each draw
shape of ``chip_smoke.draw_timing_cases`` and of ``small_draws`` as the
prng call that makes it (``bounds=False``: the same call on either
design, its launches and device µs by ``chip_smoke._graph_ms``), and
each engine of
``chip_smoke.engine_cases`` on the kernels under the profiler: its
device µs a round, the draw kernel's share of them and its threefry
launches a call.

With ``--lanes`` every run times the lane engine's period instead:
``lane_round`` at ``chip_smoke.lane_timing_cases`` (device ms by
CUDA-graph replay, its bound, the plain body's ms; a checkout without
the kernel times none), and each lane-engine case of
``chip_smoke.engine_cases`` on the kernels under the profiler: its
device µs and kernels a round, ``lane_round``'s µs a round and its
launches a call.

Prints one JSON line per run, then one object of the runs in order,
then nvidia-smi's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
#: the cut rows' CTA sizes ``--sums`` times: 1, 2 and 4 float4 groups a
#: thread (4 keeps the grid rows [2048, 65,536] at one CTA a row)
SUM_GROUPS_TRIED = (1, 2, 4)
#: the rounds of a kernel-runner call and the nodes of a small pool whose
#: draws ``--draws`` also times, where a launch's time is its latency
SMALL_ROUNDS, SMALL_NODES = 48, 4_096


def one(root: pathlib.Path) -> dict:
    """Every timed variant of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import types

    import torch

    from consul_tpu_torch import bench, faults
    from consul_tpu_torch.sim import (cuda_round, params, prng, round,
                                      scenarios, state)

    if pathlib.Path(cuda_round.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {cuda_round.__file__}, not {root}")
    smoke = _smoke()
    m = types.SimpleNamespace(bench=bench, cuda_round=cuda_round,
                              faults=faults, params=params, prng=prng,
                              round=round, scenarios=scenarios,
                              state=state)
    inputs, _ = smoke.check_inputs(torch, m, torch.device("cuda", 0))
    out = {}
    for name, p, mega, fx in smoke.timing_cases(m, inputs):
        kern, _, reps = smoke.kernel_call(m, inputs, p, mega, fx)
        out[name] = smoke.launch_times(torch, kern, reps)
    return out


def _smoke():
    spec = importlib.util.spec_from_file_location("ab_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def sums(root: pathlib.Path) -> dict:
    """The sum kernel of the checkout at ``root`` at its paths' shapes
    and in the draws phase's engines."""
    sys.path.insert(0, str(root))
    import torch

    smoke = _smoke()
    m = smoke.modules()
    if pathlib.Path(m.fused.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {m.fused.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    shapes, engines, groups = {}, {}, {}
    cases = [c for c in smoke.draw_timing_cases(torch, m, dev)
             if c[0] == "tree_sum"]
    for _, shape, kern, _, bound, library in cases:
        m.fused.reset_launches()
        kern()
        shapes[shape] = {"launches": m.fused.LAUNCHES["tree_sum"],
                         "ms": smoke._graph_ms(torch, kern, 200),
                         "library_ms": smoke._graph_ms(torch, library, 200),
                         "bound_ms": bound["bound_ms"]}
    kept = getattr(m.fused, "SUM_GROUPS", None)
    for g in SUM_GROUPS_TRIED if kept else ():
        m.fused.SUM_GROUPS = g
        m.fused.sum_plan.cache_clear()
        groups[g] = {shape: smoke._graph_ms(torch, kern, 200)
                     for _, shape, kern, *_ in cases}
    if kept:
        m.fused.SUM_GROUPS = kept
        m.fused.sum_plan.cache_clear()
    for label, prep, call, rounds, warm, traced in smoke.engine_cases(
            torch, m, dev):
        t_call, t_rounds = traced or (call, rounds)
        for _ in range(warm):
            call(*prep())
        args = prep()
        _, prof = m.bench.profile_call(lambda: t_call(*args), t_rounds, dev)
        engines[label] = {
            "device_us_per_round": prof["device_busy_us"] / t_rounds,
            "tree_sum_us_per_round": smoke.sum_us_per_round(prof)}
    return {"shapes": shapes, "groups": groups, "engines": engines}


def small_draws(torch, smoke, P, dev) -> list:
    """(shape, prng call) of the small draws: a ``SMALL_ROUNDS``-round
    call's keys and seeds, ``split(k, 5)`` and a round's slots over
    ``SMALL_NODES`` nodes on the live and lane engines."""
    k = P.key(23, device=dev)
    start = torch.tensor(5, device=dev)
    slots, n = smoke.ROUND_SLOTS, SMALL_NODES
    return [
        (f"round_keys x{SMALL_ROUNDS}",
         lambda: P.round_keys(k, start, SMALL_ROUNDS)),
        (f"round_seeds x{SMALL_ROUNDS}",
         lambda: P.round_seeds(k, start, SMALL_ROUNDS)),
        ("split x5", lambda: P.split(k, 5)),
        (f"threefry_u01 slots {slots} x{n}",
         lambda: smoke.round_draws(P.threefry_u01, slots, k, n)),
        (f"global_u01 slots {slots} x{n}",
         lambda: smoke.round_draws(P.global_u01, slots, k, 0, n))]


def draws(root: pathlib.Path) -> dict:
    """The draw kernel of the checkout at ``root``: each draw shape's
    launches and device ms, and the draws phase's engines."""
    sys.path.insert(0, str(root))
    import torch

    smoke = _smoke()
    m = smoke.modules()
    if pathlib.Path(m.fused.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {m.fused.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    shapes, engines = {}, {}
    cases = [(shape, kern) for name, shape, kern, *_ in
             smoke.draw_timing_cases(torch, m, dev, bounds=False)
             if name != "tree_sum"]
    for shape, kern in cases + small_draws(torch, smoke, m.prng, dev):
        m.fused.reset_launches()
        kern()
        shapes[shape] = {"launches": dict(m.fused.LAUNCHES),
                         "ms": smoke._graph_ms(torch, kern, 200)}
    for label, prep, call, rounds, warm, traced in smoke.engine_cases(
            torch, m, dev):
        t_call, t_rounds = traced or (call, rounds)
        for _ in range(warm):
            call(*prep())
        args = prep()
        m.fused.reset_launches()
        call(*args)
        fry = sum(v for k, v in m.fused.LAUNCHES.items()
                  if k.startswith("threefry/"))
        args = prep()
        _, prof = m.bench.profile_call(lambda: t_call(*args), t_rounds, dev)
        engines[label] = {
            "device_us_per_round": prof["device_busy_us"] / t_rounds,
            "threefry_us_per_round": smoke.draw_us_per_round(prof),
            "threefry_launches_per_call": fry, "rounds": rounds}
    return {"shapes": shapes, "engines": engines}


#: the lane kernel's name in a profile
LANE_KERNEL_NAMES = r"\blane_round\b"


def lanes(root: pathlib.Path) -> dict:
    """The lane engine of the checkout at ``root``: ``lane_round``'s
    launches where the checkout has it (``chip_smoke.time_lane_kernel``:
    device ms by CUDA-graph replay, its bound, the plain body's ms), and
    each lane-engine case of ``chip_smoke.engine_cases`` on the kernels
    under the profiler: its device µs and kernels a round, the lane
    kernel's µs a round and its launches a call."""
    sys.path.insert(0, str(root))
    import re

    import torch

    smoke = _smoke()
    m = smoke.modules()
    if pathlib.Path(m.fused.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {m.fused.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    kernel, engines = {}, {}
    if m.lane_kernel is not None:
        inputs, _ = smoke.check_inputs(torch, m, dev)
        kernel = {name: {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "x_bound")}
                  for name, t in smoke.time_lane_kernel(torch, m,
                                                        inputs).items()}
    names = re.compile(LANE_KERNEL_NAMES)
    for label, prep, call, rounds, warm, traced in smoke.engine_cases(
            torch, m, dev):
        if not label.startswith("lane engine"):
            continue
        for _ in range(warm):
            call(*prep())
        args = prep()
        m.fused.reset_launches()
        call(*args)
        launches = m.fused.LAUNCHES.get("lane_round", 0)
        args = prep()
        _, prof = m.bench.profile_call(lambda: call(*args), rounds, dev)
        engines[label] = {
            "device_us_per_round": prof["device_busy_us"] / rounds,
            "kernels_per_round": prof.get("kernels_per_round"),
            "lane_round_us_per_round": smoke._us_per_round(prof, names),
            "lane_round_launches_per_call": launches, "rounds": rounds}
    return {"kernel": kernel, "engines": engines}


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        fn = {"sums": sums, "draws": draws,
              "lanes": lanes}.get(argv[1], one)
        print(json.dumps(fn(pathlib.Path(argv[2]).resolve())), flush=True)
        return 0
    what = "rounds"
    if argv[:1] in (["--sums"], ["--draws"], ["--lanes"]):
        what, argv = argv[0][2:], argv[1:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (str(pathlib.Path(a).resolve()) for a in argv)
    runs = []
    for label, root in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        res = subprocess.run([sys.executable, __file__, "--one", what, root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"kernel_ab: the {label} run ({root}) failed")
        runs.append({"checkout": label,
                     "kernels": json.loads(res.stdout.splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": runs}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
