#!/usr/bin/env python3
"""Time the round kernels, or the sum kernel, of two checkouts of this
repository on one card.

    python3 kernel_ab.py [--sums] OLD NEW

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


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        fn = sums if argv[1] == "sums" else one
        print(json.dumps(fn(pathlib.Path(argv[2]).resolve())), flush=True)
        return 0
    what = "rounds"
    if argv[:1] == ["--sums"]:
        what, argv = "sums", argv[1:]
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
