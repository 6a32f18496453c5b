#!/usr/bin/env python3
"""Time the round kernels of two checkouts of this repository on one card.

    python3 kernel_ab.py OLD NEW

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
    spec = importlib.util.spec_from_file_location("ab_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(pathlib.Path(argv[1]).resolve())), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (str(pathlib.Path(a).resolve()) for a in argv)
    runs = []
    for label, root in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        res = subprocess.run([sys.executable, __file__, "--one", root],
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
