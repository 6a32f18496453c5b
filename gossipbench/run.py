"""Run one cell of the benchmark once and print its result.

    python3 -m gossipbench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the check compared beside its limit (also the last lines of
standard error). Exits non-zero, printing no result, without a CUDA
card (or with fewer than the cell asks for), or when the process holds
a JAX module once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gossipbench import harness

    try:
        chips = harness.load_json("workloads", args.workload)["chips"]
    except FileNotFoundError:
        print(f"no cell named {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_start=T_START)
    held = harness.forbidden_modules()
    if held:
        print(f"the process holds {', '.join(held)}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return 3
    print(json.dumps({"info": info}))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
