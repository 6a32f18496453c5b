"""Readings for the check's limits: the numbers the program gives on
many seeds, and those the control gives (the reference in bfloat16 in
the program's place) on a few, in one process, so set-up is paid once.

    python3 -m gossipbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--out <file.jsonl>]

One JSON line a seed: the program's numbers (and the control's on the
control seeds), the calls run and checked, the reference's seconds. The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from gossipbench import harness

    if not torch.cuda.is_available():
        print("calibration reads the card", file=sys.stderr)
        return 2
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(control - set(seeds))
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            res, info = harness.run_cell(args.workload, seed, args.seconds,
                                         False, control=seed in control)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "program": {k: c["value"] for k, c in
                                           res["checks"].items()},
                               "metrics": res["metrics"], **info})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
