"""Readings that set the limits of `correct`: the program and its control.

    python benchmark/control.py --workload mode2_srds.batch --seconds 30 \
        --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed, one run of the cell as the benchmark makes it (its load,
its window, the timed path) prints the numbers compared with the reference
(the lower readings).  On the control seeds the reference computed one
precision below the configuration's (reference.py, precision 'control')
takes the program's place, on the same stations and stream, and its numbers
are printed beside them (the upper readings).  All seeds run in this one
process.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           control=seed in ctl)
        line = {"seed": seed, "correct": res["correct"],
                "program": {k: v["value"] for k, v in res["checks"].items()}}
        if "control_checks" in res:
            line["control"] = res["control_checks"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
