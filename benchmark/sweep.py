"""Sweep the station count of an open-loop cell to find its knee.

    python benchmark/sweep.py --workload mode0_srds.live --seconds 10 \
        --stations 256,320,384,448,512 --seed 11

Each station count runs the cell once (same seed, its own pool) in this one
process and prints one line: latency percentiles, blocks over the mix's
limit, the open loop's lateness and whether the latency grew over the run.
The knee is the largest count whose p99 stays within the limit with no
growing backlog; the cell runs at about four fifths of it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--stations", required=True)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)
    for n in [int(x) for x in args.stations.split(",")]:
        captured = io.StringIO()
        with contextlib.redirect_stderr(captured):
            res = run.run_cell(args.workload, args.seed, args.seconds, False,
                               overrides={"stations": n})
        sched = [ln for ln in captured.getvalue().splitlines()
                 if ln.startswith("latency ms")]
        m = res["metrics"]
        print(f"stations {n}: p50 {m['latency_p50_ms']['value']:.4f} ms, failed "
              f"{res['failed']}, correct {res['correct']}; "
              f"{sched[0] if sched else ''}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
