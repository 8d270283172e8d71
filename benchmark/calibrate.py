"""Readings for the check's limits (benchmark/check.py), on the card:
the program's numbers over many seeds (the lower readings) and the
control's (the reference in float8 in the program's place) over the
first few (the upper readings), each at the cell's own size, load and
sample, in one process:

    python3 -m benchmark.calibrate --workload offline-0.6b-b192 \\
        --seeds 11,12,13 --control 3 --seconds 12

One JSON line a seed on stdout. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import spec
from benchmark.run import execute, set_cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3,
                    help="read the control on the first N seeds")
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    set_cache_dirs(cell.root)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        run, result, numbers = execute(cell, seed, args.seconds, False, dev,
                                       t0, control=i < args.control)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"],
                          "metrics": {k: v["value"] for k, v in
                                      result["metrics"].items()},
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
