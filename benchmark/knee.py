"""The knee of a serving cell: the highest Poisson rate at which the
queue does not grow over the window, ``chunk_gap_p95_ms`` stays at or
under one chunk of audio (3,200 ms) and ``ttfa_p95_ms`` at or under two
(6,400 ms, the limit of the repository's serving tool). Run once on the
card; its rate times 4/5 goes into the cell's traffic file:

    python3 -m benchmark.knee --workload serve-0.6b-s128 --rates 10,12,14 \\
        --seed 1 --seconds 30

One process: one engine and batcher, warmed once; each rate serves its
lead-in, window and drain in turn, then the batcher is drained. One JSON
line a rate on stdout. The queue grows where the median queue wait of the
requests due in the window's last third exceeds that of its first third
by more than half a second.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import record, spec
from benchmark.run import T_START, set_cache_dirs


def queue_growth_ms(run) -> float:
    s = sorted((x for x in run.window_streams() if x.ok), key=lambda x: x.due)
    if len(s) < 6:
        return float("nan")
    third = len(s) // 3
    return float(np.median([x.t_queue_ms for x in s[-third:]])
                 - np.median([x.t_queue_ms for x in s[:third]]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.knee")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated requests/s, low to high")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    set_cache_dirs(cell.root)
    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    drv = spec.kind(cell)
    base = record.Run(cell, args.seed, args.seconds, False, dev, T_START)
    weights = cell.arch.make_weights(cell.model, args.seed, dev)
    ctx = drv.setup(base, weights)
    print(f"knee: set-up {time.monotonic() - T_START:.1f} s (warm-up "
          f"{base.graph_warmup_s:.1f} s)", file=sys.stderr, flush=True)
    next_id = 0
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.mix, rate_per_s=rate)
        run = record.Run(cell, args.seed, args.seconds, False, dev, T_START)
        next_id = drv.serve(run, ctx, mix, first_id=next_id)
        ctx["cb"].run_all()
        out = {"rate_per_s": rate}
        for name in ("audio_s_per_s", "ttfa_p95_ms", "chunk_gap_p95_ms",
                     "queue_wait_p95_ms"):
            out[name] = spec.reader(cell, name)(run)
        out["queue_growth_ms"] = queue_growth_ms(run)
        out["due"] = len(run.window_streams())
        out["failed"] = sum(not s.ok for s in run.window_streams())
        out["ok"] = bool(out["chunk_gap_p95_ms"] <= 3200
                         and out["ttfa_p95_ms"] <= 6400
                         and out["queue_growth_ms"] <= 500)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
