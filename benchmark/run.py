"""Run one cell of BENCHMARK.json once, on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the weights and the traffic from
the seed, drives the window through the program (benchmark/kinds/),
frees the program's state, checks a sample of what the window served
against the plain reference (benchmark/check.py), and prints one JSON
line last on stdout: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones,
each read by benchmark/metrics/<name>.py), ``device``, with --trace 1
``breakdown``, and last ``checks``: each number compared beside its
limit, which are also the last lines on stderr.

It refuses to run (exit 1, no result) without CUDA or with fewer cards
than the cell asks for, and exits 3 with no result if JAX, flax or the
JAX package was loaded in the process. Build and kernel caches stay in
the checkout (``.bench_cache/``; the program builds its kernels into its
own ``_build/``).
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):          # run as a file: import from the root
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    __package__ = "benchmark"

import torch  # noqa: E402

from benchmark import check, record, spec, timing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_tts_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that a run may not hold."""
    names = {n.split(".")[0] for n in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout."""
    base = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def card_line(device) -> str:
    if device.type != "cuda":
        return "device: cpu (the kernels' twins; no card number)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {e})"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lengths_line(run) -> str:
    """How many streams ended before their EOS ramp, and the frame
    counts."""
    m, cap = run.cell.model, run.cell.mix["frame_cap"]
    done = [s for s in run.window_streams() if s.ok]
    early = [s for s in done
             if s.n_frames < min(cap, max(20, 4 * len(s.req.tokens)))]
    f = sorted(s.n_frames for s in done)
    if not f:
        return "frames: no request finished"
    q = [f[int(p * (len(f) - 1))] for p in (0.0, 0.25, 0.5, 0.75, 1.0)]
    return (f"streams that ended before their EOS ramp: {len(early)} of "
            f"{len(done)}; frames min/q1/median/q3/max {q}, "
            f"{sum(x == cap for x in f)} at the cap of {cap} "
            f"({m.vocoder.samples_per_frame} samples a frame)")


def release() -> None:
    """Return what was freed to the card (the caller drops its references
    first)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t0: float, control: bool = False):
    """One run of `cell`: (run record, result dict, check numbers)."""
    run = record.Run(cell, seed, seconds, trace, device, t0)
    weights = cell.arch.make_weights(cell.model, seed, device)
    _sync(device)
    log(f"weights from seed {seed} in {time.monotonic() - t0:.1f} s since "
        f"start")
    engine = spec.kind(cell).run(run, weights)
    _sync(device)
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    roofs = [x for x in cell.per_layer if x["name"].endswith("_roofline")]
    if trace and roofs and device.type == "cuda":
        run.layer_ms = timing.layer_times(run, engine,
                                          int(cell.mix.get("batch", 0))
                                          or int(cell.mix["slots"]))
    run.memory_peak_bytes = mem
    del engine, weights
    release()
    log(lengths_line(run))
    numbers = None
    spf = cell.model.vocoder.samples_per_frame
    sample = check.pick(run.window_streams(), check.CHECK_REQUESTS, seed,
                        spf)
    if sample:
        t = time.monotonic()
        ref_w = cell.arch.make_weights(cell.model, seed, device)
        numbers = check.compare(cell.arch, cell.model, cell.mix, ref_w,
                                sample, device, seed, control=control)
        del ref_w
        release()
        log(f"check: {len(sample)} requests, {numbers['tokens']} served "
            f"tokens, {numbers['chunks']} chunks, in "
            f"{time.monotonic() - t:.1f} s")
    result = result_line(run, numbers)
    return run, result, numbers


def result_line(run, numbers) -> dict:
    cell = run.cell
    wins = run.window_streams()
    failed = sum(not s.ok for s in wins)
    correct = (numbers is not None and check.judge(numbers, cell.limits)
               and failed == 0 and bool(wins))
    metrics = {}
    for mdef in (cell.per_layer if run.trace else cell.end_to_end):
        value = spec.reader(cell, mdef["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}
        elif value is not None:
            metrics[mdef["name"]] = {"value": None, "unit": mdef["unit"]}
            log(f"metric {mdef['name']}: {value} (not finite)")
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": bool(correct), "attempted": len(wins),
           "failed": failed, "metrics": metrics, "device": device}
    if run.trace and run.profile:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Path | None = None, device=None) -> int:
    """The command. `root` and `device` are for tests: another checkout
    root, and a device that skips the look for a card."""
    args = parse_args(argv)
    cell = spec.load_cell(args.workload, root)
    set_cache_dirs(cell.root)
    if device is None:
        if not torch.cuda.is_available():
            log("benchmark: no CUDA device")
            return 1
        if torch.cuda.device_count() < cell.chips:
            log(f"benchmark: {cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
            return 1
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    log(card_line(device))
    run, result, numbers = execute(cell, args.seed, args.seconds,
                                   bool(args.trace), device, T_START)
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: the run loaded {bad}; no result")
        return 3
    log(f"setup {run.setup_s:.2f} s, window {run.window_s:.2f} s, "
        f"{result['attempted']} requests due in it, {result['failed']} "
        f"failed; memory peak {run.memory_peak_bytes / 2**30:.2f} GiB")
    result["checks"] = check.report(numbers, cell.limits)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
