"""The rooflines' denominators: each layer's call timed alone by CUDA
events over N calls at the cell's batch (the loop of the program's
tools/bench_breakdown.py). The calls and their counts are the cell's
architecture's (``layer_calls``, benchmark/archs/). A call is captured
into a CUDA graph and replayed, as the timed path replays its frames, so
that launch overhead on the host does not stand in for the layer's time;
a call that replays the program's own graphs is timed as it is. A capture
that fails, or a layer's entry point that fails, raises: the traced run
then ends with no result, rather than with a roofline that times
something else or is missing. All run after the window, in the traced
run only."""

from __future__ import annotations

import sys

import torch

from . import roofline


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_call(fn, iters: int, device, capture: bool = True
              ) -> tuple[float, str]:
    """(seconds a call, how it was replayed); `capture` False for a call
    that replays the program's own graphs."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    mode, call = "program graphs", fn
    if capture:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        g.replay()
        torch.cuda.synchronize(device)
        mode, call = "graph", g.replay
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3 / iters, mode


def layer_times(run, engine, B: int) -> dict:
    """{layer: (seconds a call, mode, flops, bytes)} at batch B, for each
    call of the cell's architecture's ``layer_calls``."""
    out: dict = {}
    with torch.inference_mode():
        for name, fn, iters, capture, counts in run.cell.arch.layer_calls(
                run, engine, B):
            s, mode = time_call(fn, iters, run.device, capture)
            out[name] = (s, mode, *counts)
    for k, (s, mode, fl, by) in out.items():
        _log(f"layer {k}: {s * 1e3:.4f} ms a call ({mode}, B={B}); bound "
             f"{roofline.bound_s(fl, by) * 1e3:.4f} ms ({fl / 1e9:.2f} "
             f"GFLOP, {by / 1e6:.1f} MB): "
             f"{roofline.share_pct(fl, by, s):.2f}% of the roofline")
    return out
