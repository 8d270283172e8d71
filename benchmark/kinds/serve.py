"""Served traffic (kind "serve"): ``ContinuousBatcher`` with ``slots``
slots, ``submit`` with ``on_audio`` and ``step``, under open-loop Poisson
arrivals at ``rate_per_s`` (traffic.schedule).

Set-up: the engine, ``ContinuousBatcher.warmup`` at the mix's
``token_buckets``, then a lead-in of ``lead_in_s`` of the same arrivals,
so that the window opens on a loaded batcher. The window is
[lead-in end, + seconds): requests due in it are the ones judged.
Arrivals go on after it, and the run serves until every request due in
the window has finished (at most ``drain_max_s`` after the window; a
request still open then never came). Each request is timed from when it
was due, not from when the loop, which submits between steps, got to it:
stderr says how late the loop ran.

A traced run opens the profiler once every request due in the window has
finished, on the load that goes on arriving, and closes it
``trace_slice_steps`` steps later: the profiler's own cost touches no
judged request."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import program, traffic
from benchmark.devtrace import Slice
from benchmark.record import Stream
from benchmark.seeds import sub_seed


def setup(run, weights) -> dict:
    """The engine and its batcher, warmed up at the mix's token buckets."""
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    cell, dev = run.cell, run.device
    m, mix = cell.model, cell.mix
    tok = program.TokenTable()
    engine = cell.arch.make_engine(m, weights, tok, dev)
    tap = program.CodeTap(engine)
    params = TTSParams(
        max_audio_tokens=int(mix["frame_cap"]),
        temperature=float(mix["temperature"]), top_k=int(mix["top_k"]),
        top_p=float(mix["top_p"]),
        repetition_penalty=float(mix["repetition_penalty"]),
        seed=sub_seed(run.seed, "noise") % (1 << 31), print_timing=False)
    cb = ContinuousBatcher(engine, n_slots=int(mix["slots"]), params=params,
                           max_frames=int(mix["frame_cap"]))
    t = time.monotonic()
    cb.warmup(token_buckets=tuple(mix["token_buckets"]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.graph_warmup_s = time.monotonic() - t
    return {"engine": engine, "cb": cb, "tap": tap, "tok": tok,
            "voices": weights.voices.float().cpu().numpy()}


def serve(run, ctx: dict, mix: dict, first_id: int = 0) -> int:
    """The lead-in, the window and the drain at `mix`'s arrivals, into
    `run`; returns the next free request id."""
    cell, dev = run.cell, run.device
    m = cell.model
    cb, tap, voices = ctx["cb"], ctx["tap"], ctx["voices"]
    lead, drain = float(mix["lead_in_s"]), float(mix["drain_max_s"])
    reqs = traffic.schedule(mix, m.special, m.text_vocab, len(voices),
                            run.seed, lead + run.seconds + drain,
                            first_id=first_id)
    ctx["tok"].add(reqs)
    t_s = time.monotonic()
    ws, we = t_s + lead, t_s + lead + run.seconds
    run.t_window0, run.t_window1 = ws, we
    trace = Slice(dev, float("inf"), mix["trace_slice_steps"], run.trace)
    by_rid: dict = {}
    judged: list = []
    i = 0
    while True:
        now = time.monotonic()
        while i < len(reqs) and t_s + reqs[i].due <= now:
            r = reqs[i]
            s = Stream(r, t_s + r.due, ws <= t_s + r.due < we)
            s.submitted = now
            rid = cb.submit(r.text, embedding=voices[r.voice],
                            on_audio=lambda x, final, s=s: s.on_audio(tap, x))
            by_rid[rid] = s
            run.streams.append(s)
            if s.in_window:
                judged.append(s)
            i += 1
        if now >= we and all(s.finished for s in judged):
            if not trace.on or trace.t_close is not None:
                break
            trace.start_at = min(trace.start_at, now)
        if now >= we + drain:
            print(f"serve: {sum(not s.finished for s in judged)} request(s) "
                  f"due in the window still open {drain:.0f} s after it",
                  file=sys.stderr, flush=True)
            break
        if cb.pending():
            for rid, res in cb.step().items():
                by_rid[rid].finish(res)
            trace.tick()
        elif i < len(reqs):
            time.sleep(max(0.0, min(t_s + reqs[i].due - time.monotonic(),
                                    0.05)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.profile = trace.finish()
    late = [(s.submitted - s.due) * 1e3 for s in judged]
    if late:
        print(f"serve: the loop submitted requests due in the window "
              f"{np.median(late):.1f} ms late at the median, "
              f"{np.percentile(late, 95):.1f} ms at p95, "
              f"{max(late):.1f} ms at most ({len(judged)} due; "
              f"{i} submitted in all)", file=sys.stderr, flush=True)
    return first_id + len(reqs)


def run(run, weights) -> object:
    """Drive the window into `run`; returns the engine."""
    ctx = setup(run, weights)
    serve(run, ctx, run.cell.mix)
    return ctx["engine"]
