"""Offline traffic (kind "offline"): ``Qwen3TTS.synthesize_batch`` with
``on_chunk``, in a closed loop of ``batch`` requests a call, one call after
another.

Set-up: the engine, one untimed call of the cell's shape (the frame
graph and the lock-step buffers), and the vocoder's decode at every batch
bucket a wave of this batch can reach, so that nothing is captured inside
the window. The window starts with the first timed call and runs whole
calls until ``seconds`` have passed at a call's end; it ends when the
last call returns. Every request of those calls is in the window, and the
rate is taken over all their audio and all the window's time.

A traced run then traces one boundary between two calls, after the
window, since the window is made of whole calls and its idle time sits at
their ends. Two more calls run; the profiler opens at the first call's
wave ``frame_cap // 40`` of audio (its last wave that a stream at the cap
fills, with the last chunk in flight), holds that call's ragged-tail
flush, the host's work between the calls and the second call's prefill
and first chunk, and closes at the second call's first wave of audio,
which stops that call. So the slice holds a fixed count of waves and one
of each kind of gap that the window holds, the boundary weighing more in
it than in a whole call. The profiler's own cost stays out of the
window."""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import program, traffic
from benchmark.devtrace import Slice
from benchmark.record import Stream
from benchmark.seeds import sub_seed


CHUNK_FRAMES = 40          # frames a wave of audio carries


class _SliceDone(Exception):
    """Stops the traced call once its slice is read."""


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trace_boundary(call, tap, dev, mix: dict, first_id: int, B: int):
    """The profiler over one boundary between two calls (module
    docstring); the slice's summary, or None where nothing was traced."""
    trace = Slice(dev, float("inf"), 1, True)
    open_wave = max(1, int(mix["frame_cap"]) // CHUNK_FRAMES)
    seen, waves = [tap.batches], [0]

    def new_wave() -> bool:               # once a wave: its first stream
        if tap.batches == seen[0]:
            return False
        seen[0] = tap.batches
        waves[0] += 1
        return True

    def tick_first():
        if new_wave() and waves[0] == open_wave:
            trace.start_at = -math.inf
            trace.tick()

    def tick_second():
        if new_wave():
            trace.tick()                  # closes the slice
            raise _SliceDone

    call("trace-a", first_id, False, tick_first)
    if trace.on and trace.prof is None:
        print(f"offline: the traced call had {waves[0]} waves, under "
              f"{open_wave}; the slice opens at its end",
              file=sys.stderr, flush=True)
        trace.start_at = -math.inf
        trace.tick()
    try:
        call("trace-b", first_id + B, False, tick_second)
    except _SliceDone:
        pass
    _sync(dev)
    return trace.finish()


def run(run, weights) -> object:
    """Drive the window into `run`; returns the engine (for the layer
    timings of a traced run)."""
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    cell, dev = run.cell, run.device
    m, mix = cell.model, cell.mix
    tok = program.TokenTable()
    engine = cell.arch.make_engine(m, weights, tok, dev)
    tap = program.CodeTap(engine)
    voices = weights.voices.float().cpu().numpy()
    B = int(mix["batch"])
    params = TTSParams(
        max_audio_tokens=int(mix["frame_cap"]),
        temperature=float(mix["temperature"]), top_k=int(mix["top_k"]),
        top_p=float(mix["top_p"]),
        repetition_penalty=float(mix["repetition_penalty"]),
        print_timing=False)

    def call(key, first_id: int, in_window: bool, tick=None) -> list:
        reqs = traffic.make_requests(mix, m.special, m.text_vocab,
                                     len(voices), run.seed, B, B,
                                     first_id=first_id, key=key)
        tok.add(reqs)
        t_call = time.monotonic()
        streams = [Stream(r, t_call, in_window) for r in reqs]

        def on_chunk(b, samples):
            streams[b].on_audio(tap, samples)
            if tick is not None:
                tick()

        gen = torch.Generator(device=dev).manual_seed(
            sub_seed(run.seed, "noise", key))
        results = engine.synthesize_batch(
            [r.text for r in reqs], [voices[r.voice] for r in reqs], params,
            gen, on_chunk)
        for s, res in zip(streams, results):
            s.finish(res)
        return streams

    t = time.monotonic()
    call("warm", -B, False)
    for nb in sorted({engine.voc_bucket(n, B) for n in range(1, B + 1)},
                     reverse=True):
        engine._decode_chunk_batch(
            np.zeros((nb, 40, m.n_codebooks), np.int32), pcm16=True)
    _sync(dev)
    run.graph_warmup_s = time.monotonic() - t

    run.t_window0 = t0 = time.monotonic()
    k = 0
    while k == 0 or time.monotonic() - t0 < run.seconds:
        t = time.monotonic()
        streams = call(f"call-{k}", k * B, True)
        audio = sum(n for s in streams for _, n in s.events)
        print(f"offline: call {k} {time.monotonic() - t:.3f} s, "
              f"{audio / m.vocoder.sample_rate:.1f} s of audio",
              file=sys.stderr, flush=True)
        run.streams += streams
        k += 1
    _sync(dev)
    run.t_window1 = time.monotonic()
    if run.trace:
        run.profile = _trace_boundary(call, tap, dev, mix, k * B, B)
    return engine
