"""Continuous-batching serving bench on the card (port of the
repository's tools/bench_serve.py): sustained audio seconds per wall
second, time to first audio (TTFA) and queue wait of a churning load on
``ContinuousBatcher``, the 0.6B model at its full widths with random
weights.

An engine from random weights (``Qwen3TTS.from_components``), a batcher
of --slots slots (T=0.9, top-k 50, seed 0, a --frames cap a request);
``warmup(token_buckets=(16, 48))`` and one warm-up request; then
--requests requests submitted at once, each with an ``on_audio`` stamp of
its first audio, and ``step()`` until nothing is pending. TTFA counts
from admission (from submit less the queue wait), as the JAX tool does;
stderr also has it from submit, the queue wait and the request latency.
A failed request (a request that samples EOS on its first frame is one,
"No speech codes generated", as in the JAX package) makes the tool print
a JSON line with an ``error`` key and exit 2; stderr has the served
requests' numbers all the same.

Run: ``python -m qwen3_tts_tpu_torch.tools.bench_serve [--slots 16]
[--requests 48] [--frames 120]`` on the card; ``--device cpu --tiny``
checks the flow on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib

import numpy as np
import torch

from ..models import talker
from ..runtime.pipeline import Qwen3TTS, TTSParams
from ..runtime.serve import ContinuousBatcher
from .bench_common import (NoDevice, add_common_args, card_line, env,
                           launch_counts, launches_since, log, random_weights,
                           resolve_device, sync)

CHUNK_AUDIO_MS = 40 / 12.5 * 1e3        # one 40-frame chunk of audio


class RandomTokenizer:
    """Stand-in tokenizer: 48 pseudo-random ids per text, below
    min(vocab_size, 1000), seeded by the text's crc32 (a str hash is
    salted per process)."""

    def __init__(self, vocab_size: int, n_tokens: int = 48):
        self.vocab_size = vocab_size
        self.n_tokens = n_tokens

    def encode_for_tts(self, text: str) -> list[int]:
        rng = np.random.default_rng(zlib.crc32(text.encode()) % (2 ** 31))
        return rng.integers(0, min(self.vocab_size, 1000),
                            self.n_tokens).tolist()


class FirstAudioStamp:
    """on_audio callback: the wall time of a request's first audio."""

    def __init__(self):
        self.t: float | None = None

    def __call__(self, samples, final) -> None:
        if self.t is None and len(samples):
            self.t = time.monotonic()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tts_tpu_torch.tools.bench_serve",
        description="continuous-batching bench (module docstring)")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--frames", type=int, default=120,
                    help="frame cap a request (9.6 s of audio at 12.5 Hz)")
    ap.add_argument("--kv", choices=("bf16", "int8"), default=None,
                    help="talker KV dtype (default: QWEN3_TTS_KV, else bf16)")
    ap.add_argument("--talker", choices=("auto", "xla", "fused"),
                    default=None,
                    help="talker decode step (default: QWEN3_TTS_TALKER, "
                         "else auto)")
    add_common_args(ap)
    return ap.parse_args(argv)


def _pct(a, q) -> float:
    return float(np.percentile(np.asarray(a), q))


def run(args, weights, device: torch.device, out=None) -> int:
    """The serving load on `weights` ((cfg, talker_w, vcfg, voc_w) on
    `device`); prints the JSON record on `out` (stdout). Returns 0, or 2
    when a request failed."""
    with env("QWEN3_TTS_KV", args.kv):
        talker.set_talker_step_impl(args.talker)
        try:
            return _run(args, weights, device,
                        sys.stdout if out is None else out)
        finally:
            talker.set_talker_step_impl(None)


def _run(args, weights, device, out) -> int:
    cfg, talker_w, vcfg, voc_w = weights
    log(card_line(device))
    engine = Qwen3TTS.from_components(
        RandomTokenizer(cfg.text_vocab_size), cfg, talker_w, vcfg, voc_w,
        device)
    cb = ContinuousBatcher(engine, n_slots=args.slots, params=TTSParams(
        temperature=0.9, top_k=50, print_timing=False, seed=0),
        max_frames=args.frames)
    t0 = time.monotonic()
    cb.warmup(token_buckets=(16, 48))   # RandomTokenizer emits 48 ids
    cb.submit("warmup")
    cb.run_all()
    log(f"warmup: {time.monotonic() - t0:.1f} s")

    before = launch_counts()
    submit_t: dict[int, float] = {}
    stamps: dict[int, FirstAudioStamp] = {}
    for i in range(args.requests):
        stamp = FirstAudioStamp()
        t_sub = time.monotonic()
        rid = cb.submit(f"request number {i}", on_audio=stamp)
        submit_t[rid], stamps[rid] = t_sub, stamp

    t0 = time.monotonic()
    lat, ttfa_submit, ttfa_admit, queue_wait = [], [], [], []
    total_audio, n_done, n_failed = 0.0, 0, 0
    while cb.pending():
        for rid, r in cb.step().items():
            if not r.success:
                # counted as served, a failure would deflate the metric
                n_failed += 1
                log(f"request FAILED: {r.error_msg}")
                continue
            lat.append(r.t_total_ms)
            stamp = stamps.get(rid)
            if stamp is not None and stamp.t is not None:
                from_submit = (stamp.t - submit_t[rid]) * 1e3
                ttfa_submit.append(from_submit)
                ttfa_admit.append(from_submit - r.t_queue_ms)
                queue_wait.append(r.t_queue_ms)
            total_audio += len(r.audio) / r.sample_rate
            n_done += 1
    sync(device)
    wall = time.monotonic() - t0
    metric = f"aggregate_realtime_x_slots{args.slots}"
    log(f"kernel launches while serving: {launches_since(before)}")
    # the served requests' numbers, on stderr, whether or not some failed
    log(f"served {n_done} requests ({n_failed} failed) in {wall:.3f} s wall")
    log(f"audio generated: {total_audio:.1f} s -> "
        f"{total_audio / wall:.2f}x realtime aggregate")
    if lat:
        log(f"request latency ms: p50={_pct(lat, 50):.0f} "
            f"p90={_pct(lat, 90):.0f} max={max(lat):.0f}")
    ttfa_p50 = ttfa_p99 = -1.0
    if ttfa_admit:
        ttfa_p50, ttfa_p99 = _pct(ttfa_admit, 50), _pct(ttfa_admit, 99)
        target = 2 * CHUNK_AUDIO_MS
        log(f"ttfa (admitted) ms: p50={ttfa_p50:.0f} p99={ttfa_p99:.0f} "
            f"max={max(ttfa_admit):.0f}  [target p99<={target:.0f} "
            f"{'MET' if ttfa_p99 <= target else 'MISSED'}]")
        log(f"ttfa (from submit) ms: p50={_pct(ttfa_submit, 50):.0f} "
            f"p99={_pct(ttfa_submit, 99):.0f}")
        log(f"queue wait ms: p50={_pct(queue_wait, 50):.0f} "
            f"p99={_pct(queue_wait, 99):.0f} max={max(queue_wait):.0f} "
            f"({len(ttfa_admit)}/{n_done} requests measured)")
    if n_failed:
        print(json.dumps({
            "metric": metric, "value": 0, "unit": "x_realtime",
            "vs_baseline": 0,
            "error": f"{n_failed}/{n_failed + n_done} requests failed"}),
            file=out, flush=True)
        return 2
    print(json.dumps({
        "metric": metric,
        "value": round(total_audio / wall, 2),
        "unit": "x_realtime",
        "vs_baseline": round(total_audio / wall / 1.01, 2),
        "ttfa_p50_ms": round(ttfa_p50, 1),
        "ttfa_p99_ms": round(ttfa_p99, 1),
    }), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except NoDevice as e:
        print(f"bench_serve: {e}", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    weights = random_weights(dev, args.tiny)
    sync(dev)
    log(f"random weights on {dev} in {time.monotonic() - t0:.1f} s")
    return run(args, weights, dev)


if __name__ == "__main__":
    sys.exit(main())
