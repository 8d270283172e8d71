"""Lock-step throughput bench on the card (port of the repository's
bench.py): ms of card time per generated frame per stream at B
concurrent streams, the 0.6B model at its full widths with random
weights (the FLOPs and bytes of real ones).

One ladder entry (``measure_entry``), for B streams of 48 token ids drawn
by ``np.random.default_rng(0)`` below min(1000, text vocabulary), with
zero speaker embeddings, a cache of ``required_ctx(prefill, --max-frames,
40)`` slots (int8 or bf16, the stacked layout) and T=--temperature,
repetition penalty 1.05, top-k 50; three timed sections, each fenced by
``torch.cuda.synchronize()`` on the host clock:

- generation alone: one warm chunk, then --chunks 40-frame chunks;
- the vocoder alone: 8 decodes of one random [B, 40, 16] chunk of codes
  (causal trim, int16 PCM) in sub-batches of --voc-sub streams (default:
  the width the pipeline itself takes for B, ``Qwen3TTS.voc_sub``);
- the pipelined run (the headline): chunk k+1 is enqueued before chunk
  k's codes are read back and a chunk is decoded, and the final chunk is
  decoded too; the median of --runs.

Every chunk and decode goes through the engine's own executables, the
CUDA graphs that ``synthesize_batch`` and serving replay:
``Qwen3TTS._gen_fn`` over the engine's static lock-step state
(``Qwen3TTS._lockstep_state``), ``Qwen3TTS._decode_chunk_batch`` (the
pinned upload and ``_voc_fn``'s graph), and chunk codes leave through
``stream.Readback``. The read window is tracked on the host, as the
pipeline does. Each timed section starts from a fresh prefill into the
same buffers, so no section writes past the cache (which holds
--max-frames frames, or a section's chunks if they are more); with the
defaults every chunk reads the whole cache, as it would in a longer run.

Each entry prints one JSON line on stdout with the keys of the JAX
package's bench; ``voc_impl`` is what ran (``res_chain_impl_traced``).
The card's name and power limit, the sub-batch width and each kernel
wrapper's launches go to stderr. ``--ladder`` measures several entries in
one process, one engine each, freed between them.

Run: ``python -m qwen3_tts_tpu_torch.tools.bench [--batch 192] [--kv
int8]`` or ``--ladder 192:int8:stacked,256:int8:stacked`` on the card;
``--device cpu --tiny`` checks the flow on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from ..models import talker, vocoder
from ..ops import vocoder_fused as vf
from ..runtime.generate import ctx_bucket, required_ctx
from ..runtime.pipeline import Qwen3TTS, TTSParams
from ..runtime.stream import Readback
from .bench_common import (FRAME_BUDGET_MS, NoDevice, add_common_args,
                           card_line, env, launch_counts, launches_since, log,
                           random_weights, resolve_device, sync)

CHUNK = 40                 # frames a generation chunk (pipeline.CHUNK_FRAMES)
N_TOKENS = 48              # token ids a stream
N_VOC = 8                  # decodes of the vocoder-alone section
TALKERS = ("auto", "xla", "fused")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tts_tpu_torch.tools.bench",
        description="lock-step throughput bench (module docstring)")
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--kv", choices=("int8", "bf16"), default="int8",
                    help="talker KV cache dtype")
    ap.add_argument("--talker", choices=TALKERS, default=None,
                    help="talker decode step (default: QWEN3_TTS_TALKER, "
                         "else auto)")
    ap.add_argument("--ladder", default=None,
                    help="comma-separated B:kv:cache[:talker] entries in one "
                         "process, e.g. 192:int8:stacked,256:int8:stacked "
                         "(cache: stacked; overrides --batch/--kv/--talker)")
    ap.add_argument("--voc-sub", type=int, default=None,
                    help="vocoder sub-batch width (default: the pipeline's "
                         "for B)")
    ap.add_argument("--chunks", type=int, default=3,
                    help="measured generation chunks a run (>= 1)")
    ap.add_argument("--runs", type=int, default=3,
                    help="pipelined runs; the median is reported")
    ap.add_argument("--max-frames", type=int, default=400)
    ap.add_argument("--temperature", type=float, default=0.9)
    ap.add_argument("--check-fused", action="store_true",
                    help="hold the vocoder kernels against their twins on "
                         "one sub-batch of the bench's codes")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.chunks < 1:
        ap.error("--chunks must be >= 1")
    if args.runs < 1:
        ap.error("--runs must be >= 1")
    args.entries = ladder_entries(ap, args)
    return args


def ladder_entries(ap: argparse.ArgumentParser, args
                   ) -> list[tuple[int, str, str, str | None]]:
    """(B, kv, cache, talker) per entry: --ladder parsed as the JAX bench
    parses it, else the single entry of --batch/--kv/--talker. The port
    has the stacked cache only: "layered" is refused."""
    if not args.ladder:
        return [(args.batch, args.kv, "stacked", args.talker)]
    entries = []
    for spec in args.ladder.split(","):
        parts = spec.strip().split(":")
        if len(parts) not in (3, 4) or parts[1] not in ("int8", "bf16") \
                or parts[2] not in ("stacked", "layered") \
                or (len(parts) == 4 and parts[3] not in TALKERS) \
                or not parts[0].isdigit() or int(parts[0]) < 1:
            ap.error(f"bad --ladder entry {spec!r} (want "
                     "B:int8|bf16:stacked[:auto|xla|fused])")
        if parts[2] == "layered":
            ap.error(f"--ladder entry {spec!r}: the port has no layered "
                     "cache (QWEN3_TTS_CACHE=layered is not ported); use "
                     "stacked")
        entries.append((int(parts[0]), parts[1], parts[2],
                        parts[3] if len(parts) == 4 else args.talker))
    return entries


def token_ids(B: int, text_vocab_size: int) -> np.ndarray:
    """[B, 48] int32: the JAX bench's draws for B streams."""
    rng = np.random.default_rng(0)
    return rng.integers(0, min(1000, text_vocab_size),
                        (B, N_TOKENS)).astype(np.int32)


class Workload:
    """B lock-step streams over an engine's static state: ``fresh()``
    prefills them (into the same buffers after the first call), ``chunk()``
    enqueues one 40-frame chunk and returns its (codes [40, B, 16], valid
    [40, B]) buffers, which the next chunk overwrites."""

    def __init__(self, engine, B: int, max_frames: int, temperature: float):
        self.engine = engine
        cfg, dev = engine.talker_cfg, engine.device
        self.params = TTSParams(temperature=temperature, top_k=50,
                                repetition_penalty=1.05)
        self.greedy = temperature <= 0.0
        with torch.inference_mode():
            self.prefill = talker.build_prefill_inputs(
                engine.talker_w, cfg,
                torch.as_tensor(token_ids(B, cfg.text_vocab_size),
                                device=dev),
                torch.full((B,), N_TOKENS, dtype=torch.int32, device=dev),
                torch.zeros(B, cfg.hidden_size, device=dev))
        self.prefill_len = self.prefill.prefill_embd.shape[1]
        self.ctx = required_ctx(self.prefill_len, max_frames, CHUNK)
        self.generator = torch.Generator(device=dev).manual_seed(1)
        self.steps = 0

    def fresh(self) -> None:
        with torch.inference_mode():
            self.state, self.consts, self.bufs = self.engine._lockstep_state(
                self.prefill, self.ctx, self.params, self.generator)
        self.steps = 0

    def chunk(self):
        if self.prefill_len + self.steps + CHUNK > self.ctx:
            raise RuntimeError("the chunk would write past the cache; "
                               "call fresh() first")
        # every stream's n_past is at most prefill + frames dispatched
        rc = ctx_bucket(self.prefill_len + self.steps, CHUNK, self.ctx)
        self.steps += CHUNK
        with torch.inference_mode():
            return self.engine._gen_fn(self.state, self.consts, self.bufs,
                                       rc, self.params.top_k, self.greedy,
                                       self.params.top_p)()


def check_fused(engine, codes: np.ndarray) -> None:
    """The vocoder kernels against their twins on `codes` (one
    sub-batch), block by block along the decode, under chip_smoke.py's
    vocoder tolerances (max |err| / RMS and RMS(err) / RMS of each
    output). Raises when one is out of tolerance."""
    max_tol, rms_tol = 5e-2, 5e-3
    w, vcfg = engine.voc_w, engine.voc_cfg
    bad = []

    def rel(name, got, ref):
        diff = (got - ref).float()
        rms = ref.float().square().mean().sqrt().item()
        r = (diff.abs().max().item() / rms,
             diff.square().mean().sqrt().item() / rms)
        if not torch.isfinite(got).all():
            r = (float("inf"), float("inf"))
        log(f"check-fused {name}: max|err|/RMS {r[0]:.3e} (need <= "
            f"{max_tol}), RMS(err)/RMS {r[1]:.3e} (need <= {rms_tol})")
        if not (r[0] <= max_tol and r[1] <= rms_tol):
            bad.append(name)

    with torch.inference_mode():
        x = vocoder._front_impl(w, vcfg, torch.as_tensor(
            codes, device=engine.device))
        for i, (blk, rate) in enumerate(zip(w["dec_blocks"],
                                            vcfg.upsample_rates)):
            y = vf.snake_convt_twin(x, blk, rate)
            rel(f"block {i} snake+convT head, B={len(codes)} T={x.shape[1]}"
                f" C={x.shape[2]}", vf.fused_snake_convt(x, blk, rate), y)
            x = vf.residual_chain_twin(y, blk)
            rel(f"block {i} residual chain, C={y.shape[2]}",
                vf.fused_residual_chain(y, blk), x)
    if bad:
        raise AssertionError(f"vocoder kernels disagree with their twins: "
                             f"{bad}")


def measure_entry(engine, B: int, kv: str, talker_impl: str | None,
                  args) -> dict:
    """One ladder entry on `engine` (its KV dtype and talker step set
    here); returns the JSON record."""
    with env("QWEN3_TTS_KV", kv):
        talker.set_talker_step_impl(talker_impl)
        try:
            return _measure(engine, B, kv, args)
        finally:
            talker.set_talker_step_impl(None)


def _measure(engine, B: int, kv: str, args) -> dict:
    dev = engine.device
    tk = talker._resolve_impl()
    before = launch_counts()
    t0 = time.monotonic()
    # a cache for --max-frames, and for the longest section at least
    wl = Workload(engine, B, max(args.max_frames, (args.chunks + 1) * CHUNK),
                  args.temperature)
    wl.fresh()
    sync(dev)
    log(f"prefill B={B} ctx={wl.ctx}: {(time.monotonic() - t0) * 1e3:.0f} "
        f"ms")

    t0 = time.monotonic()
    wl.chunk()
    sync(dev)
    log(f"generation chunk, capture + first run: "
        f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    for _ in range(args.chunks):
        wl.chunk()
    sync(dev)
    gen_s = time.monotonic() - t0
    frames = args.chunks * CHUNK
    gen_ms = gen_s * 1e3 / frames
    log(f"generation alone: {frames} frames x {B} streams in {gen_s:.3f} s "
        f"-> {gen_ms:.3f} ms/frame (batch), {gen_ms / B:.4f} ms/frame/"
        f"stream")

    # the vocoder: one random chunk of codes, causal trim, int16 PCM
    vcodes = np.random.default_rng(0).integers(
        0, engine.voc_cfg.codebook_size,
        (B, CHUNK, engine.voc_cfg.n_codebooks)).astype(np.int32)
    voc_sub = args.voc_sub or engine.voc_sub(B) or B
    if B % voc_sub:
        raise ValueError(f"--voc-sub {voc_sub} does not divide B={B}")
    log(f"vocoder sub-batch: {voc_sub} streams "
        f"({'--voc-sub' if args.voc_sub else 'the pipeline'}'s)")

    def decode():
        return engine._decode_chunk_batch(vcodes, pcm16=True,
                                          max_batch=voc_sub)

    vocoder.reset_res_chain_traced()
    t0 = time.monotonic()
    decode()
    sync(dev)
    voc_impl = vocoder.res_chain_impl_traced()
    log(f"vocoder, capture + first chunk: {time.monotonic() - t0:.1f} s "
        f"(impl={voc_impl})")
    if args.check_fused:
        check_fused(engine, vcodes[:voc_sub])
    t0 = time.monotonic()
    for _ in range(N_VOC):
        decode()
    sync(dev)
    voc_ms = (time.monotonic() - t0) * 1e3 / (N_VOC * CHUNK)
    log(f"vocoder alone: {voc_ms:.3f} ms/frame (batch of {B}), "
        f"{voc_ms / B:.4f} ms/frame/stream")

    def pipelined_run() -> float:
        """chunks + 1 chunks, each decoded, chunk k+1 enqueued before
        chunk k is read back and decoded; ms a batch frame."""
        wl.fresh()
        sync(dev)
        t0 = time.monotonic()
        codes_r = Readback(wl.chunk()[0])
        for _ in range(args.chunks):
            nxt = Readback(wl.chunk()[0])      # enqueue gen k+1
            codes_r.result()                   # read chunk k
            decode()                           # vocoder chunk k
            codes_r = nxt
        codes_r.result()
        decode()                               # the final chunk too
        sync(dev)
        return (time.monotonic() - t0) * 1e3 / ((args.chunks + 1) * CHUNK)

    pipelined_run()                            # warm
    totals = [pipelined_run() for _ in range(args.runs)]
    total_ms = sorted(totals)[len(totals) // 2]
    log(f"pipelined e2e: {[f'{t:.3f}' for t in totals]} ms/frame over "
        f"{args.runs} runs -> median {total_ms:.3f}")

    per_stream = total_ms / B
    realtime_ok = total_ms <= FRAME_BUDGET_MS
    log(f"TOTAL: {total_ms:.3f} ms/frame for {B} streams (gen {gen_ms:.3f} "
        f"+ voc {voc_ms:.3f} = {gen_ms + voc_ms:.3f} serial; pipelining "
        f"recovers {gen_ms + voc_ms - total_ms:.3f}) (budget "
        f"{FRAME_BUDGET_MS:.0f} ms) -> per-stream RTF "
        f"{per_stream / FRAME_BUDGET_MS:.5f}; {B} realtime streams "
        f"{'OK' if realtime_ok else 'NOT met'}")
    log(f"kernel launches in the entry: {launches_since(before)}")
    return {
        "metric": f"ms_per_frame_per_stream_b{B}",
        "value": round(per_stream, 4),
        "unit": "ms",
        "vs_baseline": round(FRAME_BUDGET_MS / per_stream, 2),
        "voc_impl": voc_impl,
        "kv": kv,
        "cache_layout": "stacked",
        "talker_impl": tk,
        "gen_ms_per_frame": round(gen_ms, 2),
        "voc_ms_per_frame": round(voc_ms, 2),
        "total_ms_per_frame": round(total_ms, 2),
        "realtime_streams_ok": realtime_ok,
    }


def run(args, weights, device: torch.device, out=None) -> list[dict]:
    """Every ladder entry of `args` on `weights` ((cfg, talker_w, vcfg,
    voc_w) on `device`), one engine each; prints each record as a JSON
    line on `out` (stdout) as it completes and returns them."""
    out = sys.stdout if out is None else out
    cfg, talker_w, vcfg, voc_w = weights
    log(card_line(device))
    records = []
    for i, (B, kv, _cache, tk) in enumerate(args.entries):
        if len(args.entries) > 1:
            log(f"--- ladder entry {i + 1}/{len(args.entries)}: B={B} "
                f"kv={kv} cache=stacked talker={tk} ---")
        engine = Qwen3TTS.from_components(None, cfg, talker_w, vcfg, voc_w,
                                          device)
        try:
            rec = measure_entry(engine, B, kv, tk, args)
        finally:
            # free this entry's state, graphs and pool before the next
            del engine
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        print(json.dumps(rec), file=out, flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except NoDevice as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    weights = random_weights(dev, args.tiny)
    sync(dev)
    log(f"random weights on {dev} in {time.monotonic() - t0:.1f} s")
    run(args, weights, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
