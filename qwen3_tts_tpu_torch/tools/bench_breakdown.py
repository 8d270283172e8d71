"""A lock-step frame's time split by stage, on the card (port of the
repository's tools/bench_breakdown.py), the 0.6B model at its full
widths with random weights.

At batch --batch, over the engine's static lock-step state after a
prefill of 48 token ids a stream (``np.random.default_rng(0)``), each
stage of a frame is timed alone by CUDA events over --iters calls:

- the talker decode step (every layer; ``QWEN3_TTS_TALKER`` or
  ``models.talker.set_talker_step_impl`` picks the implementation, as for
  ``talker_step`` everywhere);
- the code predictor (codebooks 1-15);
- ``sample_cb0``;
- ``frame_step_embedding``;

then their sum, and one whole frame replayed from its CUDA graph
(``Qwen3TTS._gen_fn``, the graph ``synthesize_batch`` replays), from a
fresh prefill. Beside each event time stands the card's own time from
torch.profiler (every kernel, memcpy and memset, summed over the calls):
where the event time is longer, the card sat idle between launches. For
the replayed frame the profiler's time is also split by kernel group.

Prints one JSON line on stdout; the same numbers, the card's name and
power limit and the kernels' launches go to stderr.

Run: ``python -m qwen3_tts_tpu_torch.tools.bench_breakdown [--batch 16]
[--iters 40]`` on the card; ``--device cpu --tiny`` checks the flow on
the CPU (host clock, no device time).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models import code_predictor, talker
from ..ops.sampling import sample_cb0
from ..runtime.generate import ctx_bucket
from ..runtime.pipeline import Qwen3TTS
from .bench import Workload
from .bench_common import (NoDevice, add_common_args, card_line, env,
                           launch_counts, launches_since, log, random_weights,
                           resolve_device, sync)

CHUNK = 40
PROFILED = 5               # calls under the profiler, each stage
FRAME_GROUPS = {"talker step": ("talker_step",),
                "code predictor": ("codepred",),
                "decode attention": ("fd_",),
                "gemm": ("gemm", "Gemm", "nvjet", "cutlass", "xmma")}
RECORD_KEYS = ("metric", "value", "unit", "batch", "kv", "talker_impl",
               "codepred_impl", "talker_step_ms", "talker_step_device_ms",
               "code_predictor_ms", "code_predictor_device_ms",
               "sample_cb0_ms", "sample_cb0_device_ms",
               "frame_step_embedding_ms", "frame_step_embedding_device_ms",
               "sum_of_stages_ms", "frame_graph_ms", "frame_graph_device_ms",
               "frame_graph_device_ms_by_group")


class Timer:
    """ms of the work enqueued between start() and stop(): CUDA events
    on the card; on the CPU, the host clock."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def start(self) -> None:
        if self.dev.type == "cuda":
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self.dev)
            self._a.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.dev.type == "cuda":
            self._b.record()
            self._b.synchronize()
            return self._a.elapsed_time(self._b)
        return (time.perf_counter() - self._t0) * 1e3


# the profiler can drop the kernels that run first in a session on some
# hosts: sessions open this long before the work and close this long after
PROFILER_PAD_S = 0.05


def device_ms(fn, iters: int, dev: torch.device,
              groups: dict[str, tuple[str, ...]] | None = None):
    """Device ms per call of `fn` by torch.profiler: every kernel, memcpy
    and memset the card ran during `iters` calls, summed, over `iters`;
    with `groups` (name -> substrings of kernel names), also a dict of the
    kernels' ms per call by group ("other" holds the rest). None on the
    CPU: there is no device time to read there."""
    if dev.type != "cuda":
        return None if groups is None else (None, None)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(dev)
        time.sleep(PROFILER_PAD_S)
    spans = [(e.name, e.time_range.end - e.time_range.start)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(d for _, d in spans) / iters / 1e3
    if groups is None:
        return total
    by = dict.fromkeys([*groups, "other"], 0.0)
    for name, d in spans:
        g = next((g for g, subs in groups.items()
                  if any(s in name for s in subs)), "other")
        by[g] += d / iters / 1e3
    return total, by


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tts_tpu_torch.tools.bench_breakdown",
        description="a frame's time by stage (module docstring)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--kv", choices=("bf16", "int8"), default="bf16",
                    help="talker KV cache dtype")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be >= 1")
    return args


def _r(x):
    return None if x is None else round(x, 4)


def run(args, weights, device: torch.device, out=None) -> dict:
    """The breakdown on `weights` ((cfg, talker_w, vcfg, voc_w) on
    `device`; the vocoder is not used); prints the JSON record on `out`
    (stdout) and returns it."""
    with env("QWEN3_TTS_KV", args.kv):
        rec = _run(args, weights, device)
    print(json.dumps(rec), file=sys.stdout if out is None else out,
          flush=True)
    return rec


def _run(args, weights, dev) -> dict:
    cfg, talker_w = weights[0], weights[1]
    B, N = args.batch, args.iters
    log(card_line(dev))
    engine = Qwen3TTS.from_components(None, cfg, talker_w, None, None, dev)
    wl = Workload(engine, B, 400, 0.9)
    wl.fresh()
    st, consts = wl.state, wl.consts
    w, gen = engine.talker_w, wl.state.generator
    rng = np.random.default_rng(0)
    cb0 = torch.as_tensor(rng.integers(0, cfg.code_pred_vocab_size, (B,)),
                          dtype=torch.int32, device=dev)
    codes16 = torch.as_tensor(
        rng.integers(0, cfg.code_pred_vocab_size, (B, cfg.n_codebooks)),
        dtype=torch.int32, device=dev)
    rc = ctx_bucket(wl.prefill_len + 1, CHUNK, wl.ctx)
    widx = st.n_past.max()
    timer = Timer(dev)
    tk, cp = talker._resolve_impl(), code_predictor._resolve_impl()
    before = launch_counts()

    # each call rewrites the same cache slot, in place
    stages = {
        "talker_step": lambda: talker.talker_step(
            w, cfg, st.last_hidden, st.kv_cache, st.n_past, widx,
            read_ctx=rc),
        "code_predictor": lambda: code_predictor.predict_codes(
            w, cfg, st.last_hidden, cb0, 0.9, 50, gen),
        "sample_cb0": lambda: sample_cb0(
            st.logits, st.seen_mask, st.frame_idx, consts.expected_frames,
            1.05, 0.9, 50, gen, eos_id=cfg.codec_eos_id,
            suppress_start=cfg.codec_vocab_size - 1024),
        "frame_step_embedding": lambda: code_predictor.frame_step_embedding(
            w, cfg, codes16, consts.tts_pad_embed),
    }
    rec = {"metric": f"frame_breakdown_b{B}", "unit": "ms", "batch": B,
           "kv": args.kv, "talker_impl": tk, "codepred_impl": cp}
    total = 0.0
    with torch.inference_mode():
        for name, fn in stages.items():
            fn()                                  # warm
            timer.start()
            for _ in range(N):
                fn()
            ms = timer.stop() / N
            dms = device_ms(fn, PROFILED, dev)
            total += ms
            rec[f"{name}_ms"], rec[f"{name}_device_ms"] = _r(ms), _r(dms)
            log(f"{name:<24} {ms:9.4f} ms/call (device "
                f"{'not measured' if dms is None else f'{dms:.4f} ms'})")
        rec["sum_of_stages_ms"] = _r(total)
        log(f"{'sum of stages':<24} {total:9.4f} ms/frame")

        # one frame replayed from its graph, from a fresh prefill
        wl.fresh()
        t0 = time.monotonic()
        wl.chunk()                               # capture + first replays
        sync(dev)
        log(f"frame graph, capture + one chunk: {time.monotonic() - t0:.1f}"
            f" s")
        wl.fresh()
        timer.start()
        for _ in range(2):
            wl.chunk()
        frame_ms = timer.stop() / (2 * CHUNK)
        wl.fresh()
        frame_dev, by_group = device_ms(wl.chunk, 1, dev, FRAME_GROUPS)
    rec["frame_graph_ms"] = _r(frame_ms)
    rec["frame_graph_device_ms"] = (None if frame_dev is None
                                    else _r(frame_dev / CHUNK))
    rec["frame_graph_device_ms_by_group"] = (
        None if by_group is None
        else {k: _r(v / CHUNK) for k, v in by_group.items()})
    rec["value"] = rec["frame_graph_ms"]
    log(f"{'frame, graph replayed':<24} {frame_ms:9.4f} ms/frame (device "
        + ("not measured)" if frame_dev is None else
           f"{frame_dev / CHUNK:.4f} ms: " + ", ".join(
               f"{k} {v / CHUNK:.4f}" for k, v in by_group.items()) + ")"))
    log(f"kernel launches: {launches_since(before)}")
    return {k: rec[k] for k in RECORD_KEYS}


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except NoDevice as e:
        print(f"bench_breakdown: {e}", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    weights = random_weights(dev, args.tiny)
    sync(dev)
    log(f"random weights on {dev} in {time.monotonic() - t0:.1f} s")
    run(args, weights, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
