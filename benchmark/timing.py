"""The rooflines' denominators: each layer's call timed alone by CUDA
events over N calls at the cell's batch (the loop of the program's
tools/bench_breakdown.py). A call is captured into a CUDA graph and
replayed, as the timed path replays its frames, so that launch overhead
on the host does not stand in for the layer's time; the vocoder's decode
replays the program's own graphs. A capture that fails, or a layer's
entry point that fails, raises: the traced run then ends with no result,
rather than with a roofline that times something else or is missing.

Talker: ``talker.talker_step`` over a bf16 cache of the lock-step size,
every stream at the median position of the mix (the prefill plus half the
frame cap). Code predictor: ``code_predictor.predict_codes`` for one
frame. Vocoder: the engine's decode of one 40-frame chunk of the batch,
at the sub-batch the pipeline picks. All run after the window, in the
traced run only."""

from __future__ import annotations

import sys

import numpy as np
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


def layer_times(run, engine, B: int, P: int) -> dict:
    """{layer: (seconds a call, mode, flops, bytes)} at batch B with
    prefill length P (module docstring)."""
    from qwen3_tts_tpu_torch.models import code_predictor, stack, talker
    from qwen3_tts_tpu_torch.runtime.generate import ctx_bucket, required_ctx
    m, dev = run.cell.model, run.device
    cap = run.cell.mix["frame_cap"]
    cfg, w = engine.talker_cfg, engine.talker_w
    t = m.talker
    n_past = P + cap // 2
    out: dict = {}
    gen = torch.Generator(device=dev).manual_seed(run.seed % (1 << 62))
    with torch.inference_mode():
        hidden = torch.randn(B, t.hidden, generator=gen, device=dev)
        ctx = required_ctx(P, cap, 40)
        kv = stack.init_kv_cache(t.layers, B, ctx, t.kv_heads, t.head_dim,
                                 dev)
        pos = torch.full((B,), n_past, dtype=torch.int32, device=dev)
        rc = ctx_bucket(n_past, 40, ctx)
        slot = pos.max()                # the lock-step write slot, on the card
        s, mode = time_call(lambda: talker.talker_step(
            w, cfg, hidden, kv, pos, slot, read_ctx=rc), 20, dev)
        out["talker"] = (s, mode, *roofline.talker_step(m, B, n_past))
        del kv
        cb0 = torch.randint(0, m.cp_vocab, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        mix = run.cell.mix
        s, mode = time_call(lambda: code_predictor.predict_codes(
            w, cfg, hidden, cb0, mix["temperature"], mix["top_k"],
            top_p=mix["top_p"]), 20, dev)
        out["codepred"] = (s, mode, *roofline.codepred_frame(m, B))
        codes = np.random.default_rng(run.seed % (1 << 32)).integers(
            0, m.vocoder.codebook_size, (B, 40, m.n_codebooks),
            dtype=np.int32)
        s, mode = time_call(lambda: engine._decode_chunk_batch(
            codes, pcm16=True), 5, dev, capture=False)
        out["vocoder"] = (s, mode, *roofline.vocoder_chunk(m, B))
    for k, (s, mode, fl, by) in out.items():
        _log(f"layer {k}: {s * 1e3:.4f} ms a call ({mode}, B={B}); bound "
             f"{roofline.bound_s(fl, by) * 1e3:.4f} ms ({fl / 1e9:.2f} "
             f"GFLOP, {by / 1e6:.1f} MB): "
             f"{roofline.share_pct(fl, by, s):.2f}% of the roofline")
    return out
