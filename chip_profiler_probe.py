#!/usr/bin/env python3
"""Which kernels a torch.profiler session records, on one NVIDIA GPU.

Each session profiles a short sequence around one code-predictor frame
kernel (the port's `csrc/codepred.cu`, full widths, B=8) and reports
which of its kernels came back:

  python3 chip_profiler_probe.py single MODE N   # N sessions per process
      MODE cuda:    CUDA-only sessions of [kernel]
      MODE both:    CPU+CUDA sessions of [kernel]
      MODE torchop: CUDA-only sessions of [torch add, kernel]
      prints "C5 MODE [{s, events, raw, ms}, ...]" (names per session)
  python3 chip_profiler_probe.py triple MODE N
      MODE plain:   CUDA-only sessions of [torch add, kernel, torch mul]
      MODE pad:     the same, opened 20 ms before and closed 20 ms after
      MODE both:    CPU+CUDA sessions of the plain sequence
      prints "C5B MODE {n, empty, first_lost, mid_lost, last_lost, ...}"

Run each MODE in a fresh process (the first session of a process also
starts the profiler's tracing). A lost event is one the sequence
launched and the session did not record.
"""

import json
import sys
import time

import torch


def _setup():
    from qwen3_tts_tpu_torch.config import TalkerConfig
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = TalkerConfig()
    w = W.init_talker_weights(TalkerConfig(text_vocab_size=16, n_layers=1),
                              gen, dev)
    w = {"codec_embd": w["codec_embd"], "code_pred": w["code_pred"]}
    B, V = 8, cfg.code_pred_vocab_size
    hidden = torch.randn(B, cfg.hidden_size, generator=gen, device=dev)
    cb0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    noise = cf.gumbel_noise((15, B, V), gen, dev)

    def kernel():
        cf.predict_codes_fused(w, cfg, hidden, cb0, 0.9, 50, gumbel=noise)
    kernel()
    torch.cuda.synchronize()
    return kernel, torch.zeros(1024, device=dev)


def _acts(both: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    return [torch.profiler.ProfilerActivity.CPU] + acts if both else acts


def single(mode: str, n_sess: int) -> None:
    kernel, x = _setup()
    out = []
    for s in range(n_sess):
        t0 = time.monotonic()
        with torch.profiler.profile(activities=_acts(mode == "both")) as prof:
            if mode == "torchop":
                x.add_(1)
            kernel()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        raw = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        out.append({"s": s, "events": names, "raw": raw,
                    "ms": round((time.monotonic() - t0) * 1e3, 1)})
    print("C5 " + mode + " " + json.dumps(out), flush=True)


def triple(mode: str, n_sess: int) -> None:
    kernel, x = _setup()
    pad = 0.02 if mode == "pad" else 0.0
    res = {"n": 0, "empty": 0, "first_lost": 0, "mid_lost": 0,
           "last_lost": 0}
    offs = []
    for s in range(n_sess):
        t0 = time.monotonic()
        with torch.profiler.profile(activities=_acts(mode == "both")) as prof:
            time.sleep(pad)
            x.add_(1)
            kernel()
            x.mul_(2)
            torch.cuda.synchronize()
            time.sleep(pad)
        kr = prof.profiler.kineto_results
        evs = [e for e in kr.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name().lower()
               and "memset" not in e.name().lower()]
        names = [e.name() for e in evs]
        res["n"] += 1
        if not evs:
            res["empty"] += 1
        else:
            res["first_lost"] += not any("Add" in n or "add" in n
                                         for n in names)
            res["mid_lost"] += not any("codepred" in n for n in names)
            res["last_lost"] += not any("mul" in n.lower() for n in names)
            # where the first recorded kernel starts in the window
            offs.append((min(e.start_ns() for e in evs)
                         - kr.trace_start_ns()) / 1e6)
        if s == 0:
            res["first_session_ms"] = round((time.monotonic() - t0) * 1e3, 1)
            res["first_session_events"] = len(evs)
    res["first_event_offset_ms"] = offs[:40]
    print("C5B " + mode + " " + json.dumps(res), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_profiler_probe: no CUDA device")
    {"single": single, "triple": triple}[sys.argv[1]](sys.argv[2],
                                                      int(sys.argv[3]))
