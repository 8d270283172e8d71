#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
port's CUDA kernels from qwen3_tts_tpu_torch/csrc (nvcc, sm_90a), then:

1. prints the device and ``nvidia-smi --query-gpu=name,power.limit``;
2. holds each kernel against its plain torch twin at the main path's
   shapes, with the tolerance stated on each line, and times both; the
   code predictor at B 8, 64 and 192 against its twin and its XLA path,
   timed with its phase clock at B 8, 16, 64, 128 and 192; the
   decode-attention kernel in prefix, bitmask, window and wrapped-window
   modes, with empty streams, for the bf16 and the int8 cache; the
   residual chain at B 2 and 16 and the Snake + convT head at B 2, 16 and
   48, each run twice (bitwise equal); the talker megakernel at B 4 / 8 /
   32 and 192, with its phase clock at B 4, 8 and 32; the decode-attention
   kernel also at 8 query heads a kv head (G = 8, Qwen3-Omni's talker) in
   every mode and cache; the MoE FFN (csrc/moe.cu) at Qwen3-Omni's widths
   over 1, 8 and 192 decode rows, the 192 x 75 prefill rows and 192 rows
   routed to 6 experts, with a bf16 round trip of the experts' products
   shown to fail its tolerance, timed with its bound from the experts
   read; the code predictor at the 1.7B shape (a 2,048-wide talker: its
   mtp rows folded as the engine folds them, the kernel's f32-row
   instantiation) at B 8, 64 and 192 against its twin and its XLA path,
   timed with its bound, and one launch a frame in a lock-step run; and
   checks the code predictor's QWEN3_TTS_CODEPRED dispatch: an mtp_w
   without its folded rows and top_p < 1 take its XLA path on the card,
   not the kernel;
3. drives ``Qwen3TTS.synthesize_batch`` at the full 0.6B widths (random
   weights from a fixed torch.Generator, an in-memory tokenizer): greedy
   and at temperature 0.9, with the bf16 and the int8 KV cache, and once
   at temperature 0.9 with top_p 0.9; checks that every request succeeds
   with finite audio of n_frames * 1920 samples, that the lock-step path
   launched every kernel and the code predictor one kernel a frame (none
   at top_p < 1, where its XLA path runs every frame);
4. serves 20 requests through ``ContinuousBatcher`` (8 slots, greedy,
   bf16 and then int8 KV), 12 of them submitted mid-run: slots turn over,
   requests retire by EOS and by the frame cap, the ring wraps. Checks
   every result as in 3, that the serving path launched every kernel and
   the decode-attention kernel in window mode with wrapped windows, and
   holds the kernel against its twin on masks captured from the live ring
   after it wrapped;
5. load and clone: writes a full-width model directory (the TTS and the
   codec GGUF, with a speaker encoder) from the random weights, loads it
   with ``Qwen3TTS().load_models`` (and with QWEN3_TTS_LOW_MEM=1) and
   checks every tensor on the card bitwise; holds the speaker encoder,
   with TF32 at PyTorch's defaults, against CPU tensors and its batch
   enrolment against single clips, and times it; runs
   ``synthesize_with_voice`` and ``synthesize_batch`` with cloned voices
   (the low-memory engine's audio bitwise equal), one run under
   QWEN3_TTS_TALKER=xla, and the CLI in-process (-r with its .embd cache,
   -e, --serve --continuous over piped lines); every kernel must launch
   on this path too;
6. convert (the offline pipeline, qwen3_tts_tpu_torch/tools): synthetic
   BF16 HF checkpoints at the full widths from a seed (the TTS model in
   two shards, the codec; io/safetensors.py), converted at f16, then the
   acceptance run on the card: its conversion, the parity run against the
   independent HF-layout torch reference (an f32 pass on the plain path;
   a bf16 pass through the talker megakernel, the code-predictor kernel
   and the vocoder's chain and head, the step again under
   QWEN3_TTS_TALKER=xla through decode attention), load_models, greedy
   synthesis, the WAV round trip and a voice cloned from a seeded WAV
   (eager, under the profiler); each stage's error against its tolerance, the implementation that ran
   it and its kernel launches, the seconds and bytes of each step;
7. graphs: every path above already ran its chunks and vocoder decodes
   as CUDA graphs (runtime/graphs.py; captured on first use, replayed
   after). This phase sets them against QWEN3_TTS_AOT=0 in one process:
   lock-step generate ms a frame replayed and eager (auto bf16 greedy,
   xla bf16, T=0.9 with top_p 0.9), with audio bitwise equal; the capture
   and replay times of a 40-frame chunk graph and of a one-frame graph
   (auto and xla); a fresh engine's 8-slot batcher warmed up (seconds,
   graphs captured, capture time each, the pool's card memory) and
   served on phase 4's traffic against an unwarmed eager batcher (wall
   per 8-slot frame, audio bitwise equal, no bucket captured after the
   warmup); and the profile of a replayed 40-frame chunk (device ms per
   frame by kernel group, each vocoder kernel on its own, the card's busy
   share; one code-predictor and one talker launch a frame) beside an
   eager one;
8. pipelined (the lock-step loop that enqueues chunk k+1 before it reads
   and decodes chunk k): ``synthesize_batch`` over 3 chunks (120 frames)
   at B 4 and 64, auto bf16 greedy with graphs, unprofiled (generate ms a
   lock-step frame, wall) and under torch.profiler (the card's busy share
   of the wall, the three longest idle gaps on the card with the host
   operation that spanned each; one code-predictor and one talker launch
   a frame); ``set_decode_attention_impl`` auto / xla / flash on a
   lock-step and a serving run under QWEN3_TTS_TALKER=xla (xla makes no
   decode-attention launch, flash as many as auto); an engine made
   without a vocoder (``from_components(..., None, None, ...)``): codes
   as the full engine's, "Vocoder not loaded" in lock-step, no audio at
   24000 Hz from a warmed batcher; ``res_chain_impl_traced`` "fused"
   after a fresh engine's first decode, "untraced" after a reset and
   replays only. Before the main paths, the residual chain and the head
   are also checked against their twins in the exact sin^2 mode
   (``set_snake_sin2_impl``; one block, B 2, bitwise on a second call)
   and the 4 blocks timed in both modes;
9. mesh (parallel/mesh.py): a world-size-1 NCCL process group in this
   process and ``make_mesh(1, 1, "cuda")``; a second engine over the same
   weights, ``shard``-ed, against the unsharded one: ``synthesize_batch``
   (auto bf16, B 4, 80 frames, greedy and at T 0.9 with one seed) and the
   8-slot ``ContinuousBatcher`` on phase 4's traffic after ``warmup()``,
   audio bitwise equal and frames equal, the code predictor and the
   talker megakernel launched under the mesh, ms a frame sharded and
   unsharded (the cost of the per-chunk gather); ``dryrun_multichip(1,
   "cuda")``; then tp = 2 as two processes sharing the card over gloo
   (its CUDA tensors), full width, B 4, greedy, 40 frames, eager: codes
   equal to the unsharded xla run's up to bf16 near-ties (the margin of
   the reference's scores at each stream's first differing code), ms a
   frame;
10. bench (qwen3_tts_tpu_torch/tools, in process on the weights above):
   ``bench`` over the ladder 192:int8:stacked,192:bf16:stacked (one chunk,
   one run), ``bench_serve`` at 16 slots (24 requests, 120-frame cap) and
   ``bench_breakdown`` at B 16 and 192 and at B 16 under the xla talker
   (through decode attention); every record line parses, no request
   fails, ``voc_impl`` reads the kernels ("fused"), every number is
   finite, and every kernel launched (``launches_bench`` in the kernels
   line); the phase's wall time is printed. It runs before the mesh;
11. omni (``omni_phase``, before the mesh): Qwen3-Omni's speech stage at
   its widths (the 20-layer MoE talker, the code predictor, Code2Wav),
   through ``synthesize_batch`` (B 8, 80 frames, T 0.9) and an 8-slot
   ``ContinuousBatcher`` (12 requests, 4 mid-run): every request
   succeeds, the MoE kernel and flash-decode at G = 8 (prefix in
   lock-step, window in serving) launch, the megakernel does not; the
   MoE kernel's launches in the kernels line are this phase's
   (``launches_omni``, which every entry carries).

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before it. Without a CUDA device the script exits non-zero at once.

``python3 chip_smoke.py --parity-cpu`` instead runs the parity tool through
the kernels' twins on the CPU at the full widths over three seeds and
prints each stage's largest error (the measurement behind
tools/parity.BF16_TOL).

``python3 chip_smoke.py --compare DIR`` instead times the code predictor
(the kernel at the 0.6B dims, with its phase clock; ``predict_codes`` at
the 1.7B shape), decode attention, the talker megakernel, the residual
chain and the Snake + convT head through their wrappers in the checkout
at DIR and in this one, in turns DIR, this, this, DIR, each turn logging
what ptxas said of every kernel it built, and in the same turns
``synthesize_batch`` at B 4 and 64 (120 frames, greedy, bf16 and int8
KV): generate ms a lock-step frame and wall ms, with every run's codes
and int16 PCM bitwise its own side's first run's, and this checkout's
codes DIR's up to each stream's first divergence, a near-tie of DIR's
scores (margin <= LOGIT_TOL).
"""

from __future__ import annotations

import datetime
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

SEED = 1234
CODEPRED_B = 8                 # the lock-step smoke's slots, rounded up
CODEPRED_CHECK_B = (8, 64, 192)  # kernel vs twin and XLA path
# timed, with the phase clock: the benchmark cells' batches (16, 128, 192)
# and the smoke's
CODEPRED_TIME_B = (8, 16, 64, 128, 192)
# (C, T per 40-frame chunk) of the four decoder blocks' residual chains,
# and (C, C2, rate, T) of their Snake + convT heads (vocoder.py widths)
CHAIN_SHAPES = ((768, 1280), (384, 6400), (192, 25600), (96, 76800))
HEAD_SHAPES = ((1536, 768, 8, 160), (768, 384, 5, 1280), (384, 192, 4, 6400),
               (192, 96, 3, 25600))
VOC_B = 2
VOC_TIME_B = (VOC_B, 16)    # the residual chain's
HEAD_B = (VOC_B, 16, 48)    # the head's; 48: Qwen3TTS.VOC_MAX_BATCH
# code-predictor logits, kernels vs twin: activations round to bf16 after
# f32 sums taken in another order, so a rounding can land one bf16 ulp
# apart and the difference compounds over 16 positions x 5 layers
LOGIT_TOL = 5e-2
# vocoder kernels vs twins, relative to the twin's RMS. Where kernel and
# twin sum in another order a bf16 operand can round the other way; in the
# chain each such flip perturbs the next blocks' inputs and flips more, so
# the largest error grows to ~1e-2 of the RMS while the error's own RMS
# stays near 1e-3. A skipped snake parameter or a dropped bias (both drawn
# at ~0.1-0.3) moves the error's RMS by several 1e-2.
VOC_MAX_TOL = 5e-2          # max |err| / RMS
VOC_RMS_TOL = 5e-3          # RMS(err) / RMS
# decode attention, kernel vs twin: both f32 over the same dequantized
# rows, summed in another order (per-warp online softmax, split merge);
# measured <= 4e-6 on outputs of O(1). A dropped scale, a skipped block or
# a missed slot moves the output by O(0.1-1).
ATTN_TOL = 1e-4
ATTN_B = (8, 32)
ATTN_S = 1152               # required_ctx_ring(1024): the serving cache
ATTN_READ_CTX = (512, 1024, 1152)
SPLIT_SWEEP = (1, 2, 3, 6, 18)  # tiles per split timed beside the plan
ATTN_KV_HEADS = (8, 2)      # G = 2 (the 0.6B / 1.7B talkers), 8 (Omni's)
# the MoE FFN (ops/moe.py) vs its twin at Qwen3-Omni's widths: relative
# L2 over the rows both route alike. Both sum bf16 products in f32 in
# other orders, so silu(g) * u can round to the other bf16 neighbour:
# measured on an H100 7.6e-7 (one row) to 1.1e-4 (the prefill's 14,400);
# rounding the experts' products to bf16 once more reads 1.65e-3, which
# each case checks it sees. A row may route apart only at a near-tie of
# its k-th and (k+1)-th router logits
MOE_TOL = 3e-4
MOE_TIE = 1e-4              # |logit gap| that counts as a near-tie
MOE_B = (1, 8, 192)         # decode rows: one stream, a few, the cell's
MOE_PREFILL_N = 192 * 75    # the cell's prefill: B 192 x ~75 rows
OMNI_B = 8                  # the Omni phase's lock-step batch and slots
OMNI_FRAMES = 80
# latent attention's decode kernel (ops/mla.py) vs its twin, relative L2
# over the bf16 output: both round the probabilities to bf16, the kernel
# against each tile's running maximum and the twin against the final one,
# and sum in other orders; a dropped rope part, a skipped tile or a missed
# slot moves the output by O(0.1-1)
MLA_TOL = 2e-2
MLA_B = (1, 8, 192)         # streams: one, a few, the cell's batch
MLA_CTX = 384               # required_ctx(10, 256): the cell's cache
MLA_MEDIAN = 139            # the cell's median position + 1: rows counted
# the expert-parallel MoE (LongCat-Flash's block) vs its twin: MOE_TOL over
# the rows both route alike; a row may route apart only at a near-tie of
# its 12th and 13th choice (p + bias) within MOE_EP_TIE
MOE_EP_TIE = 1e-6
LONGCAT_B = 8               # the LongCat phase's lock-step batch and slots
LONGCAT_FRAMES = 80
# serving phase: a 96-frame cap puts the ring at 256 - 16 slots, so it
# wraps after 6 chunks; "h" (36-frame EOS ramp) reaches EOS by frame 72
SERVE_SLOTS = 8
SERVE_MAX_FRAMES = 96
SERVE_SHORT = "h"
SERVE_LONG = "hello world hello world hello world hello world."
LOCKSTEP_TEXTS = ["hello world.", "hello hello world.", "world hello.",
                  "hello world hello world."]
LOCKSTEP_TOKENS = 120
# (QWEN3_TTS_TALKER, KV cache, temperature, top_p) of each main-path run:
# auto takes the megakernel; one bf16 run takes the per-layer talker step,
# so that the decode-attention kernel runs on a real path too; one run at
# top_p < 1 takes the code predictor's XLA path (the kernel has no nucleus
# filter)
LOCKSTEP_RUNS = (("auto", "bf16", 0.0, 1.0), ("auto", "bf16", 0.9, 1.0),
                 ("auto", "int8", 0.0, 1.0), ("auto", "int8", 0.9, 1.0),
                 ("xla", "bf16", 0.0, 1.0), ("auto", "bf16", 0.9, 0.9))
SERVE_RUNS = (("auto", "bf16"), ("auto", "int8"), ("xla", "bf16"))

# talker megakernel vs twin, relative to the twin's RMS: y, and the K/V
# rows the step wrote (dequantized for int8) less one rounding step of
# the stored value (a bf16 ulp, at most |value| * 2^-7, or the int8 row's
# scale). Both sum in f32 in other orders, so a value rounded to bf16 (xn,
# the attention output, silu(g) * u) can land one ulp apart, and 28 layers
# carry each flip on into the residual stream. Measured on an H100 over
# every case: y RMS(err) 4.1-4.8e-3 and max 1.5-2.4e-2 of the RMS, the
# size of the gap between the twin and the per-layer xla path (2.8-3.9e-3,
# 1.3-2.1e-2), which differs from it only by bf16 attention probabilities
# and is logged beside each case. A stored row flips by one rounding step
# where a value sits at a boundary, hence the slack. A skipped norm, a
# wrong RoPE sign, a dropped scale or a skipped layer moves the error by
# 1e-1 or more.
TF_MAX_TOL = 5e-2           # max |err| / RMS
TF_RMS_TOL = 1e-2           # RMS(err) / RMS
TF_B = (4, 8, 32)           # 4: the lock-step smoke's batch
TF_HEAD_B = 8               # the shape of the kernels line's talker times
TF_S = 1152                # required_ctx_ring(1024): the serving cache
TF_READ_CTX = (256, 1152)
TF_WIDE_B = 192             # the TPU bench's batch: checked and timed once
TF_WIDE_S = 256             # its cache (and read_ctx): 5.6 GB at 28 layers
# least-time bounds (H100 SXM datasheet peaks, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nbytes(*trees) -> int:
    """Bytes of every tensor in nested dicts / lists / tuples."""
    total = 0
    for t in trees:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: bytes moved over the HBM rate
    or bf16 operations over the tensor-core peak, whichever is larger."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def cuda_time(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call on the card (CUDA events around `iters` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_split(res) -> tuple[float, float]:
    """(generate ms, decode ms) of the latest synthesize_batch call, whose
    results are `res`, from its spans (utils/trace.py): decode is its
    vocoder waves and its tail flush, generate the rest of the call after
    its tokenization. A checkout whose results still carry
    ``t_generate_ms`` / ``t_decode_ms`` (``--compare`` against an older
    one) gives those."""
    if hasattr(res[0], "t_generate_ms"):
        return res[0].t_generate_ms, res[0].t_decode_ms
    from qwen3_tts_tpu_torch.utils import trace
    call = [s for s in trace.spans() if s.name == "call"][-1]
    part = {n: sum(s.ms for s in trace.spans(call.t0, call.t1)
                   if s.parent == call.sid and s.name == n)
            for n in ("call.tokenize", "call.decode", "call.tail_flush")}
    decode = part["call.decode"] + part["call.tail_flush"]
    return call.ms - part["call.tokenize"] - decode, decode


def ptxas_summary(text: str) -> list:
    """'kernel<template args>: N registers, S bytes spilled' per kernel
    from nvcc's -Xptxas=-v output."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"\d+([a-z_][a-z_0-9]*kernel)(I(?:L[a-z]\d+E)+E)?", line)
        if "Compiling entry" in line and m:
            name = m.group(1) + (
                "<" + ",".join(re.findall(r"L[a-z](\d+)E", m.group(2))) + ">"
                if m.group(2) else "")
        elif "spill stores" in line and name:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name} {regs} registers, {spill} B spill stores")
            name = None
    return out


def _kernel_events(prof):
    """(name, start us, end us) of every kernel the profiler saw."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower()]


# the profiler drops kernels that run near the start of its capture window
# on some hosts (ROADMAP C.5): sessions open this long before the work and
# close this long after it
PROFILER_PAD_S = 0.05


def device_ms(fn, iters: int, names: tuple) -> float:
    """Mean device ms per call of the kernels whose name holds one of
    `names` (torch.profiler), after one warm-up call. A session that
    recorded no kernel at all is taken again, up to 3 times in all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
        events = _kernel_events(prof)
        if events:
            break
        log("  (the profiler session came back empty; taken again)")
    total = sum(end - start for name, start, end in events
                if any(n in name for n in names))
    if total <= 0:
        raise AssertionError(f"the profiler saw no kernel named {names}: "
                             f"{sorted({e[0][:80] for e in events})}")
    return total / iters / 1e3


def device_info() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(card)                      # name, power limit as nvidia-smi prints
    return name, card


def _gguf_tensors(talker_cfg, talker_w, spk_w):
    """(GGML name, tensor) of the TTS file, under the converter's names
    (tools/convert_checkpoints.py): linear weights back to [out, in], the
    fused and stacked tensors split per layer and per codebook."""
    out = []

    def stack(prefix, lw, n_layers, n_q, n_kv, inter):
        for i in range(n_layers):
            p = f"{prefix}.blk.{i}"
            q, k, v = lw["wqkv"][i].split([n_q, n_kv, n_kv], dim=1)
            g, u = lw["w_gu"][i].split([inter, inter], dim=1)
            out.extend([
                (f"{p}.attn_norm.weight", lw["attn_norm"][i]),
                (f"{p}.attn_q.weight", q.t()), (f"{p}.attn_k.weight", k.t()),
                (f"{p}.attn_v.weight", v.t()),
                (f"{p}.attn_output.weight", lw["wo"][i].t()),
                (f"{p}.attn_q_norm.weight", lw["q_norm"][i]),
                (f"{p}.attn_k_norm.weight", lw["k_norm"][i]),
                (f"{p}.ffn_norm.weight", lw["ffn_norm"][i]),
                (f"{p}.ffn_gate.weight", g.t()), (f"{p}.ffn_up.weight", u.t()),
                (f"{p}.ffn_down.weight", lw["w_down"][i].t())])

    c, w = talker_cfg, talker_w
    tp = w["text_proj"]
    out.extend([("talker.text_embd.weight", w["text_embd"]),
                ("talker.text_proj.fc1.weight", tp["fc1_w"].t()),
                ("talker.text_proj.fc1.bias", tp["fc1_b"]),
                ("talker.text_proj.fc2.weight", tp["fc2_w"].t()),
                ("talker.text_proj.fc2.bias", tp["fc2_b"]),
                ("talker.codec_embd.weight", w["codec_embd"]),
                ("talker.codec_head.weight", w["codec_head"].t()),
                ("talker.output_norm.weight", w["output_norm"])])
    stack("talker", w["layers"], c.n_layers, c.n_attention_heads * c.head_dim,
          c.n_key_value_heads * c.head_dim, c.intermediate_size)
    cp = w["code_pred"]
    stack("code_pred", cp["layers"], c.code_pred_layers,
          c.code_pred_n_attention_heads * c.code_pred_head_dim,
          c.code_pred_n_kv_heads * c.code_pred_head_dim,
          c.code_pred_intermediate_size)
    out.append(("code_pred.output_norm.weight", cp["output_norm"]))
    for i in range(c.n_codebooks - 1):
        out += [(f"code_pred.codec_embd.{i}.weight", cp["embd"][i]),
                (f"code_pred.lm_head.{i}.weight", cp["heads"][i].t())]
    if cp["mtp_w"] is not None:
        out.append(("code_pred.mtp_proj.weight", cp["mtp_w"].t()))
        if cp["mtp_b"] is not None:
            out.append(("code_pred.mtp_proj.bias", cp["mtp_b"]))
    out += [("spk_enc.conv0.weight", spk_w["conv0_w"]),
            ("spk_enc.conv0.bias", spk_w["conv0_b"])]
    for i, b in zip((1, 2, 3), spk_w["blocks"]):
        p = f"spk_enc.blk.{i}"
        for j in range(b["res2net_w"].shape[0]):
            out += [(f"{p}.res2net.{j}.weight", b["res2net_w"][j]),
                    (f"{p}.res2net.{j}.bias", b["res2net_b"][j])]
        for key, name in (("tdnn1", "tdnn1"), ("tdnn2", "tdnn2"),
                          ("se1", "se.conv1"), ("se2", "se.conv2")):
            out += [(f"{p}.{name}.weight", b[f"{key}_w"]),
                    (f"{p}.{name}.bias", b[f"{key}_b"])]
    for key, name in (("mfa", "mfa"), ("asp_tdnn", "asp.tdnn"),
                      ("asp_conv", "asp.conv"), ("fc", "fc")):
        out += [(f"spk_enc.{name}.weight", spk_w[f"{key}_w"]),
                (f"spk_enc.{name}.bias", spk_w[f"{key}_b"])]
    return out


def _codec_tensors(voc_cfg, voc_w):
    """(GGML name, tensor) of the codec file (the vocoder), under the
    converter's names."""
    w, t = voc_w, voc_w["pre_tfm"]
    out = [("tok_dec.vq_first.0.codebook", w["vq_first_codebook"]),
           ("tok_dec.vq_first.output_proj.weight",
            w["vq_first_out_proj"].t()[..., None]),
           ("tok_dec.vq_rest.output_proj.weight",
            w["vq_rest_out_proj"].t()[..., None]),
           ("tok_dec.pre_conv.weight", w["pre_conv_w"]),
           ("tok_dec.pre_conv.bias", w["pre_conv_b"]),
           ("tok_dec.pre_tfm.input_proj.weight", t["in_w"].t()),
           ("tok_dec.pre_tfm.input_proj.bias", t["in_b"]),
           ("tok_dec.pre_tfm.output_proj.weight", t["out_w"].t()),
           ("tok_dec.pre_tfm.output_proj.bias", t["out_b"]),
           ("tok_dec.pre_tfm.norm.weight", t["norm"]),
           ("tok_dec.dec.0.conv.weight", w["dec0_w"]),
           ("tok_dec.dec.0.conv.bias", w["dec0_b"]),
           ("tok_dec.dec.5.snake.alpha", w["dec5_a"]),
           ("tok_dec.dec.5.snake.beta", w["dec5_b"]),
           ("tok_dec.dec.6.conv.weight", w["dec6_w"]),
           ("tok_dec.dec.6.conv.bias", w["dec6_b"])]
    for i in range(voc_cfg.n_codebooks - 1):
        out.append((f"tok_dec.vq_rest.{i}.codebook",
                    w["vq_rest_codebooks"][i]))
    lay = t["layers"]
    for i in range(lay["wq"].shape[0]):
        p = f"tok_dec.pre_tfm.blk.{i}"
        for key, name in (("wq", "attn_q"), ("wk", "attn_k"),
                          ("wv", "attn_v"), ("wo", "attn_output"),
                          ("w_gate", "ffn_gate"), ("w_up", "ffn_up"),
                          ("w_down", "ffn_down")):
            out.append((f"{p}.{name}.weight", lay[key][i].t()))
        for key, name in (("attn_norm", "attn_norm.weight"),
                          ("ffn_norm", "ffn_norm.weight"),
                          ("attn_scale", "attn_scale"),
                          ("ffn_scale", "ffn_scale")):
            out.append((f"{p}.{name}", lay[key][i]))
    for i, u in enumerate(w["upsample"]):
        p = f"tok_dec.upsample.{i}"
        out += [(f"{p}.conv.weight", u["conv_t_w"]),
                (f"{p}.conv.bias", u["conv_t_b"]),
                (f"{p}.dwconv.weight", u["dw_w"]),
                (f"{p}.dwconv.bias", u["dw_b"]),
                (f"{p}.norm.weight", u["ln_w"]), (f"{p}.norm.bias", u["ln_b"]),
                (f"{p}.pwconv1.weight", u["pw1_w"].t()),
                (f"{p}.pwconv1.bias", u["pw1_b"]),
                (f"{p}.pwconv2.weight", u["pw2_w"].t()),
                (f"{p}.pwconv2.bias", u["pw2_b"]), (f"{p}.gamma", u["gamma"])]
    for blk, d in zip((1, 2, 3, 4), w["dec_blocks"]):
        p = f"tok_dec.dec.{blk}"
        out += [(f"{p}.snake.alpha", d["snake_a"]),
                (f"{p}.snake.beta", d["snake_b"]),
                (f"{p}.conv_t.weight", d["conv_t_w"]),
                (f"{p}.conv_t.bias", d["conv_t_b"])]
        for j, r in zip((2, 3, 4), d["res"]):
            q = f"{p}.res.{j}"
            out += [(f"{q}.act1.alpha", r["a1"]), (f"{q}.act1.beta", r["b1"]),
                    (f"{q}.conv1.weight", r["c1_w"]),
                    (f"{q}.conv1.bias", r["c1_b"]),
                    (f"{q}.act2.alpha", r["a2"]), (f"{q}.act2.beta", r["b2"]),
                    (f"{q}.conv2.weight", r["c2_w"]),
                    (f"{q}.conv2.bias", r["c2_b"])]
    return out


def write_model_dir(path, tokenizer, talker_cfg, talker_w, spk_cfg, spk_w,
                    voc_cfg, voc_w) -> None:
    """A model directory (the TTS and the codec GGUF) holding these
    weights and this tokenizer's vocabulary, written with the port's
    GGUFWriter under the converter's tensor names and metadata keys. bf16
    tensors are stored as BF16 and f32 as F32, so a load gives back the
    same bits."""
    from qwen3_tts_tpu_torch.io import gguf
    from qwen3_tts_tpu_torch.runtime.pipeline import CODEC_FILE, TTS_FILE

    def add(wr, name, t):
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            wr.add_tensor(name, t.view(torch.int16).numpy().view(np.uint16),
                          gguf.GGML_BF16)
        else:
            wr.add_tensor(name, t.float().numpy(), gguf.GGML_F32)

    c, sp = talker_cfg, tokenizer.special
    wr = gguf.GGUFWriter("qwen3-tts")
    for key, value in (
            ("block_count", c.n_layers), ("embedding_length", c.hidden_size),
            ("feed_forward_length", c.intermediate_size),
            ("attention.head_count", c.n_attention_heads),
            ("attention.head_count_kv", c.n_key_value_heads),
            ("attention.key_length", c.head_dim),
            ("vocab_size", c.codec_vocab_size),
            ("text_vocab_size", c.text_vocab_size),
            ("text_hidden_size", c.text_embd_dim),
            ("num_code_groups", c.n_codebooks),
            ("code_predictor.layer_count", c.code_pred_layers),
            ("code_predictor.vocab_size", c.code_pred_vocab_size),
            ("code_predictor.embedding_length", c.code_pred_hidden_size),
            ("code_predictor.feed_forward_length",
             c.code_pred_intermediate_size),
            ("code_predictor.attention.head_count",
             c.code_pred_n_attention_heads),
            ("code_predictor.attention.head_count_kv", c.code_pred_n_kv_heads),
            ("code_predictor.attention.key_length", c.code_pred_head_dim),
            ("speaker_encoder.embedding_length", spk_cfg.embedding_dim),
            ("speaker_encoder.sample_rate", spk_cfg.sample_rate),
            ("codec.pad_id", c.codec_pad_id), ("codec.bos_id", c.codec_bos_id),
            ("codec.eos_id", c.codec_eos_id),
            ("codec.think_id", c.codec_think_id),
            ("codec.nothink_id", c.codec_nothink_id),
            ("codec.think_bos_id", c.codec_think_bos_id),
            ("codec.think_eos_id", c.codec_think_eos_id),
            ("language.english_id", c.english_language_id),
            ("tts_bos_token_id", c.tts_bos_token_id),
            ("tts_eos_token_id", c.tts_eos_token_id),
            ("tts_pad_token_id", c.tts_pad_token_id)):
        wr.add(f"qwen3-tts.{key}", value)
    wr.add_f32_scalar("qwen3-tts.rope.freq_base", c.rope_theta)
    wr.add_f32_scalar("qwen3-tts.attention.layer_norm_rms_epsilon",
                      c.rms_norm_eps)
    merges = [f"{a} {b}" for (a, b), _ in sorted(
        tokenizer.bpe_ranks.items(), key=lambda kv: kv[1])]
    wr.add("tokenizer.ggml.model", "gpt2")
    wr.add("tokenizer.ggml.tokens", tokenizer.id_to_token)
    wr.add("tokenizer.ggml.merges", merges)
    wr.add("tokenizer.ggml.bos_token_id", sp.bos_token_id)
    wr.add("tokenizer.ggml.eos_token_id", sp.eos_token_id)
    wr.add("tokenizer.ggml.padding_token_id", sp.pad_token_id)
    for name, t in _gguf_tensors(talker_cfg, talker_w, spk_w):
        add(wr, name, t)
    wr.write(os.path.join(path, TTS_FILE))

    v = voc_cfg
    wr = gguf.GGUFWriter("qwen3-tts-tokenizer")
    for key, value in (("num_codebooks", v.n_codebooks),
                       ("codebook_size", v.codebook_size),
                       ("sample_rate", v.sample_rate),
                       ("decoder.hidden_size", v.hidden_dim),
                       ("decoder.num_layers", v.n_pre_tfm_layers),
                       ("decoder.num_heads", v.n_heads),
                       ("decoder.latent_dim", v.latent_dim),
                       ("upsample_rates", list(v.upsample_rates))):
        wr.add(f"qwen3-tts-tokenizer.{key}", value)
    for name, t in _codec_tensors(voc_cfg, voc_w):
        add(wr, name, t)
    wr.write(os.path.join(path, CODEC_FILE))


def _divergence_gaps(got, ref, logits, tinv, top_k, noise):
    """Per stream whose codes differ: the twin's score margin between its
    own code and the kernel's at the first differing position (where the
    fed-back codes still agree, so the scores are comparable). A bf16
    near-tie gives a margin within the logit tolerance; a wrong kernel does
    not. Sampled mode scores are z + gumbel with z = logits * tinv, and a
    top-k boundary flip explains a divergence too: a kernel code the
    twin's top-k mask dropped, by its distance below the k-th largest z;
    or the twin's code, which the kernel's mask may have dropped, by its
    distance above the (k+1)-th largest z (the smaller of that and the
    score margin)."""
    gaps = []
    for b in torch.nonzero((got != ref).any(dim=1)).flatten().tolist():
        p = int(torch.nonzero(got[b] != ref[b])[0])
        lg = logits[p, b]
        r, g = int(ref[b, p]), int(got[b, p])
        if noise is None:
            gaps.append(float(lg[r] - lg[g]))
            continue
        z = lg * tinv
        top = torch.topk(z, top_k + 1).values
        if z[g] < top[top_k - 1]:
            gaps.append(float(top[top_k - 1] - z[g]) / tinv)
        else:
            score = (z[r] + noise[p, b, r]) - (z[g] + noise[p, b, g])
            gaps.append(min(float(score), float(z[r] - top[top_k])) / tinv)
    return gaps


def _codepred_inputs(cfg, B, dev, gen):
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    V = cfg.code_pred_vocab_size
    hidden = torch.randn(B, cfg.hidden_size, generator=gen, device=dev) * 0.5
    cb0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    return hidden, cb0, cf.gumbel_noise((cf.CTX - 1, B, V), gen, dev)


def _codepred_bound(w, cfg, B):
    """(bound dict, bytes, flops, re-stream ms): every layer weight, head
    and norm once, the gathered embedding rows, hidden, cb0, the noise,
    codes and logits; 2 B x (16 positions x layer params + 15 heads)
    FLOPs. Behind an mtp projection (the 1.7B shape) the rows are the
    folded f32 ones, and the projection of position 0's talker-wide
    hidden adds its weights and 2 B x its params. The re-stream bound
    counts the layer weights once per position (they do not fit in L2)."""
    cp = w["code_pred"]
    H, V = cfg.code_pred_hidden_size, cfg.code_pred_vocab_size
    layer_params = sum(t[0].numel() for t in cp["layers"].values())
    mtp = cp.get("mtp_w") is not None
    moved = (nbytes(cp["layers"], cp["heads"], cp["output_norm"])
             + 16 * B * H * (4 if mtp else 2) + B * H * 4 + B * 4
             + 15 * B * V * 4 + B * 15 * (4 + V * 4))
    flops = 2 * B * (16 * layer_params + 15 * H * V)
    if mtp:
        moved += nbytes(cp["mtp_w"], cp["mtp_b"]) + B * cfg.hidden_size * 4
        flops += 2 * B * cp["mtp_w"].numel()
    restream = (moved + 15 * nbytes(cp["layers"])) / HBM_BYTES_PER_S * 1e3
    return bound(moved, flops), moved, flops, restream


def check_codepred(w, cfg, dev, gen, timed: bool = True) -> dict:
    """Kernel vs twin and vs the XLA path (QWEN3_TTS_CODEPRED=xla) at the
    real widths, B = 8, 64 and 192 (CODEPRED_CHECK_B), three ways:
    forced (every position's code fed by spiked noise, top_k off): the
    codes must be the forced ones and all logits within LOGIT_TOL;
    greedy and sampled (fixed noise, T=0.9, top_k=50) run free: the codes'
    agreement rate is reported, logits up to each stream's first
    divergence must be within LOGIT_TOL, and each divergence must be a
    near-tie of the reference's scores (margin <= LOGIT_TOL). Times the
    kernel at CODEPRED_TIME_B (CUDA events, and the profiler's device
    time) beside its bound, with its phase clock, and the twin at B = 8
    (unless not `timed`)."""
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    worst, rates, failed = 0.0, [], []
    for B in CODEPRED_CHECK_B:
        err, agree = _codepred_modes(
            w, cfg, B, dev, gen, failed,
            {"twin": cf.predict_codes_twin, "xla": _xla_path})
        worst = max(worst, err)
        rates += agree
    if failed:
        raise AssertionError(f"codepred kernel disagrees with its twin or "
                             f"its XLA path: {failed}")
    timing = {}
    for B in CODEPRED_TIME_B if timed else ():
        hidden, cb0, noise = _codepred_inputs(cfg, B, dev, gen)

        def fused():
            cf.predict_codes_fused(w, cfg, hidden, cb0, 0.9, 50, gumbel=noise)
        ms = cuda_time(fused, iters=10)
        dev_ms = device_ms(fused, 5, ("codepred",))
        b, moved, flops, restream = _codepred_bound(w, cfg, B)
        plain = None
        if B == CODEPRED_B:
            plain = cuda_time(lambda: cf.predict_codes_twin(
                w, cfg, hidden, cb0, 0.9, 50, gumbel=noise), iters=3)
        timing[B] = (ms, dev_ms, plain, b)
        _codepred_phases(fused, B, dev)
        log(f"codepred B={B} one frame: kernel {ms:.3f} ms (device "
            f"{dev_ms:.3f} ms), "
            + (f"twin {plain:.3f} ms, " if plain is not None else "")
            + f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
            f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), layer weights "
            f"re-streamed per position {restream:.3f} ms")
    if not timed:
        return {}
    ms, dev_ms, plain, b = timing[CODEPRED_B]
    return {"name": "codepred", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/codepred.cu",
            "replaces": "qwen3_tts_tpu/ops/codepred_fused.py:425",
            "max_abs_err": worst, "code_agreement": min(rates), "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain, **b, "library_ms": None,
            "ms_by_batch": {str(k): v[0] for k, v in timing.items()},
            "bound_ms_by_batch": {str(k): v[3]["bound_ms"]
                                  for k, v in timing.items()},
            "shape": f"B={CODEPRED_B}, one frame"}


# the 1.7B talker's widths: a 2,048-wide talker, so an mtp_w into the
# kernel's 1,024-wide code predictor
TALKER_17B = dict(hidden_size=2048, intermediate_size=6144)
LOCKSTEP_17B_TOKENS = 40


def check_codepred_17b(dev, gen, timed: bool = True) -> dict:
    """The kernel's f32-row instantiation at the 1.7B shape: the code
    predictor of a 2-layer talker at the 1.7B's widths (a non-zero mtp_b),
    its mtp rows folded as the engine folds them (``Qwen3TTS`` on a card
    calls codepred_fused.fold_mtp). At CODEPRED_CHECK_B the kernel in the
    three modes of check_codepred, against the twin on the folded rows and
    against the XLA path (QWEN3_TTS_CODEPRED=xla: each raw row projected
    through mtp_w), LOGIT_TOL and near-tie margins as there; the
    cooperative launches of these runs (one a kernel call, none from the
    XLA path) counted from zero. Then one lock-step ``synthesize_batch``
    (4 requests, 40 frames, T 0.9) on the engine over that tree, without
    a vocoder: one cooperative launch a frame. Times the wrapper (CUDA
    events, with position 0's projection; the profiler's device time is
    the kernel's alone) at CODEPRED_TIME_B beside its bound (unless not
    `timed`). Returns the kernels line's entry "codepred_17b"."""
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.config import TalkerConfig
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
    cfg = TalkerConfig(n_layers=2, **TALKER_17B)
    tw = W.init_talker_weights(cfg, gen, dev)
    tw["code_pred"]["mtp_b"] = torch.randn(
        cfg.code_pred_hidden_size, generator=gen, device=dev) * 0.02
    engine = Qwen3TTS.from_components(smoke_tokenizer(), cfg, tw, None,
                                      None, dev)
    w = {"codec_embd": engine.talker_w["codec_embd"],
         "code_pred": engine.talker_w["code_pred"]}
    if not cf.supported(cfg, CODEPRED_B, w):
        raise AssertionError("the engine did not fold the 1.7B shape's rows")
    worst, rates, failed = 0.0, [], []
    calls0 = cf.predict_codes_fused.launches
    coop0 = kernels.codepred_launches()
    for B in CODEPRED_CHECK_B:
        err, agree = _codepred_modes(
            w, cfg, B, dev, gen, failed,
            {"twin": cf.predict_codes_twin, "xla": _xla_path})
        worst = max(worst, err)
        rates += agree
    torch.cuda.synchronize()
    calls = cf.predict_codes_fused.launches - calls0
    checked = kernels.codepred_launches() - coop0
    log(f"codepred 1.7B shape: {checked} cooperative launches for {calls} "
        f"kernel calls (3 modes x B {CODEPRED_CHECK_B}), max|logit err| "
        f"{worst:.3e}, code agreement >= {min(rates):.4f}")
    if checked != calls or calls != 3 * len(CODEPRED_CHECK_B):
        failed.append(f"launches {checked} for {calls} calls")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    coop0 = kernels.codepred_launches()
    res = engine.synthesize_batch(
        LOCKSTEP_TEXTS, params=TTSParams(
            max_audio_tokens=LOCKSTEP_17B_TOKENS, temperature=0.9,
            seed=SEED),
        generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    ran = {k: fn.launches for k, fn in counters.items()}
    lockstep = kernels.codepred_launches() - coop0
    steps = _talker_steps(ran, cfg, "auto" if ran["talker_fused"] else "xla")
    log(f"codepred 1.7B shape, synthesize_batch without a vocoder: frames "
        f"{[r.n_frames for r in res]}, {lockstep} cooperative launches for "
        f"{steps} lock-step frames; kernel launches {ran}")
    if not (lockstep == ran["codepred"] == steps > 0 and all(
            r.n_frames > 0 and r.error_msg == "Vocoder not loaded"
            for r in res)):
        failed.append("lock-step: not one launch a frame, or no codes")
    if failed:
        raise AssertionError(f"codepred at the 1.7B shape: {failed}")
    timing = {}
    for B in CODEPRED_TIME_B if timed else ():
        hidden, cb0, noise = _codepred_inputs(cfg, B, dev, gen)

        def fused():
            cf.predict_codes_fused(w, cfg, hidden, cb0, 0.9, 50, gumbel=noise)
        ms = cuda_time(fused, iters=10)
        dev_ms = device_ms(fused, 5, ("codepred",))
        b, moved, flops, _ = _codepred_bound(w, cfg, B)
        timing[B] = (ms, dev_ms, b)
        log(f"codepred 1.7B shape B={B} one frame: kernel {ms:.3f} ms "
            f"(device {dev_ms:.3f} ms), bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}: {moved / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP)")
    del engine, tw, w, res
    gc.collect()
    torch.cuda.empty_cache()
    if not timed:
        return {}
    ms, dev_ms, b = timing[CODEPRED_B]
    return {"name": "codepred_17b", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/codepred.cu",
            "replaces": "qwen3_tts_tpu/models/code_predictor.py:67",
            "max_abs_err": worst, "code_agreement": min(rates), "ms": ms,
            "device_ms": dev_ms, "plain_ms": None, **b, "library_ms": None,
            "ms_by_batch": {str(k): v[0] for k, v in timing.items()},
            "device_ms_by_batch": {str(k): v[1] for k, v in timing.items()},
            "bound_ms_by_batch": {str(k): v[2]["bound_ms"]
                                  for k, v in timing.items()},
            "launches": checked + lockstep, "launches_check": checked,
            "launches_lockstep": lockstep,
            "shape": f"B={CODEPRED_B}, one frame, talker 2048, f32 rows"}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return None if tree is None else tree.to(device)


def check_codepred_dispatch(talker_w, cfg, dev, gen) -> None:
    """QWEN3_TTS_CODEPRED on the card at B = CODEPRED_B:
    - the 1.7B shape (a 2,048-wide talker, so an mtp_w into the 1,024-wide
      code predictor) as drawn, without the folded rows an engine adds
      (codepred_fused.fold_mtp; check_codepred_17b holds the folded tree
      on the kernel), under auto takes the XLA-path branch: no
      code-predictor kernel launch, one decode-attention launch a layer and
      step over the 16-slot cache. Greedy: the logits within LOGIT_TOL of
      the same call on CPU tensors up to each stream's first differing
      code, and each difference a near-tie of the CPU logits (margin <=
      LOGIT_TOL); teacher-forced (spiked noise): the forced codes exactly;
    - fused with that mtp_w raises;
    - top_p < 1 at the 0.6B dims under auto takes the XLA-path branch too,
      and at top_p -> 0 its sampled codes are its greedy codes."""
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.config import TalkerConfig
    from qwen3_tts_tpu_torch.models import code_predictor as cp
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    B = CODEPRED_B

    def launches():
        return (kernels.codepred_launches(), cf.predict_codes_fused.launches,
                fd.flash_decode.launches)

    big = TalkerConfig(text_vocab_size=16, n_layers=1, hidden_size=2048)
    w = W.init_talker_weights(big, gen, dev)
    w = {"codec_embd": w["codec_embd"], "code_pred": w["code_pred"]}
    V, steps = big.code_pred_vocab_size, big.n_codebooks - 2
    hidden = torch.randn(B, big.hidden_size, generator=gen, device=dev) * 0.5
    cb0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    fails = []
    before = launches()
    lg = torch.empty(cf.CTX - 1, B, V, device=dev)
    got = cp.predict_codes(w, big, hidden, cb0, 0.9, 50, greedy=True,
                           logits_out=lg)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(launches(), before)]
    if ran != [0, 0, big.code_pred_layers * steps]:
        fails.append(f"mtp launches (kernel, wrapper, attention) {ran}")
    lg_cpu = torch.empty(cf.CTX - 1, B, V)
    ref = cp.predict_codes(_to(w, "cpu"), big, hidden.cpu(), cb0.cpu(), 0.9,
                           50, greedy=True, logits_out=lg_cpu)
    got, lg = got.cpu(), lg.cpu()
    differs = got != ref
    first = torch.where(differs.any(dim=1), differs.float().argmax(dim=1),
                        cf.CTX - 2)
    upto = torch.arange(cf.CTX - 1)[:, None] <= first[None, :]
    err = float((lg - lg_cpu).abs()[upto].max())
    gaps = _divergence_gaps(got, ref, lg_cpu, 1.0, 50, None)
    if not (err <= LOGIT_TOL and all(g <= LOGIT_TOL for g in gaps)):
        fails.append("mtp greedy disagrees with the CPU")
    forced = torch.randint(0, V, (cf.CTX - 1, B, 1), generator=gen,
                           device=dev)
    spikes = torch.zeros(cf.CTX - 1, B, V, device=dev).scatter_(2, forced,
                                                                1e30)
    got_forced = cp.predict_codes(w, big, hidden, cb0, 1.0, 0, gumbel=spikes)
    if not torch.equal(got_forced, forced[:, :, 0].t().int()):
        fails.append("mtp forced codes")
    ms = cuda_time(lambda: cp.predict_codes(w, big, hidden, cb0, 0.9, 50,
                                            greedy=True), iters=3)
    log(f"codepred dispatch, mtp_w (talker 2048 -> code predictor 1024) "
        f"B={B} under auto: launches (kernel, wrapper, decode attention) "
        f"{ran}; greedy code agreement with CPU tensors "
        f"{float((~differs).float().mean()):.4f}, max|logit err| {err:.3e} "
        f"up to first divergence, divergence margins "
        f"{[round(g, 4) for g in gaps]} (need each <= {LOGIT_TOL}); forced "
        f"codes exact {torch.equal(got_forced, forced[:, :, 0].t().int())}; "
        f"XLA path {ms:.3f} ms a frame")
    cp.set_codepred_impl("fused")
    try:
        cp.predict_codes(w, big, hidden, cb0, 0.9, 50, greedy=True)
        fails.append("fused with an mtp_w did not raise")
    except ValueError:
        pass
    finally:
        cp.set_codepred_impl(None)
    del w
    hidden = torch.randn(B, cfg.hidden_size, generator=gen, device=dev) * 0.5
    before = launches()
    codes = cp.predict_codes(talker_w, cfg, hidden, cb0, 0.9, 50, gen,
                             top_p=0.9)
    tiny = cp.predict_codes(talker_w, cfg, hidden, cb0, 0.9, 50, gen,
                            top_p=1e-6)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(launches(), before)]
    cp.set_codepred_impl("xla")
    try:
        greedy = cp.predict_codes(talker_w, cfg, hidden, cb0, 0.9, 50,
                                  greedy=True)
    finally:
        cp.set_codepred_impl(None)
    ok = (ran == [0, 0, 2 * cfg.code_pred_layers * steps]
          and torch.equal(tiny, greedy) and 0 <= int(codes.min())
          and int(codes.max()) < cfg.code_pred_vocab_size)
    log(f"codepred dispatch, top_p 0.9 and 1e-6 at the 0.6B dims B={B} "
        f"under auto: launches (kernel, wrapper, decode attention) {ran}; "
        f"top_p 1e-6 sampled codes equal the XLA path's greedy codes "
        f"{torch.equal(tiny, greedy)}")
    if not ok:
        fails.append("top_p")
    if fails:
        raise AssertionError(f"code-predictor dispatch: {fails}")


# phases of each kind in one frame (csrc/codepred.cu): position 0 runs 4
# whole layers and layer 4's QKV and attention; positions 1-15 five
# layers, the output norm, the head and the sampler; the clock adds one
# barrier after the last sampler
CODEPRED_PHASES = {"norm": 159, "qkv": 80, "attention": 80, "wo": 79,
                   "gate/up": 79, "act": 79, "down": 79, "head": 15,
                   "sample": 15}


def codepred_phase_ms(fused, dev) -> dict:
    """One frame of `fused` (a call of the code predictor's wrapper) with
    the kernel's phase clock on: ms per frame by phase kind."""
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    ns = torch.zeros(len(cf.PHASES), dtype=torch.int64, device=dev)
    cf.predict_codes_fused.phase_ns = ns
    try:
        fused()
        torch.cuda.synchronize()
    finally:
        cf.predict_codes_fused.phase_ns = None
    return dict(zip(cf.PHASES, (ns.double() / 1e6).tolist()))


def phase_line(ms: dict) -> str:
    """ms per frame and us per phase (with its grid barrier) by kind; the
    five products' sum."""
    prod = sum(ms[k] for k in ("qkv", "wo", "gate/up", "down", "head"))
    return (", ".join(f"{k} {v:.3f} ({v * 1e3 / CODEPRED_PHASES[k]:.1f})"
                      for k, v in ms.items())
            + f"; sum {sum(ms.values()):.3f} ms, products {prod:.3f} ms")


def _codepred_phases(fused, B, dev) -> None:
    log(f"codepred B={B} phase clock (CTA 0, globaltimer), ms per frame and "
        f"us per phase: " + phase_line(codepred_phase_ms(fused, dev)))


def _xla_path(w, cfg, hidden, cb0, **kw):
    """predict_codes under QWEN3_TTS_CODEPRED=xla (the XLA-path port)."""
    from qwen3_tts_tpu_torch.models import code_predictor as cp
    cp.set_codepred_impl("xla")
    try:
        return cp.predict_codes(w, cfg, hidden, cb0, **kw)
    finally:
        cp.set_codepred_impl(None)


def _codepred_modes(w, cfg, B, dev, gen, failed, refs=None):
    """The three modes at batch B, the kernel against each of `refs`
    (name -> a function called as the kernel's wrapper is; the twin by
    default); returns (max logit error, the free modes' code agreement
    rates) and appends each failing (B, mode, reference) to `failed`.
    Forced mode replays the first reference's greedy codes."""
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    V = cfg.code_pred_vocab_size
    refs = refs or {"twin": cf.predict_codes_twin}
    hidden, cb0, noise = _codepred_inputs(cfg, B, dev, gen)
    positions = torch.arange(cf.CTX - 1, device=dev)[:, None]

    def run(fn, **kw):
        logits = torch.empty(cf.CTX - 1, B, V, device=dev)
        codes = fn(w, cfg, hidden, cb0, logits_out=logits, **kw)
        return codes, logits

    worst, rates, ref = 0.0, [], None
    for mode in ("greedy", "sampled", "forced"):
        if mode == "greedy":
            kw = dict(temperature=0.9, top_k=50, greedy=True)
        elif mode == "sampled":
            kw = dict(temperature=0.9, top_k=50, gumbel=noise)
        else:
            spikes = torch.zeros_like(noise)
            spikes.scatter_(2, ref.t()[:, :, None].long(), 1e30)
            kw = dict(temperature=1.0, top_k=0, gumbel=spikes)
        got, lk = run(cf.predict_codes_fused, **kw)
        for name, fn in refs.items():
            ref_mode, lt = run(fn, **kw)
            torch.cuda.synchronize()
            if ref is None:
                ref = ref_mode               # forced mode replays these
            differs = got != ref_mode
            first = torch.where(differs.any(dim=1),
                                differs.float().argmax(dim=1), cf.CTX - 1)
            upto = positions <= first[None, :]
            err = float((lk - lt).abs()[upto].max())
            gaps = _divergence_gaps(got, ref_mode, lt,
                                    1.0 / kw["temperature"], kw["top_k"],
                                    kw.get("gumbel")
                                    if mode == "sampled" else None)
            agree = float((~differs).float().mean())
            log(f"codepred {mode} B={B} vs {name}: code agreement "
                f"{agree:.4f}, streams agreeing "
                f"{int((~differs.any(dim=1)).sum())}/{B}, max|logit err| "
                f"{err:.3e} up to first divergence (need <= {LOGIT_TOL}), "
                f"divergence margins {[round(g, 4) for g in gaps]} (need "
                f"each <= {LOGIT_TOL})")
            if (mode == "forced" and not torch.equal(got, ref)) or not (
                    err <= LOGIT_TOL and all(g <= LOGIT_TOL for g in gaps)):
                failed.append((B, mode, name))
            worst = max(worst, err)
            if mode != "forced":
                rates.append(agree)
    return worst, rates


def decoder_blocks(vcfg, dev, gen) -> list:
    """Kernel-check decoder blocks at the real widths: the main path's
    random draws (snake parameters and biases non-zero), but conv kernels
    at 1/sqrt(fan_in), so that the residual chain stays O(1) and the sin^2
    term is not lost in the bf16 rounding of large values."""
    from qwen3_tts_tpu_torch.models import vocoder, weights as W
    blocks, c = [], vcfg.decoder_dim
    for rate in vcfg.upsample_rates:
        blocks.append(W.init_decoder_block(c, rate, gen, dev, scale=None))
        c //= 2
    return vocoder.pack_kernel_weights(
        {"dec_blocks": vocoder.cast_weights(blocks)})["dec_blocks"]


def _rms_check(name, got, ref, shape_txt) -> tuple[float, float, float]:
    """Log kernel vs twin at one shape; return (max |err|, max |err| / RMS,
    RMS(err) / RMS), with inf for a non-finite kernel output."""
    diff = (got - ref).float()
    rms = ref.square().mean().sqrt().item()
    err = diff.abs().max().item()
    err_rms = diff.square().mean().sqrt().item()
    if not torch.isfinite(got).all():
        err = err_rms = float("inf")
    log(f"{name} {shape_txt}: max|err| {err:.3e}, twin RMS {rms:.3e}, "
        f"max|err|/RMS {err / rms:.3e} (need <= {VOC_MAX_TOL}), "
        f"RMS(err)/RMS {err_rms / rms:.3e} (need <= {VOC_RMS_TOL})")
    return err, err / rms, err_rms / rms


def _voc_report(name, source, replaces, errs, ms, plain, moved, flops,
                extra=None) -> dict:
    """The kernel's report line; raises when any shape is out of
    tolerance (after every shape was checked and logged)."""
    worst = [max(e[i] for e in errs) for i in range(3)]
    b = bound(moved, flops)
    log(f"{name}, 4 decoder blocks of one 40-frame chunk at B={VOC_B}: "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms; bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)")
    if not (worst[1] <= VOC_MAX_TOL and worst[2] <= VOC_RMS_TOL):
        raise AssertionError(f"{name} kernel disagrees with its twin")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": worst[0],
            "max_err_over_rms": worst[1], "rms_err_over_rms": worst[2],
            "ms": ms, "plain_ms": plain, **b, "library_ms": None,
            "shape": f"4 decoder blocks, one 40-frame chunk, B={VOC_B}",
            **(extra or {})}


RES_CHAIN_KERNELS = ("res_gemm", "snake_bf16")   # csrc/vocoder.cu
HEAD_KERNELS = ("snake_convt",)                  # its pre-pass and product


def _check_vocoder(name, runs, batches, prof_names, per_call, replaces, dev,
                   gen, timed) -> dict:
    """One vocoder kernel at the four decoder blocks' shapes (`runs`: per
    block (C, T, kernel(x), twin(x), its packed parameters, flops per
    stream)) and each B of `batches`: within tolerance of its twin, two
    calls on one input bitwise equal. Times the kernel at each B (CUDA
    events, and the profiler's device time by block) beside its bound, and
    the twin at VOC_B (unless not `timed`)."""
    ms, dev_ms, moved, flops = ({B: 0.0 for B in batches} for _ in range(4))
    plain, errs, unstable, blk_ms = 0.0, [], [], {}
    for B in batches:
        for c, t, kern, twin, params, fl in runs:
            x = torch.randn(B, t, c, generator=gen, device=dev)
            got, again, ref = kern(x), kern(x), twin(x)
            if got.shape != ref.shape:
                raise AssertionError(f"{name} shape {tuple(got.shape)}, twin "
                                     f"{tuple(ref.shape)}")
            if not torch.equal(got, again):
                unstable.append((B, c))
            errs.append(_rms_check(name, got, ref, f"B={B} T={t} C={c}"))
            moved[B] += nbytes(x, got, params)     # x in, y out, parameters
            flops[B] += B * fl
            if timed:
                ms[B] += cuda_time(lambda: kern(x), iters=5)
                blk_ms[(B, c)] = device_ms(lambda: kern(x), 3, prof_names)
                dev_ms[B] += blk_ms[(B, c)]
                if B == VOC_B:
                    plain += cuda_time(lambda: twin(x), iters=5)
            del x, got, again, ref
        torch.cuda.empty_cache()
    log(f"{name}: two calls bitwise equal at every shape: "
        f"{not unstable} {unstable or ''}")
    if unstable:
        raise AssertionError(f"{name} is not deterministic: {unstable}")
    for B in batches if timed else ():
        b = bound(moved[B], flops[B])
        log(f"{name}, 4 decoder blocks of one 40-frame chunk at B={B}: "
            f"kernel {ms[B]:.3f} ms (device {dev_ms[B]:.3f} ms, "
            f"{flops[B] / dev_ms[B] / 1e9:.1f} TFLOP/s, roofline share "
            f"{b['bound_ms'] / dev_ms[B]:.1%}); bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}: {moved[B] / 1e6:.1f} MB, "
            f"{flops[B] / 1e9:.2f} GFLOP) on {per_call} launches a block; "
            f"device ms by block (C): " + ", ".join(
                f"{r[0]} {blk_ms[(B, r[0])]:.3f}" for r in runs))
    extra = {"launches_per_call": per_call, "device_ms": dev_ms[VOC_B],
             "ms_by_batch": {str(B): ms[B] for B in batches},
             "device_ms_by_batch": {str(B): dev_ms[B] for B in batches},
             "device_ms_by_block": {f"B={B} C={c}": v
                                    for (B, c), v in blk_ms.items()},
             "bound_ms_by_batch": {str(B): bound(moved[B], flops[B])[
                 "bound_ms"] for B in batches}}
    return _voc_report(name, "qwen3_tts_tpu_torch/csrc/vocoder.cu", replaces,
                       errs, ms[VOC_B], plain, moved[VOC_B], flops[VOC_B],
                       extra)


def check_res_chain(blocks, dev, gen, timed: bool = True) -> dict:
    """The residual chain at B = 2 and 16: 3 units x 8 taps of C x C a
    row."""
    from qwen3_tts_tpu_torch.ops import vocoder_fused as vf
    runs = [(c, t, lambda x, blk=blk: vf.fused_residual_chain(x, blk),
             lambda x, blk=blk: vf.residual_chain_twin(x, blk),
             blk["kernel"]["res"], 3 * 8 * 2 * t * c * c)
            for blk, (c, t) in zip(blocks, CHAIN_SHAPES)]
    return _check_vocoder("res_chain", runs, VOC_TIME_B, RES_CHAIN_KERNELS, 7,
                          "qwen3_tts_tpu/ops/vocoder_fused.py:233", dev, gen,
                          timed)


def check_snake_convt(blocks, dev, gen, timed: bool = True) -> dict:
    """The Snake + convT head at B = 2, 16 and 48: one K = 2C product of
    r * C2 columns a row."""
    from qwen3_tts_tpu_torch.ops import vocoder_fused as vf
    runs = [(c, t, lambda x, blk=blk, r=r: vf.fused_snake_convt(x, blk, r),
             lambda x, blk=blk, r=r: vf.snake_convt_twin(x, blk, r),
             blk["kernel"]["head"], 2 * t * (2 * c) * (r * c2))
            for blk, (c, c2, r, t) in zip(blocks, HEAD_SHAPES)]
    return _check_vocoder("snake_convt", runs, HEAD_B, HEAD_KERNELS, 2,
                          "qwen3_tts_tpu/ops/vocoder_fused.py:151", dev, gen,
                          timed)


def _attn_cache(B, S, dev, gen, n_kv=8):
    """Random bf16 K/V [B, n_kv, S, 128] and their int8 rows + scales as
    the cache stores them (stack.quantize_kv_rows)."""
    from qwen3_tts_tpu_torch.models.stack import quantize_kv_rows
    k, v = (torch.randn(B, n_kv, S, 128, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    (k8, ks), (v8, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    return {"bf16": (k, v, None, None), "int8": (k8, v8, ks, vs)}


def _attn_cases(B, S, read_ctx, dev, gen) -> dict:
    """Mode -> wrapper kwargs at one read_ctx. Stream 2 is empty in every
    mode. Windows put hi - 1 on a block start with its bit set (a window
    end read one short drops that block), keep lo >= 64 in the plain window
    (block 0 is read for the prefill region only) and take lo > hi in the
    wrapped one."""
    from qwen3_tts_tpu_torch.ops.flash_decode import BLOCK
    from qwen3_tts_tpu_torch.runtime.generate import RING_PREFILL_SLOTS as P

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    def ints(lo, hi):
        return torch.randint(lo, hi, (B,), generator=gen, device=dev,
                             dtype=torch.int32)

    n_valid = ints(1, read_ctx + 1)
    n_valid[0], n_valid[1], n_valid[2] = 1, read_ctx, 0
    mask = rand(B, S) < 0.4
    mask[2] = False
    slot = torch.arange(S, device=dev)
    cases = {"prefix": dict(n_valid=n_valid), "mask": dict(valid_mask=mask)}
    for mode, hi in (("window", read_ctx - BLOCK + 1), ("wrap", 2 * BLOCK + 1)):
        if mode == "window":
            lo = ints(BLOCK, hi - 1)
            inside = (slot[None] >= lo[:, None]) & (slot[None] < hi)
        else:
            lo = ints(hi + BLOCK, read_ctx)
            inside = (((slot[None] >= P) & (slot[None] < hi))
                      | ((slot[None] >= lo[:, None])
                         & (slot[None] < read_ctx)))
        m = inside & (rand(B, S) < 0.7)
        m[:, :10] = True                    # prefill rows
        m[:, hi - 1] = True
        m[2] = False
        cases[mode] = dict(valid_mask=m, window_lo=lo, prefill_len=P,
                           window_hi=torch.tensor(hi, dtype=torch.int32,
                                                  device=dev))
    return cases


def _attn_call(kw, q, k, v, ks, vs, read_ctx, twin):
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    if twin:
        return fd.flash_decode_twin(q, k, v, read_ctx=read_ctx, k_scale=ks,
                                    v_scale=vs, **kw)
    if "n_valid" in kw:
        return fd.flash_decode(q, k, v, kw["n_valid"], read_ctx=read_ctx,
                               k_scale=ks, v_scale=vs)
    kw = dict(kw)
    return fd.flash_decode_masked(q, k, v, kw.pop("valid_mask"),
                                  read_ctx=read_ctx, k_scale=ks, v_scale=vs,
                                  **kw)


def check_flash_decode(dev, gen, timed: bool = True) -> dict:
    """The decode-attention kernel against its twin at the talkers' widths
    (16 query heads over 8 kv heads, G = 2, and over 2, G = 8, Qwen3-Omni's
    talker; D = 128), B = 8 and 32, S = 1,152, read_ctx 512 / 1,024 /
    1,152: prefix (ragged, 1 and read_ctx), scattered bitmask, ring
    window, wrapped window, each with an empty stream; bf16 and int8
    caches. Times kernel and twin at the serving shape (window mode,
    read_ctx 1,152), G = 8 at B = 32 in bf16 only, unless not `timed`."""
    worst, timing, dev_t, sweep, failed = 0.0, {}, {}, {}, []
    g8 = {}
    for B in ATTN_B:
        q = torch.randn(B, 16, 128, generator=gen, device=dev).bfloat16()
        for n_kv in ATTN_KV_HEADS:
            caches = _attn_cache(B, ATTN_S, dev, gen, n_kv)
            G = 16 // n_kv
            for read_ctx in ATTN_READ_CTX:
                cases = _attn_cases(B, ATTN_S, read_ctx, dev, gen)
                for kv, (k, v, ks, vs) in caches.items():
                    errs = {}
                    for mode, kw in cases.items():
                        got = _attn_call(kw, q, k, v, ks, vs, read_ctx, False)
                        ref = _attn_call(kw, q, k, v, ks, vs, read_ctx, True)
                        err = (got - ref).abs().max().item()
                        if not torch.isfinite(got).all():
                            err = float("inf")
                        if got[2].abs().max().item() != 0.0:
                            err = float("inf")          # empty stream not 0
                        errs[mode] = err
                        if not err <= ATTN_TOL:
                            failed.append((B, G, read_ctx, kv, mode))
                    log(f"flash_decode B={B} G={G} S={ATTN_S} "
                        f"read_ctx={read_ctx} {kv}: max|err| " + ", ".join(
                            f"{m} {e:.3e}" for m, e in errs.items())
                        + f" (need <= {ATTN_TOL}; empty stream exactly 0)")
                    worst = max(worst, *errs.values())
                if read_ctx != ATTN_S or not timed:
                    continue
                kw = cases["window"]
                if G == 8:
                    if B == ATTN_B[1]:
                        k, v = caches["bf16"][:2]
                        g8 = {"ms": cuda_time(lambda: _attn_call(
                                  kw, q, k, v, None, None, read_ctx, False),
                                  iters=20),
                              "device_ms": device_ms(lambda: _attn_call(
                                  kw, q, k, v, None, None, read_ctx, False),
                                  20, ("fd_",)),
                              **_attn_bound(kw, q, None, read_ctx, n_kv)}
                        log(f"flash_decode window mode B={B} G=8 S={ATTN_S} "
                            f"read_ctx={ATTN_S} bf16, one layer: kernel "
                            f"{g8['ms']:.4f} ms (device {g8['device_ms']:.4f}"
                            f" ms, roofline share "
                            f"{g8['bound_ms'] / g8['device_ms']:.1%}); bound "
                            f"{g8['bound_ms']:.4f} ms ({g8['bound_by']})")
                    continue
                for kv, (k, v, ks, vs) in caches.items():
                    timing[(B, kv)] = [cuda_time(
                        lambda t=t: _attn_call(kw, q, k, v, ks, vs, read_ctx,
                                               t), iters=20)
                        for t in (False, True)]
                    timing[(B, kv)] += [_attn_bound(kw, q, ks, read_ctx)]
                    dev_t[(B, kv)] = device_ms(
                        lambda: _attn_call(kw, q, k, v, ks, vs, read_ctx,
                                           False), 20, ("fd_",))
                    sweep[(B, kv)] = _split_sweep(kw, q, k, v, ks, vs,
                                                  read_ctx)
                # the yardstick: one PyTorch call, bf16, the same slots
                timing[(B, "bf16")].append(_sdpa_ms(
                    kw, q, *caches["bf16"][:2], read_ctx))
    for (B, kv), (ms, plain, b, *lib) in timing.items():
        sdpa = f"scaled_dot_product_attention {lib[0]:.4f} ms, " if lib else ""
        log(f"flash_decode window mode B={B} S={ATTN_S} read_ctx={ATTN_S} "
            f"{kv}, one layer: kernel {ms:.4f} ms (device "
            f"{dev_t[(B, kv)]:.4f} ms, roofline share "
            f"{b['bound_ms'] / dev_t[(B, kv)]:.1%}), twin {plain:.4f} ms, "
            f"{sdpa}bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
            f"{sweep[(B, kv)]}")
    if failed:
        raise AssertionError(f"flash_decode kernel disagrees with its twin: "
                             f"{failed}")
    if not timed:
        return {}
    ms, plain, b, lib = timing[(ATTN_B[0], "bf16")]
    return {"name": "flash_decode", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/flash_decode.cu",
            "replaces": "qwen3_tts_tpu/ops/flash_decode.py:255",
            "also_replaces": "qwen3_tts_tpu/ops/flash_decode.py:277",
            "max_abs_err": worst, "ms": ms,
            "device_ms": dev_t[(ATTN_B[0], "bf16")], "plain_ms": plain, **b,
            "library_ms": lib,
            "b32": {"ms": timing[(ATTN_B[1], "bf16")][0],
                    "device_ms": dev_t[(ATTN_B[1], "bf16")],
                    "bound_ms": timing[(ATTN_B[1], "bf16")][2]["bound_ms"],
                    "library_ms": timing[(ATTN_B[1], "bf16")][3]},
            "g8_b32": g8,
            "shape": f"B={ATTN_B[0]} bf16 window mode, read_ctx={ATTN_S}, "
                     "one layer, G=2 (g8_b32: B=32, 2 kv heads)"}


def _split_sweep(kw, q, k, v, ks, vs, read_ctx) -> str:
    """Device ms of a call at each tiles-per-split of SPLIT_SWEEP, the
    wrapper's plan replaced for the measurement, beside the plan's own."""
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    plan, n_tiles = fd.split_plan, -(-read_ctx // fd.BLOCK)
    picked = plan(q.shape[0] * k.shape[1], n_tiles, fd._sm_count(q.device))
    out = []
    try:
        for per in SPLIT_SWEEP:
            fd.split_plan = lambda *_, per=per: (per, -(-n_tiles // per))
            ms = device_ms(lambda: _attn_call(kw, q, k, v, ks, vs, read_ctx,
                                              False), 20, ("fd_",))
            out.append(f"{per} {ms:.4f}")
    finally:
        fd.split_plan = plan
    return (f"device ms by tiles per split (the plan takes {picked[0]}): "
            + ", ".join(out))


def _attn_counted(kw, q, read_ctx):
    """[B, read_ctx] bool: the slots this case counts."""
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    kw = dict(kw)
    hi = kw.pop("window_hi", None)
    return fd._slots_read(q.shape[0], read_ctx, q.device, window_hi=hi, **kw)


def _attn_bound(kw, q, k_scale, read_ctx, n_kv=8) -> dict:
    """One layer's decode attention must read q, the mask and the K/V rows
    (with scales) of the counted slots over n_kv heads, and write the
    output; 4 flops per query head, dim and counted slot."""
    slots = int(_attn_counted(kw, q, read_ctx).sum())
    B, n_heads, D = q.shape
    row = n_kv * D * (1 if k_scale is not None else 2) + (
        n_kv * 4 if k_scale is not None else 0)
    moved = (nbytes(q) + B * read_ctx + 2 * slots * row + B * n_heads * D * 4)
    return bound(moved, 4 * slots * n_heads * D)


def _sdpa_ms(kw, q, k, v, read_ctx) -> float:
    """ms of torch's scaled_dot_product_attention (GQA, bool mask of the
    counted slots) on the same bf16 inputs: a yardstick, unused by the
    port."""
    import torch.nn.functional as F
    mask = _attn_counted(kw, q, read_ctx)[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k[:, :, :read_ctx], v[:, :, :read_ctx]
    return cuda_time(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), iters=20)


def _moe_layer(dev, gen):
    """One MoE layer at Qwen3-Omni's talker widths (config.MoEConfig's
    defaults: H 1024, 128 experts of 384, shared 768, top-6), bf16
    normal(0, 0.02) but the router normal(0, 0.1), whose logits of a few
    units decide as a trained router's do."""
    from qwen3_tts_tpu_torch.config import MoEConfig
    moe, H = MoEConfig(), 1024
    E, Ie, Is = moe.n_experts, moe.expert_intermediate, moe.shared_intermediate

    def rn(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=dev) * std).bfloat16()

    return moe, {"w_router": rn(H, E, std=0.1), "w_gu_e": rn(E, H, 2 * Ie),
                 "w_down_e": rn(E, Ie, H), "w_gu_s": rn(H, 2 * Is),
                 "w_down_s": rn(Is, H), "w_sgate": rn(H)}


def _moe_bound(lw, moe, N, experts) -> dict:
    """One call over N rows must read the weights of the experts its rows
    route to (`experts` distinct), the shared expert, router and gate, the
    rows in (f32) and out (f32); its operations are the active
    parameters' (k experts, the shared expert, router and gate a row)."""
    H, Ie, Is = 1024, moe.expert_intermediate, moe.shared_intermediate
    per_expert = 3 * H * Ie
    fixed = 3 * H * Is + H * moe.n_experts + H
    moved = 2 * (experts * per_expert + fixed) + 2 * 4 * N * H
    return bound(moved, 2 * N * (moe.top_k * per_expert + fixed))


def check_moe(dev, gen, timed: bool = True) -> dict:
    """The MoE FFN (ops/moe.py: router, grouped experts, gated shared
    expert; four launches) against its twin at Qwen3-Omni's widths, over
    N = 1, 8 and 192 decode rows, the cell's prefill (192 x 75 rows) and
    192 rows that all route to the same 6 experts. Rows route alike
    unless their k-th and (k+1)-th router logits nearly tie (MOE_TIE);
    over the rows that route alike, the relative L2 error must be at most
    MOE_TOL, which a bf16 round trip of the experts' products must exceed.
    Times the kernel at N = 192 and at the prefill, with its bound from
    the experts those rows route to, unless not `timed`."""
    from qwen3_tts_tpu_torch.ops import moe as M
    moe, lw = _moe_layer(dev, gen)
    cases = [(N, None) for N in MOE_B + (MOE_PREFILL_N,)]
    cases.append((192, (5, 17, 33, 64, 99, 127)))
    failed, worst, timing = [], 0.0, {}
    for N, dominate in cases:
        w = dict(lw)
        h = torch.randn(N, 1024, generator=gen, device=dev)
        if dominate is not None:
            h = h.abs()
            wr = torch.zeros(1024, moe.n_experts, device=dev)
            for i, e in enumerate(dominate):
                wr[:, e] = 0.01 * (i + 1)
            w["w_router"] = wr.bfloat16()
        s = {}
        got = M.moe_ffn(h, w, moe, scratch=s)
        want = M.moe_ffn_twin(h, w, moe)
        ek = s["experts"].long().sort(-1).values
        x, et, _, _ = M.route(h, w["w_router"], w["w_sgate"], moe.top_k,
                              moe.norm_topk_prob)
        et = et.sort(-1).values
        same = (ek == et).all(-1)
        logits = (x.float() @ w["w_router"].float()).sort(-1,
                                                          descending=True)[0]
        gap = logits[:, moe.top_k - 1] - logits[:, moe.top_k]
        ties = int((~same).sum())
        untied = int((~same & (gap > MOE_TIE)).sum())
        inner = M.swiglu
        M.swiglu = lambda *a: inner(*a).to(torch.bfloat16).float()
        try:
            rounded = M.moe_ffn_twin(h, w, moe)
        finally:
            M.swiglu = inner

        def rel(a):
            a, b = a[same].double(), want[same].double()
            return ((a - b).norm() / b.norm()).item()
        err, seen = rel(got), rel(rounded)
        worst = max(worst, err)
        ok = (torch.isfinite(got).all().item() and err <= MOE_TOL < seen
              and untied == 0)
        if dominate is not None:
            ok = ok and set(ek.unique().tolist()) == set(dominate)
        if not ok:
            failed.append((N, dominate is not None))
        n_experts = int(et.unique().numel())
        log(f"moe N={N}{' six experts' if dominate else ''}: rel L2 "
            f"{err:.3e} over {int(same.sum())} rows routed alike (need <= "
            f"{MOE_TOL}; the experts' products rounded to bf16 read "
            f"{seen:.3e}); {ties} rows routed apart, {untied} of them "
            f"without a near-tie; {n_experts} experts read")
        if timed and dominate is None and N in (192, MOE_PREFILL_N):
            fn = (lambda h=h, w=w: M.moe_ffn(h, w, moe))
            timing[N] = {"ms": cuda_time(fn, iters=20),
                         "device_ms": device_ms(fn, 20, ("moe_",)),
                         "plain_ms": cuda_time(
                             lambda h=h, w=w: M.moe_ffn_twin(h, w, moe),
                             iters=3),
                         "experts_read": n_experts,
                         **_moe_bound(w, moe, N, n_experts)}
            t = timing[N]
            log(f"moe N={N}, one layer: kernel {t['ms']:.4f} ms (device "
                f"{t['device_ms']:.4f} ms, roofline share "
                f"{t['bound_ms'] / t['device_ms']:.1%}), twin "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}, {n_experts} experts read)")
        del h, got, want, rounded
    if failed:
        raise AssertionError(f"moe kernel disagrees with its twin: {failed}")
    if not timed:
        return {}
    return {"name": "moe", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/moe.cu",
            "replaces": "none: the JAX package has no MoE talker",
            "max_rel_err": worst, **timing[192],
            "prefill": timing[MOE_PREFILL_N],
            "shape": f"N=192 decode rows, one layer (prefill: "
                     f"N={MOE_PREFILL_N})"}


def _mla_inputs(B, dev, gen, mode):
    """(q [B, 64, 576], rows [B, MLA_CTX, 576] bf16, the mode's keywords):
    prefix mode with ragged n_valid (stream 0 empty where B > 1, stream 1
    at the whole cache), masked mode with a random bitmask."""
    q = torch.randn(B, 64, 576, generator=gen, device=dev).bfloat16()
    rows = torch.randn(B, MLA_CTX, 576, generator=gen, device=dev).bfloat16()
    if mode == "prefix":
        n = torch.randint(1, MLA_CTX + 1, (B,), generator=gen, device=dev)
        if B > 1:
            n[0], n[1] = 0, MLA_CTX
        return q, rows, dict(n_valid=n.int())
    mask = torch.rand(B, MLA_CTX, generator=gen, device=dev) < 0.5
    return q, rows, dict(valid_mask=mask)


def check_mla(dev, gen, timed: bool = True) -> dict:
    """Latent attention's decode kernel (csrc/mla_decode.cu) against its
    twin at LongCat-Flash's widths (64 heads over 576-wide rows, values
    512), B 1, 8 and 192, prefix and masked modes, read_ctx the cell's
    cache and a bucket under it (rows past it NaN, never read); twice
    each, bitwise equal. Timed at B 192 with every stream at the cell's
    median position, beside its bound."""
    from qwen3_tts_tpu_torch.ops import mla
    scale = 192 ** -0.5
    failed, worst, timing = [], 0.0, {}
    for B in MLA_B:
        for mode in ("prefix", "masked"):
            for rc in (MLA_CTX, 256):
                q, rows, kw = _mla_inputs(B, dev, gen, mode)
                rows[:, rc:] = float("nan")
                fn = (mla.mla_decode if mode == "prefix"
                      else mla.mla_decode_masked)
                arg = kw.get("n_valid", kw.get("valid_mask"))
                got = fn(q, rows, arg, scale, 64, read_ctx=rc)
                again = fn(q, rows, arg, scale, 64, read_ctx=rc)
                want = mla.mla_decode_twin(q, rows, scale, 64, read_ctx=rc,
                                           **kw)
                err = ((got.float() - want.float()).norm()
                       / want.float().norm().clamp_min(1e-30)).item()
                worst = max(worst, err)
                ok = (torch.isfinite(got).all().item() and err <= MLA_TOL
                      and torch.equal(got, again))
                if mode == "prefix" and B > 1:
                    ok = ok and not got[0].any().item()
                if not ok:
                    failed.append((B, mode, rc))
                log(f"mla B={B} {mode} read_ctx={rc}: rel L2 {err:.3e} "
                    f"(need <= {MLA_TOL}), repeat bitwise "
                    f"{torch.equal(got, again)}")
    if failed:
        raise AssertionError(f"mla kernel disagrees with its twin: {failed}")
    if not timed:
        return {}
    B = 192
    q, rows, _ = _mla_inputs(B, dev, gen, "prefix")
    n = torch.full((B,), MLA_MEDIAN, dtype=torch.int32, device=dev)
    fn = lambda: mla.mla_decode(q, rows, n, scale, 64, read_ctx=MLA_CTX)
    moved = 2 * B * (MLA_MEDIAN * 576 + 64 * 576 + 64 * 512)
    flops = B * 2 * 64 * (576 + 512) * MLA_MEDIAN
    timing = {"ms": cuda_time(fn, iters=50),
              "device_ms": device_ms(fn, 20, ("",)),
              "plain_ms": cuda_time(lambda: mla.mla_decode_twin(
                  q, rows, scale, 64, n_valid=n, read_ctx=MLA_CTX), iters=5),
              **bound(moved, flops)}
    t = timing
    log(f"mla B={B} at {MLA_MEDIAN} rows: kernel {t['ms']:.4f} ms (device "
        f"{t['device_ms']:.4f} ms, roofline share "
        f"{t['bound_ms'] / t['device_ms']:.1%}), twin {t['plain_ms']:.4f} "
        f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return {"name": "mla", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/mla_decode.cu",
            "replaces": "none: the JAX package has no latent attention",
            "max_rel_err": worst, **timing,
            "shape": f"B={B}, 64 heads x 576, {MLA_MEDIAN} rows a stream"}


def _moe_ep_layer(dev, gen):
    """One LongCat-Flash MoE at its widths (H 6144; 512 real and 256
    identity experts, top-12, p x 6; experts of 2048), this chip's 16
    experts [0, 16): bf16 normal(0, 0.02), the correction bias normal(0,
    1e-3), as the benchmark's configuration draws them."""
    from qwen3_tts_tpu_torch.config import MoEConfig
    moe = MoEConfig(n_experts=512, top_k=12, expert_intermediate=2048,
                    shared_intermediate=0, norm_topk_prob=False,
                    n_zero_experts=256, routed_scaling=6.0, n_held=16)
    H, Ie = 6144, 2048

    def rn(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=dev) * std).bfloat16()

    return moe, {"w_router": rn(H, moe.router_width),
                 "e_bias": torch.randn(moe.router_width, generator=gen,
                                       device=dev) * 1e-3,
                 "w_gu_e": rn(16, H, 2 * Ie), "w_down_e": rn(16, Ie, H)}


def check_moe_ep(dev, gen, timed: bool = True) -> dict:
    """The expert-parallel MoE path (ops/moe.py, q3_moe_ffn_ep) against its
    twin at LongCat-Flash's widths over N = 1, 8 and 192 decode rows and
    192 rows routed by the bias to 12 chosen ids (held, identity and
    remote experts): the route's ids, the counts [5] and, over the rows
    routed alike, the output within MOE_TOL, which a bf16 round trip of
    the experts' products exceeds on the chosen ids (under the random
    router few rows reach a held expert). Timed at N = 192 with its
    bound."""
    from qwen3_tts_tpu_torch.ops import moe as M
    moe, lw = _moe_ep_layer(dev, gen)
    chosen = (0, 3, 15, 512, 600, 767, 100, 200, 300, 400, 5, 700)
    failed, worst, timing = [], 0.0, {}
    for N, dom in ((1, False), (8, False), (192, False), (192, True)):
        w = dict(lw, moe_counts=torch.zeros(5, dtype=torch.int32,
                                            device=dev))
        if dom:
            w["e_bias"] = torch.zeros_like(lw["e_bias"])
            w["e_bias"][list(chosen)] = torch.arange(
                12, 0, -1, device=dev).float()
        h = torch.randn(N, 6144, generator=gen, device=dev)
        s = {}
        got = M.moe_ffn(h, w, moe, scratch=s)
        counts = w["moe_counts"].clone()
        w["moe_counts"] = torch.zeros_like(counts)
        want = M.moe_ffn_twin(h, w, moe)
        x, et, _ = M.route_ep(h, w["w_router"], w["e_bias"], moe)
        # the same ids; the order among the top_k may differ where two of
        # them nearly tie, which only reorders the combine's f32 sums
        same = (s["experts"].long().sort(-1).values
                == et.sort(-1).values).all(-1)
        p = torch.softmax(M.dot(x, w["w_router"]), -1) + w["e_bias"]
        srt = p.sort(-1, descending=True).values
        gap = srt[:, moe.top_k - 1] - srt[:, moe.top_k]
        untied = int((~same & (gap > MOE_EP_TIE)).sum())
        inner = M.swiglu
        M.swiglu = lambda *a: inner(*a).to(torch.bfloat16).float()
        try:
            rounded = M.moe_ffn_twin(h, {k: v for k, v in w.items()
                                         if k != "moe_counts"}, moe)
        finally:
            M.swiglu = inner

        def rel(a):
            a, b = a[same].double(), want[same].double()
            return ((a - b).norm() / b.norm()).item()
        err, seen = rel(got), rel(rounded)
        worst = max(worst, err)
        ok = (torch.isfinite(got).all().item() and err <= MOE_TOL
              and untied == 0
              and (counts.tolist() == w["moe_counts"].tolist()
                   or not bool(same.all())))
        if dom:
            # 4 held experts of every row: the products weigh enough here
            # for their bf16 round trip to show (few rows reach a held
            # expert under the random router)
            ok = ok and s["experts"][0].tolist() == list(chosen) \
                and seen > MOE_TOL
        if not ok:
            failed.append((N, dom))
        log(f"moe_ep N={N}{' chosen ids' if dom else ''}: rel L2 {err:.3e} "
            f"over {int(same.sum())} rows routed alike (need <= {MOE_TOL}; "
            f"bf16 expert products read {seen:.3e}); {int((~same).sum())} "
            f"rows apart, {untied} without a near-tie; counts (pairs, rows, "
            f"max, zero, remote) {counts.tolist()} against the twin's "
            f"{w['moe_counts'].tolist()}")
        if timed and N == 192 and not dom:
            held = et[(et < 16)]
            n_read = int(held.unique().numel())
            per_expert = 3 * 6144 * 2048
            moved = (2 * (n_read * per_expert + 6144 * 768) + 4 * 768
                     + 2 * 4 * N * 6144)
            flops = 2 * (held.numel() * per_expert + N * 6144 * 768)
            fn = (lambda h=h, w=w: M.moe_ffn(h, w, moe))
            timing = {"ms": cuda_time(fn, iters=20),
                      "device_ms": device_ms(fn, 20, ("",)),
                      "experts_read": n_read, **bound(moved, flops)}
            t = timing
            log(f"moe_ep N=192, one layer: {t['ms']:.4f} ms (device "
                f"{t['device_ms']:.4f} ms, roofline share "
                f"{t['bound_ms'] / t['device_ms']:.1%}), bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {n_read} experts "
                f"read, {held.numel()} pairs)")
        del h, got, want, rounded
    if failed:
        raise AssertionError(f"moe_ep disagrees with its twin: {failed}")
    if not timed:
        return {}
    return {"name": "moe_ep", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/moe.cu",
            "replaces": "none: the JAX package has no MoE talker",
            "max_rel_err": worst, **timing,
            "shape": "N=192 decode rows, one LongCat layer, 16 held experts"}


def _tf_cache(L, B, kv, read_ctx, dev, gen, S=TF_S):
    """A random [L, 2, B, 8, S, 128] cache (bf16, or int8 rows and
    scales as stack.quantize_kv_rows stores them) with NaN planted at and
    past read_ctx (values for bf16, scales for int8)."""
    from qwen3_tts_tpu_torch.models.stack import QuantKV, quantize_kv_rows
    shape = (L, 2, B, 8, S, 128)
    vals = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for l in range(L):
        vals[l] = torch.randn(shape[1:], generator=gen, device=dev) * 0.5
    if kv == "bf16":
        vals[..., read_ctx:, :] = float("nan")
        return vals
    q = torch.empty(shape, dtype=torch.int8, device=dev)
    sc = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
    for l in range(L):
        q[l], sc[l] = quantize_kv_rows(vals[l])
    sc[..., read_ctx:] = float("nan")
    return QuantKV(q, sc)


def _tf_case(mode, B, read_ctx, dev, gen, S=TF_S):
    """(positions, n_valid, valid_mask, widx) of one talker check. Prefix:
    stream 0 live at widx, 1 and 2 frozen below it, 3 empty, 4 claims
    more than read_ctx (only read_ctx slots count), the rest ragged. Mask:
    ring validity in each lane's window [lo, widx] plus the prefill rows;
    even lanes wrapped (lo > widx: [16, widx] U [lo, read_ctx)), lane 1
    dead at widx, bits set past read_ctx (never read)."""
    from qwen3_tts_tpu_torch.runtime.generate import RING_PREFILL_SLOTS as P
    widx = read_ctx - 9 if mode == "prefix" else read_ctx // 4
    positions = torch.randint(0, 2000, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
    if mode == "prefix":
        n_valid = torch.randint(1, widx + 1, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
        special = [widx + 1, widx, 37, 0, S][:B]
        n_valid[:len(special)] = torch.tensor(special, device=dev)
        return positions, n_valid, None, widx
    slot = torch.arange(S, device=dev)[None]
    lo = torch.randint(P, widx, (B,), generator=gen, device=dev)
    lo[0::2] = torch.randint(widx + 2, read_ctx, (len(lo[0::2]),),
                             generator=gen, device=dev)
    inside = torch.where((lo > widx)[:, None],
                         ((slot >= P) & (slot <= widx))
                         | ((slot >= lo[:, None]) & (slot < read_ctx)),
                         (slot >= lo[:, None]) & (slot <= widx))
    mask = inside & (torch.rand(B, S, generator=gen, device=dev) < 0.7)
    mask[:, :10] = True                             # prefill rows
    mask[:, widx] = True
    mask[1, widx] = False                           # a lane dead this step
    mask[:, read_ctx:] = torch.rand(B, S - read_ctx, generator=gen,
                                    device=dev) < 0.5
    return positions, None, mask, widx


def _cache_parts(c):
    return (c.values, c.scales) if hasattr(c, "scales") else (c,)


def _bits(t):
    """A bit-exact view (NaN compares equal to itself)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
        t.view(torch.int32) if t.dtype == torch.float32 else t)


def _tf_row(c, widx):
    """The rows the step wrote, every layer, dequantized for int8, and the
    per-element slack of one rounding step of the stored value: the int8
    row's scale, or |value| * 2^-7 (at least a bf16 ulp)."""
    if hasattr(c, "scales"):
        scale = c.scales[..., widx, None]
        return c.values[..., widx, :].float() * scale, scale
    row = c[..., widx, :].float()
    return row, row.abs() * 2.0 ** -7


def _rel_err(got, ref, slack=0.0) -> list:
    """[max |err| / RMS, RMS(err) / RMS] of got against ref, `slack` taken
    off each |err|; inf where got is not finite."""
    if not torch.isfinite(got).all():
        return [float("inf")] * 2
    diff = ((got - ref).abs() - slack).clamp_min(0.0)
    rms = ref.float().square().mean().sqrt().item()
    return [diff.max().item() / rms, diff.square().mean().sqrt().item() / rms]


def _tf_bytes_flops(lw, B, kv, rc, n_valid, mask):
    """What one step must move and compute: every weight and norm once,
    x and y, the written rows, and the K/V rows (with scales) of the slots
    this case counts."""
    L, H = lw["wqkv"].shape[:2]
    if mask is not None:
        slots = int(mask[:, :rc].sum())
    else:
        slots = int(n_valid.clamp(0, rc).sum())
    row = 8 * 128 * (1 if kv == "int8" else 2) + (8 * 4 if kv == "int8" else 0)
    moved = (nbytes(lw) + 2 * B * H * 4 + 2 * L * B * row
             + 2 * L * slots * row)
    params = sum(lw[n][0].numel() for n in ("wqkv", "wo", "w_gu", "w_down"))
    flops = 2 * B * L * params + 4 * L * 16 * 128 * slots
    return moved, flops


def check_talker_fused(talker_w, cfg, dev, gen, timed: bool = True) -> dict:
    """The megakernel against its twin at the full widths (28 layers, H
    1024, 16/8 heads, D 128, I 3072), B = 4, 8 and 32, bf16 and int8,
    read_ctx 256 and 1,152 in a cache of 1,152 slots with NaN at and past
    read_ctx,
    prefix mode (ragged, frozen, empty streams) and mask mode (scattered
    ring bits, a dead lane, wrapped windows): y and the written rows within
    TF_*_TOL of the twin's RMS, every other cache row bit-identical, y
    finite; and B = TF_WIDE_B at read_ctx TF_WIDE_S. Times kernel, twin
    and the xla path's talker_step (layers, output norm and codec head) on
    the prefix case of each shape, with the phase clock at TF_CLOCKED
    (unless not `timed`)."""
    from qwen3_tts_tpu_torch.models import stack, talker
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    lw = talker_w["layers"]
    kw = dict(n_heads=cfg.n_attention_heads, n_kv=cfg.n_key_value_heads,
              head_dim=cfg.head_dim, eps=cfg.rms_norm_eps,
              theta=cfg.rope_theta)
    worst, failed, timing = [0.0, 0.0, 0.0], [], {}
    for B in TF_B:
        for kv in ("bf16", "int8"):
            for rc in TF_READ_CTX:
                orig = _tf_cache(cfg.n_layers, B, kv, rc, dev, gen)
                x = torch.randn(B, cfg.hidden_size, generator=gen, device=dev)
                for mode in ("prefix", "mask"):
                    pos, n_valid, mask, widx = _tf_case(mode, B, rc, dev, gen)
                    widx_t = torch.tensor(widx, dtype=torch.int32, device=dev)
                    ck, ct = _clone_cache(orig), _clone_cache(orig)
                    args = (x, pos)
                    y_k, _ = tf.talker_step_fused(
                        lw, *args, ck, widx_t, n_valid, read_ctx=rc,
                        valid_mask=mask, **kw)
                    y_t, _ = tf.talker_step_fused_twin(
                        lw, *args, ct, widx_t, n_valid, read_ctx=rc,
                        valid_mask=mask, **kw)
                    cx = _clone_cache(orig)
                    y_x, _ = stack.stack_step(
                        lw, *args, cx, widx_t, n_valid, read_ctx=rc,
                        valid_mask=mask, **kw)
                    del cx
                    torch.cuda.synchronize()
                    (row_k, _), (row_t, slack) = (_tf_row(ck, widx),
                                                  _tf_row(ct, widx))
                    errs = [_rel_err(y_k, y_t), _rel_err(row_k, row_t, slack)]
                    yard = _rel_err(y_x, y_t)
                    keep = torch.ones(TF_S, dtype=torch.bool, device=dev)
                    keep[widx] = False
                    same = all(
                        torch.equal(_bits(a)[..., keep, :] if a.dim() == 6
                                    else _bits(a)[..., keep],
                                    _bits(b)[..., keep, :] if b.dim() == 6
                                    else _bits(b)[..., keep])
                        for a, b in zip(_cache_parts(ck), _cache_parts(orig)))
                    abs_err = (y_k - y_t).abs().max().item()
                    ok = same and all(e[0] <= TF_MAX_TOL
                                      and e[1] <= TF_RMS_TOL for e in errs)
                    log(f"talker_fused B={B} {kv} read_ctx={rc} {mode}: y "
                        f"max|err|/RMS {errs[0][0]:.3e}, RMS(err)/RMS "
                        f"{errs[0][1]:.3e} (max|err| {abs_err:.3e}); written "
                        f"rows {errs[1][0]:.3e}, {errs[1][1]:.3e} (need <= "
                        f"{TF_MAX_TOL}, {TF_RMS_TOL}); other rows "
                        f"{'bit-identical' if same else 'CHANGED'}; xla path "
                        f"vs twin {yard[0]:.3e}, {yard[1]:.3e}")
                    if not ok:
                        failed.append((B, kv, rc, mode))
                    worst = [max(worst[0], abs_err), max(worst[1], errs[0][0]),
                             max(worst[2], errs[0][1])]
                    if timed and mode == "prefix" and kv == "bf16" and (
                            B, rc) in TF_CLOCKED:
                        _talker_phases(lambda: tf.talker_step_fused(
                            lw, *args, ck, widx_t, n_valid, read_ctx=rc,
                            **kw), B, rc, cfg.n_layers, dev)
                    if timed and mode == "prefix":
                        timing[(B, kv, rc)] = (
                            cuda_time(lambda: tf.talker_step_fused(
                                lw, *args, ck, widx_t, n_valid, read_ctx=rc,
                                **kw), iters=10),
                            cuda_time(lambda: tf.talker_step_fused_twin(
                                lw, *args, ct, widx_t, n_valid, read_ctx=rc,
                                **kw), iters=2),
                            _xla_step_ms(talker, talker_w, cfg, x, pos, ct,
                                         widx_t, rc),
                            _tf_bytes_flops(lw, B, kv, rc, n_valid, None))
                    del ck, ct
                del orig
                torch.cuda.empty_cache()
    for (B, kv, rc), (ms, plain, xla, (moved, flops)) in timing.items():
        b = bound(moved, flops)
        log(f"talker_fused step B={B} {kv} read_ctx={rc} ({cfg.n_layers} "
            f"layers): kernel {ms:.3f} ms, twin {plain:.3f} ms, xla "
            f"talker_step {xla:.3f} ms; "
            f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}: "
            f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    wide = _tf_wide(lw, cfg, kw, dev, gen, failed, timed)
    if failed:
        raise AssertionError(f"talker_fused disagrees with its twin: {failed}")
    if not timed:
        return {}
    ms, plain, xla, (moved, flops) = timing[(TF_HEAD_B, "bf16",
                                             TF_READ_CTX[0])]
    by_shape = {f"B={B} {kv} read_ctx={rc}": {
        "ms": t[0], "plain_ms": t[1], "bound_ms": bound(*t[3])["bound_ms"]}
        for (B, kv, rc), t in timing.items()}
    by_shape[f"B={TF_WIDE_B} bf16 read_ctx={TF_WIDE_S}"] = wide
    return {"name": "talker_fused", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/talker_fused.cu",
            "replaces": "qwen3_tts_tpu/ops/talker_fused.py:548",
            "max_abs_err": worst[0], "max_err_over_rms": worst[1],
            "rms_err_over_rms": worst[2], "ms": ms, "plain_ms": plain,
            "xla_path_ms": xla, **bound(moved, flops), "library_ms": None,
            "shape": f"B={TF_HEAD_B} bf16 read_ctx={TF_READ_CTX[0]}, one step",
            "by_shape": by_shape}


# (B, read_ctx) with the phase clock
TF_CLOCKED = ((4, 256), (8, 256), (32, 1152))


def _talker_phases(fn, B, rc, n_layers, dev) -> None:
    """One step with the kernel's phase clock on: ms per step and us per
    phase (with its grid barrier) by phase kind, beside the step's time
    with the clock off (CUDA events)."""
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    count = {k: n * n_layers + (k == "norm") for k, n in
             tf.PHASES_PER_LAYER.items()}
    ns = torch.zeros(len(tf.PHASES), dtype=torch.int64, device=dev)
    tf.talker_step_fused.phase_ns = ns
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        tf.talker_step_fused.phase_ns = None
    step_ms = cuda_time(fn, iters=10)
    ms = dict(zip(tf.PHASES, (ns.double() / 1e6).tolist()))
    log(f"talker_fused B={B} bf16 read_ctx={rc}: step {step_ms:.3f} ms; "
        f"phase clock (CTA 0, globaltimer), ms per step and us per phase: "
        + ", ".join(f"{k} {v:.3f} ({v * 1e3 / count[k]:.1f})"
                    for k, v in ms.items())
        + f"; sum {sum(ms.values()):.3f} ms; "
        f"{tf.BARRIERS_PER_LAYER} grid barriers a layer")


def _tf_wide(lw, cfg, kw, dev, gen, failed, timed=True) -> dict:
    """B = TF_WIDE_B, bf16, read_ctx = S = TF_WIDE_S, prefix mode: y within
    tolerance of the twin; the kernel timed beside its bound (when
    `timed`)."""
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    B, rc = TF_WIDE_B, TF_WIDE_S
    orig = _tf_cache(cfg.n_layers, B, "bf16", rc, dev, gen, S=rc)
    x = torch.randn(B, cfg.hidden_size, generator=gen, device=dev)
    pos, n_valid, _, widx = _tf_case("prefix", B, rc, dev, gen, S=rc)
    widx_t = torch.tensor(widx, dtype=torch.int32, device=dev)
    ck, ct = _clone_cache(orig), _clone_cache(orig)
    del orig
    y_k, _ = tf.talker_step_fused(lw, x, pos, ck, widx_t, n_valid,
                                  read_ctx=rc, **kw)
    y_t, _ = tf.talker_step_fused_twin(lw, x, pos, ct, widx_t, n_valid,
                                       read_ctx=rc, **kw)
    del ct
    err = _rel_err(y_k, y_t)
    if not timed:
        log(f"talker_fused B={B} bf16 read_ctx={rc} prefix: y max|err|/RMS "
            f"{err[0]:.3e}, RMS(err)/RMS {err[1]:.3e} (need <= "
            f"{TF_MAX_TOL}, {TF_RMS_TOL})")
        if not (err[0] <= TF_MAX_TOL and err[1] <= TF_RMS_TOL):
            failed.append((B, "bf16", rc, "prefix"))
        return {}
    ms = cuda_time(lambda: tf.talker_step_fused(
        lw, x, pos, ck, widx_t, n_valid, read_ctx=rc, **kw), iters=5)
    dev_ms = device_ms(lambda: tf.talker_step_fused(
        lw, x, pos, ck, widx_t, n_valid, read_ctx=rc, **kw), 3,
        ("talker_step",))
    b = bound(*_tf_bytes_flops(lw, B, "bf16", rc, n_valid, None))
    log(f"talker_fused B={B} bf16 read_ctx={rc} prefix: y max|err|/RMS "
        f"{err[0]:.3e}, RMS(err)/RMS {err[1]:.3e} (need <= {TF_MAX_TOL}, "
        f"{TF_RMS_TOL}); step kernel {ms:.3f} ms (device {dev_ms:.3f} ms), "
        f"bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    if not (err[0] <= TF_MAX_TOL and err[1] <= TF_RMS_TOL):
        failed.append((B, "bf16", rc, "prefix"))
    del ck
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev_ms, "bound_ms": b["bound_ms"]}


def _xla_step_ms(talker, w, cfg, x, positions, cache, widx, read_ctx):
    """ms of the per-layer talker_step (QWEN3_TTS_TALKER=xla)."""
    talker.set_talker_step_impl("xla")
    try:
        return cuda_time(lambda: talker.talker_step(
            w, cfg, x, cache, positions, widx, read_ctx=read_ctx), iters=2)
    finally:
        talker.set_talker_step_impl(None)


def _check_results(results, engine) -> None:
    spf = engine.voc_cfg.samples_per_frame
    for res in results:
        if not res.success:
            raise AssertionError(f"request failed: {res.error_msg}")
        if not np.isfinite(res.audio).all():
            raise AssertionError("non-finite audio")
        if len(res.audio) != res.n_frames * spf:
            raise AssertionError(f"{len(res.audio)} samples for "
                                 f"{res.n_frames} frames")


def _expect_launches(ran: dict, impl: str, what: str,
                     top_p: float = 1.0) -> None:
    """Every kernel of the path launched and no other: the vocoder's two,
    the talker step's (the megakernel under auto, decode attention under
    xla) and the code predictor's (its kernel, or under top_p < 1 its XLA
    path, whose attention is decode attention)."""
    need = {"res_chain", "snake_convt",
            {"auto": "talker_fused", "xla": "flash_decode"}[impl],
            "codepred" if top_p >= 1.0 else "flash_decode"}
    if min(ran[k] for k in need) <= 0 or any(
            ran[k] for k in ran if k not in need):
        raise AssertionError(f"{what} ({impl}, top_p={top_p}): kernel "
                             f"launches {ran}")


def _talker_steps(ran: dict, cfg, impl: str) -> int:
    """Talker decode steps of a run, from the launch counts."""
    if impl == "auto":
        return ran["talker_fused"]
    return ran["flash_decode"] // cfg.n_layers


def lockstep_run(engine, impl, kv, temperature, top_p, card, counters,
                 dev) -> dict:
    """One synthesize_batch of 4 requests at the full widths under
    QWEN3_TTS_TALKER=impl; returns its kernel launches. The code predictor
    makes one kernel launch a frame, or, at top_p < 1, none: its XLA path
    runs each frame, with one decode-attention launch a layer and step."""
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    os.environ["QWEN3_TTS_KV"] = kv
    talker.set_talker_step_impl(impl)
    from qwen3_tts_tpu_torch import kernels
    for fn in counters.values():
        fn.launches = 0
    coop0 = kernels.codepred_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        res = engine.synthesize_batch(
            LOCKSTEP_TEXTS, params=TTSParams(
                max_audio_tokens=LOCKSTEP_TOKENS, temperature=temperature,
                top_p=top_p, seed=SEED),
            generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
    finally:
        talker.set_talker_step_impl(None)
    wall = time.monotonic() - t0
    ran = {k: fn.launches for k, fn in counters.items()}
    _check_results(res, engine)
    cfg = engine.talker_cfg
    steps = _talker_steps(ran, cfg, impl)
    audio_s = sum(len(r.audio) for r in res) / engine.voc_cfg.sample_rate
    gen_ms, dec_ms = call_split(res)
    log(f"synthesize_batch talker={impl} kv={kv} temperature={temperature} "
        f"top_p={top_p}: {len(res)} requests, frames "
        f"{[r.n_frames for r in res]}, "
        f"{audio_s:.2f} s of audio in {wall:.2f} s wall (generate "
        f"{gen_ms:.0f} ms, decode {dec_ms:.0f} ms)"
        f"; generate {gen_ms / steps:.2f} ms per lock-step "
        f"frame ({steps} frames) on {card}; kernel launches {ran}")
    _expect_launches(ran, impl, "synthesize_batch", top_p)
    coop = kernels.codepred_launches() - coop0
    log(f"  code predictor: {coop} cooperative launches for {steps} frames "
        f"({ran['codepred']} wrapper calls)")
    if top_p >= 1.0 and not coop == ran["codepred"] == steps:
        raise AssertionError("the code predictor did not make exactly one "
                             "kernel launch per lock-step frame")
    per_frame = cfg.code_pred_layers * (cfg.n_codebooks - 2)
    if top_p < 1.0 and not (coop == ran["codepred"] == 0 and impl == "auto"
                            and ran["flash_decode"] == steps * per_frame):
        raise AssertionError(f"top_p={top_p}: the code-predictor kernel "
                             f"launched, or its XLA path did not run each "
                             f"frame ({per_frame} attention launches)")
    return ran


PROFILE_TOKENS = 40           # one 40-frame chunk under the profiler
PROFILE_GROUPS = (("code predictor", ("codepred",)),
                  ("talker megakernel", ("talker_step",)),
                  ("decode attention", ("fd_",)),
                  ("residual chain", RES_CHAIN_KERNELS),
                  ("Snake+convT head", ("snake_convt",)))


def profile_lockstep(engine, card, dev, mode: str) -> float:
    """One greedy bf16 synthesize_batch (4 requests, one 40-frame chunk)
    under torch.profiler and QWEN3_TTS_TALKER=auto: device ms per
    lock-step frame by kernel group, the rest of the kernels, and the
    share of the wall the card was busy (union of kernel intervals).
    mode "graph": the chunk and the vocoder replay their CUDA graphs (the
    warm call before captured them), and the profile must show one
    code-predictor and one talker launch a frame; "eager": QWEN3_TTS_AOT=0.
    Returns (busy share, busy device ms per frame)."""
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    os.environ["QWEN3_TTS_KV"] = "bf16"
    os.environ["QWEN3_TTS_AOT"] = "0" if mode == "eager" else "1"
    talker.set_talker_step_impl("auto")
    params = TTSParams(max_audio_tokens=PROFILE_TOKENS, temperature=0.0,
                       seed=SEED)
    try:
        engine.synthesize_batch(LOCKSTEP_TEXTS, params=params)  # warm
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            t0 = time.monotonic()
            res = engine.synthesize_batch(LOCKSTEP_TEXTS, params=params)
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) * 1e3
            time.sleep(PROFILER_PAD_S)
    finally:
        talker.set_talker_step_impl(None)
        os.environ.pop("QWEN3_TTS_AOT", None)
    events = _kernel_events(prof)
    frames = max(r.n_frames for r in res)
    gen_ms, dec_ms = call_split(res)
    groups, rest = {}, 0.0
    for name, start, end in events:
        for label, keys in PROFILE_GROUPS:
            if any(k in name for k in keys):
                groups[label] = groups.get(label, 0.0) + (end - start)
                break
        else:
            rest += end - start
    busy = sum(end - start for start, end in _merged(events))
    n_cp = sum("codepred_frame_kernel" in e[0] for e in events)
    n_tf = sum("talker_step_kernel" in e[0] for e in events)
    split = ", ".join(f"{k} {v / 1e3 / frames:.3f}" for k, v in groups.items())
    log(f"profiled synthesize_batch ({mode}) talker=auto kv=bf16 greedy, "
        f"{frames} lock-step frames, wall {wall:.1f} ms (generate "
        f"{gen_ms:.1f} ms, decode {dec_ms:.1f} ms; "
        f"host clock under the profiler) on {card}: device ms per frame: "
        f"{split}, other kernels {rest / 1e3 / frames:.3f} "
        f"({len(events)} kernels in all; code predictor {n_cp}, talker "
        f"{n_tf} launches); card busy {busy / 1e3:.1f} ms, "
        f"{busy / 1e3 / wall:.1%} of the wall")
    if mode == "graph" and not n_cp == n_tf == PROFILE_TOKENS:
        raise AssertionError(f"a replayed chunk of {PROFILE_TOKENS} frames "
                             f"launched the code predictor {n_cp} and the "
                             f"talker {n_tf} times")
    return busy / 1e3 / wall, busy / 1e3 / frames


def _clone_cache(cache):
    from qwen3_tts_tpu_torch.models.stack import QuantKV
    if isinstance(cache, QuantKV):
        return QuantKV(cache.values.clone(), cache.scales.clone())
    return cache.clone()


def serve_run(engine, impl, kv, card, counters, dev):
    """ContinuousBatcher at the full widths under QWEN3_TTS_TALKER=impl: 8
    requests, 8 more after the second step, 4 more after the fourth,
    short and long texts alternating. Returns (kernel launches, device
    copies of the ring state at steps after the ring first wrapped)."""
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.runtime.generate import RING_PREFILL_SLOTS
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    os.environ["QWEN3_TTS_KV"] = kv
    talker.set_talker_step_impl(impl)
    cb = ContinuousBatcher(engine, n_slots=SERVE_SLOTS,
                           params=TTSParams(temperature=0.0, seed=SEED),
                           max_frames=SERVE_MAX_FRAMES)
    ring = cb.ctx - RING_PREFILL_SLOTS
    texts = [SERVE_SHORT, SERVE_LONG] * 10
    for fn in counters.values():
        fn.launches = 0
    fd.flash_decode.launches_by_mode.update(prefix=0, mask=0, window=0)
    fd.flash_decode.wrapped = torch.zeros(1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        rids = [cb.submit(t) for t in texts[:8]]
        results, captures, n_steps = {}, [], 0
        while cb.pending():
            results.update(cb.step())
            n_steps += 1
            if n_steps in (2, 4):
                rids += [cb.submit(t) for t in texts[
                    len(rids):len(rids) + (8 if n_steps == 2 else 4)]]
            if cb._steps_done > ring and len(captures) < 2:
                # device-side copies: no host sync in the serving loop
                st = cb.state
                captures.append(dict(
                    kv=kv, mask=st.valid_mask.clone(), lo=st.ring_lo.clone(),
                    hi=st.write_slot.clone(), done=st.done.clone(),
                    n_past=st.n_past.clone(),
                    cache=_clone_cache(st.kv_cache), read_ctx=cb.ctx))
        torch.cuda.synchronize()
    finally:
        talker.set_talker_step_impl(None)
    wall = time.monotonic() - t0
    ran = {k: fn.launches for k, fn in counters.items()}
    modes = dict(fd.flash_decode.launches_by_mode)
    wrapped = int(fd.flash_decode.wrapped.item())
    fd.flash_decode.wrapped = None
    _check_results([results[r] for r in rids], engine)
    frames = [results[r].n_frames for r in rids]
    n_cap = sum(f == cb.max_frames for f in frames)
    n_eos = sum(f < cb.max_frames for f in frames)
    audio_s = (sum(len(results[r].audio) for r in rids)
               / engine.voc_cfg.sample_rate)
    steps = _talker_steps(ran, engine.talker_cfg, impl)
    log(f"ContinuousBatcher talker={impl} kv={kv} slots={SERVE_SLOTS} "
        f"max_frames={SERVE_MAX_FRAMES}: {len(rids)} requests "
        f"({len(rids) - 8} submitted mid-run), {n_steps} steps, frames "
        f"{frames} ({n_cap} retired by the frame cap, {n_eos} by EOS), "
        f"{sum(frames)} frames, {audio_s:.2f} s of audio in {wall:.2f} s "
        f"wall, {wall * 1e3 / steps:.2f} ms of wall per {SERVE_SLOTS}-slot "
        f"frame ({steps} talker steps) on {card}; ring of {ring} slots, "
        f"{cb._steps_done} ring writes; kernel launches {ran}, "
        f"flash_decode by mode {modes}, streams served with a wrapped "
        f"window {wrapped}")
    _expect_launches(ran, impl, "serving")
    if impl == "xla" and (modes["window"] <= 0 or wrapped <= 0):
        raise AssertionError("serving did not run window mode on a wrapped "
                             "window")
    if not (n_cap and n_eos and cb._steps_done > ring):
        raise AssertionError("serving did not retire by cap and by EOS and "
                             "wrap the ring")
    return ran, captures


def check_captured(captures, talker_w, cfg, dev, gen) -> None:
    """Both attention kernels against their twins on ring states captured
    from live serving after the ring wrapped: decode attention on layer 0
    with the ring window; the megakernel on the whole cache with the next
    step's mask (bit write_slot set to liveness) and random inputs."""
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    from qwen3_tts_tpu_torch.runtime.generate import RING_PREFILL_SLOTS
    n_wrapped = 0
    kw = dict(n_heads=cfg.n_attention_heads, n_kv=cfg.n_key_value_heads,
              head_dim=cfg.head_dim, eps=cfg.rms_norm_eps,
              theta=cfg.rope_theta)
    for c in captures:
        cache = c["cache"]
        parts = _cache_parts(cache)
        k, v = parts[0][0, 0], parts[0][0, 1]
        ks, vs = (parts[1][0, 0], parts[1][0, 1]) if len(parts) == 2 \
            else (None, None)
        B = k.shape[0]
        q = torch.randn(B, 16, 128, generator=gen, device=dev).bfloat16()
        akw = dict(window_lo=c["lo"], window_hi=c["hi"],
                   prefill_len=RING_PREFILL_SLOTS, read_ctx=c["read_ctx"],
                   k_scale=ks, v_scale=vs)
        got = fd.flash_decode_masked(q, k, v, c["mask"], **akw)
        ref = fd.flash_decode_twin(q, k, v, valid_mask=c["mask"], **akw)
        err = (got - ref).abs().max().item()
        mask = c["mask"].clone()
        widx = c["hi"]
        mask[:, widx.long()] = ~c["done"]
        x = torch.randn(B, cfg.hidden_size, generator=gen, device=dev)
        ck, ct = _clone_cache(cache), _clone_cache(cache)
        y_k, _ = tf.talker_step_fused(talker_w["layers"], x, c["n_past"], ck,
                                      widx, None, read_ctx=c["read_ctx"],
                                      valid_mask=mask, **kw)
        y_t, _ = tf.talker_step_fused_twin(
            talker_w["layers"], x, c["n_past"], ct, widx, None,
            read_ctx=c["read_ctx"], valid_mask=mask, **kw)
        diff = y_k - y_t
        rms = y_t.square().mean().sqrt().item()
        tf_err = (diff.abs().max().item() / rms,
                  diff.square().mean().sqrt().item() / rms)
        live_wrapped = int(((c["lo"] > c["hi"]) & ~c["done"]).sum())
        n_wrapped += live_wrapped
        log(f"on a live ring after its wrap ({c['kv']}, write_slot "
            f"{int(c['hi'])}, ring_lo {c['lo'].tolist()}, {live_wrapped} live "
            f"streams wrapped): flash_decode max|err| {err:.3e} (need <= "
            f"{ATTN_TOL}); talker_fused y max|err|/RMS {tf_err[0]:.3e}, "
            f"RMS(err)/RMS {tf_err[1]:.3e} (need <= {TF_MAX_TOL}, "
            f"{TF_RMS_TOL})")
        if not (err <= ATTN_TOL and tf_err[0] <= TF_MAX_TOL
                and tf_err[1] <= TF_RMS_TOL):
            raise AssertionError("a kernel disagrees on a live ring")
    if not captures or n_wrapped == 0:
        raise AssertionError("no live ring state with a wrapped window")


def _leaves(tree, path="w"):
    """(path, tensor) of every tensor in nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _check_bits(got, want, device, what) -> int:
    """Every tensor of `got` on `device`, of `want`'s dtype, shape and
    bits; returns the tensor count."""
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    if set(got_l) != set(want_l):
        raise AssertionError(f"{what}: the loaded tree has other tensors: "
                             f"{sorted(set(got_l) ^ set(want_l))[:8]}")
    for path, g in got_l.items():
        w = want_l[path]
        if g.device != device or g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what} {path}: {g.device} {g.dtype} "
                                 f"{tuple(g.shape)}, want {device} {w.dtype} "
                                 f"{tuple(w.shape)}")
        gb, wb = (t.detach().cpu().contiguous().view(torch.uint8)
                  for t in (g, w))
        if not torch.equal(gb, wb):
            raise AssertionError(f"{what} {path}: bits differ")
    return len(got_l)


def _load(model_dir, low_mem: bool):
    """Qwen3TTS().load_models(model_dir) as a user calls it (no device
    argument): the engine, its load seconds and the card memory it holds
    (allocated bytes after the load less before)."""
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS
    os.environ["QWEN3_TTS_LOW_MEM"] = "1" if low_mem else "0"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    try:
        eng = Qwen3TTS()
        if not eng.load_models(model_dir):
            raise AssertionError(f"load_models failed: {eng.error_msg}")
    finally:
        os.environ.pop("QWEN3_TTS_LOW_MEM")
    seconds = time.monotonic() - t0
    return eng, seconds, torch.cuda.memory_allocated() - before


CLONE_TOKENS = 120
CLONE_CLIP_S = (2, 3, 4, 5, 6, 7, 8, 10)     # the batch enrolment's clips
SPK_TIMED = ((3.0, None), (10.0, None), (None, 8), (None, 32))


def _clip(seconds, sr, seed):
    """A voiced-like test clip: two partials and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 110 + 40 * rng.random()
    return (0.4 * np.sin(2 * np.pi * f0 * t)
            + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _check_speaker_encoder(eng, ref_wav, dev, card) -> np.ndarray:
    """encode_speaker with TF32 at PyTorch's defaults inside the call,
    against the same encoder on CPU tensors; the batch enrolment against
    single clips; the encoder's times. Returns the batch's embeddings."""
    from qwen3_tts_tpu_torch.models import speaker_encoder as spk
    from qwen3_tts_tpu_torch.runtime import audio_io
    # PyTorch's defaults: cuDNN may use TF32, cuBLAS may not
    torch.backends.cudnn.allow_tf32 = True
    try:
        emb = eng.encode_speaker(ref_wav)    # loads the encoder: first use
        if emb is None:
            raise AssertionError(f"encode_speaker failed: {eng.error_msg}")
        cfg = eng.spk_cfg
        samples, sr = audio_io.load_wav(ref_wav)
        mel = spk.mel_spectrogram(audio_io.resample_linear(
            samples, sr, cfg.sample_rate), cfg)
        pad = np.zeros((1, spk.bucket_frames(len(mel)), cfg.n_mels),
                       np.float32)
        pad[0, :len(mel)] = mel
        n = torch.tensor([len(mel)])
        cpu_w = _to(eng.spk_w, "cpu")
        want = spk.encode(cpu_w, cfg, torch.from_numpy(pad), n)[0].numpy()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            tf32 = spk._encode(eng.spk_w, cfg, torch.from_numpy(pad).to(dev),
                               n.to(dev))[0].cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    rms = float(np.sqrt(np.mean(want ** 2)))
    err = float(np.abs(emb - want).max())
    log(f"speaker encoder on the card, TF32 at PyTorch's defaults (cuDNN on):"
        f" {sr} Hz reference resampled to {cfg.sample_rate}, {len(mel)} "
        f"frames in a {pad.shape[1]}-frame bucket; max|err| {err:.3e} "
        f"against CPU tensors, RMS {rms:.3e} (need <= 1e-4 x RMS); the "
        f"encoder with cuDNN TF32 left on would give "
        f"{np.abs(tf32 - want).max():.3e}")
    if not (emb.shape == (cfg.embedding_dim,) and err <= 1e-4 * rms):
        raise AssertionError("speaker embedding differs from the CPU's")

    clips = [_clip(s, cfg.sample_rate, i) for i, s in enumerate(CLONE_CLIP_S)]
    batch = eng.encode_speaker_batch(clips, cfg.sample_rate)
    single = np.stack([eng.encode_speaker_samples(c, cfg.sample_rate)
                       for c in clips])
    gap = float(np.abs(batch - single).max())
    log(f"encode_speaker_batch of {len(clips)} clips of {CLONE_CLIP_S} s "
        f"against single clips: max|err| {gap:.3e} (need atol 1e-3 + rtol "
        f"1e-3)")
    np.testing.assert_allclose(batch, single, atol=1e-3, rtol=1e-3)

    times = []
    for seconds, n_clips in SPK_TIMED:
        if n_clips is None:
            clip = _clip(seconds, cfg.sample_rate, 99)
            fn = lambda: eng.encode_speaker_samples(clip, cfg.sample_rate)
            what = f"{seconds:g} s clip"
        else:
            group = [clips[i % len(clips)] for i in range(n_clips)]
            fn = lambda: eng.encode_speaker_batch(group, cfg.sample_rate)
            what = f"batch of {n_clips} clips (2-10 s)"
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(5):
            fn()                 # returns host numpy: synchronised
        times.append(f"{what} {(time.monotonic() - t0) / 5 * 1e3:.2f} ms")
    log(f"speaker encoder wall ms per call (host mel for one clip, device "
        f"mel for a batch; 5 calls after one warm-up) on {card}: "
        + ", ".join(times))
    return batch


def load_and_clone(tok, cfg, talker_w, vcfg, voc_w, engine, card, counters,
                   dev) -> dict:
    """The model-loading and voice-cloning entry points at the full
    widths: a model directory written from random weights, loaded as a
    user loads it (normal and QWEN3_TTS_LOW_MEM=1), checked bitwise; the
    speaker encoder; synthesize_with_voice and synthesize_batch with
    cloned voices; the CLI in-process. Returns the kernel launches of its
    synthesis runs."""
    import contextlib
    import io
    import shutil
    import tempfile
    from qwen3_tts_tpu_torch import cli
    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig
    from qwen3_tts_tpu_torch.models import speaker_encoder as spk
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.runtime import audio_io
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    scfg = SpeakerEncoderConfig(embedding_dim=cfg.hidden_size)
    spk_w = spk.init_speaker_encoder_weights(scfg, gen, dev)
    root = tempfile.mkdtemp(prefix="q3tts_models_")
    try:
        t0 = time.monotonic()
        write_model_dir(root, tok, cfg, talker_w, scfg, spk_w, vcfg, voc_w)
        size = sum(os.path.getsize(os.path.join(root, f))
                   for f in os.listdir(root))
        log(f"model directory written: {size / 1e9:.3f} GB "
            f"({sorted(os.listdir(root))}) in {time.monotonic() - t0:.1f} s")

        eng, secs, held = _load(root, low_mem=False)
        n = _check_bits(eng.talker_w, talker_w, dev, "talker")
        n += _check_bits(eng.voc_w, engine.voc_w, dev, "vocoder")
        low, low_secs, low_held = _load(root, low_mem=True)
        host = [t for _, t in _leaves(low.voc_w)]
        if not all(t.device.type == "cpu" and t.is_pinned() for t in host):
            raise AssertionError("low-memory vocoder weights not pinned host")
        _check_bits(_to(low.voc_w, dev), engine.voc_w, dev, "low-mem vocoder")
        log(f"load_models at the full widths on {card}: {secs:.2f} s, "
            f"{held / 2**30:.3f} GiB of card memory after loading "
            f"(allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB in "
            f"all); {n} tensors on {dev}, bitwise equal to the written "
            f"weights; QWEN3_TTS_LOW_MEM=1: {low_secs:.2f} s, "
            f"{low_held / 2**30:.3f} GiB of card memory, the vocoder's "
            f"{len(host)} tensors in pinned host memory")

        ref = os.path.join(root, "ref16k.wav")
        audio_io.save_wav(ref, _clip(3.0, 16000, 5), 16000)
        batch_emb = _check_speaker_encoder(eng, ref, dev, card)
        _check_bits(eng.spk_w, spk_w, dev, "speaker encoder")

        params = TTSParams(max_audio_tokens=CLONE_TOKENS, temperature=0.0,
                           seed=SEED, print_timing=False)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        res = eng.synthesize_with_voice(LOCKSTEP_TEXTS[0], ref, params)
        _check_results([res], eng)
        res_gen = call_split([res])[0]
        embs = list(batch_emb[:len(LOCKSTEP_TEXTS)])
        steps = counters["talker_fused"].launches
        t0 = time.monotonic()
        got = eng.synthesize_batch(LOCKSTEP_TEXTS, embs, params)
        wall = time.monotonic() - t0
        steps = counters["talker_fused"].launches - steps
        _check_results(got, eng)
        log(f"synthesize_with_voice: {res.n_frames} frames, t_encode_ms "
            f"{res.t_encode_ms:.1f}, generate {res_gen:.1f} ms, "
            f"t_total_ms {res.t_total_ms:.1f}; synthesize_batch with "
            f"{len(embs)} cloned voices, greedy: frames "
            f"{[r.n_frames for r in got]}, {wall:.2f} s wall, generate "
            f"{call_split(got)[0] / steps:.2f} ms per lock-step frame "
            f"({steps} frames) on {card}")
        low_got = low.synthesize_batch(LOCKSTEP_TEXTS, embs, params)
        for a, b in zip(got, low_got):
            if not np.array_equal(a.audio, b.audio):
                raise AssertionError("low-memory audio differs")
        log("low-memory engine: the same audio, bitwise, for "
            f"{len(low_got)} cloned voices")
        talker.set_talker_step_impl("xla")
        try:
            xla = eng.synthesize_with_embedding(
                LOCKSTEP_TEXTS[1], embs[1], TTSParams(
                    max_audio_tokens=40, temperature=0.0, seed=SEED,
                    print_timing=False))
        finally:
            talker.set_talker_step_impl(None)
        _check_results([xla], eng)
        del low, low_got

        out = os.path.join(root, "cli.wav")
        base = ["-m", root, "-t", LOCKSTEP_TEXTS[2], "--temperature", "0",
                "--seed", str(SEED), "--max-tokens", "60"]
        if cli.main(base + ["-r", ref, "-o", out]) != 0:
            raise AssertionError("cli -r failed")
        cached = audio_io.load_embedding(ref + ".embd")
        wav, sr = audio_io.load_wav(out)
        if cached is None or cached.shape != (cfg.hidden_size,) or \
                len(wav) % vcfg.samples_per_frame or not len(wav):
            raise AssertionError("cli -r: no .embd cache or a bad WAV")
        if cli.main(base + ["-e", ref + ".embd", "-o", out + "2"]) != 0 or \
                not np.array_equal(audio_io.load_wav(out + "2")[0], wav):
            raise AssertionError("cli -e on the cache gave other audio")
        outs = [os.path.join(root, f"serve{i}.wav") for i in range(3)]
        r_fd, w_fd = os.pipe()
        with os.fdopen(w_fd, "w") as w:
            w.write("".join(f"{t}\t{o}\n"
                            for t, o in zip(LOCKSTEP_TEXTS, outs)))
        stdout, stdin = io.StringIO(), sys.stdin
        try:
            with os.fdopen(r_fd) as sys.stdin, \
                    contextlib.redirect_stdout(stdout):
                rc = cli.main(["-m", root, "--serve", "--continuous",
                               "--batch", "4", "--max-frames", "96",
                               "--temperature", "0", "--seed", str(SEED),
                               "-e", ref + ".embd"])
        finally:
            sys.stdin = stdin
        lines = [l for l in stdout.getvalue().splitlines()
                 if l.startswith(("OK", "ERR"))]
        if rc != 0 or len(lines) != 3 or not all(
                l.startswith("OK\t") for l in lines) or not all(
                os.path.exists(o) for o in outs):
            raise AssertionError(f"cli --serve --continuous: rc {rc}, "
                                 f"{lines}")
        torch.cuda.synchronize()
        ran = {k: fn.launches for k, fn in counters.items()}
        log(f"cli: -r (WAV of {len(wav)} samples, .embd cache of "
            f"{len(cached)} floats), -e on the cache (the same audio), "
            f"--serve --continuous --batch 4 over 3 piped lines: {lines}; "
            f"kernel launches of the clone path {ran}")
        if min(ran.values()) <= 0:
            raise AssertionError(f"the clone path skipped a kernel: {ran}")
        return ran
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the graphs phase (runtime/graphs.py): graph against eager in one process
CHUNK = 40                    # frames a generation chunk (pipeline's)
GRAPH_RUNS = (("auto", 0.0, 1.0), ("xla", 0.0, 1.0), ("auto", 0.9, 0.9))


def _lockstep_once(engine, impl, temperature, top_p, aot, counters, dev):
    """One synthesize_batch of the lock-step texts with QWEN3_TTS_AOT=aot;
    returns (results, generate ms per lock-step frame, launches)."""
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    os.environ["QWEN3_TTS_AOT"] = aot
    talker.set_talker_step_impl(impl)
    for fn in counters.values():
        fn.launches = 0
    try:
        res = engine.synthesize_batch(
            LOCKSTEP_TEXTS, params=TTSParams(
                max_audio_tokens=LOCKSTEP_TOKENS, temperature=temperature,
                top_p=top_p, seed=SEED),
            generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
    finally:
        talker.set_talker_step_impl(None)
        os.environ.pop("QWEN3_TTS_AOT", None)
    ran = {k: fn.launches for k, fn in counters.items()}
    _check_results(res, engine)
    _expect_launches(ran, impl, "synthesize_batch", top_p)
    steps = _talker_steps(ran, engine.talker_cfg, impl)
    return res, call_split(res)[0] / steps, ran


def _design_times(engine, impl, card, dev) -> None:
    """The two capture granularities at B=4, greedy bf16, read_ctx 512:
    one 40-frame chunk graph replayed once, against a one-frame graph
    replayed 40 times (the frame index would then live on the card);
    capture (warm run, capture and instantiate) and replay ms per 40
    frames, beside the eager chunk."""
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.runtime import generate as G
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.utils import trace
    cfg, w = engine.talker_cfg, engine.talker_w
    talker.set_talker_step_impl(impl)
    cache = graphs.GraphCache()
    out = []
    try:
        with torch.inference_mode():
            pf = talker.build_prefill_inputs(
                w, cfg, torch.zeros(4, 16, dtype=torch.int32, device=dev),
                torch.full((4,), 16, dtype=torch.int32, device=dev),
                torch.zeros(4, cfg.hidden_size, device=dev))
            st = G.init_state(w, cfg, pf, 512, None)
            cs = G.make_consts(pf, 0.0, 1.05)
            for frames in (CHUNK, 1, 0):
                G.init_state(w, cfg, pf, 512, None, into=st)
                n = frames or CHUNK

                def chunk(n=n):
                    return G.generate_chunk(w, cfg, st, cs, 50, n,
                                            greedy=True, read_ctx=512)[1:]

                key = f"design-{impl}-{frames}"
                fn = (cache.get_or_capture(key, chunk, dev) if frames
                      else chunk)
                fn()
                reps = CHUNK // n
                ms = cuda_time(lambda: [fn() for _ in range(reps)], 2)
                if frames:
                    cap = [s for s in trace.spans()
                           if s.name == "graphs.capture"][-1].attrs
                    out.append(f"{frames}-frame graph: warm run "
                               f"{cap['warm_us'] / 1e3:.1f} ms, capture and "
                               f"instantiate {cap['capture_us'] / 1e3:.1f} ms,"
                               f" {ms:.2f} ms per {CHUNK} frames replayed")
                else:
                    out.append(f"eager {ms:.2f} ms per {CHUNK} frames")
    finally:
        talker.set_talker_step_impl(None)
    log(f"graph granularity, talker={impl} B=4 greedy bf16 on {card}: "
        + "; ".join(out))


def _serve_traffic(cb) -> tuple[list, int]:
    """serve_run's traffic: 8 requests, 8 more after the second step, 4
    more after the fourth. Returns (results in order, steps)."""
    texts = [SERVE_SHORT, SERVE_LONG] * 10
    rids = [cb.submit(t) for t in texts[:8]]
    results, n_steps = {}, 0
    while cb.pending():
        results.update(cb.step())
        n_steps += 1
        if n_steps in (2, 4):
            rids += [cb.submit(t) for t in texts[
                len(rids):len(rids) + (8 if n_steps == 2 else 4)]]
    return [results[r] for r in rids], n_steps


def graphs_phase(tok, cfg, talker_w, vcfg, voc_w, engine, card, counters,
                 dev) -> dict:
    """CUDA graphs against eager in one process: lock-step generate ms a
    frame (auto bf16 greedy, xla bf16, top_p 0.9) with equal audio; the
    two capture granularities; a fresh engine's 8-slot batcher warmed up
    (seconds, buckets captured, capture time each, the pool's memory)
    and served against an unwarmed eager batcher on the same traffic;
    the profile of a replayed chunk beside an eager one. Returns the
    kernel launches of its graph runs."""
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    from qwen3_tts_tpu_torch.utils import trace
    os.environ["QWEN3_TTS_KV"] = "bf16"
    total = dict.fromkeys(counters, 0)
    per_frame = {}
    for impl, temperature, top_p in GRAPH_RUNS:
        _lockstep_once(engine, impl, temperature, top_p, "1", counters, dev)
        coop0 = kernels.codepred_launches()
        g_res, g_ms, ran = _lockstep_once(engine, impl, temperature, top_p,
                                          "1", counters, dev)
        coop = kernels.codepred_launches() - coop0
        total = {k: total[k] + ran[k] for k in counters}
        e_res, e_ms, _ = _lockstep_once(engine, impl, temperature, top_p, "0",
                                        counters, dev)
        per_frame[impl, temperature, top_p] = {"graph": g_ms, "eager": e_ms}
        same = all(g.n_frames == e.n_frames and np.array_equal(g.audio,
                                                               e.audio)
                   for g, e in zip(g_res, e_res))
        log(f"graphs: synthesize_batch talker={impl} kv=bf16 temperature="
            f"{temperature} top_p={top_p}: generate {g_ms:.2f} ms per "
            f"lock-step frame replayed, {e_ms:.2f} eager (QWEN3_TTS_AOT=0), "
            f"frames {[r.n_frames for r in g_res]}, audio "
            f"{'bitwise equal' if same else 'DIFFERENT'}; code-predictor "
            f"launches {ran['codepred']} (C side {coop}) on {card}")
        if not same:
            raise AssertionError(f"graph and eager audio differ ({impl}, "
                                 f"top_p {top_p})")
        if top_p >= 1.0 and impl == "auto" and coop != ran["codepred"]:
            raise AssertionError("replays did not add the code predictor's "
                                 "launches on the C side")
    for impl in ("auto", "xla"):
        _design_times(engine, impl, card, dev)
    log(f"graphs: the lock-step engine's pool holds "
        f"{engine.graphs.pool_bytes(dev) / 2**20:.1f} MiB of card memory "
        f"({len(engine.graphs.graphs)} graphs)")

    # serving: a fresh engine, so that warmup captures every bucket
    fresh = Qwen3TTS.from_components(tok, cfg, talker_w, vcfg, voc_w, dev)
    params = TTSParams(temperature=0.0, seed=SEED)
    walls = {}
    for mode in ("graph", "eager"):
        os.environ["QWEN3_TTS_AOT"] = "1" if mode == "graph" else "0"
        for fn in counters.values():
            fn.launches = 0
        try:
            cb = ContinuousBatcher(fresh, n_slots=SERVE_SLOTS, params=params,
                                   max_frames=SERVE_MAX_FRAMES)
            reserved0 = torch.cuda.memory_reserved(dev)
            if mode == "graph":
                t_warm = time.monotonic_ns()
                cb.warmup()
                caps = [s for s in trace.spans(t_warm)
                        if s.name == "graphs.capture"]
                log(f"graphs: warmup of an {SERVE_SLOTS}-slot batcher "
                    f"(max_frames {SERVE_MAX_FRAMES}, buckets "
                    f"{cb.warmup_buckets()}): {cb.warmup_s:.2f} s, "
                    f"{len(caps)} graphs captured: " + "; ".join(
                        f"{c.attrs['kind']} warm run "
                        f"{c.attrs['warm_us'] / 1e3:.1f} ms, capture "
                        f"{c.attrs['capture_us'] / 1e3:.1f} ms"
                        for c in caps)
                    + f"; pool {fresh.graphs.pool_bytes(dev) / 2**20:.1f} MiB"
                    f", reserved +{(torch.cuda.memory_reserved(dev) - reserved0) / 2**20:.1f} MiB"
                    f" on {card}")
                n_graphs = len(fresh.graphs.graphs)
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.monotonic()
            res, n_steps = _serve_traffic(cb)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            os.environ.pop("QWEN3_TTS_AOT", None)
        ran = {k: fn.launches for k, fn in counters.items()}
        _check_results(res, fresh)
        _expect_launches(ran, "auto", f"serving ({mode})")
        steps = _talker_steps(ran, cfg, "auto")
        walls[mode] = (res, wall * 1e3 / steps)
        if mode == "graph":
            total = {k: total[k] + ran[k] for k in counters}
            if len(fresh.graphs.graphs) != n_graphs:
                raise AssertionError("serving after warmup captured a bucket")
        log(f"graphs: ContinuousBatcher ({mode}) auto bf16 slots="
            f"{SERVE_SLOTS}: {len(res)} requests, {n_steps} steps, "
            f"{wall:.2f} s wall, {wall * 1e3 / steps:.2f} ms of wall per "
            f"{SERVE_SLOTS}-slot frame ({steps} talker steps) on {card}")
    same = all(g.n_frames == e.n_frames and np.array_equal(g.audio, e.audio)
               for g, e in zip(walls["graph"][0], walls["eager"][0]))
    if not same:
        raise AssertionError("warmed graph serving and eager serving differ")
    log(f"graphs: serving audio bitwise equal, graph / eager "
        f"{walls['graph'][1]:.2f} / {walls['eager'][1]:.2f} ms per frame; "
        f"pool after serving {fresh.graphs.pool_bytes(dev) / 2**20:.1f} MiB")

    busy = {m: profile_lockstep(engine, card, dev, m)
            for m in ("graph", "eager")}
    unprofiled = per_frame["auto", 0.0, 1.0]
    log(f"graphs: profiled busy share, replayed chunk {busy['graph'][0]:.1%},"
        f" eager {busy['eager'][0]:.1%}; without the profiler, its busy "
        f"device ms per frame over the generate ms per frame above: "
        f"replayed {busy['graph'][1] / unprofiled['graph']:.1%}, eager "
        f"{busy['eager'][1] / unprofiled['eager']:.1%} on {card}")
    return total


MESH_B = 4                    # LOCKSTEP_TEXTS
MESH_TOKENS = 80              # frames of the world-size-1 lock-step runs
MESH_TP_FRAMES = 40           # frames of the tp = 2 run (one chunk)


# the vocabulary of the main paths' tokenizer and of the synthetic HF
# checkpoints
SMOKE_TOKENS = ["<|im_start|>", "<|im_end|>", "assistant", "Ċ", "h", "e",
                "l", "o", "Ġ", "w", "r", "d", ".", "he", "ll", "hell",
                "hello", "Ġw", "Ġwo"]
SMOKE_MERGES = ["h e", "l l", "he ll", "hell o", "Ġ w", "Ġw o"]


def smoke_tokenizer():
    """The in-memory tokenizer of the main paths."""
    from qwen3_tts_tpu_torch.config import TokenizerSpecialTokens
    from qwen3_tts_tpu_torch.tokenizer import TextTokenizer
    return TextTokenizer(SMOKE_TOKENS, SMOKE_MERGES, TokenizerSpecialTokens(
        bos_token_id=0, eos_token_id=1, pad_token_id=1))


def _record_frames(out: list, logits: bool):
    """Record each generated frame as (codes [B, 16] with CB0 as sampled,
    EOS included; and with `logits` the CB0 scores [B, codec_vocab] and
    the code predictor's logits [15, B, V] that greedy took the argmax of)
    by wrapping runtime/generate.py's sample_cb0 and
    code_predictor.predict_codes, for eager runs. Returns the undo."""
    from qwen3_tts_tpu_torch.models import code_predictor as cp
    from qwen3_tts_tpu_torch.runtime import generate as G
    orig_cb0, orig_pred = G.sample_cb0, cp.predict_codes
    last = {}

    def sample_cb0(raw, *args, **kw):
        if logits:
            kw["scores_out"] = last["scores"] = torch.empty_like(raw)
        last["cb0"] = orig_cb0(raw, *args, **kw)
        return last["cb0"]

    def predict_codes(w, cfg, hidden, cb0, *args, **kw):
        lg = None
        if logits:
            kw["logits_out"] = lg = torch.empty(
                cfg.n_codebooks - 1, hidden.shape[0], cfg.code_pred_vocab_size,
                device=hidden.device)
        rest = orig_pred(w, cfg, hidden, cb0, *args, **kw)
        out.append((torch.cat([last["cb0"][:, None], rest], 1),
                    last.get("scores"), lg))
        return rest

    G.sample_cb0, cp.predict_codes = sample_cb0, predict_codes

    def undo():
        G.sample_cb0, cp.predict_codes = orig_cb0, orig_pred
    return undo


def _near_tie_gaps(got, ref, ref_frames, n_frames):
    """Per stream whose codes differ within its frames (up to its EOS
    frame): the reference's score margin between its own code and the
    other run's at the first differing frame and position, where every
    earlier code agreed (``_divergence_gaps`` at the frame level)."""
    gaps = []
    for b in range(got.shape[1]):
        upto = min(n_frames[b] + 1, got.shape[0], ref.shape[0])
        diff = torch.nonzero(got[:upto, b] != ref[:upto, b])
        if not len(diff):
            continue
        f, p = (int(x) for x in diff[0])
        _, scores, cp_logits = ref_frames[f]
        lg = scores[b] if p == 0 else cp_logits[p - 1, b]
        r, g = int(ref[f, b, p]), int(got[f, b, p])
        gaps.append((b, f, p, float(lg[r] - lg[g])))
    return gaps


def _mesh_tp_child(rank: int, store: str, out: str) -> None:
    """One of two ranks sharing card 0, tp = 2 over gloo: the main path's
    full-width weights (the same draws from SEED), sharded; one greedy
    synthesize_batch of the lock-step texts, MESH_TP_FRAMES frames,
    eager. Rank 0 saves the frames' codes, the results, ms a frame and
    the kernel launches."""
    import torch.distributed as dist
    from qwen3_tts_tpu_torch.config import TalkerConfig, VocoderConfig
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.parallel import make_mesh
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=600))
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cfg, vcfg = TalkerConfig(), VocoderConfig()
        talker_w = W.init_talker_weights(cfg, gen, dev)
        voc_w = W.init_vocoder_weights(vcfg, gen, dev)
        engine = Qwen3TTS.from_components(
            smoke_tokenizer(), cfg, talker_w, vcfg, voc_w,
            dev).shard(make_mesh(1, 2, "cuda"))
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        frames = []
        undo = _record_frames(frames, logits=False)
        try:
            res = engine.synthesize_batch(LOCKSTEP_TEXTS, params=TTSParams(
                max_audio_tokens=MESH_TP_FRAMES, temperature=0.0, seed=SEED,
                print_timing=False))
            torch.cuda.synchronize()
        finally:
            undo()
        if rank == 0:
            torch.save(dict(
                codes=torch.stack([f[0] for f in frames]).cpu(),
                n_frames=[r.n_frames for r in res],
                audio=[r.audio for r in res],
                ok=[r.success and bool(np.isfinite(r.audio).all())
                    for r in res],
                ms=call_split(res)[0] / len(frames),
                launches={k: fn.launches for k, fn in counters.items()}),
                out)
    finally:
        dist.destroy_process_group()


# --- pipelined lock-step, the A.19 switches, a vocoder-less engine -----------
PIPE_B = (4, 64)              # the multi-chunk profile's batches
PIPE_GAPS = 3                 # the longest idle gaps shown, each profile
SIN2_BLOCK = 0                # the exact-mode check's decoder block (B = 2)


def _merged(events) -> list:
    """The union of (name, start, end) intervals as sorted [start, end]."""
    out: list = []
    for _, start, end in sorted(events, key=lambda e: e[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _host_ops(prof) -> list:
    """(name, start us, end us) of the profiler's host-side events: aten
    operators and CUDA runtime calls."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def _idle_gaps(kernels, host, n: int) -> list:
    """The n longest gaps between the card's busy intervals, longest
    first: (gap us, its start in us after the first kernel's, the host
    operation that spanned it, the share of the gap it covers). The
    spanning operation is the shortest host event that covers at least
    half of the gap (the innermost), else the one covering the most of
    it."""
    busy = _merged(kernels)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:n]
    out = []
    for us, g0, g1 in gaps:
        cover = [(min(g1, e) - max(g0, s), e - s, name)
                 for name, s, e in host if s < g1 and e > g0]
        inner = [c for c in cover if c[0] >= us / 2]
        best = (min(inner, key=lambda c: c[1]) if inner
                else max(cover, default=(0.0, 0.0, "(no host event)")))
        out.append((us, g0 - busy[0][0], best[2], best[0] / us if us else 0.0))
    return out


def profile_pipelined(engine, card, dev, B: int, counters) -> dict:
    """A multi-chunk lock-step run (LOCKSTEP_TOKENS = 3 chunks of the
    lock-step texts repeated to B streams, greedy, bf16, auto, CUDA
    graphs): a warm call, an unprofiled call (generate ms a lock-step
    frame, wall) and one under torch.profiler: the card's busy share of
    the wall, and its PIPE_GAPS longest idle gaps with the host operation
    that spanned each. One code-predictor and one talker launch a frame.
    Returns the unprofiled call's kernel launches."""
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    os.environ["QWEN3_TTS_KV"] = "bf16"
    texts = (LOCKSTEP_TEXTS * B)[:B]
    params = TTSParams(max_audio_tokens=LOCKSTEP_TOKENS, temperature=0.0,
                       seed=SEED)
    engine.synthesize_batch(texts, params=params)          # warm
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = engine.synthesize_batch(texts, params=params)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3
    ran = {k: fn.launches for k, fn in counters.items()}
    _check_results(res, engine)
    _expect_launches(ran, "auto", f"pipelined B={B}")
    steps = ran["talker_fused"]
    gen_ms, dec_ms = call_split(res)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        t0 = time.monotonic()
        pres = engine.synthesize_batch(texts, params=params)
        torch.cuda.synchronize()
        pwall = (time.monotonic() - t0) * 1e3
        time.sleep(PROFILER_PAD_S)
    events = _kernel_events(prof)
    busy = sum(e - s for s, e in _merged(events))
    n_cp = sum("codepred_frame_kernel" in e[0] for e in events)
    n_tf = sum("talker_step_kernel" in e[0] for e in events)
    gaps = _idle_gaps(events, _host_ops(prof), PIPE_GAPS)
    frames = [r.n_frames for r in res]
    log(f"pipelined: synthesize_batch B={B} auto bf16 greedy, "
        f"{LOCKSTEP_TOKENS} frames cap, {steps} lock-step frames "
        f"({steps // CHUNK} chunks), stream frames {min(frames)}-"
        f"{max(frames)}; unprofiled: generate {gen_ms:.1f} ms "
        f"= {gen_ms / steps:.3f} ms per lock-step frame, decode "
        f"{dec_ms:.1f} ms, wall {wall:.1f} ms; profiled: wall "
        f"{pwall:.1f} ms, card busy {busy / 1e3:.1f} ms = "
        f"{busy / 1e3 / pwall:.1%} of the wall (idle {1 - busy / 1e3 / pwall:.1%}; busy over the "
        f"unprofiled wall {busy / 1e3 / wall:.1%}); code predictor {n_cp}, "
        f"talker {n_tf} launches on {card}")
    span = (max(e for _, _, e in events) - min(s for _, s, _ in events)) / 1e3
    for us, at, name, share in gaps:
        log(f"  idle gap {us / 1e3:.3f} ms at {at / 1e3:.1f} of the "
            f"{span:.1f} ms from the first kernel to the last, spanned by "
            f"host op {name!r} ({share:.0%} of the gap)")
    if not (n_cp == n_tf == steps and steps % CHUNK == 0
            and steps >= max(frames) and _same(res, pres)):
        raise AssertionError(f"B={B}: {steps} frames run, code predictor "
                             f"{n_cp} and talker {n_tf} launches profiled; "
                             f"profiled audio as unprofiled: "
                             f"{_same(res, pres)}")
    return ran


def attention_switch_runs(engine, card, counters, dev) -> dict:
    """set_decode_attention_impl on the main paths under
    QWEN3_TTS_TALKER=xla (whose per-layer step reaches decode attention):
    one lock-step synthesize_batch (40 frames) and one ContinuousBatcher
    run (8 slots, 8 requests) for each of auto, xla and flash. xla makes
    no decode-attention launch, flash as many as auto; auto's frames are
    flash's (the same kernels). Then xla and flash again, eagerly, each
    frame recorded (xla's with the scores its greedy argmax read): each
    run's frames are its graph run's, and flash's codes xla's up to each
    stream's first divergence, which must be a near-tie of xla's scores
    (margin <= LOGIT_TOL): attention that rounds otherwise may part there
    and end a stream at another frame. Returns the launches of the
    three."""
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.ops import attention
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    os.environ["QWEN3_TTS_KV"] = "bf16"
    total = dict.fromkeys(counters, 0)
    attn, frames, rec = {}, {}, {}

    def lockstep():
        return engine.synthesize_batch(LOCKSTEP_TEXTS, params=TTSParams(
            max_audio_tokens=CHUNK, temperature=0.0, seed=SEED))

    def serving():
        cb = ContinuousBatcher(engine, n_slots=SERVE_SLOTS,
                               params=TTSParams(temperature=0.0, seed=SEED),
                               max_frames=48)
        rids = [cb.submit(t) for t in [SERVE_SHORT, SERVE_LONG] * 4]
        out = cb.run_all()
        return [out[r] for r in rids]  # request j in slot j

    talker.set_talker_step_impl("xla")
    try:
        for impl in ("auto", "xla", "flash"):
            attention.set_decode_attention_impl(impl)
            for fn in counters.values():
                fn.launches = 0
            res = lockstep()
            served = serving()
            torch.cuda.synchronize()
            _check_results(res + served, engine)
            ran = {k: fn.launches for k, fn in counters.items()}
            total = {k: total[k] + ran[k] for k in counters}
            attn[impl] = ran["flash_decode"]
            frames[impl] = [r.n_frames for r in res + served]
            log(f"decode-attention switch {impl}: lock-step (talker xla, B=4,"
                f" {CHUNK} frames) and serving (8 requests): kernel launches "
                f"{ran}")
        os.environ["QWEN3_TTS_AOT"] = "0"
        for impl in ("xla", "flash"):
            attention.set_decode_attention_impl(impl)
            rec[impl] = []
            for run in (lockstep, serving):
                got = []
                undo = _record_frames(got, logits=impl == "xla")
                try:
                    res = run()
                    torch.cuda.synchronize()
                finally:
                    undo()
                rec[impl].append((torch.stack([f[0] for f in got]), got,
                                  [r.n_frames for r in res]))
    finally:
        os.environ.pop("QWEN3_TTS_AOT", None)
        talker.set_talker_step_impl(None)
        attention.set_decode_attention_impl(None)
    if not (attn["xla"] == 0 and attn["flash"] == attn["auto"] > 0):
        raise AssertionError(f"decode-attention launches by switch: {attn}")
    if frames["auto"] != frames["flash"]:
        raise AssertionError(f"frames by switch: {frames}")
    eager = {k: [n for *_, fr in v for n in fr] for k, v in rec.items()}
    gaps = [g for (got, _, n_got), (ref, ref_frames, n_ref) in
            zip(rec["flash"], rec["xla"])
            for g in _near_tie_gaps(got, ref, ref_frames,
                                    [max(a, b) for a, b in zip(n_got, n_ref)])]
    log(f"decode-attention switch frames: {frames}; eager recorded runs "
        f"{eager}; flash's first divergences from xla (stream of the "
        f"lock-step run, then of the batcher; frame, codebook, xla's margin) "
        f"{[(b, f, p, round(g, 4)) for b, f, p, g in gaps]} (need each <= "
        f"{LOGIT_TOL})")
    if (any(eager[k] != frames[k] for k in eager)
            or any(g > LOGIT_TOL for *_, g in gaps)):
        raise AssertionError("decode attention xla against flash: frames "
                             "unlike the graph runs' or a divergence beyond "
                             "a near-tie")
    return total


def check_exact_sin2(blocks, card, dev, gen) -> dict:
    """set_snake_sin2_impl("exact") on the kernels: the residual chain and
    the Snake + convT head at block SIN2_BLOCK's shape, B = VOC_B, against
    their twins in the same mode (the fast mode's tolerances), two calls
    bitwise equal; then the 4 blocks of a chunk at B = VOC_B timed in both
    modes, in turns fast, exact, exact, fast (CUDA events and the
    profiler's device ms). Returns, per kernel, the exact mode's ms."""
    from qwen3_tts_tpu_torch.ops import vocoder_fused as vf
    blk = blocks[SIN2_BLOCK]
    c, t = CHAIN_SHAPES[SIN2_BLOCK]
    hc, _, rate, ht = HEAD_SHAPES[SIN2_BLOCK]
    xc = torch.randn(VOC_B, t, c, generator=gen, device=dev)
    xh = torch.randn(VOC_B, ht, hc, generator=gen, device=dev)
    pairs = {"res_chain": (lambda: vf.fused_residual_chain(xc, blk),
                           lambda: vf.residual_chain_twin(xc, blk)),
             "snake_convt": (lambda: vf.fused_snake_convt(xh, blk, rate),
                             lambda: vf.snake_convt_twin(xh, blk, rate))}
    vf.set_snake_sin2_impl("exact")
    try:
        for name, (kern, twin) in pairs.items():
            got, again, ref = kern(), kern(), twin()
            _, e_max, e_rms = _rms_check(f"{name} exact sin^2", got, ref,
                                         f"B={VOC_B} block {SIN2_BLOCK}")
            if not (torch.equal(got, again) and e_max <= VOC_MAX_TOL
                    and e_rms <= VOC_RMS_TOL):
                raise AssertionError(f"{name} in the exact mode: bitwise "
                                     f"{torch.equal(got, again)}, {e_max}, "
                                     f"{e_rms}")
    finally:
        vf.set_snake_sin2_impl("fast")
    xs = [torch.randn(VOC_B, t, c, generator=gen, device=dev)
          for c, t in CHAIN_SHAPES]
    hs = [torch.randn(VOC_B, t, c, generator=gen, device=dev)
          for c, _, _, t in HEAD_SHAPES]
    calls = {"res_chain": (lambda: [vf.fused_residual_chain(x, b) for x, b
                                    in zip(xs, blocks)], RES_CHAIN_KERNELS),
             "snake_convt": (lambda: [vf.fused_snake_convt(x, b, r) for
                                      x, b, (*_, r, _) in zip(hs, blocks,
                                                              HEAD_SHAPES)],
                             HEAD_KERNELS)}
    times = {name: {"fast": [], "exact": []} for name in calls}
    try:
        for mode in ("fast", "exact", "exact", "fast"):
            vf.set_snake_sin2_impl(mode)
            for name, (fn, names) in calls.items():
                times[name][mode].append((cuda_time(fn, iters=5),
                                          device_ms(fn, 3, names)))
    finally:
        vf.set_snake_sin2_impl("fast")
    out = {}
    for name, by in times.items():
        txt = "; ".join(f"{m} " + ", ".join(f"{a:.3f} (device {b:.3f})"
                                            for a, b in v)
                        for m, v in by.items())
        log(f"{name}, 4 decoder blocks at B={VOC_B}, ms by sin^2 mode: {txt}"
            f" on {card}")
        out[name] = {"exact_ms": min(a for a, _ in by["exact"]),
                     "exact_device_ms": min(b for _, b in by["exact"]),
                     "fast_ms_again": min(a for a, _ in by["fast"])}
    return out


def vocoderless_runs(tok, cfg, talker_w, engine, card, counters,
                     dev) -> dict:
    """An engine made with from_components(..., voc_cfg=None, voc_w=None)
    (the JAX package's semantics): synthesize_batch generates the full
    engine's frames and reports "Vocoder not loaded" with no audio; a
    warmed ContinuousBatcher serves the full engine's frames with no
    audio at 24000 Hz; no vocoder kernel launches. Returns the
    launches."""
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    os.environ["QWEN3_TTS_KV"] = "bf16"
    bare = Qwen3TTS.from_components(tok, cfg, talker_w, None, None, dev)
    params = TTSParams(max_audio_tokens=LOCKSTEP_TOKENS, temperature=0.0,
                       seed=SEED)
    serve_texts = [SERVE_SHORT, SERVE_LONG] * 4
    runs, ran = {}, {}
    for name, eng in (("full", engine), ("bare", bare)):
        for fn in counters.values():
            fn.launches = 0
        res = eng.synthesize_batch(LOCKSTEP_TEXTS, params=params)
        cb = ContinuousBatcher(eng, n_slots=SERVE_SLOTS, params=TTSParams(
            temperature=0.0, seed=SEED), max_frames=48)
        if name == "bare":
            cb.warmup()
        rids = [cb.submit(t) for t in serve_texts]
        out = cb.run_all()
        torch.cuda.synchronize()
        runs[name] = (res, [out[r] for r in rids])
        ran[name] = {k: fn.launches for k, fn in counters.items()}
    (f_res, f_srv), (b_res, b_srv) = runs["full"], runs["bare"]
    total = {k: ran["full"][k] + ran["bare"][k] for k in counters}
    ok = (all(b.n_frames == f.n_frames > 0 and not b.success
              and b.error_msg == "Vocoder not loaded" and len(b.audio) == 0
              for b, f in zip(b_res, f_res))
          and all(b.n_frames == f.n_frames > 0 and b.success
                  and len(b.audio) == 0 and b.sample_rate == 24000
                  for b, f in zip(b_srv, f_srv))
          and ran["bare"]["res_chain"] == ran["bare"]["snake_convt"] == 0)
    log(f"vocoder-less engine: synthesize_batch frames "
        f"{[r.n_frames for r in b_res]} (full engine "
        f"{[r.n_frames for r in f_res]}), messages "
        f"{sorted({r.error_msg for r in b_res})}; warmed ContinuousBatcher "
        f"frames {[r.n_frames for r in b_srv]} (full "
        f"{[r.n_frames for r in f_srv]}), success "
        f"{all(r.success for r in b_srv)}, rates "
        f"{sorted({r.sample_rate for r in b_srv})}; launches {ran['bare']}")
    if not ok:
        raise AssertionError("the vocoder-less engine broke the JAX "
                             "package's semantics")
    return total


def traced_runs(tok, cfg, talker_w, vcfg, voc_w, dev) -> None:
    """res_chain_impl_traced on the card: a fresh engine's first decode
    captures its vocoder graphs through the kernels' wrappers ("fused");
    after a reset the same call only replays them ("untraced")."""
    from qwen3_tts_tpu_torch.models import vocoder
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
    fresh = Qwen3TTS.from_components(tok, cfg, talker_w, vcfg, voc_w, dev)
    params = TTSParams(max_audio_tokens=CHUNK, temperature=0.0, seed=SEED)
    readings = []
    for _ in range(2):
        vocoder.reset_res_chain_traced()
        fresh.synthesize_batch(LOCKSTEP_TEXTS, params=params)
        readings.append(vocoder.res_chain_impl_traced())
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    log(f"res_chain_impl_traced: first decode {readings[0]!r}, after a "
        f"reset and replays only {readings[1]!r}")
    if readings != ["fused", "untraced"]:
        raise AssertionError(f"res_chain_impl_traced read {readings}")


def pipelined_phase(tok, cfg, talker_w, vcfg, voc_w, engine, card, counters,
                    dev) -> dict:
    """The pipelined lock-step loop profiled over 3 chunks at B 4 and 64,
    the decode-attention switch, a vocoder-less engine and
    res_chain_impl_traced (module docstring, item 8). Returns the kernel
    launches of its main-path runs."""
    t0 = time.monotonic()
    total = dict.fromkeys(counters, 0)
    for B in PIPE_B:
        ran = profile_pipelined(engine, card, dev, B, counters)
        total = {k: total[k] + ran[k] for k in counters}
    for ran in (attention_switch_runs(engine, card, counters, dev),
                vocoderless_runs(tok, cfg, talker_w, engine, card, counters,
                                 dev)):
        total = {k: total[k] + ran[k] for k in counters}
    traced_runs(tok, cfg, talker_w, vcfg, voc_w, dev)
    log(f"pipelined phase: {time.monotonic() - t0:.1f} s")
    return total


BENCH_LADDER = "192:int8:stacked,192:bf16:stacked"
BENCH_SERVE = ("--slots", "16", "--requests", "24", "--frames", "120")
BENCH_BREAKDOWN = ((16, None), (192, None), (16, "xla"))


def bench_phase(cfg, talker_w, vcfg, voc_w, card, counters, dev) -> dict:
    """The measurement programs of qwen3_tts_tpu_torch/tools in process on
    the smoke's weights (module docstring, item 10): every record line
    parses, no request fails, the vocoder ran its kernels. Returns the
    kernel launches of their runs."""
    import io
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.tools import bench, bench_breakdown, bench_serve
    t0 = time.monotonic()
    for fn in counters.values():
        fn.launches = 0
    weights, out = (cfg, talker_w, vcfg, voc_w), io.StringIO()
    bench.run(bench.parse_args(["--ladder", BENCH_LADDER, "--chunks", "1",
                                "--runs", "1"]), weights, dev, out)
    n_bench = len(out.getvalue().splitlines())
    rc = bench_serve.run(bench_serve.parse_args(list(BENCH_SERVE)), weights,
                         dev, out)
    for B, impl in BENCH_BREAKDOWN:
        talker.set_talker_step_impl(impl)
        try:
            bench_breakdown.run(bench_breakdown.parse_args(
                ["--batch", str(B)]), weights, dev, out)
        finally:
            talker.set_talker_step_impl(None)
    torch.cuda.synchronize()
    ran = {k: fn.launches for k, fn in counters.items()}
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"bench record: {line}")
    recs = [json.loads(line) for line in lines]    # every line parses
    ladder, serve, breakdown = (recs[:n_bench], recs[n_bench],
                                recs[n_bench + 1:])
    if rc != 0 or "error" in serve:
        raise AssertionError(f"bench_serve: a request failed (rc {rc}): "
                             f"{serve}")
    if [(r["kv"], r["voc_impl"]) for r in ladder] != [
            ("int8", "fused"), ("bf16", "fused")]:
        raise AssertionError(f"bench ladder records: {ladder}")
    numbers = [r[k] for r in ladder for k in ("value", "gen_ms_per_frame",
                                              "voc_ms_per_frame",
                                              "total_ms_per_frame")]
    numbers += [serve[k] for k in ("value", "ttfa_p50_ms", "ttfa_p99_ms")]
    numbers += [r[k] for r in breakdown for k in (
        "talker_step_ms", "talker_step_device_ms", "sum_of_stages_ms",
        "frame_graph_ms", "frame_graph_device_ms")]
    if not all(np.isfinite(x) and x > 0 for x in numbers):
        raise AssertionError(f"a bench number is not finite and positive: "
                             f"{numbers}")
    if [r["talker_impl"] for r in breakdown] != ["auto", "auto", "xla"]:
        raise AssertionError(f"breakdown talker impls: {breakdown}")
    if min(ran.values()) <= 0:
        raise AssertionError(f"bench phase: a kernel never launched: {ran}")
    log(f"bench phase on {card}: {time.monotonic() - t0:.1f} s wall; "
        f"kernel launches {ran}")
    gc.collect()
    torch.cuda.empty_cache()
    return ran


def omni_phase(tok, card, counters, dev) -> dict:
    """Qwen3-Omni's speech stage at its widths on the normal paths (module
    docstring, item 11): the 20-layer MoE talker (16 / 2 heads, 128
    experts of 384, top-6, shared 768), the code predictor and Code2Wav,
    random weights. ``synthesize_batch`` at B 8 (T 0.9, 80 frames) and an
    8-slot ``ContinuousBatcher`` on 12 requests (4 submitted mid-run).
    Every request succeeds with n_frames * 1920 finite samples; the MoE
    kernel, flash-decode at G = 8 (prefix in lock-step, window in
    serving), the code predictor and the vocoder kernels launch on both
    paths, and the megakernel never does. Returns the launches."""
    from qwen3_tts_tpu_torch.config import (Code2WavConfig, MoEConfig,
                                            TalkerConfig, VocoderConfig)
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.ops import moe as M
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    os.environ["QWEN3_TTS_KV"] = "bf16"
    t_phase = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    cfg = TalkerConfig(n_key_value_heads=2, n_layers=20)
    vcfg = VocoderConfig(codebook_dim=1024, latent_dim=1024, hidden_dim=1024)
    engine = Qwen3TTS.from_components(
        tok, cfg, W.init_talker_weights(cfg, gen, dev, moe=MoEConfig()),
        vcfg, W.init_code2wav_weights(vcfg, gen, dev, Code2WavConfig()), dev)
    counters = {**counters, "moe": M.moe_ffn}
    total = dict.fromkeys(counters, 0)
    texts = [SERVE_SHORT, SERVE_LONG] * 6
    for what in ("lockstep", "serving"):
        for fn in counters.values():
            fn.launches = 0
        fd.flash_decode.launches_by_mode.update(prefix=0, mask=0, window=0)
        t0 = time.monotonic()
        if what == "lockstep":
            res = engine.synthesize_batch(texts[:OMNI_B], params=TTSParams(
                max_audio_tokens=OMNI_FRAMES, temperature=0.9, seed=SEED,
                print_timing=False))
        else:
            cb = ContinuousBatcher(engine, n_slots=OMNI_B, params=TTSParams(
                temperature=0.9, seed=SEED), max_frames=OMNI_FRAMES)
            rids = [cb.submit(t) for t in texts[:8]]
            out, n_steps = {}, 0
            while cb.pending():
                out.update(cb.step())
                n_steps += 1
                if n_steps == 2:
                    rids += [cb.submit(t) for t in texts[8:]]
            res = [out[r] for r in rids]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        _check_results(res, engine)
        ran = {k: fn.launches for k, fn in counters.items()}
        modes = dict(fd.flash_decode.launches_by_mode)
        mode = "prefix" if what == "lockstep" else "window"
        if (min(ran["moe"], ran["codepred"], ran["res_chain"],
                ran["snake_convt"], modes[mode]) <= 0
                or ran["talker_fused"] != 0):
            raise AssertionError(f"omni {what}: launches {ran}, "
                                 f"flash_decode by mode {modes}")
        total = {k: total[k] + ran[k] for k in counters}
        frames = [r.n_frames for r in res]
        log(f"omni {what} ({len(res)} requests, 20-layer MoE talker, "
            f"Code2Wav): frames {frames}, {sum(frames)} frames, "
            f"{sum(len(r.audio) for r in res) / 24000:.2f} s of audio in "
            f"{wall:.2f} s wall; launches {ran}, flash_decode by mode "
            f"{modes}")
    del engine
    torch.cuda.empty_cache()
    log(f"omni phase: {time.monotonic() - t_phase:.1f} s")
    return total


def longcat_phase(tok, card, counters, dev) -> dict:
    """LongCat-Flash-Omni's backbone block as a talker at its widths on the
    normal paths: 2 double layers (MLA over the latent cache, the dense
    SwiGLUs, the shortcut MoE of 512 + 256 identity experts with 16 held),
    the code predictor behind its 6144 -> 1024 mtp rows, the 12 Hz
    vocoder, random weights. ``synthesize_batch`` at B 8 (T 0.9, 80
    frames) and an 8-slot ``ContinuousBatcher`` on 12 requests (4
    submitted mid-run). Every request succeeds with n_frames * 1920 finite
    samples; the MLA and MoE kernels, the code predictor and the vocoder
    kernels launch on both paths, the megakernel and flash-decode never;
    each chunk's talker.moe span counts identity and remote pairs.
    Returns the launches."""
    from qwen3_tts_tpu_torch.config import (MLAConfig, TalkerConfig,
                                            VocoderConfig)
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.ops import mla as A
    from qwen3_tts_tpu_torch.ops import moe as M
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    from qwen3_tts_tpu_torch.utils import trace
    os.environ["QWEN3_TTS_KV"] = "bf16"
    t_phase = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    cfg = TalkerConfig(hidden_size=6144, n_layers=2, n_attention_heads=64,
                       intermediate_size=12288)
    moe, mla = _moe_ep_layer(dev, gen)[0], MLAConfig()
    vcfg = VocoderConfig()
    engine = Qwen3TTS.from_components(
        tok, cfg, W.init_talker_weights(cfg, gen, dev, moe=moe, mla=mla),
        vcfg, W.init_vocoder_weights(vcfg, gen, dev), dev, moe=moe, mla=mla)
    counters = {**counters, "moe": M.moe_ffn, "mla": A.mla_decode}
    total = dict.fromkeys(counters, 0)
    texts = [SERVE_SHORT, SERVE_LONG] * 6
    for what in ("lockstep", "serving"):
        for fn in counters.values():
            fn.launches = 0
        trace.reset()
        t0 = time.monotonic()
        if what == "lockstep":
            res = engine.synthesize_batch(texts[:LONGCAT_B], params=TTSParams(
                max_audio_tokens=LONGCAT_FRAMES, temperature=0.9, seed=SEED,
                print_timing=False))
        else:
            cb = ContinuousBatcher(engine, n_slots=LONGCAT_B,
                                   params=TTSParams(temperature=0.9,
                                                    seed=SEED),
                                   max_frames=LONGCAT_FRAMES)
            rids = [cb.submit(t) for t in texts[:8]]
            out, n_steps = {}, 0
            while cb.pending():
                out.update(cb.step())
                n_steps += 1
                if n_steps == 2:
                    rids += [cb.submit(t) for t in texts[8:]]
            res = [out[r] for r in rids]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        _check_results(res, engine)
        ran = {k: fn.launches for k, fn in counters.items()}
        spans = [sp.attrs for sp in trace.spans() if sp.name == "talker.moe"]
        if (min(ran["moe"], ran["mla"], ran["codepred"], ran["res_chain"],
                ran["snake_convt"]) <= 0 or ran["talker_fused"] != 0
                or ran["flash_decode"] != 0 or not spans
                or not all("zero" in a and "remote" in a for a in spans)):
            raise AssertionError(f"longcat {what}: launches {ran}, spans "
                                 f"{spans[:2]}")
        pairs = sum(a["pairs"] + a["zero"] + a["remote"] for a in spans)
        total = {k: total[k] + ran[k] for k in counters}
        frames = [r.n_frames for r in res]
        log(f"longcat {what} ({len(res)} requests, 2 double layers, 16 of "
            f"512 experts): frames {frames}, {sum(frames)} frames, "
            f"{sum(len(r.audio) for r in res) / 24000:.2f} s of audio in "
            f"{wall:.2f} s wall; launches {ran}; identity share "
            f"{sum(a['zero'] for a in spans) / max(pairs, 1):.3f}, remote "
            f"share {sum(a['remote'] for a in spans) / max(pairs, 1):.3f}")
    del engine
    torch.cuda.empty_cache()
    log(f"longcat phase: {time.monotonic() - t_phase:.1f} s")
    return total


def _counters() -> dict:
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    from qwen3_tts_tpu_torch.ops import vocoder_fused as vf
    return {"codepred": cf.predict_codes_fused,
            "res_chain": vf.fused_residual_chain,
            "snake_convt": vf.fused_snake_convt,
            "flash_decode": fd.flash_decode,
            "talker_fused": tf.talker_step_fused}


def _same(a, b) -> bool:
    return all(x.n_frames == y.n_frames and np.array_equal(x.audio, y.audio)
               for x, y in zip(a, b))


def mesh_phase(tok, cfg, talker_w, vcfg, voc_w, engine, card, counters,
               dev) -> dict:
    """parallel/mesh.py on the card (module docstring, item 9). Returns
    the kernel launches of the sharded runs (the tp = 2 ranks' counted
    once, rank 0's)."""
    import torch.distributed as dist
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.parallel import dryrun_multichip, make_mesh
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    os.environ["QWEN3_TTS_KV"] = "bf16"
    total = dict.fromkeys(counters, 0)
    tmp = tempfile.mkdtemp()
    t_phase = time.monotonic()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        sharded = Qwen3TTS.from_components(tok, cfg, talker_w, vcfg, voc_w,
                                           dev).shard(make_mesh(1, 1, "cuda"))
        for temperature in (0.0, 0.9):
            runs = {"unsharded": [], "sharded": []}
            # the first run of each engine captures its graphs
            for name in ("unsharded", "sharded", "sharded", "unsharded",
                         "unsharded", "sharded"):
                eng = sharded if name == "sharded" else engine
                for fn in counters.values():
                    fn.launches = 0
                res = eng.synthesize_batch(
                    LOCKSTEP_TEXTS, params=TTSParams(
                        max_audio_tokens=MESH_TOKENS, temperature=temperature,
                        seed=SEED, print_timing=False),
                    generator=torch.Generator(device=dev).manual_seed(SEED))
                torch.cuda.synchronize()
                ran = {k: fn.launches for k, fn in counters.items()}
                _check_results(res, eng)
                _expect_launches(ran, "auto", f"mesh synthesize_batch {name}")
                if name == "sharded":
                    total = {k: total[k] + ran[k] for k in counters}
                runs[name].append((res, call_split(res)[0]
                                   / ran["talker_fused"]))
            same = all(_same(r, runs["unsharded"][0][0])
                       for r, _ in runs["unsharded"] + runs["sharded"])
            ms = {k: [round(m, 3) for _, m in v[1:]] for k, v in runs.items()}
            log(f"mesh: synthesize_batch world size 1 (NCCL, mesh 1x1) "
                f"auto bf16 B={MESH_B} temperature={temperature}: frames "
                f"{[r.n_frames for r in runs['sharded'][0][0]]}, sharded "
                f"audio {'bitwise equal' if same else 'DIFFERENT'} to the "
                f"unsharded engine's; generate ms per lock-step frame "
                f"(warm runs) sharded {ms['sharded']}, unsharded "
                f"{ms['unsharded']} on {card}")
            if not same:
                raise AssertionError(f"sharded synthesize_batch differs at "
                                     f"temperature {temperature}")
        served = {}
        for name, eng in (("unsharded", engine), ("sharded", sharded)):
            cb = ContinuousBatcher(eng, n_slots=SERVE_SLOTS,
                                   params=TTSParams(temperature=0.0,
                                                    seed=SEED),
                                   max_frames=SERVE_MAX_FRAMES)
            cb.warmup()
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.monotonic()
            res, n_steps = _serve_traffic(cb)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            ran = {k: fn.launches for k, fn in counters.items()}
            _check_results(res, eng)
            _expect_launches(ran, "auto", f"mesh serving {name}")
            if name == "sharded":
                total = {k: total[k] + ran[k] for k in counters}
            served[name] = (res, wall * 1e3 / ran["talker_fused"])
        same = _same(served["sharded"][0], served["unsharded"][0])
        log(f"mesh: ContinuousBatcher {SERVE_SLOTS} slots after warmup(), "
            f"{len(served['sharded'][0])} requests: sharded (mesh 1x1) "
            f"{'bitwise equal' if same else 'DIFFERENT'} to unsharded; ms "
            f"of wall per {SERVE_SLOTS}-slot frame sharded "
            f"{served['sharded'][1]:.3f}, unsharded "
            f"{served['unsharded'][1]:.3f} on {card}")
        if not same:
            raise AssertionError("the sharded batcher differs")
        if min(total["codepred"], total["talker_fused"]) <= 0:
            raise AssertionError(f"mesh runs launched {total}")
        del sharded
        t0 = time.monotonic()
        dryrun_multichip(1, "cuda")
        log(f"mesh: dryrun_multichip(1, 'cuda') in "
            f"{time.monotonic() - t0:.1f} s")
    finally:
        dist.destroy_process_group()

    # tp = 2: two ranks on this card over gloo, against the unsharded xla
    # run here, recorded with the scores its greedy argmax read
    t0 = time.monotonic()
    out = os.path.join(tmp, "tp.pt")
    torch.multiprocessing.spawn(_mesh_tp_child,
                                args=(os.path.join(tmp, "gloo"), out),
                                nprocs=2, join=True)
    tp = torch.load(out, weights_only=False)
    t_tp = time.monotonic() - t0
    ref_frames = []
    os.environ["QWEN3_TTS_AOT"] = "0"
    talker.set_talker_step_impl("xla")
    undo = _record_frames(ref_frames, logits=True)
    try:
        ref = engine.synthesize_batch(LOCKSTEP_TEXTS, params=TTSParams(
            max_audio_tokens=MESH_TP_FRAMES, temperature=0.0, seed=SEED,
            print_timing=False))
        torch.cuda.synchronize()
        ref_ms = call_split(ref)[0]
    finally:
        undo()
        talker.set_talker_step_impl(None)
        os.environ.pop("QWEN3_TTS_AOT", None)
    ref_codes = torch.stack([f[0] for f in ref_frames]).cpu()
    ref_frames = [(c, s.cpu(), lg.cpu()) for c, s, lg in ref_frames]
    n_ref = [r.n_frames for r in ref]
    gaps = _near_tie_gaps(tp["codes"], ref_codes, ref_frames,
                          [max(a, b) for a, b in zip(n_ref, tp["n_frames"])])
    same = not gaps and _same(
        [type(r)(audio=a, n_frames=n) for r, a, n in
         zip(ref, tp["audio"], tp["n_frames"])], ref)
    agree = float((tp["codes"] == ref_codes).float().mean())
    log(f"mesh: tp=2 (two ranks sharing the card over gloo, eager) "
        f"synthesize_batch full width B={MESH_B} greedy {MESH_TP_FRAMES} "
        f"frames: {tp['ms']:.2f} ms per lock-step frame (xla unsharded "
        f"{ref_ms / MESH_TP_FRAMES:.2f}, eager), frames "
        f"{tp['n_frames']} (unsharded xla {n_ref}), code agreement "
        f"{agree:.4f}, "
        + ("codes and audio bitwise equal" if same else
           f"first divergences (stream, frame, codebook, reference margin) "
           f"{[(b, f, p, round(g, 4)) for b, f, p, g in gaps]} (need each "
           f"<= {LOGIT_TOL})")
        + f"; launches {tp['launches']}; {t_tp:.1f} s with the ranks' "
        f"start on {card}")
    if not all(tp["ok"]) or any(g > LOGIT_TOL for *_, g in gaps):
        raise AssertionError("tp = 2 codes disagree beyond bf16 near-ties")
    total = {k: total[k] + tp["launches"][k] for k in counters}
    log(f"mesh: phase took {time.monotonic() - t_phase:.1f} s")
    return total


# -- the convert phase: the offline pipeline (qwen3_tts_tpu_torch/tools) --
# widths of the synthetic HF checkpoints: the 0.6B model's and the 12 Hz
# tokenizer's decoder's (config.py's defaults). The text vocabulary stays
# whole: the converter writes no BOS id, and the tokenizer's default one
# (151644) must name a row of the text embedding.
HF_WIDTHS = dict(hidden=1024, layers=28, heads=16, kv_heads=8, head_dim=128,
                 inter=3072, text_vocab=151936, text_hidden=2048,
                 codec_vocab=3072, groups=16, cp_layers=5, cp_vocab=2048,
                 spk_hidden=512, spk_scale=8, n_mels=128,
                 codebook_size=2048, codebook_dim=256, voc_hidden=512,
                 latent=1024, voc_layers=8, voc_heads=16, decoder_dim=1536,
                 rates=(8, 5, 4, 3))


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values rounded to bf16, as uint16 bits on the host."""
    return t.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(
        np.uint16)


def hf_tts_tensors(wd: dict, gen: torch.Generator) -> dict:
    """HF-named tensors of a synthetic TTS checkpoint (talker, code
    predictor, ECAPA speaker encoder) at the widths `wd`, drawn from `gen`
    on its device, as bf16 bits (uint16 on the host): matrices
    normal(0, 0.02) and norms 1 + normal(0, 0.1) as
    weights.init_talker_weights draws them, the speaker encoder's convs
    normal(0, 1/sqrt(fan_in)) and biases normal(0, 0.1) as
    speaker_encoder.init_speaker_encoder_weights draws them."""
    dev = gen.device

    def rn(*shape, std=0.02):
        return _bf16_bits(torch.randn(shape, generator=gen, device=dev)
                          * std)

    def norm(n):
        return _bf16_bits(1.0 + 0.1 * torch.randn(n, generator=gen,
                                                  device=dev))

    def zeros(n):
        return np.zeros(n, np.uint16)

    def conv(*shape):
        return rn(*shape, std=(shape[-2] * shape[-1]) ** -0.5)

    H, hd, I = wd["hidden"], wd["head_dim"], wd["inter"]
    nq, nkv = wd["heads"] * hd, wd["kv_heads"] * hd
    E, t = wd["text_hidden"], {}

    def layer(p):
        t.update({f"{p}.input_layernorm.weight": norm(H),
                  f"{p}.self_attn.q_proj.weight": rn(nq, H),
                  f"{p}.self_attn.k_proj.weight": rn(nkv, H),
                  f"{p}.self_attn.v_proj.weight": rn(nkv, H),
                  f"{p}.self_attn.o_proj.weight": rn(H, nq),
                  f"{p}.self_attn.q_norm.weight": norm(hd),
                  f"{p}.self_attn.k_norm.weight": norm(hd),
                  f"{p}.post_attention_layernorm.weight": norm(H),
                  f"{p}.mlp.gate_proj.weight": rn(I, H),
                  f"{p}.mlp.up_proj.weight": rn(I, H),
                  f"{p}.mlp.down_proj.weight": rn(H, I)})

    t["talker.model.text_embedding.weight"] = rn(wd["text_vocab"], E)
    t["talker.model.codec_embedding.weight"] = rn(wd["codec_vocab"], H)
    for i in range(wd["layers"]):
        layer(f"talker.model.layers.{i}")
    t["talker.model.norm.weight"] = norm(H)
    t["talker.codec_head.weight"] = rn(wd["codec_vocab"], H)
    t["talker.text_projection.linear_fc1.weight"] = rn(E, E)
    t["talker.text_projection.linear_fc1.bias"] = zeros(E)
    t["talker.text_projection.linear_fc2.weight"] = rn(H, E)
    t["talker.text_projection.linear_fc2.bias"] = zeros(H)
    cp = "talker.code_predictor"
    for i in range(wd["cp_layers"]):
        layer(f"{cp}.model.layers.{i}")
    t[f"{cp}.model.norm.weight"] = norm(H)
    for i in range(wd["groups"] - 1):
        t[f"{cp}.model.codec_embedding.{i}.weight"] = rn(wd["cp_vocab"], H)
        t[f"{cp}.lm_head.{i}.weight"] = rn(wd["cp_vocab"], H)

    sh, scale, sp = wd["spk_hidden"], wd["spk_scale"], "speaker_encoder"
    br, se, mfa = sh // scale, max(sh // 4, 1), 3 * sh

    def bias(n):
        return rn(n, std=0.1)

    t[f"{sp}.blocks.0.conv.weight"] = conv(sh, wd["n_mels"], 5)
    t[f"{sp}.blocks.0.conv.bias"] = bias(sh)
    for i in (1, 2, 3):
        p = f"{sp}.blocks.{i}"
        for j in (1, 2):
            t[f"{p}.tdnn{j}.conv.weight"] = conv(sh, sh, 1)
            t[f"{p}.tdnn{j}.conv.bias"] = bias(sh)
        for j in range(scale - 1):
            t[f"{p}.res2net_block.blocks.{j}.conv.weight"] = conv(br, br, 3)
            t[f"{p}.res2net_block.blocks.{j}.conv.bias"] = bias(br)
        t[f"{p}.se_block.conv1.weight"] = conv(se, sh, 1)
        t[f"{p}.se_block.conv1.bias"] = bias(se)
        t[f"{p}.se_block.conv2.weight"] = conv(sh, se, 1)
        t[f"{p}.se_block.conv2.bias"] = bias(sh)
    t[f"{sp}.mfa.conv.weight"] = conv(mfa, mfa, 1)
    t[f"{sp}.mfa.conv.bias"] = bias(mfa)
    t[f"{sp}.asp.tdnn.conv.weight"] = conv(se, 3 * mfa, 1)
    t[f"{sp}.asp.tdnn.conv.bias"] = bias(se)
    t[f"{sp}.asp.conv.weight"] = conv(mfa, se, 1)
    t[f"{sp}.asp.conv.bias"] = bias(mfa)
    t[f"{sp}.fc.weight"] = conv(H, 2 * mfa, 1)
    t[f"{sp}.fc.bias"] = bias(H)
    return t


def hf_codec_tensors(wd: dict, gen: torch.Generator) -> dict:
    """HF-named tensors of a synthetic speech-codec checkpoint (the
    decoder) at the widths `wd`, drawn from `gen`, as bf16 bits: unit
    norms, 0.5 layer scales and zero biases as init_vocoder_weights draws
    them, the decoder blocks as weights.init_decoder_block draws them,
    codebooks whose embedding_sum / cluster_usage is normal(0, 1), and
    every kernel normal(0, 1/sqrt(fan_in)) (init_decoder_block's
    scale=None) but each residual unit's last, at 0.3/sqrt(fan_in), and
    the output conv's, at 0.25/sqrt(fan_in). At init_vocoder_weights'
    0.1, or with every kernel at 1/sqrt(fan_in), each decoder block grows
    the activations ~2.8x and the audio saturates at full width, where a
    comparison of audio sees nothing; so the audio stays mostly in tanh's
    near-linear range."""
    dev = gen.device

    def rn(*shape, std):
        return _bf16_bits(torch.randn(shape, generator=gen, device=dev)
                          * std)

    def lin(*shape):        # [out, in, (k)]: normal(0, 1/sqrt(in * k))
        return rn(*shape, std=float(np.prod(shape[1:])) ** -0.5)

    def full(n, v):
        return _bf16_bits(torch.full((n,), v))

    CD, HID, LAT = wd["codebook_dim"], wd["voc_hidden"], wd["latent"]
    n_cb, q, t = wd["codebook_size"], "decoder.quantizer", {}

    def codebook(p):
        usage = 0.5 + torch.rand(n_cb, generator=gen, device=dev)
        t[f"{p}._codebook.embedding_sum"] = _bf16_bits(
            torch.randn(n_cb, CD, generator=gen, device=dev)
            * usage[:, None])
        t[f"{p}._codebook.cluster_usage"] = _bf16_bits(usage)

    for part in ("rvq_first", "rvq_rest"):
        t[f"{q}.{part}.output_proj.weight"] = lin(HID, CD, 1)
        t[f"{q}.{part}.input_proj.weight"] = lin(CD, HID, 1)
    codebook(f"{q}.rvq_first.vq.layers.0")
    for i in range(wd["groups"] - 1):
        codebook(f"{q}.rvq_rest.vq.layers.{i}")
    t["decoder.pre_conv.conv.weight"] = lin(LAT, HID, 3)
    t["decoder.pre_conv.conv.bias"] = full(LAT, 0.0)
    pt = "decoder.pre_transformer"
    t[f"{pt}.input_proj.weight"] = lin(HID, LAT)
    t[f"{pt}.input_proj.bias"] = full(HID, 0.0)
    t[f"{pt}.output_proj.weight"] = lin(LAT, HID)
    t[f"{pt}.output_proj.bias"] = full(LAT, 0.0)
    t[f"{pt}.norm.weight"] = full(HID, 1.0)
    for i in range(wd["voc_layers"]):
        p = f"{pt}.layers.{i}"
        t.update({f"{p}.input_layernorm.weight": full(HID, 1.0),
                  f"{p}.self_attn.q_proj.weight": lin(LAT, HID),
                  f"{p}.self_attn.k_proj.weight": lin(LAT, HID),
                  f"{p}.self_attn.v_proj.weight": lin(LAT, HID),
                  f"{p}.self_attn.o_proj.weight": lin(HID, LAT),
                  f"{p}.self_attn_layer_scale.scale": full(HID, 0.5),
                  f"{p}.post_attention_layernorm.weight": full(HID, 1.0),
                  f"{p}.mlp.gate_proj.weight": lin(2 * HID, HID),
                  f"{p}.mlp.up_proj.weight": lin(2 * HID, HID),
                  f"{p}.mlp.down_proj.weight": lin(HID, 2 * HID),
                  f"{p}.mlp_layer_scale.scale": full(HID, 0.5)})
    for i in range(2):
        p = f"decoder.upsample.{i}"
        t.update({f"{p}.0.conv.weight": lin(LAT, LAT, 2),
                  f"{p}.0.conv.bias": full(LAT, 0.0),
                  f"{p}.1.dwconv.conv.weight": lin(LAT, 1, 7),
                  f"{p}.1.dwconv.conv.bias": full(LAT, 0.0),
                  f"{p}.1.norm.weight": full(LAT, 1.0),
                  f"{p}.1.norm.bias": full(LAT, 0.0),
                  f"{p}.1.pwconv1.weight": lin(2 * LAT, LAT),
                  f"{p}.1.pwconv1.bias": full(2 * LAT, 0.0),
                  f"{p}.1.pwconv2.weight": lin(LAT, 2 * LAT),
                  f"{p}.1.pwconv2.bias": full(LAT, 0.0),
                  f"{p}.1.gamma": full(LAT, 0.5)})
    c = wd["decoder_dim"]
    t["decoder.decoder.0.conv.weight"] = lin(c, LAT, 7)
    t["decoder.decoder.0.conv.bias"] = full(c, 0.0)
    for blk, rate in enumerate(wd["rates"], start=1):
        p, co = f"decoder.decoder.{blk}.block", c // 2
        t.update({f"{p}.0.alpha": rn(c, std=0.3),
                  f"{p}.0.beta": rn(c, std=0.3),
                  f"{p}.1.conv.weight": rn(c, co, 2 * rate,
                                           std=(2 * c) ** -0.5),
                  f"{p}.1.conv.bias": rn(co, std=0.1)})
        for res in (2, 3, 4):
            r = f"{p}.{res}"
            t.update({f"{r}.act1.alpha": rn(co, std=0.3),
                      f"{r}.act1.beta": rn(co, std=0.3),
                      f"{r}.conv1.conv.weight": lin(co, co, 7),
                      f"{r}.conv1.conv.bias": rn(co, std=0.1),
                      f"{r}.act2.alpha": rn(co, std=0.3),
                      f"{r}.act2.beta": rn(co, std=0.3),
                      f"{r}.conv2.conv.weight": rn(co, co, 1,
                                                   std=0.3 * co ** -0.5),
                      f"{r}.conv2.conv.bias": rn(co, std=0.1)})
        c = co
    t["decoder.decoder.5.alpha"] = rn(c, std=0.3)
    t["decoder.decoder.5.beta"] = rn(c, std=0.3)
    t["decoder.decoder.6.conv.weight"] = rn(1, c, 7,
                                            std=0.25 * (7 * c) ** -0.5)
    t["decoder.decoder.6.conv.bias"] = full(1, 0.0)
    return t


def write_hf_checkpoints(tts_dir, codec_dir, seed: int, device="cpu",
                         **widths) -> int:
    """Synthetic HF checkpoints from `seed` (a torch.Generator on
    `device`): the TTS model in two BF16
    shards with its config.json and BPE vocabulary files, the speech codec
    in one BF16 file with its config.json, at HF_WIDTHS with `widths`
    replacing some (a CPU test runs it at tiny widths), written through
    io/safetensors.py. Special ids a reduced vocabulary cannot hold are
    moved to its last rows. Returns the bytes written."""
    from qwen3_tts_tpu_torch.io.safetensors import save_file
    wd = {**HF_WIDTHS, **widths}
    gen = torch.Generator(device=device).manual_seed(seed)
    tv, cv = wd["text_vocab"], wd["codec_vocab"]
    os.makedirs(tts_dir, exist_ok=True)
    os.makedirs(codec_dir, exist_ok=True)
    talker_cfg = {
        "hidden_size": wd["hidden"], "intermediate_size": wd["inter"],
        "num_hidden_layers": wd["layers"],
        "num_attention_heads": wd["heads"],
        "num_key_value_heads": wd["kv_heads"], "head_dim": wd["head_dim"],
        "vocab_size": cv, "text_vocab_size": tv,
        "text_hidden_size": wd["text_hidden"],
        "num_code_groups": wd["groups"], "rms_norm_eps": 1e-6,
        "rope_theta": 1e6,
        "code_predictor_config": {"num_hidden_layers": wd["cp_layers"],
                                  "vocab_size": wd["cp_vocab"]},
        "tts_bos_token_id": min(151672, tv - 2),
        "tts_eos_token_id": min(151673, tv - 1),
        "tts_pad_token_id": min(151671, tv - 3)}
    codec_ids = ("codec_pad_id", "codec_bos_id", "codec_eos_token_id",
                 "codec_think_id", "codec_nothink_id", "codec_think_bos_id",
                 "codec_think_eos_id", "english_language_id")
    for key, default, low in zip(codec_ids, (2148, 2149, 2150, 2154, 2155,
                                             2156, 2157, 2050),
                                 range(cv - 8, cv)):
        talker_cfg[key] = default if cv > 2157 else low
    files = {
        os.path.join(tts_dir, "config.json"): json.dumps({
            "talker_config": talker_cfg,
            "speaker_encoder_config": {"enc_dim": wd["hidden"],
                                       "sample_rate": 24000}}),
        os.path.join(tts_dir, "vocab.json"): json.dumps(
            {tok: i for i, tok in enumerate(SMOKE_TOKENS)}),
        os.path.join(tts_dir, "merges.txt"):
            "#version: 0.2\n" + "\n".join(SMOKE_MERGES) + "\n",
        os.path.join(tts_dir, "tokenizer_config.json"): json.dumps(
            {"eos_token": "<|im_end|>", "pad_token": "<|im_end|>"}),
        os.path.join(codec_dir, "config.json"): json.dumps({
            "input_sample_rate": 24000,
            "encoder_config": {"codebook_size": wd["codebook_size"],
                               "_frame_rate": 12.5},
            "decoder_config": {
                "hidden_size": wd["voc_hidden"],
                "num_hidden_layers": wd["voc_layers"],
                "num_attention_heads": wd["voc_heads"],
                "latent_dim": wd["latent"], "num_quantizers": wd["groups"],
                "upsample_rates": list(wd["rates"])}})}
    for path, text in files.items():
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    tts = hf_tts_tensors(wd, gen)
    first = [k for k in tts if k.startswith("talker.model.")]
    shards = ({k: tts.pop(k) for k in first}, tts)
    paths = [os.path.join(tts_dir, f"model-0000{i}-of-00002.safetensors")
             for i in (1, 2)]
    for path, shard in zip(paths, shards):
        save_file(shard, path, {"format": "pt"}, bf16=True)
    del shards, tts
    paths.append(os.path.join(codec_dir, "model.safetensors"))
    save_file(hf_codec_tensors(wd, gen), paths[-1], {"format": "pt"},
              bf16=True)
    return sum(os.path.getsize(p) for p in [*paths, *files])


CONVERT_SEED = SEED + 11
CONVERT_TEXT = "hello world."
CONVERT_TOKENS = 40           # one generation chunk a synthesis
PARITY_CPU_SEEDS = (SEED, SEED + 1, SEED + 2)
# kernels of the port, by the substrings of their names in a profile
KERNEL_NAMES = ("talker_step", "codepred", "fd_", "res_gemm", "snake_bf16",
                "snake_convt")


def _stage_line(r: dict) -> str:
    err = (f"not served: {r['error']}" if "error" in r else
           f"rel {r['rel']:.3e} (tol {r['tol']:.1e})" if "rel" in r else
           f"codes equal (tol {r['tol']:.1e})" if r["codes_equal"] else
           f"near-tie margin {r['gap']:.3e} (tol {r['tol']:.1e})")
    return (f"  {r['stage']:<28} {err} "
            f"{'OK' if r['ok'] else 'FAIL'}  [{r['impl']}]  launches "
            f"{r['launches'] or {}}")


def _check_parity_report(report: list, n_layers: int) -> None:
    """Every stage passed; in the bf16 pass the step, the code predictor
    and the vocoder took their kernels, the xla step decode attention (a
    launch a layer); the f32 pass, on the plain path end to end (decode
    attention at xla), launched no kernel."""
    seen = set()
    for r in report:
        ran = r["launches"]
        if not r["ok"]:
            raise AssertionError(f"parity stage failed: {r}")
        if r["pass"] == "f32" and ran:
            raise AssertionError(f"f32 pass launched a kernel: {r}")
        stage = r["stage"].split(":")[1]
        if r["pass"] != "bf16":
            continue
        need = {"step_hidden[fused]": ("talker_fused",),
                "code_pred_codes": ("codepred",),
                "vocoder_audio": ("res_chain", "snake_convt")}.get(stage)
        if need:
            if not r["impl"].startswith("fused"):
                raise AssertionError(f"not the kernel at full width: {r}")
            if any(ran.get(k, 0) <= 0 for k in need):
                raise AssertionError(f"{need} did not launch: {r}")
            seen.add(stage)
        if stage == "step_hidden[xla]":
            if ran.get("flash_decode", 0) != n_layers:
                raise AssertionError(f"decode attention: {r}")
            seen.add(stage)
    if len(seen) != 4:
        raise AssertionError(f"bf16 pass stages missing: {sorted(seen)}")


def convert_phase(card, counters, dev) -> dict:
    """The offline pipeline on the port alone at the full widths: synthetic
    BF16 HF checkpoints (two TTS shards and the codec) written through
    io/safetensors.py, converted at f16 by tools/convert_checkpoints.py,
    then tools/acceptance.run_acceptance on the card under torch.profiler
    (eagerly, QWEN3_TTS_AOT=0, so that no graph is captured inside the
    profiler's session): its own conversion,
    tools/parity.run_parity (both passes; each stage's error against its
    tolerance, its implementation and its kernel launches), load_models,
    synthesis, the WAV round trip and the cloned voice from a seeded
    reference WAV. Returns the phase's kernel launches."""
    import shutil
    from pathlib import Path
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.runtime import audio_io
    from qwen3_tts_tpu_torch.tools import acceptance
    from qwen3_tts_tpu_torch.tools import convert_checkpoints as cc

    t_phase = time.monotonic()
    root = Path(tempfile.mkdtemp(prefix="q3tts_convert_"))
    try:
        tts, codec = root / "hf_tts", root / "hf_codec"
        t0 = time.monotonic()
        n = write_hf_checkpoints(tts, codec, CONVERT_SEED, device=dev)
        log(f"convert: synthetic BF16 HF checkpoints at the 0.6B widths "
            f"(TTS in two shards, codec): {n:,} bytes in "
            f"{time.monotonic() - t0:.1f} s")
        for what, fn, src in (("tts", cc.convert_tts, tts),
                              ("codec", cc.convert_codec, codec)):
            out = root / f"{what}-f16.gguf"
            t0 = time.monotonic()
            fn(src, out, "f16")
            log(f"convert: {what} -> GGUF f16: {out.stat().st_size:,} bytes "
                f"in {time.monotonic() - t0:.1f} s")
            out.unlink()
        wav = root / "ref.wav"
        audio_io.save_wav(str(wav), _clip(3.0, 24000, CONVERT_SEED), 24000)

        for fn in counters.values():
            fn.launches = 0
        coop0 = kernels.codepred_launches()
        report: list = []
        # eager under the profiler: no graph is captured inside its session
        aot = os.environ.get("QWEN3_TTS_AOT")
        os.environ["QWEN3_TTS_AOT"] = "0"
        t0 = time.monotonic()
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILER_PAD_S)
                results = acceptance.run_acceptance(
                    tts, codec, root / "work", ref_wav=wav, out_type="f16",
                    text=CONVERT_TEXT, max_tokens=CONVERT_TOKENS,
                    device=str(dev), parity_report=report)
                torch.cuda.synchronize()
                time.sleep(PROFILER_PAD_S)
        finally:
            if aot is None:
                os.environ.pop("QWEN3_TTS_AOT")
            else:
                os.environ["QWEN3_TTS_AOT"] = aot
        secs = time.monotonic() - t0
        ran = {k: fn.launches for k, fn in counters.items()}
        coop = kernels.codepred_launches() - coop0
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"convert: parity on {card} (reference on the CPU in f32):")
    for r in report:
        log(_stage_line(r))
    for r in results:
        log(f"  acceptance {r['step']:<20} {r['seconds']:6.1f} s  "
            f"{'OK' if r['ok'] else 'FAIL'}  {r['detail']}")
    names: dict = {}
    for name, _, _ in _kernel_events(prof):
        m = re.search(r"\w*(?:%s)\w*" % "|".join(KERNEL_NAMES), name)
        if m:
            names[m.group(0)] = names.get(m.group(0), 0) + 1
    log(f"convert: acceptance in {secs:.1f} s; kernel launches {ran}; code "
        f"predictor {coop} cooperative launches; profiler kernels {names}")
    failed = [r["step"] for r in results if not r["ok"]]
    if failed:
        raise AssertionError(f"acceptance steps failed: {failed}")
    _check_parity_report(report, HF_WIDTHS["layers"])
    if min(ran.values()) <= 0:
        raise AssertionError(f"a kernel never ran in the convert phase: {ran}")
    log(f"convert: phase took {time.monotonic() - t_phase:.1f} s")
    return ran


def parity_cpu() -> int:
    """``--parity-cpu``: tools/parity.run_parity through the kernels'
    twins on the CPU at the full widths, over PARITY_CPU_SEEDS (the
    measurement behind parity.BF16_TOL): the largest ratio of each stage,
    and twice it, as one JSON line."""
    import shutil
    from pathlib import Path
    from qwen3_tts_tpu_torch.tools import parity

    worst: dict = {}
    for seed in PARITY_CPU_SEEDS:
        root = Path(tempfile.mkdtemp(prefix="q3tts_parity_"))
        try:
            t0 = time.monotonic()
            write_hf_checkpoints(root / "tts", root / "codec", seed)
            report: list = []
            parity.run_parity(root / "tts", root / "codec", "cpu",
                              seed=seed, report=report)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        log(f"seed {seed}: {time.monotonic() - t0:.1f} s")
        for r in report:
            stage = r["stage"].split("[")[0]
            v = r.get("rel", r.get("gap") or 0.0)
            worst[stage] = max(worst.get(stage, 0.0), v)
    print(json.dumps({"seeds": list(PARITY_CPU_SEEDS), "max": worst,
                      "twice": {k: 2 * v for k, v in worst.items()}}),
          flush=True)
    return 0


COMPARE_CHILD = r"""
import importlib.util, json, sys
import torch
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from qwen3_tts_tpu_torch.config import TalkerConfig
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.ops import codepred_fused as cf
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
cfg = TalkerConfig(text_vocab_size=16, n_layers=1)
w = W.init_talker_weights(cfg, gen, dev)
out, phases = {}, {}
for B in cs.CODEPRED_TIME_B:
    hidden, cb0, noise = cs._codepred_inputs(cfg, B, dev, gen)
    fn = lambda: cf.predict_codes_fused(w, cfg, hidden, cb0, 0.9, 50,
                                        gumbel=noise)
    out[f"codepred B={B}"] = [cs.cuda_time(fn, iters=10),
                              cs.device_ms(fn, 5, ("",))]
    phases[f"B={B}"] = cs.codepred_phase_ms(fn, dev)
# the 1.7B shape through predict_codes under auto, as an engine holds it:
# its mtp rows folded where the checkout folds them (the kernel), else the
# XLA-path branch
from qwen3_tts_tpu_torch.models import code_predictor as cp
big = TalkerConfig(text_vocab_size=16, n_layers=1, hidden_size=2048)
wb = W.init_talker_weights(big, gen, dev)
wb = {"codec_embd": wb["codec_embd"], "code_pred": wb["code_pred"]}
if hasattr(cf, "fold_mtp"):
    wb = cf.fold_mtp(wb, big)
for B in cs.CODEPRED_TIME_B:
    hidden, cb0, noise = cs._codepred_inputs(big, B, dev, gen)
    fn = lambda: cp.predict_codes(wb, big, hidden, cb0, 0.9, 50,
                                  gumbel=noise)
    out[f"codepred 1.7B B={B}"] = [cs.cuda_time(fn, iters=10),
                                   cs.device_ms(fn, 5, ("",))]
del wb
for B in cs.ATTN_B:
    caches = cs._attn_cache(B, cs.ATTN_S, dev, gen)
    q = torch.randn(B, 16, 128, generator=gen, device=dev).bfloat16()
    kw = cs._attn_cases(B, cs.ATTN_S, cs.ATTN_S, dev, gen)["window"]
    for kv, (k, v, ks, vs) in caches.items():
        fn = lambda: cs._attn_call(kw, q, k, v, ks, vs, cs.ATTN_S, False)
        out[f"flash_decode window B={B} {kv}"] = [
            cs.cuda_time(fn, iters=20), cs.device_ms(fn, 20, ("",))]
from qwen3_tts_tpu_torch.config import VocoderConfig
from qwen3_tts_tpu_torch.ops import talker_fused as tf
from qwen3_tts_tpu_torch.ops import vocoder_fused as vf
cfg = TalkerConfig(text_vocab_size=16)
lw = W.init_talker_weights(cfg, gen, dev)["layers"]
kw = dict(n_heads=cfg.n_attention_heads, n_kv=cfg.n_key_value_heads,
          head_dim=cfg.head_dim, eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
for B, rc in cs.COMPARE_TALKER:
    cache = cs._tf_cache(cfg.n_layers, B, "bf16", rc, dev, gen)
    x = torch.randn(B, cfg.hidden_size, generator=gen, device=dev)
    pos, n_valid, _, widx = cs._tf_case("prefix", B, rc, dev, gen)
    widx = torch.tensor(widx, dtype=torch.int32, device=dev)
    fn = lambda: tf.talker_step_fused(lw, x, pos, cache, widx, n_valid,
                                      read_ctx=rc, **kw)
    out[f"talker step B={B} read_ctx={rc}"] = [
        cs.cuda_time(fn, iters=10), cs.device_ms(fn, 5, ("",))]
    del cache
del lw
torch.cuda.empty_cache()
blocks = cs.decoder_blocks(VocoderConfig(), dev, gen)
for B in cs.VOC_TIME_B:
    xs = [torch.randn(B, t, c, generator=gen, device=dev)
          for c, t in cs.CHAIN_SHAPES]
    fn = lambda: [vf.fused_residual_chain(x, blk)
                  for x, blk in zip(xs, blocks)]
    out[f"res_chain 4 blocks B={B}"] = [cs.cuda_time(fn, iters=5),
                                        cs.device_ms(fn, 3, ("",))]
    del xs
    xs = [torch.randn(B, t, c, generator=gen, device=dev)
          for c, _, _, t in cs.HEAD_SHAPES]
    fn = lambda: [vf.fused_snake_convt(x, blk, r) for x, blk, (*_, r, _) in
                  zip(xs, blocks, cs.HEAD_SHAPES)]
    out[f"snake_convt 4 blocks B={B}"] = [cs.cuda_time(fn, iters=5),
                                          cs.device_ms(fn, 3, ("",))]
    del xs
    torch.cuda.empty_cache()
# Qwen3-Omni's MoE layer at B = 192 from its own seed: time and the
# output's bits, which a change that leaves that path alone keeps
import hashlib
from qwen3_tts_tpu_torch.ops import moe as M
g2 = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
moe, mlw = cs._moe_layer(dev, g2)
h = torch.randn(192, 1024, generator=g2, device=dev)
fn = lambda: M.moe_ffn(h, mlw, moe)
moe_bits = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
out["moe omni B=192"] = [cs.cuda_time(fn, iters=20),
                         cs.device_ms(fn, 20, ("",))]
from qwen3_tts_tpu_torch import kernels
print("COMPARE " + json.dumps({
    "times": out, "phases": phases, "moe_bits": moe_bits,
    "ptxas": cs.ptxas_summary(kernels.build_log())}), flush=True)
"""
# (B, read_ctx) of the talker steps --compare times
COMPARE_TALKER = ((4, 256), (8, 256), (8, 1152), (32, 256), (32, 1152))
COMPARE_LOCKSTEP_B = (4, 64)  # the lock-step row's batches (PIPE_B)

# The lock-step row of --compare: synthesize_batch at the full widths
# (random weights from SEED), B 4 and 64, LOCKSTEP_TOKENS frames, greedy,
# bf16 and int8 KV, through the checkout in the working directory; a warm
# call, then a timed one, then an eager one whose every frame is recorded
# (with the scores its greedy argmax read where argv[3], another run's
# .npz, is given) and whose streams must be the timed run's. Writes each
# run's codes (the frames the loop handed to the vocoder), int16 PCM,
# frame counts and the eager run's frames [F, B, 16] to an .npz at
# argv[2]; with argv[3], also the first divergences of that run's
# recorded frames from these (_near_tie_gaps: stream, frame, codebook,
# this run's score margin).
COMPARE_LOCKSTEP = r"""
import importlib.util, json, os, sys, time
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from qwen3_tts_tpu_torch.config import TalkerConfig, VocoderConfig
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.ops import talker_fused as tf
from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
cfg, vcfg = TalkerConfig(), VocoderConfig()
eng = Qwen3TTS.from_components(
    cs.smoke_tokenizer(), cfg, W.init_talker_weights(cfg, gen, dev), vcfg,
    W.init_vocoder_weights(vcfg, gen, dev), dev)
seen = {}
try:  # the chunk loop's core (runtime/stream.py): each call's StreamCodes
    from qwen3_tts_tpu_torch.runtime.stream import StreamCodes
    alloc = StreamCodes.alloc
    def record(*a):
        seen["streams"] = alloc(*a)
        return seen["streams"]
    StreamCodes.alloc = record
    def stream_codes():
        return [s.buf[:s.n_frames] for s in seen["streams"]]
except ImportError:  # a checkout whose loop keeps each stream's chunks
    decode = eng._decode_streaming
    def record(frames, *a):
        seen["frames"] = frames
        return decode(frames, *a)
    eng._decode_streaming = record
    def stream_codes():
        return [np.concatenate(f) for f in seen["frames"]]
out, arrays = {}, {}
for B in cs.COMPARE_LOCKSTEP_B:
    texts = (cs.LOCKSTEP_TEXTS * B)[:B]
    for kv in ("bf16", "int8"):
        os.environ["QWEN3_TTS_KV"] = kv
        p = TTSParams(max_audio_tokens=cs.LOCKSTEP_TOKENS, temperature=0.0,
                      seed=cs.SEED, print_timing=False)
        eng.synthesize_batch(texts, params=p)
        torch.cuda.synchronize()
        steps = tf.talker_step_fused.launches
        t0 = time.monotonic()
        res = eng.synthesize_batch(texts, params=p)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        steps = tf.talker_step_fused.launches - steps
        name = f"B={B} {kv}"
        out[name] = [cs.call_split(res)[0] / steps, wall, steps]
        arrays[name + " codes"] = np.concatenate(stream_codes())
        arrays[name + " pcm"] = np.concatenate(
            [np.round(r.audio * 32767.0).astype(np.int16) for r in res])
        arrays[name + " frames"] = np.array([r.n_frames for r in res])
        os.environ["QWEN3_TTS_AOT"] = "0"
        frames = []
        undo = cs._record_frames(frames, logits=len(sys.argv) > 3)
        try:
            eager = eng.synthesize_batch(texts, params=p)
            torch.cuda.synchronize()
        finally:
            undo()
            os.environ.pop("QWEN3_TTS_AOT")
        codes = torch.stack([f[0] for f in frames])
        n = [r.n_frames for r in eager]
        if n != [r.n_frames for r in res] or not np.array_equal(
                np.concatenate([codes[:k, b].cpu().numpy()
                                for b, k in enumerate(n)]),
                arrays[name + " codes"]):
            raise SystemExit(f"{name}: the eager run's streams are not the "
                             f"timed run's")
        arrays[name + " recorded"] = codes.cpu().numpy()
        if len(sys.argv) > 3:
            other = np.load(sys.argv[3])
            arrays[name + " gaps"] = np.array(cs._near_tie_gaps(
                torch.as_tensor(other[name + " recorded"], device=dev),
                codes, frames, [max(a, int(b)) for a, b in
                                zip(n, other[name + " frames"])]),
                np.float64).reshape(-1, 4)
        del frames
np.savez(sys.argv[2], **arrays)
print("LOCKSTEP " + json.dumps(out), flush=True)
"""


def _child(code: str, tag: str, root: str, *args) -> dict:
    """Run a --compare child in the checkout at `root`; its `tag` line."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", code, os.path.join(here, "chip_smoke.py"),
         *args], cwd=os.path.abspath(root), capture_output=True, text=True,
        timeout=900)
    lines = [l for l in out.stdout.splitlines() if l.startswith(tag + " ")]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"compare {root} failed:\n{out.stderr[-3000:]}")
    return json.loads(lines[0][len(tag) + 1:])


def compare(parent: str) -> int:
    """Time the code predictor (CODEPRED_TIME_B: the kernel at the 0.6B
    dims, and ``predict_codes`` under auto at the 1.7B shape, its mtp
    rows folded where the checkout folds them), decode attention
    (window mode, read_ctx 1,152, B 8 / 32), the talker megakernel (B 4 at
    read_ctx 256, B 8 / 32 x read_ctx 256 / 1,152; bf16, prefix mode;
    COMPARE_TALKER), the residual chain and the Snake + convT head
    (the 4 blocks of a chunk, B 2 / 16) through their public wrappers
    in the checkout at `parent` and in this one, in turns parent, this,
    this, parent, each in a child process of its own on this card: CUDA
    events per call and the profiler's device ms per call (every kernel
    the call ran), and the code predictor's phase clock at each of its B.
    In the same turns, the lock-step row
    (COMPARE_LOCKSTEP): generate ms a lock-step frame and wall ms of
    synthesize_batch at B 4 and 64, bf16 and int8 KV, greedy; every run's
    codes and int16 PCM must equal its own side's first run's bitwise
    (the eager recorded run's frames too), and the first change run's
    codes the parent's up to each stream's first divergence, which must
    be a near-tie of the last parent run's scores (margin <= LOGIT_TOL):
    a change that reorders sums may part from the parent there. Each
    child logs what ptxas said of every kernel it built."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _, card = device_info()
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="q3tts_compare_")
    first, bits = {}, []
    try:
        for i, (name, root) in enumerate((("parent", parent),
                                          ("change", here), ("change", here),
                                          ("parent", parent))):
            got = _child(COMPARE_CHILD, "COMPARE", root)
            bits.append(got["moe_bits"])
            log(f"{name} ({root}): Omni MoE output bits {got['moe_bits']}; "
                + ", ".join(
                f"{k} {v[0]:.4f} ms (device {v[1]:.4f})"
                for k, v in got["times"].items()) + f" on {card}; ptxas "
                + "; ".join(got["ptxas"]))
            for b, ms in got["phases"].items():
                log(f"{name} codepred {b} phase clock, ms per frame and us "
                    f"per phase: " + phase_line(ms))
            npz = os.path.join(tmp, f"run{i}.npz")
            # the last parent run holds the first change run to near-ties
            rows = _child(COMPARE_LOCKSTEP, "LOCKSTEP", root, npz,
                          *([os.path.join(tmp, "run1.npz")] if i == 3
                            else []))
            got = dict(np.load(npz))
            first.setdefault(name, got)
            same = {k: np.array_equal(got[k], first[name][k])
                    for k in first[name]}
            gaps = {k.rsplit(" ", 1)[0]: [(int(b), int(f), int(p),
                                           round(float(g), 4))
                                          for b, f, p, g in v]
                    for k, v in got.items() if k.endswith(" gaps")}
            log(f"{name} lock-step ({root}): " + ", ".join(
                f"{k}: generate {v[0]:.3f} ms a frame ({v[2]} frames), wall "
                f"{v[1]:.1f} ms" for k, v in rows.items())
                + f"; codes and PCM bitwise the first {name} run's: "
                f"{all(same.values())}"
                + (f"; the change's first divergences from the parent "
                   f"(stream, frame, codebook, the parent's margin) {gaps} "
                   f"(need each <= {LOGIT_TOL})" if gaps else "")
                + f" on {card}")
            if not all(same.values()):
                raise SystemExit(f"lock-step output differs from the first "
                                 f"{name} run's: "
                                 f"{[k for k, v in same.items() if not v]}")
            if any(g[3] > LOGIT_TOL for v in gaps.values() for g in v):
                raise SystemExit("the change's lock-step codes part from the "
                                 "parent's beyond a near-tie")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    if len(set(bits)) != 1:
        raise SystemExit(f"the Omni MoE layer's output differs between the "
                         f"runs: {bits}")
    log(f"Omni MoE output bitwise equal over the four runs: {bits[0]}")
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        return compare(sys.argv[2])
    if sys.argv[1:] == ["--parity-cpu"]:
        return parity_cpu()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.config import TalkerConfig, VocoderConfig
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS

    # the twins hold f32 products of bf16 values: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, card = device_info()
    t0 = time.monotonic()
    lib_path = kernels.build()
    kernels.lib()
    log(f"built {lib_path.name} in {time.monotonic() - t0:.1f} s")
    log("ptxas: " + "; ".join(ptxas_summary(kernels.build_log())))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg, vcfg = TalkerConfig(), VocoderConfig()
    t0 = time.monotonic()
    talker_w = W.init_talker_weights(cfg, gen, dev)
    voc_w = W.init_vocoder_weights(vcfg, gen, dev)
    torch.cuda.synchronize()
    log(f"random full-width weights on the card in "
        f"{time.monotonic() - t0:.1f} s")

    # every kernel against its twin; all run, then any failure stops the
    # script before the main paths
    report, failed = [], []
    blocks = decoder_blocks(vcfg, dev, gen)
    for check, args in ((check_codepred, (talker_w, cfg, dev, gen)),
                        (check_codepred_17b, (dev, gen)),
                        (check_codepred_dispatch, (talker_w, cfg, dev, gen)),
                        (check_res_chain, (blocks, dev, gen)),
                        (check_snake_convt, (blocks, dev, gen)),
                        (check_flash_decode, (dev, gen)),
                        (check_talker_fused, (talker_w, cfg, dev, gen)),
                        (check_moe, (dev, gen)),
                        (check_mla, (dev, gen)),
                        (check_moe_ep, (dev, gen))):
        try:
            entry = check(*args)
            if entry:
                report.append(entry)
        except Exception:
            traceback.print_exc()
            failed.append(check.__name__)
    if failed:
        raise SystemExit(f"kernel checks failed: {failed}")
    exact = check_exact_sin2(blocks, card, dev, gen)
    for entry in report:
        entry.update(exact.get(entry["name"], {}))

    # the main paths through the user's entry points, at the full widths
    tok = smoke_tokenizer()
    engine = Qwen3TTS.from_components(tok, cfg, talker_w, vcfg, voc_w, dev)
    counters = _counters()
    lockstep = dict.fromkeys(counters, 0)
    for impl, kv, temperature, top_p in LOCKSTEP_RUNS:
        ran = lockstep_run(engine, impl, kv, temperature, top_p, card,
                           counters, dev)
        lockstep = {k: lockstep[k] + ran[k] for k in counters}
    serving, captured = dict.fromkeys(counters, 0), []
    for impl, kv in SERVE_RUNS:
        ran, caps = serve_run(engine, impl, kv, card, counters, dev)
        serving = {k: serving[k] + ran[k] for k in counters}
        captured += caps
    check_captured(captured, talker_w, cfg, dev, gen)
    clone = load_and_clone(tok, cfg, talker_w, vcfg, voc_w, engine, card,
                           counters, dev)
    converted = convert_phase(card, counters, dev)
    graphed = graphs_phase(tok, cfg, talker_w, vcfg, voc_w, engine, card,
                           counters, dev)
    piped = pipelined_phase(tok, cfg, talker_w, vcfg, voc_w, engine, card,
                            counters, dev)
    benched = bench_phase(cfg, talker_w, vcfg, voc_w, card, counters, dev)
    omni = omni_phase(tok, card, counters, dev)
    longcat = longcat_phase(tok, card, counters, dev)
    meshed = mesh_phase(tok, cfg, talker_w, vcfg, voc_w, engine, card,
                        counters, dev)
    for entry in report:
        if entry["name"] == "codepred_17b":
            # its launches are its check's and its own lock-step run's
            continue
        if entry["name"] == "moe":
            # only the Omni phase runs an MoE talker
            entry.update(launches=omni["moe"], launches_omni=omni["moe"])
            if entry["launches"] <= 0:
                raise AssertionError("moe never ran on the Omni phase")
            continue
        if entry["name"] in ("mla", "moe_ep"):
            # only the LongCat phase runs its block
            n = longcat["mla" if entry["name"] == "mla" else "moe"]
            entry.update(launches=n, launches_longcat=n)
            if n <= 0:
                raise AssertionError(f"{entry['name']} never ran on the "
                                     f"LongCat phase")
            continue
        a, b, c, d, e, f, g, h = (
            lockstep[entry["name"]], serving[entry["name"]],
            clone[entry["name"]], graphed[entry["name"]],
            meshed[entry["name"]], converted[entry["name"]],
            piped[entry["name"]], benched[entry["name"]])
        o = omni[entry["name"]]
        entry.update(launches=a + b + c + d + e + f + g + h + o
                     + longcat[entry["name"]],
                     launches_lockstep=a, launches_serving=b,
                     launches_clone=c, launches_graphs=d, launches_mesh=e,
                     launches_convert=f, launches_pipelined=g,
                     launches_bench=h, launches_omni=o)
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} never ran on a main path")
        if entry["launches_mesh"] <= 0:
            raise AssertionError(f"{entry['name']} never ran on the mesh")
        if entry["launches_bench"] <= 0:
            raise AssertionError(f"{entry['name']} never ran in the bench "
                                 f"phase")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
