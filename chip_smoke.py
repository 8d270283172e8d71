#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
port's CUDA kernels from qwen3_tts_tpu_torch/csrc (nvcc, sm_90a), then:

1. prints the device and ``nvidia-smi --query-gpu=name,power.limit``;
2. holds each kernel against its plain torch twin at the main path's
   shapes, with the tolerance stated on each line, and times both; the
   decode-attention kernel in prefix, bitmask, window and wrapped-window
   modes, with empty streams, for the bf16 and the int8 cache;
3. drives ``Qwen3TTS.synthesize_batch`` at the full 0.6B widths (random
   weights from a fixed torch.Generator, an in-memory tokenizer): greedy
   and at temperature 0.9, with the bf16 and the int8 KV cache; checks that
   every request succeeds with finite audio of n_frames * 1920 samples and
   that the lock-step path launched every kernel;
4. serves 20 requests through ``ContinuousBatcher`` (8 slots, greedy,
   bf16 and then int8 KV), 12 of them submitted mid-run: slots turn over,
   requests retire by EOS and by the frame cap, the ring wraps. Checks
   every result as in 3, that the serving path launched every kernel and
   the decode-attention kernel in window mode with wrapped windows, and
   holds the kernel against its twin on masks captured from the live ring
   after it wrapped.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before it. Without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

SEED = 1234
CODEPRED_B = 8
# (C, T per 40-frame chunk) of the four decoder blocks' residual chains,
# and (C, C2, rate, T) of their Snake + convT heads (vocoder.py widths)
CHAIN_SHAPES = ((768, 1280), (384, 6400), (192, 25600), (96, 76800))
HEAD_SHAPES = ((1536, 768, 8, 160), (768, 384, 5, 1280), (384, 192, 4, 6400),
               (192, 96, 3, 25600))
VOC_B = 2
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
# serving phase: a 96-frame cap puts the ring at 256 - 16 slots, so it
# wraps after 6 chunks; "h" (36-frame EOS ramp) reaches EOS by frame 72
SERVE_SLOTS = 8
SERVE_MAX_FRAMES = 96
SERVE_SHORT = "h"
SERVE_LONG = "hello world hello world hello world hello world."

def log(msg: str) -> None:
    print(msg, flush=True)


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


def _divergence_gaps(got, ref, logits, tinv, top_k, noise):
    """Per stream whose codes differ: the twin's score margin between its
    own code and the kernel's at the first differing position (where the
    fed-back codes still agree, so the scores are comparable). A bf16
    near-tie gives a margin within the logit tolerance; a wrong kernel does
    not. Sampled mode scores are z + gumbel with z = logits * tinv; a code
    the twin's top-k mask dropped scores by its distance to the k-th
    largest z (a top-k boundary flip)."""
    gaps = []
    for b in torch.nonzero((got != ref).any(dim=1)).flatten().tolist():
        p = int(torch.nonzero(got[b] != ref[b])[0])
        lg = logits[p, b]
        r, g = int(ref[b, p]), int(got[b, p])
        if noise is None:
            gaps.append(float(lg[r] - lg[g]))
            continue
        z = lg * tinv
        kth = torch.topk(z, top_k).values[-1]
        if z[g] < kth:
            gaps.append(float(kth - z[g]) / tinv)
        else:
            gaps.append(float((z[r] + noise[p, b, r]) - (z[g] + noise[p, b, g]))
                        / tinv)
    return gaps


def check_codepred(w, cfg, dev, gen) -> dict:
    """Kernels vs twin at B=8 and the real widths, three ways:
    forced (every position's code fed by spiked noise, top_k off): the
    codes must be the forced ones and all logits within LOGIT_TOL;
    greedy and sampled (fixed noise, T=0.9, top_k=50) run free: the codes'
    agreement rate is reported, logits up to each stream's first
    divergence must be within LOGIT_TOL, and each divergence must be a
    near-tie of the twin's scores (margin <= LOGIT_TOL)."""
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    B, V = CODEPRED_B, cfg.code_pred_vocab_size
    hidden = torch.randn(B, cfg.hidden_size, generator=gen, device=dev) * 0.5
    cb0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    noise = cf.gumbel_noise((cf.CTX - 1, B, V), gen, dev)
    positions = torch.arange(cf.CTX - 1, device=dev)[:, None]

    def run(fn, **kw):
        logits = torch.empty(cf.CTX - 1, B, V, device=dev)
        codes = fn(w, cfg, hidden, cb0, logits_out=logits, **kw)
        return codes, logits

    worst, rates = 0.0, []
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
        ref_mode, lt = run(cf.predict_codes_twin, **kw)
        torch.cuda.synchronize()
        if mode == "greedy":
            ref = ref_mode                   # forced mode replays these
        differs = got != ref_mode
        first = torch.where(differs.any(dim=1),
                            differs.float().argmax(dim=1), cf.CTX - 1)
        upto = positions <= first[None, :]
        err = float((lk - lt).abs()[upto].max())
        gaps = _divergence_gaps(got, ref_mode, lt, 1.0 / kw["temperature"],
                                kw["top_k"], kw.get("gumbel")
                                if mode == "sampled" else None)
        agree = float((~differs).float().mean())
        log(f"codepred {mode} B={B}: code agreement {agree:.4f}, streams "
            f"agreeing {int((~differs.any(dim=1)).sum())}/{B}, max|logit "
            f"err| {err:.3e} up to first divergence (need <= {LOGIT_TOL}), "
            f"divergence margins {[round(g, 4) for g in gaps]} (need each "
            f"<= {LOGIT_TOL})")
        if mode == "forced" and not torch.equal(got, ref):
            raise AssertionError("codepred kernel ignored the forced codes")
        if not err <= LOGIT_TOL or any(g > LOGIT_TOL for g in gaps):
            raise AssertionError(f"codepred kernel disagrees with twin ({mode})")
        worst = max(worst, err)
        rates.append(agree)
    ms = cuda_time(lambda: cf.predict_codes_fused(
        w, cfg, hidden, cb0, 0.9, 50, gumbel=noise), iters=5)
    plain = cuda_time(lambda: cf.predict_codes_twin(
        w, cfg, hidden, cb0, 0.9, 50, gumbel=noise), iters=3)
    log(f"codepred B={B} one frame: kernels {ms:.3f} ms, twin {plain:.3f} ms")
    return {"name": "codepred", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/codepred.cu",
            "replaces": "qwen3_tts_tpu/ops/codepred_fused.py:425",
            "max_abs_err": worst, "code_agreement": min(rates[:2]), "ms": ms,
            "plain_ms": plain}


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


def _voc_report(name, source, replaces, errs, ms, plain) -> dict:
    """The kernel's report line; raises when any shape is out of
    tolerance (after every shape was checked and logged)."""
    worst = [max(e[i] for e in errs) for i in range(3)]
    if not (worst[1] <= VOC_MAX_TOL and worst[2] <= VOC_RMS_TOL):
        raise AssertionError(f"{name} kernel disagrees with its twin")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": worst[0],
            "max_err_over_rms": worst[1], "rms_err_over_rms": worst[2],
            "ms": ms, "plain_ms": plain}


def check_res_chain(blocks, dev, gen) -> dict:
    """The residual chain at the four decoder blocks' shapes."""
    from qwen3_tts_tpu_torch.ops import vocoder_fused as vf
    ms = plain = 0.0
    errs = []
    for blk, (c, t) in zip(blocks, CHAIN_SHAPES):
        x = torch.randn(VOC_B, t, c, generator=gen, device=dev)
        got = vf.fused_residual_chain(x, blk)
        ref = vf.residual_chain_twin(x, blk)
        errs.append(_rms_check("res_chain", got, ref,
                               f"B={VOC_B} T={t} C={c}"))
        ms += cuda_time(lambda: vf.fused_residual_chain(x, blk), iters=5)
        plain += cuda_time(lambda: vf.residual_chain_twin(x, blk), iters=5)
    log(f"res_chain, 4 decoder blocks of one 40-frame chunk at B={VOC_B}: "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms")
    return _voc_report("res_chain", "qwen3_tts_tpu_torch/csrc/vocoder.cu",
                       "qwen3_tts_tpu/ops/vocoder_fused.py:233", errs, ms,
                       plain)


def check_snake_convt(blocks, dev, gen) -> dict:
    """The Snake + convT head at the four decoder blocks' shapes."""
    from qwen3_tts_tpu_torch.ops import vocoder_fused as vf
    ms = plain = 0.0
    errs = []
    for blk, (c, c2, r, t) in zip(blocks, HEAD_SHAPES):
        x = torch.randn(VOC_B, t, c, generator=gen, device=dev)
        got = vf.fused_snake_convt(x, blk, r)
        ref = vf.snake_convt_twin(x, blk, r)
        if got.shape != (VOC_B, t * r, c2):
            raise AssertionError(f"snake_convt shape {tuple(got.shape)}")
        errs.append(_rms_check("snake_convt", got, ref,
                               f"B={VOC_B} T={t} C={c} rate={r}"))
        ms += cuda_time(lambda: vf.fused_snake_convt(x, blk, r), iters=5)
        plain += cuda_time(lambda: vf.snake_convt_twin(x, blk, r), iters=5)
    log(f"snake_convt, 4 decoder blocks of one 40-frame chunk at B={VOC_B}: "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms")
    return _voc_report("snake_convt", "qwen3_tts_tpu_torch/csrc/vocoder.cu",
                       "qwen3_tts_tpu/ops/vocoder_fused.py:151", errs, ms,
                       plain)


def _attn_cache(B, S, dev, gen):
    """Random bf16 K/V [B, 8, S, 128] and their int8 rows + scales as the
    cache stores them (stack.quantize_kv_rows)."""
    from qwen3_tts_tpu_torch.models.stack import quantize_kv_rows
    k, v = (torch.randn(B, 8, S, 128, generator=gen, device=dev).bfloat16()
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


def check_flash_decode(dev, gen) -> dict:
    """The decode-attention kernel against its twin at the talker's widths
    (16 query heads, 8 kv heads, D = 128), B = 8 and 32, S = 1,152, read_ctx
    512 / 1,024 / 1,152: prefix (ragged, 1 and read_ctx), scattered bitmask,
    ring window, wrapped window, each with an empty stream; bf16 and int8
    caches. Times kernel and twin at the serving shape (window mode,
    read_ctx 1,152)."""
    worst, timing = 0.0, {}
    for B in ATTN_B:
        caches = _attn_cache(B, ATTN_S, dev, gen)
        q = torch.randn(B, 16, 128, generator=gen, device=dev).bfloat16()
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
                log(f"flash_decode B={B} S={ATTN_S} read_ctx={read_ctx} "
                    f"{kv}: max|err| " + ", ".join(
                        f"{m} {e:.3e}" for m, e in errs.items())
                    + f" (need <= {ATTN_TOL}; empty stream exactly 0)")
                worst = max(worst, *errs.values())
            if read_ctx == ATTN_S:
                kw = cases["window"]
                for kv, (k, v, ks, vs) in caches.items():
                    timing[(B, kv)] = [cuda_time(
                        lambda t=t: _attn_call(kw, q, k, v, ks, vs, read_ctx,
                                               t), iters=20)
                        for t in (False, True)]
    for (B, kv), (ms, plain) in timing.items():
        log(f"flash_decode window mode B={B} S={ATTN_S} read_ctx={ATTN_S} "
            f"{kv}, one layer: kernel {ms:.4f} ms, twin {plain:.4f} ms")
    if not worst <= ATTN_TOL:
        raise AssertionError("flash_decode kernel disagrees with its twin")
    ms, plain = timing[(ATTN_B[0], "bf16")]
    return {"name": "flash_decode", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/flash_decode.cu",
            "replaces": "qwen3_tts_tpu/ops/flash_decode.py:255",
            "also_replaces": "qwen3_tts_tpu/ops/flash_decode.py:277",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain}


def serve_phase(engine, kv, card, counters, dev):
    """ContinuousBatcher at the full widths: 8 requests, 8 more after the
    second step, 4 more after the fourth, short and long texts alternating.
    Returns (launches per counter, device copies of the ring state at each
    step after the ring first wrapped)."""
    from qwen3_tts_tpu_torch.models.stack import QuantKV
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.runtime.generate import RING_PREFILL_SLOTS
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    os.environ["QWEN3_TTS_KV"] = kv
    cb = ContinuousBatcher(engine, n_slots=SERVE_SLOTS,
                           params=TTSParams(temperature=0.0, seed=SEED),
                           max_frames=SERVE_MAX_FRAMES)
    ring = cb.ctx - RING_PREFILL_SLOTS
    texts = [SERVE_SHORT, SERVE_LONG] * 10
    for fn in counters:
        fn.launches = 0
    fd.flash_decode.launches_by_mode.update(prefix=0, mask=0, window=0)
    fd.flash_decode.wrapped = torch.zeros(1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rids = [cb.submit(t) for t in texts[:8]]
    results, captures, n_steps = {}, [], 0
    while cb.pending():
        results.update(cb.step())
        n_steps += 1
        if n_steps in (2, 4):
            rids += [cb.submit(t) for t in
                     texts[len(rids):len(rids) + (8 if n_steps == 2 else 4)]]
        if cb._steps_done > ring and len(captures) < 3:
            # device-side copies: no host sync in the serving loop
            st = cb.state
            cache = st.kv_cache
            if isinstance(cache, QuantKV):
                kvl = (cache.values[0, 0], cache.values[0, 1],
                       cache.scales[0, 0], cache.scales[0, 1])
            else:
                kvl = (cache[0, 0], cache[0, 1], None, None)
            captures.append(dict(
                kv=kv, mask=st.valid_mask.clone(), lo=st.ring_lo.clone(),
                hi=st.write_slot.clone(), done=st.done.clone(),
                cache=tuple(None if t is None else t.clone() for t in kvl),
                read_ctx=cb.ctx))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ran = [fn.launches for fn in counters]
    modes = dict(fd.flash_decode.launches_by_mode)
    wrapped = int(fd.flash_decode.wrapped.item())
    fd.flash_decode.wrapped = None
    spf = engine.voc_cfg.samples_per_frame
    frames = [results[r].n_frames for r in rids]
    for r in rids:
        res = results[r]
        if not res.success:
            raise AssertionError(f"serving request {r} failed: "
                                 f"{res.error_msg}")
        if not np.isfinite(res.audio).all():
            raise AssertionError("non-finite audio")
        if len(res.audio) != res.n_frames * spf:
            raise AssertionError(f"{len(res.audio)} samples for "
                                 f"{res.n_frames} frames")
    n_cap = sum(f == cb.max_frames for f in frames)
    n_eos = sum(f < cb.max_frames for f in frames)
    audio_s = (sum(len(results[r].audio) for r in rids)
               / engine.voc_cfg.sample_rate)
    log(f"ContinuousBatcher kv={kv} slots={SERVE_SLOTS} max_frames="
        f"{SERVE_MAX_FRAMES}: {len(rids)} requests ({len(rids) - 8} "
        f"submitted mid-run), {n_steps} steps, frames {frames} ({n_cap} "
        f"retired by the frame cap, {n_eos} by EOS), {sum(frames)} frames, "
        f"{audio_s:.2f} s of audio in {wall:.2f} s wall on {card}; ring of "
        f"{ring} slots, {cb._steps_done} ring writes; kernel launches "
        f"codepred/res_chain/snake_convt/flash_decode {ran}, flash_decode "
        f"by mode {modes}, streams served with a wrapped window {wrapped}")
    if min(ran) <= 0 or modes["window"] <= 0:
        raise AssertionError(f"a kernel was not launched in serving: {ran}")
    if not (n_cap and n_eos and cb._steps_done > ring and wrapped > 0):
        raise AssertionError("serving did not retire by cap and by EOS and "
                             "wrap the ring")
    return ran, captures


def check_captured(captures, dev, gen) -> None:
    """The kernel against its twin on valid_mask / ring_lo / write_slot and
    layer-0 K/V captured from the live ring after it wrapped."""
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.runtime.generate import RING_PREFILL_SLOTS
    n_wrapped = 0
    for c in captures:
        k, v, ks, vs = c["cache"]
        B = k.shape[0]
        q = torch.randn(B, 16, 128, generator=gen, device=dev).bfloat16()
        kw = dict(window_lo=c["lo"], window_hi=c["hi"],
                  prefill_len=RING_PREFILL_SLOTS, read_ctx=c["read_ctx"],
                  k_scale=ks, v_scale=vs)
        got = fd.flash_decode_masked(q, k, v, c["mask"], **kw)
        ref = fd.flash_decode_twin(q, k, v, valid_mask=c["mask"], **kw)
        err = (got - ref).abs().max().item()
        live_wrapped = int(((c["lo"] > c["hi"]) & ~c["done"]).sum())
        n_wrapped += live_wrapped
        log(f"flash_decode on a live ring after its wrap ({c['kv']}, "
            f"write_slot {int(c['hi'])}, ring_lo {c['lo'].tolist()}, "
            f"{live_wrapped} live streams wrapped): max|err| {err:.3e} "
            f"(need <= {ATTN_TOL})")
        if not err <= ATTN_TOL:
            raise AssertionError("flash_decode disagrees on a live ring")
    if not captures or n_wrapped == 0:
        raise AssertionError("no live ring state with a wrapped window")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    from qwen3_tts_tpu.config import (TalkerConfig, TokenizerSpecialTokens,
                                      VocoderConfig)
    from qwen3_tts_tpu.tokenizer import TextTokenizer
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.ops import codepred_fused as cf
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.ops import vocoder_fused as vf
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams

    # the twins hold f32 products of bf16 values: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, card = device_info()
    t0 = time.monotonic()
    lib_path = kernels.build()
    kernels.lib()
    log(f"built {lib_path.name} in {time.monotonic() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg, vcfg = TalkerConfig(), VocoderConfig()
    t0 = time.monotonic()
    talker_w = W.init_talker_weights(cfg, gen, dev)
    voc_w = W.init_vocoder_weights(vcfg, gen, dev)
    torch.cuda.synchronize()
    log(f"random full-width weights on the card in "
        f"{time.monotonic() - t0:.1f} s")

    # phase 2: every kernel against its twin; all run, then any failure
    # stops the script before the synthesis phase
    report, failed = [], []
    blocks = decoder_blocks(vcfg, dev, gen)
    for check, args in ((check_codepred, (talker_w, cfg, dev, gen)),
                        (check_res_chain, (blocks, dev, gen)),
                        (check_snake_convt, (blocks, dev, gen)),
                        (check_flash_decode, (dev, gen))):
        try:
            report.append(check(*args))
        except Exception:
            traceback.print_exc()
            failed.append(check.__name__)
    if failed:
        raise SystemExit(f"kernel checks failed: {failed}")

    # full-width synthesis through the user's entry point
    tokens = ["<|im_start|>", "<|im_end|>", "assistant", "Ċ", "h", "e", "l",
              "o", "Ġ", "w", "r", "d", ".", "he", "ll", "hell", "hello",
              "Ġw", "Ġwo"]
    merges = ["h e", "l l", "he ll", "hell o", "Ġ w", "Ġw o"]
    tok = TextTokenizer(tokens, merges, TokenizerSpecialTokens(
        bos_token_id=0, eos_token_id=1, pad_token_id=1))
    engine = Qwen3TTS.from_components(tok, cfg, talker_w, vcfg, voc_w, dev)
    texts = ["hello world.", "hello hello world.", "world hello.",
             "hello world hello world."]
    counters = (cf.predict_codes_fused, vf.fused_residual_chain,
                vf.fused_snake_convt, fd.flash_decode)
    for fn in counters:
        fn.launches = 0
    spf = vcfg.samples_per_frame
    for kv in ("bf16", "int8"):
        os.environ["QWEN3_TTS_KV"] = kv
        for temperature in (0.0, 0.9):
            before = [fn.launches for fn in counters]
            params = TTSParams(max_audio_tokens=120, temperature=temperature,
                               seed=SEED)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = engine.synthesize_batch(
                texts, params=params,
                generator=torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            for r in res:
                if not r.success:
                    raise AssertionError(f"synthesis failed: {r.error_msg}")
                if not np.isfinite(r.audio).all():
                    raise AssertionError("non-finite audio")
                if len(r.audio) != r.n_frames * spf:
                    raise AssertionError(f"{len(r.audio)} samples for "
                                         f"{r.n_frames} frames")
            ran = [fn.launches - b for fn, b in zip(counters, before)]
            if min(ran) <= 0:
                raise AssertionError(f"a kernel was not launched: {ran}")
            audio_s = sum(len(r.audio) for r in res) / vcfg.sample_rate
            log(f"synthesize_batch kv={kv} temperature={temperature}: "
                f"{len(res)} requests, frames {[r.n_frames for r in res]}, "
                f"{audio_s:.2f} s of audio in {wall:.2f} s wall "
                f"(generate {res[0].t_generate_ms:.0f} ms, decode "
                f"{res[0].t_decode_ms:.0f} ms) on {card}; kernel launches "
                f"codepred/res_chain/snake_convt/flash_decode {ran}")
    lockstep = [fn.launches for fn in counters]

    serving, captured = [0] * len(counters), []
    for kv in ("bf16", "int8"):
        ran, caps = serve_phase(engine, kv, card, counters, dev)
        serving = [a + b for a, b in zip(serving, ran)]
        captured += caps
    check_captured(captured, dev, gen)
    for entry, a, b in zip(report, lockstep, serving):
        entry.update(launches=a + b, launches_lockstep=a,
                     launches_serving=b)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
