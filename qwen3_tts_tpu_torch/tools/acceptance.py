"""Real-weight acceptance run on the port alone (the port of
tools/acceptance.py): ONE command that validates the whole stack the
moment checkpoints are available.

  1. convert   HF checkpoints -> GGUF model dir (tools/convert_checkpoints)
  2. parity    per-stage activation diff against an independent torch
               reference, both passes (tools/parity.run_parity, in this
               process)
  3. tokenizer golden vectors — the exact ids from the reference's test
               (tests/test_tokenizer.cpp:13-15): encode("Hello.") must
               contain [9707, 13] and encode_for_tts("Hello.") must equal
               [151644, 77091, 198, 9707, 13, 151645, 198,
                151644, 77091, 198]; round-trip decode
  4. synth     load_models -> synthesize (greedy) -> WAV: sample-count
               arithmetic (n_frames x samples/frame), WAV round-trip,
               optional duration A/B vs a reference WAV
  5. cloning   encode a speaker embedding from the reference WAV
               (.embd cache format parity, main.cpp:38-59)

The steps and their names in the JSON report are the JAX tool's. Every
step runs end-to-end on synthetic checkpoints; --real additionally
enforces the golden tokenizer vectors, which only hold for the true Qwen2
vocab. The model runs on --device (default cuda).

Usage (real weights):
  python -m qwen3_tts_tpu_torch.tools.acceptance --hf-tts <hf_tts_dir> \\
      --hf-codec <hf_codec_dir> --work /tmp/accept --real \\
      [--ref-wav voice.wav]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from ..io.gguf import GGUFReader
from ..models import vocoder as voc_mod
from ..runtime import audio_io
from ..runtime.pipeline import CODEC_FILE, TTS_FILE, Qwen3TTS, TTSParams
from ..tokenizer import TextTokenizer
from . import convert_checkpoints as cc
from . import parity

# Golden vectors from the reference's tokenizer test
# (tests/test_tokenizer.cpp:13-15 of the reference project)
GOLDEN_TEXT = "Hello."
GOLDEN_ENCODE_SUBSEQ = [9707, 13]
GOLDEN_ENCODE_FOR_TTS = [151644, 77091, 198, 9707, 13, 151645, 198,
                         151644, 77091, 198]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _check(name: str, ok: bool, detail: str = "") -> dict:
    status = "OK" if ok else "FAIL"
    log(f"[accept] {name}: {status}{(' — ' + detail) if detail else ''}")
    return {"step": name, "ok": bool(ok), "detail": detail}


def run_acceptance(hf_tts: Path, hf_codec: Path, work: Path, *,
                   real: bool = False, ref_wav: Path | None = None,
                   ab_wav: Path | None = None,
                   out_type: str = "f16", text: str = GOLDEN_TEXT,
                   max_tokens: int = 64, device="cuda",
                   parity_report: list | None = None) -> list[dict]:
    """Run the full acceptance sequence on `device`; returns a list of
    step results, each with the seconds since the previous one's.
    real=True additionally enforces the golden tokenizer vectors (valid
    only for the true 151k-token Qwen2 vocab). parity_report receives
    run_parity's per-stage records."""
    results: list[dict] = []
    mark = time.perf_counter()

    def check(name: str, ok: bool, detail: str = "") -> dict:
        nonlocal mark
        now = time.perf_counter()
        r = {**_check(name, ok, detail), "seconds": now - mark}
        mark = now
        return r

    work.mkdir(parents=True, exist_ok=True)
    mdir = work / "models"
    mdir.mkdir(exist_ok=True)

    # -- 1. convert: the model-dir layout load_models opens, whatever the
    # quantization
    tts_gguf = mdir / TTS_FILE
    codec_gguf = mdir / CODEC_FILE
    cc.convert_tts(Path(hf_tts), tts_gguf, out_type)
    # the codec is always f16, as the setup driver writes it
    cc.convert_codec(Path(hf_codec), codec_gguf, "f16")
    results.append(check(
        "convert", tts_gguf.exists() and codec_gguf.exists(),
        f"{tts_gguf.name} ({tts_gguf.stat().st_size >> 20} MiB), "
        f"{codec_gguf.name} ({codec_gguf.stat().st_size >> 20} MiB)"))

    # -- 2. parity vs the independent torch reference ---------------------
    try:
        failures, _ = parity.run_parity(
            Path(hf_tts), Path(hf_codec), device,
            out=work / "parity.npz", report=parity_report)
        results.append(check(
            "parity", not failures,
            f"PARITY FAIL: {failures}" if failures else "PARITY OK"))
    except Exception as e:  # noqa: BLE001 — record it and keep going
        # the harness must emit its JSON report even when one step fails
        traceback.print_exc()
        results.append(check("parity", False, f"{type(e).__name__}: {e}"))

    # -- 3. tokenizer golden vectors (from the converted GGUF) -----------
    with GGUFReader(str(tts_gguf)) as _r:
        tok = TextTokenizer.from_gguf(_r)
    golden_text = GOLDEN_TEXT if real else text
    ids = tok.encode(golden_text)
    tts_ids = tok.encode_for_tts(golden_text)
    roundtrip = tok.decode(ids)
    if real:
        def subseq(needle, hay):
            return any(hay[i:i + len(needle)] == needle
                       for i in range(len(hay) - len(needle) + 1))
        ok = (subseq(GOLDEN_ENCODE_SUBSEQ, list(ids))
              and list(tts_ids) == GOLDEN_ENCODE_FOR_TTS
              and roundtrip == golden_text)
        results.append(check(
            "tokenizer_goldens", ok,
            f"encode={list(ids)} encode_for_tts={list(tts_ids)}"))
    else:
        # a synthetic vocab may not round-trip spaces (unknown byte tokens
        # are skipped); only require the encode paths to execute. --real
        # enforces the exact golden ids + round-trip.
        results.append(check(
            "tokenizer_roundtrip",
            isinstance(roundtrip, str) and len(tts_ids) > 0,
            "synthetic vocab; golden ids enforced with --real"))

    # -- 4. synthesis -> WAV arithmetic ----------------------------------
    tts = Qwen3TTS()
    ok = tts.load_models(str(mdir), device)
    results.append(check("load_models", ok, tts.error_msg if not ok else ""))
    params = TTSParams(max_audio_tokens=max_tokens, temperature=0.0,
                       seed=0, print_timing=False)
    res = tts.synthesize(text, params)
    if tts.voc_w is not None:
        expect = voc_mod.vocoder_output_length(tts.voc_w, tts.voc_cfg,
                                               res.n_frames, trim="causal")
        synth_ok = (res.success and res.n_frames >= 1
                    and len(res.audio) == expect)
        detail = (f"{res.n_frames} frames, {len(res.audio)} samples "
                  f"(expect {expect}), {res.t_total_ms:.0f} ms")
    else:  # load_models failed above; record rather than crash on None
        synth_ok, detail = False, "vocoder not loaded"
    results.append(check("synthesize", synth_ok, detail))

    wav = work / "accept.wav"
    audio_io.save_wav(str(wav), res.audio, res.sample_rate)
    samples, sr = audio_io.load_wav(str(wav))
    q = np.clip(np.round(res.audio * 32767.0), -32768, 32767) / 32768.0
    results.append(check(
        "wav_roundtrip", sr == res.sample_rate and len(samples) ==
        len(res.audio) and np.allclose(samples, q, atol=1 / 32768),
        f"{len(samples)} samples @ {sr} Hz"))

    if ab_wav is not None:
        # A/B duration vs audio the C++ reference synthesized for the
        # SAME text: greedy runs should land within 25% (frame counts may
        # differ by a few EOS frames)
        ref_samples, ref_sr = audio_io.load_wav(str(ab_wav))
        dur = len(res.audio) / res.sample_rate
        ref_dur = len(ref_samples) / ref_sr
        results.append(check(
            "duration_ab", 0.75 <= dur / max(ref_dur, 1e-9) <= 1.25,
            f"ours {dur:.2f}s vs reference {ref_dur:.2f}s"))

    if ref_wav is not None:
        # -- 5. voice cloning + .embd cache format -----------------------
        emb = tts.encode_speaker(str(ref_wav))
        embd_path = work / "accept.embd"
        ok = (emb is not None and emb.ndim == 1
              and audio_io.save_embedding(str(embd_path), emb))
        back = audio_io.load_embedding(str(embd_path)) if ok else None
        results.append(check(
            "speaker_embd", ok and back is not None
            and np.array_equal(back, emb.astype(np.float32)),
            f"{0 if emb is None else len(emb)} floats (raw f32 .embd, "
            "main.cpp:38-59 format)"))
        if emb is None:
            results.append(check("synthesize_cloned", False,
                                  f"no embedding: {tts.error_msg}"))
        else:
            res_v = tts.synthesize_with_embedding(text, emb, params)
            results.append(check(
                "synthesize_cloned", res_v.success and res_v.n_frames >= 1,
                f"{res_v.n_frames} frames"))

    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hf-tts", type=Path, required=True,
                    help="HF checkpoint dir (config.json + safetensors)")
    ap.add_argument("--hf-codec", type=Path, required=True,
                    help="HF speech-codec checkpoint dir")
    ap.add_argument("--work", type=Path, default=Path("accept_work"))
    ap.add_argument("--real", action="store_true",
                    help="enforce the golden tokenizer vectors (real "
                         "Qwen2 vocab only)")
    ap.add_argument("--ref-wav", type=Path, default=None,
                    help="speaker reference WAV: voice-clone + .embd path")
    ap.add_argument("--ab-wav", type=Path, default=None,
                    help="WAV the C++ reference synthesized for --text: "
                         "duration A/B")
    ap.add_argument("--type", default="f16",
                    choices=["f32", "f16", "q8_0", "q4_0", "q4_k"])
    ap.add_argument("--text", default=GOLDEN_TEXT)
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="device the model runs on (default cuda)")
    args = ap.parse_args(argv)

    results = run_acceptance(args.hf_tts, args.hf_codec, args.work,
                             real=args.real, ref_wav=args.ref_wav,
                             ab_wav=args.ab_wav,
                             out_type=args.type, text=args.text,
                             max_tokens=args.max_tokens, device=args.device)
    print(json.dumps(results, indent=2))
    if all(r["ok"] for r in results):
        log(f"ACCEPTANCE OK ({len(results)} steps)")
        return 0
    log("ACCEPTANCE FAILED:")
    for r in results:
        if not r["ok"]:
            log(f"  - {r['step']}: {r['detail']}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
