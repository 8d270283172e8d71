"""The port's slice end to end: text -> lock-step generation -> streaming
vocoder -> PCM, against the JAX package's pipeline on the same tiny
weights (CPU); the port free of JAX; chip_smoke.py refusing to run
without a card."""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu.runtime import pipeline as jpipe  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe  # noqa: E402
from qwen3_tts_tpu_torch.runtime import stream as tstream  # noqa: E402
from qwen3_tts_tpu_torch.utils import trace  # noqa: E402

from .test_tokenizer import make_tiny_tokenizer  # noqa: E402
from .test_torch_config import port_cfg, port_tokenizer  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TEXTS = ["hello world.", "hello hello world hello.", "world."]


@pytest.fixture(scope="module")
def engines():
    # weights under which no code of these frames sits at a bf16 near-tie
    # (other seeds flip a code-predictor argmax at a ~1e-3 logit margin
    # and the streams part from there, as ROADMAP.md C describes)
    rng = np.random.default_rng(52)
    cfg = tiny_talker_config()
    jw = init_talker_weights(rng, cfg)
    vcfg = dataclasses.replace(jvoc.tiny_vocoder_config(),
                               codebook_size=2048)
    jvw = jvoc.init_vocoder_weights(rng, vcfg)
    tok = make_tiny_tokenizer()
    jeng = jpipe.Qwen3TTS.from_components(tok, cfg, jw, vcfg, jvw)
    teng = tpipe.Qwen3TTS.from_components(
        port_tokenizer(tok), port_cfg(cfg),
        W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw), "cpu"),
        port_cfg(vcfg),
        W.vocoder_weights_from_numpy(jax.tree.map(np.asarray, jvw), "cpu"),
        "cpu")
    return jeng, teng


def test_synthesize_batch_matches_jax(engines):
    """Greedy streaming synthesis (a full 40-frame chunk and a flushed
    tail): the same frames per stream, and the same int16 PCM up to a
    step."""
    jeng, teng = engines
    kw = dict(max_audio_tokens=56, temperature=0.0, seed=0)
    want = jeng.synthesize_batch(TEXTS, params=jpipe.TTSParams(
        print_timing=False, **kw))
    got = teng.synthesize_batch(TEXTS, params=tpipe.TTSParams(**kw))
    for g, w in zip(got, want):
        assert g.success and w.success, (g.error_msg, w.error_msg)
        assert g.n_frames == w.n_frames
        assert len(g.audio) == g.n_frames * 64     # tiny: 4*2^4 per frame
        np.testing.assert_allclose(g.audio, w.audio, atol=2.5 / 32767)


def test_streaming_chunks_sampled(engines):
    _, teng = engines
    seen = []
    t0 = time.monotonic_ns()
    res = teng.synthesize_batch(
        TEXTS, params=tpipe.TTSParams(max_audio_tokens=48, temperature=0.9,
                                      seed=3),
        on_chunk=lambda b, pcm: seen.append((b, len(pcm))))
    for b, r in enumerate(res):
        assert r.success and np.isfinite(r.audio).all()
        assert sum(n for s, n in seen if s == b) == len(r.audio)
    # the call's own spans: t_total_ms is timed inside its `call` span,
    # which holds its prefill, dispatches and decodes
    spans = trace.spans(t0)
    call = [s for s in spans if s.name == "call"]
    assert len(call) == 1 and call[0].attrs == {"streams": len(TEXTS)}
    assert 0.0 < res[0].t_total_ms <= call[0].ms
    inner = [s for s in spans if s.name != "call"]
    assert {s.name for s in inner} >= {"call.tokenize", "call.prefill",
                                       "call.dispatch", "call.decode",
                                       "call.tail_flush"}
    assert all(call[0].t0 <= s.t0 <= s.t1 <= call[0].t1 for s in inner)


def test_call_spans_flush_and_decodes(engines, capsys):
    """One synthesize_batch: one call.tail_flush after the last dispatch,
    a call.decode per vocoder wave (rows <= bucket) and one for the
    ragged tails, inside the flush (one row a stream with a tail, in the
    bucket that covers them), and the ``Timing:`` report read from those
    spans."""
    _, teng = engines
    t0 = time.monotonic_ns()
    res = teng.synthesize_batch(
        TEXTS, params=tpipe.TTSParams(max_audio_tokens=52, temperature=0.9,
                                      seed=5))
    assert all(r.success for r in res)
    spans = trace.spans(t0)
    call = next(s for s in spans if s.name == "call")
    flush = [s for s in spans if s.name == "call.tail_flush"]
    assert len(flush) == 1 and flush[0].parent == call.sid
    assert max(s.t1 for s in spans if s.name == "call.dispatch") \
        <= flush[0].t0
    decodes = [s for s in spans if s.name == "call.decode"]
    assert all(1 <= s.attrs["rows"] <= s.attrs["bucket"] for s in decodes)
    waves = [s for s in decodes if s.parent == call.sid]
    tails = [s for s in decodes if s.parent == flush[0].sid]
    assert len(waves) + len(tails) == len(decodes)
    # one 40-frame wave of every stream that reached 40 frames, then one
    # wave of every stream with a ragged tail
    full = sum(r.n_frames >= 40 for r in res)
    assert [s.attrs["rows"] for s in waves] == ([full] if full else [])
    rows = sum(r.n_frames % 40 > 0 for r in res)
    assert rows > 0 and [s.attrs for s in tails] == [
        {"rows": rows, "bucket": teng.voc_bucket(rows, len(TEXTS))}]
    err = capsys.readouterr().err
    for line in ("Timing:", "Tokenization:", "Prefill:", "Vocoder decode:",
                 "Tail flush:", "Total:", "RTF="):
        assert line in err


def _record_streams(monkeypatch, seen):
    """seen["streams"]: the StreamCodes of each later synthesize_batch
    call, the codes the loop hands to the vocoder."""
    alloc = tstream.StreamCodes.alloc

    def record(*a, **kw):
        seen["streams"] = alloc(*a, **kw)
        return seen["streams"]

    monkeypatch.setattr(tstream.StreamCodes, "alloc", record)


def _stream_codes(seen):
    return [s.buf[:s.n_frames] for s in seen["streams"]]


# frames each stream keeps, each at most what it makes greedily before
# its EOS: fewer than one chunk, a chunk boundary, and three ragged tails
# of other lengths
TAIL_FRAMES = (23, 80, 57, 62, 75)


def test_tail_wave_pairs_rows_with_callbacks(engines, monkeypatch):
    """Streams cut at TAIL_FRAMES (their later frames marked invalid):
    every on_chunk carries the samples of the next row of the latest
    vocoder decode, in row order (the pairing the benchmark's code tap
    relies on); the last decode holds each ragged tail, zero-padded, in
    stream order, and its callbacks are the rows trimmed to the tail's
    length; a stream ending on a chunk boundary gets no tail callback;
    each stream's audio is its chunked decode up to 2 int16 steps."""
    _, teng = engines
    texts = (TEXTS * 2)[:len(TAIL_FRAMES)]
    gen_fn, inner = teng._gen_fn, teng._decode_chunk_batch
    steps, seen, decodes, calls = [0], {}, [], []

    def cut(*a, **kw):
        run = gen_fn(*a, **kw)

        def chunk():
            codes, valid = run()
            f = steps[0] + torch.arange(tpipe.CHUNK_FRAMES)[:, None]
            valid &= f < torch.tensor(TAIL_FRAMES)
            steps[0] += tpipe.CHUNK_FRAMES
            return codes, valid
        return chunk

    def decode(codes, *a, **kw):
        out = inner(codes, *a, **kw)
        decodes.append((np.array(codes, copy=True),
                        np.array(out, copy=True), 0))
        return out

    def on_chunk(b, pcm):
        rows, out, i = decodes[-1]
        decodes[-1] = (rows, out, i + 1)
        calls.append((b, len(decodes) - 1, i, pcm))

    monkeypatch.setattr(teng, "_gen_fn", cut)
    monkeypatch.setattr(teng, "_decode_chunk_batch", decode)
    _record_streams(monkeypatch, seen)
    res = teng.synthesize_batch(texts, params=tpipe.TTSParams(
        max_audio_tokens=120, temperature=0.0, seed=0), on_chunk=on_chunk)
    monkeypatch.undo()
    assert [r.n_frames for r in res] == list(TAIL_FRAMES)
    frames = _stream_codes(seen)
    for b, k, i, pcm in calls:
        np.testing.assert_array_equal(
            pcm, decodes[k][1][i][:len(pcm)].astype(np.float32) / 32767.0)
    tails = [b for b, n in enumerate(TAIL_FRAMES) if n % 40]
    last = len(decodes) - 1
    assert [(b, i) for b, k, i, _ in calls if k == last] == [
        (b, i) for i, b in enumerate(tails)]
    assert len(decodes[last][0]) == teng.voc_bucket(len(tails), len(texts))
    for i, b in enumerate(tails):
        n = TAIL_FRAMES[b] % 40
        want = np.zeros((40, 16), np.int32)
        want[:n] = frames[b][-n:]
        np.testing.assert_array_equal(decodes[last][0][i], want)
        pcm = next(p for c, k, _, p in calls if c == b and k == last)
        assert len(pcm) == tpipe.vocoder.vocoder_output_length(
            teng.voc_w, teng.voc_cfg, n, trim="causal")
    for b, r in enumerate(res):
        assert [c for c, _, _, _ in calls].count(b) == -(-r.n_frames // 40)
        np.testing.assert_allclose(
            r.audio, teng.decode_codes_chunked(frames[b]), atol=2 / 32767)


def test_decode_codes_chunked_length(engines):
    _, teng = engines
    frames = np.random.default_rng(2).integers(0, 256, (50, 16)).astype(
        np.int32)
    audio = teng.decode_codes_chunked(frames, chunk=40)
    assert audio.shape == (50 * 64,)
    assert teng.voc_bucket(3, 16) == 4 and teng.voc_bucket(20, 16) == 16


def _vocoderless(engines):
    """Both engines' weights and tokenizer, without a vocoder."""
    jeng, teng = engines
    return (jpipe.Qwen3TTS.from_components(jeng.tokenizer, jeng.talker_cfg,
                                           jeng.talker_w, jeng.voc_cfg, None),
            tpipe.Qwen3TTS.from_components(teng.tokenizer, teng.talker_cfg,
                                           teng.talker_w, teng.voc_cfg, None,
                                           "cpu"))


@pytest.mark.parametrize("max_tokens", [0, 56])
def test_vocoderless_engine_matches_jax(engines, max_tokens):
    """An engine made with voc_w=None builds and still generates codes;
    each stream reports what the JAX engine reports (frames, success,
    message, rate): "No speech codes generated" with no frame, else
    "Vocoder not loaded", and no audio. Exact: no tolerance."""
    jeng, teng = _vocoderless(engines)
    assert teng.voc_w is None
    kw = dict(max_audio_tokens=max_tokens, temperature=0.0, seed=0)
    want = jeng.synthesize_batch(TEXTS, params=jpipe.TTSParams(
        print_timing=False, **kw))
    got = teng.synthesize_batch(TEXTS, params=tpipe.TTSParams(**kw))
    for g, w in zip(got, want):
        assert (g.n_frames, g.success, g.error_msg, g.sample_rate) == (
            w.n_frames, w.success, w.error_msg, w.sample_rate)
        assert len(g.audio) == 0
    assert [g.error_msg for g in got] == [
        "Vocoder not loaded" if max_tokens else "No speech codes generated"
    ] * len(TEXTS)


def _jax_chunk_draws(key, B, cfg):
    """The Gumbel noise of one lock-step chunk of the JAX loop, drawn
    from its state key as generate_chunk splits it (per frame: key, CB0
    key, code-predictor key; the code predictor splits once per sampled
    codebook): [chunk, B, codec_vocab] and [chunk, 15, B, V]."""
    cb0, codes = [], []
    for _ in range(tpipe.CHUNK_FRAMES):
        key, k_cb0, k_codes = jax.random.split(key, 3)
        cb0.append(np.array(jax.random.gumbel(
            k_cb0, (B, cfg.codec_vocab_size), np.float32)))
        rows = []
        for _ in range(cfg.n_codebooks - 1):
            k_codes, sub = jax.random.split(k_codes)
            rows.append(np.array(jax.random.gumbel(
                sub, (B, cfg.code_pred_vocab_size), np.float32)))
        codes.append(np.stack(rows))
    return torch.from_numpy(np.stack(cb0)), torch.from_numpy(np.stack(codes))


def _recorded_run(mod, eng, params, monkeypatch, keys=None):
    """synthesize_batch with its chunks, frames and on_chunk calls
    recorded: (results, codes per stream, chunks dispatched, on_chunk
    calls per stream). keys: the JAX loop's state key at each chunk is
    appended to it (JAX), or its chunks' draws are passed to the port's
    frames (port)."""
    seen = {"chunks": 0, "frames": None}
    calls = [0] * len(TEXTS)
    if mod is jpipe:
        decode = eng._decode_streaming

        def record_frames(frames, *a):
            seen["frames"] = frames
            return decode(frames, *a)

        monkeypatch.setattr(eng, "_decode_streaming", record_frames)
        chunk = jpipe.generate_chunk

        def counted(w, cfg, state, *a, **kw):
            seen["chunks"] += 1
            if keys is not None:
                keys.append(np.asarray(state.key))   # donated below
            return chunk(w, cfg, state, *a, **kw)

        monkeypatch.setattr(jpipe, "generate_chunk", counted)
    else:
        gen_fn = eng._gen_fn

        def counted_gen_fn(*a, **kw):
            run = gen_fn(*a, **kw)

            def chunk():
                seen["chunks"] += 1
                return run()
            return chunk

        monkeypatch.setattr(eng, "_gen_fn", counted_gen_fn)
        _record_streams(monkeypatch, seen)
        if keys is not None:
            frame = tpipe.generate_frame
            draws, n = {}, [0]

            def with_draws(w, cfg, state, *a, **kw):
                k, f = divmod(n[0], tpipe.CHUNK_FRAMES)
                if k not in draws:
                    draws[k] = _jax_chunk_draws(keys[k], len(TEXTS), cfg)
                n[0] += 1
                return frame(w, cfg, state, *a, cb0_gumbel=draws[k][0][f],
                             codes_gumbel=draws[k][1][f], **kw)

            monkeypatch.setattr(tpipe, "generate_frame", with_draws)

    def on_chunk(b, pcm):
        calls[b] += 1

    res = eng.synthesize_batch(TEXTS, params=params, on_chunk=on_chunk)
    codes = ([np.concatenate(f) if f else np.zeros((0, 16), np.int32)
              for f in seen["frames"]] if mod is jpipe else
             _stream_codes(seen))
    monkeypatch.undo()
    return res, codes, seen["chunks"], calls


# (temperature, KV cache, max_audio_tokens, seed): 400 frames end every
# stream by EOS before the chunk cap, 56 cut the longest streams at the
# cap. The sampled seeds are ones whose streams do not part from the JAX
# package's: with other draws a stream can (seed 0 with int8: stream 2,
# frame 34, codebook 13), and the unpipelined loop gives the same codes
# bitwise as this one there, so the parting comes from the two packages'
# rounding (ROADMAP.md C, bf16 near-ties), not from the loop's order
LOOP_CASES = {"greedy-bf16-cap": (0.0, "bf16", 56, 0),
              "greedy-int8-eos": (0.0, "int8", 400, 0),
              "sampled-bf16-eos": (0.9, "bf16", 400, 0),
              "sampled-int8-cap": (0.9, "int8", 56, 2)}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_pipelined_loop_matches_jax(engines, monkeypatch, case):
    """The pipelined lock-step loop against the JAX loop, at the tiny
    dims: codes exact (sampled: the JAX loop's draws passed in), the int16
    PCM up to a step (2.5 / 32767, as above), the same number of chunks
    dispatched and of on_chunk calls per stream; the EOS cases end before
    the chunk cap, the cap cases cut a stream at max_audio_tokens."""
    temperature, kv, max_tokens, seed = LOOP_CASES[case]
    jeng, teng = engines
    keys = [] if temperature > 0 else None
    kw = dict(max_audio_tokens=max_tokens, temperature=temperature,
              seed=seed)
    monkeypatch.setenv("QWEN3_TTS_KV", kv)
    want, wcodes, wchunks, wcalls = _recorded_run(
        jpipe, jeng, jpipe.TTSParams(print_timing=False, **kw), monkeypatch,
        keys)
    monkeypatch.setenv("QWEN3_TTS_KV", kv)
    got, gcodes, gchunks, gcalls = _recorded_run(
        tpipe, teng, tpipe.TTSParams(**kw), monkeypatch, keys)
    assert gchunks == wchunks and gcalls == wcalls
    n_chunks = -(-max_tokens // tpipe.CHUNK_FRAMES)
    frames = [r.n_frames for r in got]
    if case.endswith("eos"):
        assert gchunks < n_chunks and max(frames) < max_tokens
    else:
        assert gchunks == n_chunks and max(frames) == max_tokens
    for g, w, gc, wc in zip(got, want, gcodes, wcodes):
        assert g.success and w.success, (g.error_msg, w.error_msg)
        np.testing.assert_array_equal(gc, wc)
        assert g.n_frames == w.n_frames == len(gc)
        np.testing.assert_allclose(g.audio, w.audio, atol=2.5 / 32767)


def test_loop_enqueues_next_chunk_before_decoding(engines, monkeypatch):
    """Chunk k+1 is dispatched before chunk k's codes are read and
    decoded: the order of chunk dispatches ("gen"), reads of a chunk's
    copies ("read") and vocoder waves ("decode") is gen, then (gen, read)
    per later chunk, then the last read, with every wave after a read
    (the first chunk's right after its read) and the tails' wave last."""
    _, teng = engines
    events = []
    gen_fn, take, wave = (teng._gen_fn, tstream.ChunkCopies.take,
                          tpipe.decode_wave)

    def gen(*a, **kw):
        run = gen_fn(*a, **kw)

        def chunk():
            events.append("gen")
            return run()
        return chunk

    def read(copies):
        events.append("read")
        return take(copies)

    def dec(*a, **kw):
        events.append("decode")
        return wave(*a, **kw)

    monkeypatch.setattr(teng, "_gen_fn", gen)
    monkeypatch.setattr(tstream.ChunkCopies, "take", read)
    monkeypatch.setattr(tpipe, "decode_wave", dec)
    res = teng.synthesize_batch(TEXTS, params=tpipe.TTSParams(
        max_audio_tokens=400, temperature=0.0, seed=0))
    n = events.count("gen")
    assert n >= 2 and all(r.success for r in res)
    assert [e for e in events if e != "decode"] == (
        ["gen"] + ["gen", "read"] * (n - 1) + ["read"])
    assert events[:4] == ["gen", "gen", "read", "decode"]
    assert all(prev != "gen" for prev, e in zip(events, events[1:])
               if e == "decode")
    assert events[-1] == "decode"


def test_port_imports_no_jax():
    """Every module of the port imports (the CLI, GGUF, speaker-encoder,
    trace and audio modules by name), and a tiny synthesis and speaker
    encode run, in a process where importing jax or anything of the JAX
    package fails; no module of either is loaded afterwards."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["qwen3_tts_tpu"] = None
        import importlib, pkgutil, dataclasses
        import qwen3_tts_tpu_torch as P
        for m in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
            importlib.import_module(m.name)
        for name in ("cli", "io.gguf", "models.speaker_encoder",
                     "utils.trace", "runtime.audio_io"):
            importlib.import_module("qwen3_tts_tpu_torch." + name)
        import torch
        from qwen3_tts_tpu_torch.config import TokenizerSpecialTokens
        from qwen3_tts_tpu_torch.tokenizer import TextTokenizer
        from qwen3_tts_tpu_torch.models import weights as W
        from qwen3_tts_tpu_torch.models.vocoder import tiny_vocoder_config
        from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
        torch.set_num_threads(2)
        gen = torch.Generator().manual_seed(0)
        cfg = W.tiny_talker_config()
        vcfg = dataclasses.replace(tiny_vocoder_config(), codebook_size=2048)
        tok = TextTokenizer(["<|im_start|>", "<|im_end|>", "assistant", "a"],
                            [], TokenizerSpecialTokens(bos_token_id=0,
                                                       eos_token_id=1))
        eng = Qwen3TTS.from_components(
            tok, cfg, W.init_talker_weights(cfg, gen, "cpu"), vcfg,
            W.init_vocoder_weights(vcfg, gen, "cpu"), "cpu")
        r = eng.synthesize("aaa", TTSParams(max_audio_tokens=8, seed=1))
        assert r.success and len(r.audio) == r.n_frames * 64, r.error_msg
        from qwen3_tts_tpu_torch import cli
        from qwen3_tts_tpu_torch.models import speaker_encoder as spk
        scfg = spk.tiny_speaker_encoder_config()
        emb = spk.encode(spk.init_speaker_encoder_weights(scfg, gen, "cpu"),
                         scfg, torch.zeros(1, 32, scfg.n_mels),
                         torch.tensor([32]))
        assert emb.shape == (1, scfg.embedding_dim)
        assert cli.build_parser().parse_args(["-m", "m"]).device == "cuda"
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "qwen3_tts_tpu")]
        assert not loaded, loaded
        print("NOJAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "NOJAX_OK" in out.stdout, out.stderr


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    out = _run_smoke(cwd)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
