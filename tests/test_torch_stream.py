"""The chunk loop's core (qwen3_tts_tpu_torch/runtime/stream.py), which
the lock-step call and the serving batcher share: a stream's code buffer,
one vocoder wave, and a chunk's copies home (CPU, tiny engine)."""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.models.vocoder import (  # noqa: E402
    tiny_vocoder_config, vocoder_output_length)
from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS  # noqa: E402
from qwen3_tts_tpu_torch.runtime.stream import (  # noqa: E402
    CHUNK_FRAMES, ChunkCopies, StreamCodes, decode_wave)
from qwen3_tts_tpu_torch.utils import trace  # noqa: E402

N_CB = 16


@pytest.fixture(scope="module")
def engine():
    gen = torch.Generator().manual_seed(0)
    cfg = W.tiny_talker_config()
    vcfg = dataclasses.replace(tiny_vocoder_config(), codebook_size=2048)
    return Qwen3TTS.from_components(
        None, cfg, W.init_talker_weights(cfg, gen, "cpu"), vcfg,
        W.init_vocoder_weights(vcfg, gen, "cpu"), "cpu")


def _chunk(rng, B):
    """A chunk's host codes [40, B, 16] and a valid mask [40, B] with
    holes."""
    codes = rng.integers(0, 2048, (CHUNK_FRAMES, B, N_CB)).astype(np.int32)
    return codes, rng.random((CHUNK_FRAMES, B)) < 0.7


@pytest.mark.parametrize("cap", [1, 50, 80, 4096])
def test_take_honours_valid_and_cuts_at_cap(cap):
    """take() appends exactly a stream's valid frames, in order, up to its
    cap, and returns how many; the streams are views of one zeroed array
    of whole chunks, zeros past each stream's frames."""
    rng = np.random.default_rng(cap)
    streams = StreamCodes.alloc(3, cap, N_CB)
    want = [[] for _ in streams]
    for _ in range(3):
        codes, valid = _chunk(rng, 3)
        for b, s in enumerate(streams):
            before = s.n_frames
            got = s.take(codes, valid, b)
            want[b] += list(codes[valid[:, b], b])
            assert got == s.n_frames - before
    base = streams[0].buf.base
    for b, s in enumerate(streams):
        n = min(len(want[b]), cap)
        assert s.n_frames == n and s.cap == cap
        np.testing.assert_array_equal(s.buf[:n],
                                      np.array(want[b][:n]).reshape(n, N_CB))
        assert not s.buf[n:].any()
        assert len(s.buf) == -(-cap // CHUNK_FRAMES) * CHUNK_FRAMES
        assert s.buf.base is base


def test_next_chunk_full_then_zero_padded_tail():
    """Full chunks come out one at a time, whether final or not; the tail
    only with final, zero-padded to the chunk, with its frame count; then
    nothing."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 2048, (93, 1, N_CB)).astype(np.int32)
    (s,) = StreamCodes.alloc(1, 120, N_CB)
    s.take(codes[:60], np.ones((60, 1), bool), 0)
    c, k = s.next_chunk()
    assert k == CHUNK_FRAMES and s.n_decoded == 40
    np.testing.assert_array_equal(c, codes[:40, 0])
    assert s.next_chunk() is None and s.n_decoded == 40
    s.take(codes[60:], np.ones((33, 1), bool), 0)
    c, k = s.next_chunk(final=True)
    assert k == CHUNK_FRAMES
    np.testing.assert_array_equal(c, codes[40:80, 0])
    assert s.next_chunk() is None
    c, k = s.next_chunk(final=True)
    assert k == 13 and c.shape == (CHUNK_FRAMES, N_CB)
    np.testing.assert_array_equal(c[:13], codes[80:, 0])
    assert not c[13:].any()
    assert s.n_decoded == s.n_frames == 93
    assert s.next_chunk(final=True) is None


@pytest.mark.parametrize("max_batch", [None, 2])
def test_decode_wave_one_call_in_its_bucket(engine, monkeypatch, max_batch):
    """Two full chunks and a 13-frame tail: one _decode_chunk_batch call
    of voc_bucket(3, 16) rows (the chunks in order, zeros after), with
    pcm16 and the caller's max_batch; a PCMRef a chunk, the tail's valid
    its causal output length; the span with rows and bucket; deliver
    called in row order inside the span; the waveform of a stream's refs
    is their samples / 32767, with room left after them."""
    rng = np.random.default_rng(2)
    (s,) = StreamCodes.alloc(1, 93, N_CB)
    s.take(rng.integers(0, 2048, (93, 1, N_CB)).astype(np.int32),
           np.ones((93, 1), bool), 0)
    parts = [s.next_chunk(), s.next_chunk(), s.next_chunk(final=True)]
    inner, calls, got = engine._decode_chunk_batch, [], []

    def decode(codes, **kw):
        out = inner(codes, **kw)
        calls.append((np.array(codes, copy=True), kw, out.numpy().copy()))
        return out

    monkeypatch.setattr(engine, "_decode_chunk_batch", decode)
    t0 = time.monotonic_ns()
    refs = decode_wave(engine, parts, 16, "call.decode", max_batch,
                       deliver=lambda i, ref: got.append(
                           (i, ref, time.monotonic_ns())))
    monkeypatch.undo()
    nb = engine.voc_bucket(3, 16)
    assert nb == 4 and len(calls) == 1
    batch, kw, out = calls[0]
    assert kw == {"pcm16": True, "max_batch": max_batch}
    assert batch.shape == (nb, CHUNK_FRAMES, N_CB)
    for i, (c, _) in enumerate(parts):
        np.testing.assert_array_equal(batch[i], c)
    assert not batch[3].any()
    tail = vocoder_output_length(engine.voc_w, engine.voc_cfg, 13,
                                 trim="causal")
    assert [r.valid for r in refs] == [None, None, tail]
    assert [r.row for r in refs] == [0, 1, 2]
    (sp,) = [x for x in trace.spans(t0) if x.name == "call.decode"]
    assert sp.attrs == {"rows": 3, "bucket": nb}
    assert [(i, r) for i, r, _ in got] == list(enumerate(refs))
    assert all(sp.t0 <= t <= sp.t1 for _, _, t in got)
    for r in refs:
        np.testing.assert_array_equal(
            r.to_f32(), out[r.row][:r.valid] / np.float32(32767.0))
    s.audio = refs
    wave = s.waveform(room=5)
    assert len(wave) == 2 * len(out[0]) + tail + 5
    np.testing.assert_array_equal(
        wave[:-5], np.concatenate([r.to_f32() for r in refs]))


@pytest.mark.parametrize("moe", [False, True])
def test_chunk_copies_take(moe):
    """take() returns the chunk's host (codes, valid, done); with an MoE
    talker's counters it records talker.moe (pairs and rows summed over
    the layers, max_rows their max, from the dispatch) and the counters;
    a dense talker records none."""
    codes = torch.arange(40 * 2 * N_CB, dtype=torch.int32).reshape(
        40, 2, N_CB)
    valid = torch.ones(40, 2, dtype=torch.bool)
    done = torch.tensor([True, False])
    counts = torch.tensor([[5, 16, 3], [7, 32, 4]], dtype=torch.int32)
    before = trace.counters()
    t0 = time.monotonic_ns()
    copies = ChunkCopies(codes, valid, done, counts if moe else None, t0)
    codes.zero_()     # the copies were taken when the chunk was enqueued
    c, v, d = copies.take()
    assert isinstance(c, np.ndarray) and c[-1, -1, -1] == 40 * 2 * N_CB - 1
    assert v.all() and d.tolist() == [True, False]
    recorded = [s for s in trace.spans(t0) if s.name == "talker.moe"]
    after = trace.counters()
    if not moe:
        assert not recorded
        return
    (sp,) = recorded
    assert sp.t0 == t0 and sp.attrs == {"pairs": 12, "rows": 48,
                                        "max_rows": 4}
    assert after["moe.pairs"] - before.get("moe.pairs", 0) == 12
    assert after["moe.rows"] - before.get("moe.rows", 0) == 48
