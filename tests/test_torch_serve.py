"""Port parity of continuous batching: the port's ContinuousBatcher
against the JAX package's on the same tiny weights (greedy, CPU), and the
behaviour of tests/test_serve.py on the port: streaming, failure isolation,
frame caps and queue accounting."""

import dataclasses
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu.runtime import pipeline as jpipe  # noqa: E402
from qwen3_tts_tpu.runtime import serve as jserve  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe  # noqa: E402
from qwen3_tts_tpu_torch.runtime import serve as tserve  # noqa: E402
from qwen3_tts_tpu_torch.utils import trace  # noqa: E402

from .test_tokenizer import make_tiny_tokenizer  # noqa: E402
from .test_torch_config import port_cfg, port_tokenizer  # noqa: E402

# the int16 PCM may differ by a step where the two vocoders round apart
PCM_TOL = 2.5 / 32767
LONG_TEXT = "hello world. " * 60      # trailing schedule > 256 rows


@pytest.fixture(scope="module")
def engines():
    # weights and texts under which no code of the compared frames sits at
    # a bf16 near-tie: other choices flip a code at a ~1e-3 logit margin
    # and the stream parts from there, in lock-step synthesis as much as
    # here (with these weights "world hello world." does; ROADMAP.md C)
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


def _params(mod, **kw):
    kw = {"temperature": 0.0, "top_k": 50, "seed": 0, **kw}
    if mod is jpipe:
        kw["print_timing"] = False
    return mod.TTSParams(**kw)


def _late_join(cb, results):
    """5 requests over 2 slots, 3 of them submitted after the first
    chunk ran."""
    rids = [cb.submit("hello world. hello world. hello world."),
            cb.submit("hello.")]
    results.update(cb.step())
    rids += [cb.submit(t) for t in ("hello world. hello.",
                                    "hello hello world.",
                                    "hello world hello.")]
    return rids


def _one_slot_ring_wraps(cb, results):
    """7 sequential requests through one slot: each takes a 40-frame
    chunk of the 112-slot ring, so the ring wraps twice."""
    return [cb.submit("hello world.") for _ in range(7)]


def _long_text(cb, results):
    return [cb.submit(LONG_TEXT)]


SCENARIOS = {
    # name: (submitting function, n_slots, max_frames)
    "late_join": (_late_join, 2, 16),
    "one_slot_ring_wraps": (_one_slot_ring_wraps, 1, 4),
    "long_text": (_long_text, 2, 280),
}


def _run(mod, serve_mod, engine, name):
    drive, n_slots, max_frames = SCENARIOS[name]
    cb = serve_mod.ContinuousBatcher(engine, n_slots=n_slots,
                                     params=_params(mod),
                                     max_frames=max_frames)
    results = {}
    rids = drive(cb, results)
    results.update(cb.run_all())
    return [results[r] for r in rids], cb


@pytest.fixture(scope="module")
def runs(engines):
    jeng, teng = engines
    return {name: (_run(jpipe, jserve, jeng, name),
                   _run(tpipe, tserve, teng, name)) for name in SCENARIOS}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batcher_matches_jax(runs, name):
    (want, _), (got, cb) = runs[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.success and w.success, (g.error_msg, w.error_msg)
        assert g.n_frames == w.n_frames
        assert len(g.audio) == g.n_frames * 64     # tiny: 64 per frame
        np.testing.assert_allclose(g.audio, w.audio, atol=PCM_TOL)
    if name == "one_slot_ring_wraps":
        # 7 chunks of 40 ring slots over a 112-slot ring
        assert cb._steps_done == 7 * 40 > 2 * (cb.ctx - 16)
    if name == "long_text":
        # the shared buffer grew at admission instead of cutting the text
        assert cb.trailing_buf == 512


def test_continuous_matches_lockstep_greedy(engines):
    """A request in a continuous batch gives the frames of standalone
    synthesis (slot isolation)."""
    _, teng = engines
    base = teng.synthesize("hello world.",
                           _params(tpipe, max_audio_tokens=12))
    cb = tserve.ContinuousBatcher(teng, n_slots=3, params=_params(tpipe),
                                  max_frames=12)
    rid = cb.submit("hello world.")
    res = cb.run_all()[rid]
    assert res.n_frames == base.n_frames
    np.testing.assert_allclose(res.audio, base.audio, atol=1e-3)


def test_streaming_callback(engines):
    _, teng = engines
    got = []
    cb = tserve.ContinuousBatcher(teng, n_slots=1, params=_params(tpipe),
                                  max_frames=6)
    cb.submit("hello world.",
              on_audio=lambda a, final: got.append((len(a), final)))
    results = cb.run_all()
    assert got and got[-1][1] is True
    assert sum(n for n, _ in got) == len(list(results.values())[0].audio)


def test_streaming_final_fires_exactly_once(engines):
    """A stream retired at exactly a chunk multiple gets one final=True."""
    _, teng = engines
    got = []
    cb = tserve.ContinuousBatcher(teng, n_slots=1, params=_params(tpipe),
                                  max_frames=40)
    cb.submit("hello world. " * 10,
              on_audio=lambda a, final: got.append((len(a), final)))
    assert list(cb.run_all().values())[0].success
    finals = [f for _, f in got]
    assert sum(finals) == 1 and finals[-1] is True


def test_poisoned_callback_fails_only_its_request(engines):
    _, teng = engines

    def bad_sink(a, final):
        raise RuntimeError("sink exploded")

    cb = tserve.ContinuousBatcher(teng, n_slots=2, params=_params(tpipe),
                                  max_frames=6)
    r_bad = cb.submit("hello world.", on_audio=bad_sink)
    r_ok = cb.submit("hello.")
    results = cb.run_all()
    assert not results[r_bad].success
    assert "sink exploded" in results[r_bad].error_msg
    assert results[r_ok].success
    r_next = cb.submit("hello world.")
    assert cb.run_all()[r_next].success


def test_bad_embedding_fails_only_its_request(engines):
    _, teng = engines
    cb = tserve.ContinuousBatcher(teng, n_slots=2, params=_params(tpipe),
                                  max_frames=8)
    r_bad = cb.submit("hello world.", embedding=np.zeros(7, np.float32))
    r_ok = cb.submit("hello.")
    results = cb.run_all()
    assert not results[r_bad].success
    assert "embedding" in results[r_bad].error_msg
    assert results[r_ok].success


def test_step_failure_fails_inflight_not_process(engines, monkeypatch):
    """A raise inside the shared step fails the in-flight requests,
    rebuilds the device state, and the batcher serves on correctly."""
    _, teng = engines
    cb = tserve.ContinuousBatcher(teng, n_slots=2, params=_params(tpipe),
                                  max_frames=6)
    r1, r2 = cb.submit("hello world."), cb.submit("hello.")
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise RuntimeError("device fell over")

    monkeypatch.setattr(tserve, "decode_wave", boom)
    out = {}
    for _ in range(4):
        out.update(cb.step())
        if out:
            break
    assert calls["n"] >= 1 and set(out) == {r1, r2}
    assert all(not r.success and "device fell over" in r.error_msg
               for r in out.values())
    assert not cb.pending()

    monkeypatch.undo()
    base = teng.synthesize("hello world.",
                           _params(tpipe, max_audio_tokens=6))
    r3 = cb.submit("hello world.")
    res = cb.run_all()[r3]
    assert res.success and res.n_frames == base.n_frames
    np.testing.assert_allclose(res.audio, base.audio, atol=1e-3)


def test_queued_requests_survive_step_failure(engines, monkeypatch):
    _, teng = engines
    cb = tserve.ContinuousBatcher(teng, n_slots=1, params=_params(tpipe),
                                  max_frames=6)
    r1, r2 = cb.submit("hello world."), cb.submit("hello.")
    real = cb._dispatch_chunk
    fired = {"done": False}

    def boom_once(*a, **k):
        if not fired["done"]:
            fired["done"] = True
            raise RuntimeError("transient")
        return real(*a, **k)

    monkeypatch.setattr(cb, "_dispatch_chunk", boom_once)
    results = cb.run_all()
    assert set(results) == {r1, r2}
    assert not results[r1].success and results[r2].success


def test_honors_max_audio_tokens(engines):
    _, teng = engines
    cb = tserve.ContinuousBatcher(
        teng, n_slots=2, params=_params(tpipe, max_audio_tokens=6),
        max_frames=100)
    assert cb.max_frames == 6
    rid = cb.submit("hello world.")
    res = cb.run_all()[rid]
    assert res.success and res.n_frames <= 6


def test_queue_wait_recorded(engines):
    """t_queue_ms: submit -> admission; requests queued behind a full
    batcher wait at least one request's generation and decode."""
    _, teng = engines
    cb = tserve.ContinuousBatcher(teng, n_slots=2, params=_params(tpipe),
                                  max_frames=8)
    first = [cb.submit("hello world.") for _ in range(2)]
    queued = [cb.submit("hello world.") for _ in range(2)]
    results = cb.run_all()
    assert all(results[r].success for r in first + queued)
    assert all(results[r].t_queue_ms >= 0.0 for r in first)
    for r in queued:
        assert results[r].t_queue_ms > results[first[0]].t_queue_ms
        assert results[r].t_queue_ms > 50.0
    assert results[queued[0]].t_total_ms > 0.0


def test_request_and_step_spans(engines):
    """Each request's spans, under its id, in order: req.queue <=
    req.first_codes <= req.first_audio, all from its admission on, and
    t_queue_ms is its req.queue; a serve.step a step with its busy slots,
    a serve.decode a wave with rows <= bucket."""
    _, teng = engines
    t0 = time.monotonic_ns()
    cb = tserve.ContinuousBatcher(teng, n_slots=2, params=_params(tpipe),
                                  max_frames=48)
    audio = {}
    rids = [cb.submit(t, on_audio=lambda x, final, i=i: audio.setdefault(
        i, time.monotonic_ns())) for i, t in enumerate(
            ["hello world.", "hello.", "world hello."])]
    results = cb.run_all()
    spans = trace.spans(t0)
    for i, rid in enumerate(rids):
        assert results[rid].success
        mine = {s.name: s for s in spans if s.rid == rid}
        assert set(mine) == {"req.queue", "req.first_codes",
                             "req.first_audio"}
        q, c, a = (mine[n] for n in ("req.queue", "req.first_codes",
                                     "req.first_audio"))
        assert q.t1 == c.t0 == a.t0            # all from its admission
        assert q.t0 <= q.t1 <= c.t1 <= a.t1 <= audio[i]
        assert results[rid].t_queue_ms == pytest.approx(q.ms, abs=1e-9)
    assert results[rids[2]].t_queue_ms > 0.0   # waited for a free slot
    steps = [s for s in spans if s.name == "serve.step"]
    assert steps and all(s.attrs["slots"] == 2
                         and 0 <= s.attrs["busy"] <= 2 for s in steps)
    assert max(s.attrs["busy"] for s in steps) == 2
    waves = [s for s in spans if s.name == "serve.decode"]
    assert waves and all(1 <= s.attrs["rows"] <= s.attrs["bucket"]
                         for s in waves)
    assert all(s.parent in {x.sid for x in steps} for s in waves)
    admitted = [s.attrs["admitted"] for s in spans if s.name == "serve.admit"]
    assert sum(admitted) == 3


def test_scatter_mode_not_ported(engines, monkeypatch):
    _, teng = engines
    monkeypatch.setenv("QWEN3_TTS_RING", "0")
    with pytest.raises(NotImplementedError, match="QWEN3_TTS_RING=0"):
        tserve.ContinuousBatcher(teng, n_slots=1, params=_params(tpipe))


@pytest.mark.parametrize("n_slots,max_frames", [(1, 4), (2, 16), (8, 96),
                                                (16, 1024), (192, 1024)])
def test_warmup_buckets_match_jax(engines, n_slots, max_frames):
    """The port warms the read_ctx buckets and vocoder decode sizes that
    the JAX package's warmup walks (its ctx_bucket, RING_PREFILL_SLOTS
    and voc_bucket) for the same slots and frame cap."""
    from qwen3_tts_tpu.runtime import generate as jgen
    jeng, teng = engines
    ctx = jgen.required_ctx_ring(max_frames, 40)
    want, steps = [], 0
    while True:
        rc = jgen.ctx_bucket(min(jgen.RING_PREFILL_SLOTS + steps + 40, ctx),
                             0, ctx)
        if not want or rc != want[-1]:
            want.append(rc)
        if rc >= ctx:
            break
        steps += 40
    sizes = sorted({jeng.voc_bucket(n, n_slots)
                    for n in range(1, n_slots + 1)})
    cb = tserve.ContinuousBatcher.__new__(tserve.ContinuousBatcher)
    cb.engine, cb.n_slots = teng, n_slots
    cb.ctx = tserve.required_ctx_ring(max_frames, tpipe.CHUNK_FRAMES)
    assert cb.ctx == ctx
    assert cb.warmup_buckets() == (want, sizes)


def test_warmup_then_serve(engines):
    """warmup() builds every serving executable and leaves a pristine
    state in the same buffers: requests served afterwards match the JAX
    batcher's, request by request (tests/test_serve.py)."""
    jeng, teng = engines
    texts = ("hello world.", "hello.", "hello hello world.")
    cb = tserve.ContinuousBatcher(teng, n_slots=2, params=_params(tpipe),
                                  max_frames=8)
    cache = cb.state.kv_cache
    cb.warmup()
    assert not cb.pending() and cb.state.kv_cache is cache
    assert int(cb.state.write_slot) == tserve.RING_PREFILL_SLOTS
    assert bool(cb.state.done.all()) and cb._steps_done == 0
    rids = [cb.submit(t) for t in texts]
    got = cb.run_all()
    jcb = jserve.ContinuousBatcher(jeng, n_slots=2, params=_params(jpipe),
                                   max_frames=8)
    jrids = [jcb.submit(t) for t in texts]
    want = jcb.run_all()
    for r, jr in zip(rids, jrids):
        g, w = got[r], want[jr]
        assert g.success and w.success, (g.error_msg, w.error_msg)
        assert g.n_frames == w.n_frames
        np.testing.assert_allclose(g.audio, w.audio, atol=PCM_TOL)


def test_warmup_long_token_bucket(engines):
    """warmup() grows the trailing buffer exactly like the live admission
    path (tests/test_serve.py): a long-text bucket warms without tripping
    _pad_trailing's capacity check."""
    _, teng = engines
    cb = tserve.ContinuousBatcher(teng, n_slots=1, params=_params(tpipe),
                                  max_frames=32, trailing_buf=16)
    cb.warmup(token_buckets=(64,))
    assert cb.trailing_buf >= 32  # grew (capped at max_frames)
    r = cb.submit("hello.")
    assert cb.run_all()[r].success


def test_vocoderless_batcher_matches_jax(engines):
    """A batcher over an engine made with voc_w=None (the JAX package's
    semantics): warmup() skips the vocoder, the slots generate codes, and
    every request reports the JAX batcher's frames, success, message and
    rate (24000 Hz with no vocoder config) with no audio. Exact: no
    tolerance."""
    jeng, teng = engines
    jeng = jpipe.Qwen3TTS.from_components(jeng.tokenizer, jeng.talker_cfg,
                                          jeng.talker_w, None, None)
    teng = tpipe.Qwen3TTS.from_components(teng.tokenizer, teng.talker_cfg,
                                          teng.talker_w, None, None, "cpu")
    texts = ("hello world.", "hello.", "hello hello world.")
    out = []
    for mod, serve_mod, eng in ((jpipe, jserve, jeng),
                                (tpipe, tserve, teng)):
        cb = serve_mod.ContinuousBatcher(eng, n_slots=2,
                                         params=_params(mod), max_frames=48)
        if mod is tpipe:
            cb.warmup()
        rids = [cb.submit(t) for t in texts]
        res = cb.run_all()
        out.append([res[r] for r in rids])
    for g, w in zip(*reversed(out)):
        assert (g.n_frames, g.success, g.error_msg, g.sample_rate) == (
            w.n_frames, w.success, w.error_msg, w.sample_rate)
        assert g.n_frames > 0 and len(g.audio) == len(w.audio) == 0
