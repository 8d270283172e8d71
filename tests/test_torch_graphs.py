"""The port's compiled-executable layer on the CPU (runtime/graphs.py and
the in-place state it needs): every GenState / GenConsts buffer keeps its
object and address through generate_chunk, admit_slots, park_slot and
init_state(into=...); refilled buffers give the JAX package's codes; the
static-buffer chunk runner matches plain calls across admissions and a
reset; graph keys tell every static switch apart; QWEN3_TTS_AOT=0 and the
CPU run eagerly. All comparisons are bitwise: the CPU runs the same eager
code. Replays on a card are in tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.runtime import generate as jgen  # noqa: E402
from qwen3_tts_tpu_torch.models import vocoder as tvoc  # noqa: E402
from qwen3_tts_tpu_torch.models.stack import QuantKV  # noqa: E402
from qwen3_tts_tpu_torch.ops import codepred_fused as cf  # noqa: E402
from qwen3_tts_tpu_torch.runtime import generate as tgen  # noqa: E402
from qwen3_tts_tpu_torch.runtime import graphs  # noqa: E402
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe  # noqa: E402

from .test_torch_config import port_tokenizer  # noqa: E402
from .test_torch_generate import (B, CFG, CHUNK, TCFG,  # noqa: E402,F401
                                  _jax_draws, _prefill_pair, setup)
from .test_tokenizer import make_tiny_tokenizer  # noqa: E402

V = CFG.codec_vocab_size


def _tensors(obj) -> dict:
    """name -> tensor of every tensor field (the int8 cache's two parts
    apart)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, QuantKV):
            out[f.name + ".values"], out[f.name + ".scales"] = v
        elif isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


def _addresses(*objs) -> dict:
    return {(i, k): (t, t.data_ptr()) for i, o in enumerate(objs)
            for k, t in _tensors(o).items()}


def _assert_same_buffers(before: dict, *objs) -> None:
    after = _addresses(*objs)
    assert after.keys() == before.keys()
    for k, (t, ptr) in before.items():
        assert after[k][0] is t, f"{k} was rebound"
        assert after[k][1] == ptr, f"{k} moved"


def _noise(seed, n_frames, B_):
    rng = np.random.default_rng(seed)
    cb0 = rng.gumbel(size=(n_frames, B_, V)).astype(np.float32)
    rest = rng.gumbel(size=(n_frames, CFG.n_codebooks - 1, B_,
                            CFG.code_pred_vocab_size)).astype(np.float32)
    return torch.from_numpy(cb0), torch.from_numpy(rest)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("ring", [False, True], ids=["lockstep", "ring"])
def test_generate_chunk_keeps_buffers(setup, ring, greedy, kv_quant):
    """Two chunks (the ring wraps in the second) leave every state and
    consts tensor the same object at the same address."""
    _, tw, _, tp = setup
    ctx = 24 if ring else 64        # a ring of 8 slots wraps in chunk 2
    st = tgen.init_state(tw, TCFG, tp, ctx, None, kv_quant=kv_quant)
    cs = tgen.make_consts(tp, 0.0 if greedy else 0.9, 1.05)
    before = _addresses(st, cs)
    for chunk in range(2):
        cb0, rest = (None, None) if greedy else _noise(chunk, CHUNK, B)
        out, codes, valid = tgen.generate_chunk(
            tw, TCFG, st, cs, 50, CHUNK, greedy=greedy, ring=ring,
            read_ctx=ctx, cb0_gumbel=cb0, codes_gumbel=rest)
        assert out is st and codes.shape == (CHUNK, B, 16)
        _assert_same_buffers(before, st, cs)
    if ring:
        assert int(st.write_slot) < tgen.RING_PREFILL_SLOTS + CHUNK


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_admit_park_and_refill_keep_buffers(setup, kv_quant):
    """admit_slots, park_slot, init_state(into=...) and
    make_consts(into=...) write in place; the refill equals a fresh
    state, bit for bit."""
    jw, tw, _, tp = setup
    rng = np.random.default_rng(3)
    n, ctx = 3, 32
    _, dummy = _prefill_pair(jw, tw, np.zeros((n, 16), np.int32),
                             np.full(n, 16, np.int32))
    st = tgen.init_state(tw, TCFG, dummy, ctx, None, kv_quant=kv_quant,
                         active=torch.zeros(n, dtype=torch.bool))
    cs = tgen.make_consts(dummy, 0.0, 1.05)
    before = _addresses(st, cs)
    toks = rng.integers(0, CFG.text_vocab_size, (2, 16)).astype(np.int32)
    _, tp2 = _prefill_pair(jw, tw, toks, np.array([16, 14], np.int32))
    tgen.admit_slots(tw, TCFG, st, cs, torch.tensor([2, 0]), tp2)
    tgen.generate_chunk(tw, TCFG, st, cs, 50, CHUNK, greedy=True,
                        read_ctx=ctx, ring=True)
    tgen.park_slot(st, 2)
    _assert_same_buffers(before, st, cs)
    gen = torch.Generator().manual_seed(5)
    refilled = tgen.init_state(tw, TCFG, dummy, ctx, gen, kv_quant=kv_quant,
                               active=torch.zeros(n, dtype=torch.bool),
                               into=st)
    tgen.make_consts(dummy, 0.9, 1.1, into=cs)
    assert refilled is st and st.generator is gen
    assert (cs.temperature, cs.repetition_penalty) == (0.9, 1.1)
    _assert_same_buffers(before, st, cs)
    fresh = tgen.init_state(tw, TCFG, dummy, ctx, gen, kv_quant=kv_quant,
                            active=torch.zeros(n, dtype=torch.bool))
    fc = tgen.make_consts(dummy, 0.9, 1.1)
    for (i, name), (t, _) in _addresses(fresh, fc).items():
        want = _tensors((st, cs)[i])[name]
        assert torch.equal(t, want), name
    with pytest.raises(ValueError, match="cannot hold"):
        tgen.init_state(tw, TCFG, dummy, ctx * 2, None, kv_quant=kv_quant,
                        into=st)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_refilled_buffers_match_jax(setup, kv_quant, temperature):
    """Buffers that served another batch first, then refilled with
    init_state(into=...), give the JAX generate_chunk's codes."""
    jw, tw, jp, tp = setup
    greedy = temperature <= 0.0
    ctx = jgen.required_ctx(jp.prefill_embd.shape[1], 2 * CHUNK, CHUNK)
    rng = np.random.default_rng(17)
    _, other = _prefill_pair(
        jw, tw, rng.integers(0, CFG.text_vocab_size, (B, 16)).astype(
            np.int32), np.array([15, 16], np.int32))
    ts = tgen.init_state(tw, TCFG, other, ctx, None, kv_quant=kv_quant)
    tc = tgen.make_consts(other, 0.5, 1.2)
    tgen.generate_chunk(tw, TCFG, ts, tc, 50, CHUNK, greedy=True)
    tgen.init_state(tw, TCFG, tp, ctx, None, kv_quant=kv_quant, into=ts)
    tgen.make_consts(tp, temperature, 1.05, into=tc)
    key = jax.random.PRNGKey(21)
    js = jgen.init_state(jw, CFG, jp, ctx, key, kv_quant=kv_quant)
    jc = jgen.make_consts(jp, temperature, 1.05)
    for chunk in range(2):
        read_ctx = jgen.ctx_bucket(jp.prefill_embd.shape[1] + chunk * CHUNK,
                                   CHUNK, ctx, bucket=16)
        draws = (None, None) if greedy else _jax_draws(js.key)
        js, jcodes, jvalid = jgen.generate_chunk(
            jw, CFG, js, jc, 50, CHUNK, greedy=greedy, read_ctx=read_ctx,
            lockstep=True)
        _, tcodes, tvalid = tgen.generate_chunk(
            tw, TCFG, ts, tc, 50, CHUNK, greedy=greedy, read_ctx=read_ctx,
            cb0_gumbel=draws[0], codes_gumbel=draws[1])
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


@pytest.fixture(scope="module")
def engine(setup):
    _, tw, _, _ = setup
    vcfg = dataclasses.replace(tvoc.tiny_vocoder_config(), codebook_size=2048)
    gen = torch.Generator().manual_seed(4)
    from qwen3_tts_tpu_torch.models import weights as W
    return tpipe.Qwen3TTS.from_components(
        port_tokenizer(make_tiny_tokenizer()), TCFG, tw, vcfg,
        W.init_vocoder_weights(vcfg, gen, "cpu"), "cpu")


def test_static_buffer_runner_matches_plain_calls(engine, setup):
    """The engine's chunk runner (``_gen_fn`` over one static state, ring
    mode) over 3 chunks, with an admission after the first and an
    in-place reset after the second, gives the codes of plain
    generate_chunk calls on a state of their own, and keeps its
    buffers."""
    jw, tw, _, _ = setup
    n, ctx, rc = 2, 128, 128
    rng = np.random.default_rng(9)
    _, dummy = _prefill_pair(jw, tw, np.zeros((n, 16), np.int32),
                             np.full(n, 16, np.int32))
    idle = torch.zeros(n, dtype=torch.bool)
    run = (tgen.init_state(tw, TCFG, dummy, ctx, None, active=idle),
           tgen.make_consts(dummy, 0.0, 1.05))
    plain = (tgen.init_state(tw, TCFG, dummy, ctx, None, active=idle),
             tgen.make_consts(dummy, 0.0, 1.05))
    before = _addresses(*run)
    bufs = graphs.new_buffer_id()

    def admit():
        toks = rng.integers(0, CFG.text_vocab_size, (n, 16)).astype(np.int32)
        _, pf = _prefill_pair(jw, tw, toks, np.array([16, 13], np.int32))
        for st, cs in (run, plain):
            tgen.admit_slots(tw, TCFG, st, cs, torch.tensor([0, 1]), pf)

    admit()
    for chunk in range(3):
        got, got_valid = engine._gen_fn(run[0], run[1], bufs, rc, 50, True,
                                        1.0, ring=True)()
        _, want, want_valid = tgen.generate_chunk(
            tw, TCFG, plain[0], plain[1], 50, tpipe.CHUNK_FRAMES,
            greedy=True, read_ctx=rc, ring=True)
        assert torch.equal(got, want) and torch.equal(got_valid, want_valid)
        assert chunk == 1 or bool(got_valid.any())   # 0, 2: just admitted
        _assert_same_buffers(before, *run)
        if chunk == 0:
            admit()
        if chunk == 1:
            tgen.init_state(tw, TCFG, dummy, ctx, None, active=idle,
                            into=run[0])
            tgen.make_consts(dummy, 0.0, 1.05, into=run[1])
            plain = (tgen.init_state(tw, TCFG, dummy, ctx, None,
                                     active=idle),
                     tgen.make_consts(dummy, 0.0, 1.05))
            admit()


KEY = dict(model_tag="abcd1234", buffers=1, B=4, ctx=1152, kv_quant=False,
           talker_impl="auto", codepred_impl="auto", read_ctx=512, top_k=50,
           greedy=True, ring=True, trailing=256, top_p=1.0, temperature=0.0,
           repetition_penalty=1.05, device="cuda:0")
OTHER = dict(buffers=2, B=8, ctx=2048, kv_quant=True, talker_impl="xla",
             codepred_impl="fused", read_ctx=1024, top_k=20, greedy=False,
             ring=False, trailing=512, top_p=0.9, temperature=0.9,
             repetition_penalty=1.1, device="cuda:1",
             model_tag="ffff0000")


@pytest.mark.parametrize("switch", list(OTHER))
def test_gen_keys_tell_switches_apart(switch):
    assert graphs.gen_key(**KEY) == graphs.gen_key(**dict(KEY))
    assert graphs.gen_key(**KEY) != graphs.gen_key(
        **{**KEY, switch: OTHER[switch]})


def test_voc_keys():
    k = dict(model_tag="abcd1234", n=8, frames=40, sub=None, pcm16=True,
             res_impl="auto", device="cuda:0")
    assert graphs.voc_key(**k) == graphs.voc_key(**dict(k))
    for name, other in (("n", 16), ("frames", 20), ("sub", 4),
                        ("pcm16", False), ("res_impl", "xla"),
                        ("model_tag", "x"), ("device", "cuda:1")):
        assert graphs.voc_key(**k) != graphs.voc_key(**{**k, name: other})


def test_engine_keys_follow_the_impl_switches(engine, setup, monkeypatch):
    """Qwen3TTS._gen_fn keys read QWEN3_TTS_TALKER / _CODEPRED and the
    KV dtype at each call, as the JAX package bakes them in at trace
    time."""
    _, tw, _, tp = setup
    st = tgen.init_state(tw, TCFG, tp, 64, None)
    cs = tgen.make_consts(tp, 0.0, 1.05)
    keys = []
    cache = graphs.GraphCache()
    monkeypatch.setattr(engine, "_graph_cache", cache)
    monkeypatch.setattr(graphs.GraphCache, "capturing",
                        staticmethod(lambda device: True))
    for env, val in ((None, None), ("QWEN3_TTS_TALKER", "xla"),
                     ("QWEN3_TTS_CODEPRED", "xla")):
        if env:
            monkeypatch.setenv(env, val)
        engine._gen_fn(st, cs, 7, 64, 50, True, 1.0)
        keys.append(next(k for k in cache.graphs if k not in keys))
    assert len(set(keys)) == 3
    assert "tkauto-cpauto" in keys[0][0] and "tkxla-cpxla" in keys[2][0]


def test_engine_voc_keys_follow_the_res_chain_switch(engine, monkeypatch):
    """Qwen3TTS._voc_fn keys read the vocoder's set_res_chain_impl at each
    call, as _gen_fn's read the talker's and the code predictor's
    switches: a change takes a new graph instead of replaying the old."""
    cache = graphs.GraphCache()
    monkeypatch.setattr(engine, "_graph_cache", cache)
    monkeypatch.setattr(graphs.GraphCache, "capturing",
                        staticmethod(lambda device: True))
    keys = []
    try:
        for impl in (None, "xla", "auto"):
            tvoc.set_res_chain_impl(impl)
            engine._voc_fn(2, 40, None, True)
            keys.append([k for k, _ in cache.graphs])
    finally:
        tvoc.set_res_chain_impl(None)
    assert len(keys[0]) == 1 and "-vauto-" in keys[0][0]
    assert len(keys[1]) == 2 and "-vxla-" in keys[1][1]
    assert keys[2] == keys[1]          # auto again: the first graph


def test_aot_switch_and_devices(monkeypatch):
    monkeypatch.delenv("QWEN3_TTS_AOT", raising=False)
    monkeypatch.delenv("QWEN3_TTS_PROFILE", raising=False)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    cache = graphs.GraphCache()
    assert cache.capturing(cuda) and not cache.capturing(cpu)

    def fn():
        return "ran"

    assert cache.get_or_capture("k", fn, cpu) is fn
    assert not cache.graphs
    g = cache.get_or_capture("k", fn, cuda, owner=4)
    assert g is not fn and cache.get_or_capture("k", fn, cuda) is g
    cache.get_or_capture("other", fn, cuda, owner=5)
    cache.release(4)
    assert [k for k, _ in cache.graphs] == ["other"]
    monkeypatch.setenv("QWEN3_TTS_AOT", "0")
    assert not graphs.aot_enabled() and not cache.capturing(cuda)
    assert cache.get_or_capture("k2", fn, cuda) is fn
    monkeypatch.setenv("QWEN3_TTS_AOT", "1")
    monkeypatch.setenv("QWEN3_TTS_PROFILE", "/nonexistent")
    assert not cache.capturing(cuda)
    monkeypatch.delenv("QWEN3_TTS_PROFILE")
    monkeypatch.setattr(cf.predict_codes_fused, "phase_ns",
                        torch.zeros(9, dtype=torch.int64))
    assert not cache.capturing(cuda)      # phase-clock runs stay eager


def test_lockstep_static_buffers_follow_the_switch(engine, monkeypatch):
    """With QWEN3_TTS_AOT on, lock-step calls of one shape reuse one set
    of buffers (and give the caller's generator back advanced as an eager
    call does), and a call of another shape replaces them; with
    QWEN3_TTS_AOT=0 each call makes its own."""
    params = tpipe.TTSParams(max_audio_tokens=8, temperature=0.9, seed=0,
                             print_timing=False)
    monkeypatch.delenv("QWEN3_TTS_AOT", raising=False)
    g1 = torch.Generator().manual_seed(3)
    a = engine.synthesize_batch(["hello world.", "hello."], params=params,
                                generator=g1)
    held = engine._lockstep
    b = engine.synthesize_batch(["hello world.", "hello."], params=params,
                                generator=torch.Generator().manual_seed(3))
    assert engine._lockstep[1] is held[1] and engine._lockstep[3] == held[3]
    assert any(k[0] == held[3] for k in engine._chunk_bufs)
    engine.synthesize_batch(["hello."], params=params)      # B=1
    assert engine._lockstep[3] != held[3]
    assert not any(k[0] == held[3] for k in engine._chunk_bufs)
    monkeypatch.setenv("QWEN3_TTS_AOT", "0")
    g2 = torch.Generator().manual_seed(3)
    c = engine.synthesize_batch(["hello world.", "hello."], params=params,
                                generator=g2)
    assert torch.equal(g1.get_state(), g2.get_state())
    for x, y, z in zip(a, b, c):
        assert x.success and x.n_frames == y.n_frames == z.n_frames
        np.testing.assert_array_equal(x.audio, y.audio)
        np.testing.assert_array_equal(x.audio, z.audio)


def test_decode_paths_share_the_bucket_buffers(engine):
    """_decode_chunk_batch and decode_codes_chunked decode through the
    bucket's code buffer (``_voc_fn``) and agree with a plain decode."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 64, (3, tpipe.CHUNK_FRAMES, 16)).astype(np.int32)
    got = engine._decode_chunk_batch(codes)
    buf, _ = engine._voc_bufs[(3, tpipe.CHUNK_FRAMES, None, False)]
    assert torch.equal(buf, torch.from_numpy(codes))
    with torch.inference_mode():
        want = tvoc.vocoder_decode(engine.voc_w, engine.voc_cfg,
                                   torch.from_numpy(codes), "causal")
    np.testing.assert_array_equal(got, want.numpy())
    frames = codes[0, :25]
    chunked = engine.decode_codes_chunked(frames)
    assert chunked.shape == (25 * engine.voc_cfg.samples_per_frame,)
    np.testing.assert_array_equal(
        chunked, engine._decode_chunk_batch(
            np.pad(frames, ((0, 15), (0, 0)))[None])[0][:len(chunked)])
