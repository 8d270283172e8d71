"""Port parity: lock-step generate_chunk against the JAX package at tiny
dims (bf16 and int8 caches, greedy and sampled with JAX's draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import talker as jtalker  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu.runtime import generate as jgen  # noqa: E402
from qwen3_tts_tpu_torch.models import talker as ttalker  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime import generate as tgen  # noqa: E402

from .test_torch_config import port_cfg  # noqa: E402

CFG = tiny_talker_config()
TCFG = port_cfg(CFG)
B, CHUNK = 2, 6


@pytest.fixture(scope="module")
def setup():
    jw = init_talker_weights(np.random.default_rng(2024), CFG)
    tw = W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, CFG.text_vocab_size, (B, 16)).astype(np.int32)
    lens = np.array([16, 13], np.int32)
    spk = (rng.standard_normal((B, CFG.hidden_size)) * 0.05).astype(
        np.float32)
    jp = jtalker.build_prefill_inputs(jw, CFG, jnp.asarray(tokens),
                                      jnp.asarray(lens), jnp.asarray(spk))
    tp = ttalker.build_prefill_inputs(tw, TCFG, torch.from_numpy(tokens),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(spk))
    return jw, tw, jp, tp


def _jax_draws(key):
    """The Gumbel noise behind generate_chunk's categorical draws: per
    frame, split(key, 3) -> (key, CB0 key, code-predictor key); the code
    predictor splits once per sampled codebook."""
    cb0, codes = [], []
    for _ in range(CHUNK):
        key, k_cb0, k_codes = jax.random.split(key, 3)
        cb0.append(np.array(jax.random.gumbel(
            k_cb0, (B, CFG.codec_vocab_size), jnp.float32)))
        rows = []
        for _ in range(CFG.n_codebooks - 1):
            k_codes, sub = jax.random.split(k_codes)
            rows.append(np.array(jax.random.gumbel(
                sub, (B, CFG.code_pred_vocab_size), jnp.float32)))
        codes.append(np.stack(rows))
    return torch.from_numpy(np.stack(cb0)), torch.from_numpy(np.stack(codes))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_generate_chunk_lockstep(setup, kv_quant, temperature):
    jw, tw, jp, tp = setup
    greedy = temperature <= 0.0
    ctx = jgen.required_ctx(jp.prefill_embd.shape[1], 2 * CHUNK, CHUNK)
    key = jax.random.PRNGKey(21)
    js = jgen.init_state(jw, CFG, jp, ctx, key, kv_quant=kv_quant)
    jc = jgen.make_consts(jp, temperature, 1.05)
    ts = tgen.init_state(tw, TCFG, tp, ctx, None, kv_quant=kv_quant)
    tc = tgen.make_consts(tp, temperature, 1.05)
    for chunk in range(2):
        read_ctx = jgen.ctx_bucket(jp.prefill_embd.shape[1] + chunk * CHUNK,
                                   CHUNK, ctx, bucket=16)
        draws = (None, None) if greedy else _jax_draws(js.key)
        js, jcodes, jvalid = jgen.generate_chunk(
            jw, CFG, js, jc, 50, CHUNK, greedy=greedy, read_ctx=read_ctx,
            lockstep=True)
        ts, tcodes, tvalid = tgen.generate_chunk(
            tw, TCFG, ts, tc, 50, CHUNK, greedy=greedy, read_ctx=read_ctx,
            cb0_gumbel=draws[0], codes_gumbel=draws[1])
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(ts.n_past.numpy(), np.asarray(js.n_past))
        np.testing.assert_array_equal(ts.seen_mask.numpy(),
                                      np.asarray(js.seen_mask))
    # one bf16 ulp of an activation after the output norm (test_torch_talker)
    np.testing.assert_allclose(ts.logits.numpy(), np.asarray(js.logits),
                               atol=1e-2)


def test_state_updates_in_place(setup):
    _, tw, _, tp = setup
    ts = tgen.init_state(tw, TCFG, tp, 64, None)
    cache, n_past = ts.kv_cache, ts.n_past
    before = n_past.clone()
    out, codes, valid = tgen.generate_chunk(
        tw, TCFG, ts, tgen.make_consts(tp, 0.0, 1.05), 50, 3, greedy=True)
    assert out is ts and out.kv_cache is cache and out.n_past is n_past
    assert (n_past == before + 3).all()
    assert codes.shape == (3, B, 16) and valid.dtype == torch.bool


def test_expected_frames_and_ctx_helpers():
    n = np.array([1, 5, 9, 30], np.int32)
    np.testing.assert_array_equal(
        tgen.expected_frames(torch.from_numpy(n)).numpy(),
        np.asarray(jgen.expected_frames(jnp.asarray(n))))
    for args in ((10, 100, 40), (16, 4096, 40), (9, 1, 8)):
        assert tgen.required_ctx(*args) == jgen.required_ctx(*args)
    for args in ((10, 40, 640), (600, 40, 640), (50, 40, 4096)):
        assert tgen.ctx_bucket(*args) == jgen.ctx_bucket(*args)


def test_kv_env(monkeypatch):
    monkeypatch.delenv("QWEN3_TTS_KV", raising=False)
    assert tgen.kv_quant_enabled() is False
    monkeypatch.setenv("QWEN3_TTS_KV", "int8")
    assert tgen.kv_quant_enabled() is True


def _prefill_pair(jw, tw, tokens, lens):
    spk = np.zeros((len(tokens), CFG.hidden_size), np.float32)
    jp = jtalker.build_prefill_inputs(jw, CFG, jnp.asarray(tokens),
                                      jnp.asarray(lens), jnp.asarray(spk))
    tp = ttalker.build_prefill_inputs(tw, TCFG, torch.from_numpy(tokens),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(spk))
    return jp, tp


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_ring_mode_matches_jax(setup, kv_quant):
    """Continuous batching's device primitives, greedy: admit_slots with a
    duplicated slot (the later row wins) -> ring-mode chunks over a 16-slot
    ring that wraps -> park_slot by frame cap -> a late admission. Codes,
    valid frames and the ring state match the JAX package exactly."""
    jw, tw, _, _ = setup
    n_slots, ctx = 3, 32
    rng = np.random.default_rng(31)
    jd, td = _prefill_pair(jw, tw, np.zeros((n_slots, 16), np.int32),
                           np.full(n_slots, 16, np.int32))
    js = jgen.init_state(jw, CFG, jd, ctx, jax.random.PRNGKey(0),
                         active=jnp.zeros(n_slots, bool), kv_quant=kv_quant)
    jc = jgen.make_consts(jd, 0.0, 1.05)
    ts = tgen.init_state(tw, TCFG, td, ctx, None,
                         active=torch.zeros(n_slots, dtype=torch.bool),
                         kv_quant=kv_quant)
    tc = tgen.make_consts(td, 0.0, 1.05)

    def admit(slots):
        nonlocal js, jc
        toks = rng.integers(0, CFG.text_vocab_size,
                            (len(slots), 16)).astype(np.int32)
        lens = rng.integers(12, 17, len(slots)).astype(np.int32)
        jp, tp = _prefill_pair(jw, tw, toks, lens)
        if len(slots) == 1:        # the single-request wrapper
            js, jc = jgen.admit_slot(jw, CFG, js, jc, slots[0], jp)
            tgen.admit_slot(tw, TCFG, ts, tc, slots[0], tp)
        else:
            js, jc = jgen.admit_slots(jw, CFG, js, jc, jnp.asarray(slots),
                                      jp)
            tgen.admit_slots(tw, TCFG, ts, tc, torch.tensor(slots), tp)

    def check_state():
        for name in ("n_past", "valid_mask", "write_slot", "ring_lo", "done"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)), name)

    admit([0, 2, 1, 2])            # slot 2 takes the last row
    check_state()
    lo_gt_hi = False
    for chunk in range(5):
        covered = tgen.RING_PREFILL_SLOTS + chunk * CHUNK + CHUNK
        read_ctx = tgen.ctx_bucket(min(covered, ctx), 0, ctx, bucket=16)
        js, jcodes, jvalid = jgen.generate_chunk(
            jw, CFG, js, jc, 50, CHUNK, greedy=True, read_ctx=read_ctx,
            ring=True)
        _, tcodes, tvalid = tgen.generate_chunk(
            tw, TCFG, ts, tc, 50, CHUNK, greedy=True, read_ctx=read_ctx,
            ring=True)
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        check_state()
        lo_gt_hi |= bool((ts.ring_lo > ts.write_slot).any())
        if chunk == 1:
            # slot 0 retires by its frame cap; a late request takes it at
            # ring slot 28, so the ring wraps below its ring_lo next chunk
            js = jgen.park_slot(js, jnp.int32(0))
            tgen.park_slot(ts, 0)
            check_state()
            admit([0])
            check_state()
    assert lo_gt_hi, "the ring never wrapped past a live stream's ring_lo"


def test_ring_ctx_helper_and_prefill_guard(setup):
    """required_ctx_ring matches the JAX helper; an admission whose
    prefill is longer than the reserved region raises instead of
    overwriting the shared ring."""
    _, tw, _, tp = setup
    for args in ((4, 40), (1024, 40), (100, 8)):
        assert tgen.required_ctx_ring(*args) == jgen.required_ctx_ring(*args)
    assert tgen.RING_PREFILL_SLOTS == jgen.RING_PREFILL_SLOTS
    ts = tgen.init_state(tw, TCFG, tp, 64, None)
    tc = tgen.make_consts(tp, 0.0, 1.05)
    long = tp._replace(prefill_embd=torch.zeros(
        2, tgen.RING_PREFILL_SLOTS + 1, CFG.hidden_size))
    with pytest.raises(ValueError, match="RING_PREFILL_SLOTS"):
        tgen.admit_slots(tw, TCFG, ts, tc, torch.tensor([0, 1]), long)
