"""Port parity: qwen3_tts_tpu_torch.models.{stack,talker} against the JAX
package at tiny dims, bf16 and int8 KV caches (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import stack as jstack  # noqa: E402
from qwen3_tts_tpu.models import talker as jtalker  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu_torch.models import stack as tstack  # noqa: E402
from qwen3_tts_tpu_torch.models import talker as ttalker  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402

from .test_torch_config import port_cfg  # noqa: E402

CFG = tiny_talker_config()
TCFG = port_cfg(CFG)
B = 3
# The stack rounds q, k, v, probabilities and every matmul input to bf16.
# Where the two frameworks' f32 sums differ in the last bits, a rounding
# can land one bf16 ulp (2^-8 relative) apart; after the output RMSNorm
# that is ~3e-3 on a hidden value (seen on stream 1 of these inputs).
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def weights():
    jw = init_talker_weights(np.random.default_rng(2024), CFG)
    return jw, W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw),
                                         "cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, CFG.text_vocab_size, (B, 16)).astype(np.int32)
    lens = np.array([16, 12, 9], np.int32)
    spk = (rng.standard_normal((B, CFG.hidden_size)) * 0.05).astype(np.float32)
    return tokens, lens, spk


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def test_weights_keep_layout_and_dtype(weights):
    jw, tw = weights
    assert tw["layers"]["wqkv"].dtype == torch.bfloat16
    assert tw["code_pred"]["mtp_w"] is None
    np.testing.assert_array_equal(
        _np(tw["code_pred"]["heads"]),
        np.asarray(jw["code_pred"]["heads"], np.float32))


def test_project_text_tokens(weights, inputs):
    jw, tw = weights
    tokens = inputs[0]
    want = jtalker.project_text_tokens(jw, jnp.asarray(tokens))
    got = ttalker.project_text_tokens(tw, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("use_think", [True, False])
def test_build_prefill_inputs(weights, inputs, use_think):
    jw, tw = weights
    tokens, lens, spk = inputs
    want = jtalker.build_prefill_inputs(jw, CFG, jnp.asarray(tokens),
                                        jnp.asarray(lens), jnp.asarray(spk),
                                        use_think=use_think)
    got = ttalker.build_prefill_inputs(tw, TCFG, torch.from_numpy(tokens),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(spk),
                                       use_think=use_think)
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), atol=1e-4,
                                   err_msg=name)


def _cache_np(cache):
    if isinstance(cache, (jstack.QuantKV, tstack.QuantKV)):
        return _np(cache.values), _np(cache.scales)
    return (_np(cache),)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_prefill_and_steps(weights, inputs, quant):
    """Prefill, then three lock-step decode steps at a shared slot with a
    per-stream position (one stream frozen) and a read window."""
    jw, tw = weights
    tokens, lens, spk = inputs
    jp = jtalker.build_prefill_inputs(jw, CFG, jnp.asarray(tokens),
                                      jnp.asarray(lens), jnp.asarray(spk))
    tp = ttalker.build_prefill_inputs(tw, TCFG, torch.from_numpy(tokens),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(spk))
    S = 64
    P = jp.prefill_embd.shape[1]
    args = (CFG.n_layers, B, S, CFG.n_key_value_heads, CFG.head_dim)
    jc = jstack.init_kv_cache(*args, quant=quant)
    tc = tstack.init_kv_cache(*args, "cpu", quant=quant)
    jh, jl, jc = jtalker.talker_prefill(jw, CFG, jp.prefill_embd, jc)
    th, tl, tc = ttalker.talker_prefill(tw, TCFG, tp.prefill_embd, tc)
    np.testing.assert_allclose(_np(th), _np(jh), atol=BF16_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=BF16_TOL)
    for a, b in zip(_cache_np(tc), _cache_np(jc)):
        np.testing.assert_allclose(a, b, atol=2e-2)

    rng = np.random.default_rng(3)
    n_past = np.full((B,), P, np.int32)
    for step in range(3):
        x = (rng.standard_normal((B, CFG.hidden_size)) * 0.1).astype(
            np.float32)
        slot = int(n_past.max())
        jh, jl, jc = jtalker.talker_step(
            jw, CFG, jnp.asarray(x), jc, jnp.asarray(n_past), read_ctx=32,
            write_idx=jnp.int32(slot))
        th, tl, tc = ttalker.talker_step(
            tw, TCFG, torch.from_numpy(x), tc, torch.from_numpy(n_past),
            torch.tensor(slot), read_ctx=32)
        np.testing.assert_allclose(_np(th), _np(jh), atol=BF16_TOL)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=BF16_TOL)
        n_past = n_past + np.array([1, 1, 0], np.int32)   # stream 2 frozen
    for a, b in zip(_cache_np(tc), _cache_np(jc)):
        np.testing.assert_allclose(a, b, atol=2e-2)



def test_forward_text(weights, inputs):
    """forward_text (project, optional speaker add, prefill) against the
    JAX function on the same weights, with and without the speaker
    embedding, at the stack's bf16 tolerance (BF16_TOL above)."""
    jw, tw = weights
    tokens, _, spk = inputs
    tokens = tokens[:, :5]
    args = (CFG.n_layers, B, 16, CFG.n_key_value_heads, CFG.head_dim)
    for emb in (spk, None):
        jh, jlog, _ = jtalker.forward_text(
            jw, CFG, jnp.asarray(tokens),
            None if emb is None else jnp.asarray(emb),
            jstack.init_kv_cache(*args))
        th, tlog, _ = ttalker.forward_text(
            tw, TCFG, torch.from_numpy(tokens),
            None if emb is None else torch.from_numpy(emb),
            tstack.init_kv_cache(*args, "cpu"))
        np.testing.assert_allclose(_np(th), _np(jh), atol=BF16_TOL)
        np.testing.assert_allclose(_np(tlog), _np(jlog), atol=BF16_TOL)
        if emb is not None:
            with_spk = _np(th)
    assert not np.allclose(_np(th), with_spk)
