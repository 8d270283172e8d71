"""Port parity: the code predictor.

- models.code_predictor.predict_codes (CPU = the XLA-path port) against
  the JAX XLA path at tiny dims: greedy exact, sampled exact with JAX's
  Gumbel draws fed in.
- ops.codepred_fused twin against the JAX Pallas megakernel run in
  interpret mode at the real dims (B=8, greedy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.config import TalkerConfig  # noqa: E402
from qwen3_tts_tpu.models import code_predictor as jcp  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu.ops import codepred_fused as jcf  # noqa: E402
from qwen3_tts_tpu_torch.models import code_predictor as tcp  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.ops import codepred_fused as tcf  # noqa: E402

from .test_torch_config import port_cfg  # noqa: E402

CFG = tiny_talker_config()
TCFG = port_cfg(CFG)
B = 4
# logit margin that counts as a bf16 near-tie between two implementations
NEAR_TIE = 5e-2


@pytest.fixture(scope="module")
def tiny():
    jw = init_talker_weights(np.random.default_rng(2024), CFG)
    tw = W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    rng = np.random.default_rng(11)
    hidden = (rng.standard_normal((B, CFG.hidden_size))).astype(np.float32)
    cb0 = rng.integers(0, CFG.codec_vocab_size - 1024, B).astype(np.int32)
    return jw, tw, hidden, cb0


def _xla_path_noise(key, n_steps, shape):
    """The Gumbel draws behind predict_codes' categorical samples: one
    split per sampled codebook, in its order."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_predict_codes_matches_xla_path(tiny, greedy):
    jw, tw, hidden, cb0 = tiny
    key = jax.random.PRNGKey(5)
    want = jcp.predict_codes(jw, CFG, jnp.asarray(hidden), jnp.asarray(cb0),
                             jnp.float32(0.8), 20, key, greedy=greedy)
    noise = _xla_path_noise(key, CFG.n_codebooks - 1,
                            (B, CFG.code_pred_vocab_size))
    got = tcp.predict_codes(tw, TCFG, torch.from_numpy(hidden),
                            torch.from_numpy(cb0), 0.8, 20, greedy=greedy,
                            gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_frame_step_embedding(tiny):
    jw, tw, _, _ = tiny
    rng = np.random.default_rng(12)
    codes = np.concatenate(
        [rng.integers(0, 2048, (B, 1)),
         rng.integers(0, CFG.code_pred_vocab_size, (B, 15))], 1).astype(
             np.int32)
    trail = rng.standard_normal((B, CFG.hidden_size)).astype(np.float32)
    want = jcp.frame_step_embedding(jw, CFG, jnp.asarray(codes),
                                    jnp.asarray(trail))
    got = tcp.frame_step_embedding(tw, TCFG, torch.from_numpy(codes),
                                   torch.from_numpy(trail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_twin_greedy_equals_xla_path_at_tiny_dims(tiny):
    """The twin keeps attention probabilities in f32 where the XLA path
    rounds them to bf16; at tiny dims that moves no argmax."""
    _, tw, hidden, cb0 = tiny
    args = (tw, TCFG, torch.from_numpy(hidden), torch.from_numpy(cb0), 0.8,
            20)
    np.testing.assert_array_equal(
        tcf.predict_codes_twin(*args, greedy=True).numpy(),
        tcp.predict_codes(*args, greedy=True).numpy())


def _real_code_pred_weights(seed=0, scale=0.02):
    """Code-predictor weights at the real dims (the kernel's only inputs):
    bf16 matrices, unit norms, as init_talker_weights_fast draws them."""
    cfg = TalkerConfig()
    rng = np.random.default_rng(seed)
    L, H, I = cfg.code_pred_layers, cfg.code_pred_hidden_size, 3072
    qkv = (cfg.code_pred_n_attention_heads + 2 * cfg.code_pred_n_kv_heads) \
        * cfg.code_pred_head_dim

    def rnd(*shape):
        return jnp.asarray(rng.standard_normal(shape, np.float32) * scale,
                           jnp.bfloat16)

    ones = lambda *shape: jnp.ones(shape, jnp.float32)  # noqa: E731
    w = {"codec_embd": rnd(cfg.codec_vocab_size, H),
         "code_pred": {
             "layers": {"attn_norm": ones(L, H), "wqkv": rnd(L, H, qkv),
                        "wo": rnd(L, 2048, H), "q_norm": ones(L, 128),
                        "k_norm": ones(L, 128), "ffn_norm": ones(L, H),
                        "w_gu": rnd(L, H, 2 * I), "w_down": rnd(L, I, H)},
             "output_norm": ones(H),
             "embd": rnd(15, cfg.code_pred_vocab_size, H),
             "heads": rnd(15, H, cfg.code_pred_vocab_size),
             "mtp_w": None, "mtp_b": None}}
    return cfg, w


def _near_tie_divergences(got, ref, logits):
    """First-divergence margins of the reference's logits per differing
    stream (the fed-back codes agree before that position)."""
    margins = []
    for b in np.nonzero((got != ref).any(axis=1))[0]:
        p = int(np.nonzero(got[b] != ref[b])[0][0])
        margins.append(float(logits[p, b, ref[b, p]] - logits[p, b, got[b, p]]))
    return margins


def test_twin_matches_pallas_kernel_interpret():
    """Twin vs the JAX megakernel in interpret mode, real dims, B=8,
    greedy: codes agree, and a stream that differs does so first at a
    bf16 near-tie of the twin's logits."""
    cfg, jw = _real_code_pred_weights()
    tw = W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    rng = np.random.default_rng(1)
    hidden = (rng.standard_normal((8, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    cb0 = rng.integers(0, cfg.code_pred_vocab_size, 8).astype(np.int32)
    want = np.asarray(jcf.predict_codes_fused(
        jw, cfg, jnp.asarray(hidden), jnp.asarray(cb0), jnp.float32(0.9), 50,
        jax.random.PRNGKey(3), greedy=True, interpret=True))
    logits = torch.empty(15, 8, cfg.code_pred_vocab_size)
    got = tcf.predict_codes_twin(tw, port_cfg(cfg),
                                 torch.from_numpy(hidden),
                                 torch.from_numpy(cb0), 0.9, 50, greedy=True,
                                 logits_out=logits).numpy()
    margins = _near_tie_divergences(want, got, logits.numpy())
    assert (got == want).all(axis=1).mean() >= 0.5, margins
    assert all(m <= NEAR_TIE for m in margins), margins


def test_cpu_wrapper_runs_twin(tiny):
    _, tw, hidden, cb0 = tiny
    args = (tw, TCFG, torch.from_numpy(hidden), torch.from_numpy(cb0), 0.8,
            20)
    np.testing.assert_array_equal(
        tcf.predict_codes_fused(*args, greedy=True).numpy(),
        tcf.predict_codes_twin(*args, greedy=True).numpy())



def test_kernel_scratch_is_allocated_once_and_holds_every_product():
    """The kernel's per-(device, batch) scratch: the partial sums hold the
    largest product's K splits (256-row splits; gate/up's 4 x 6,144
    columns), the K/V cache is [L, B, NKV, CTX, D], and a second frame of
    the same batch gets the same tensors."""
    B = 3
    sc = tcf._scratch(torch.device("cpu"), B, 1e6)
    splits = {n: k // tcf.K_SPLIT * n for k, n in (
        (tcf.H, (tcf.NH + 2 * tcf.NKV) * tcf.D), (tcf.NH * tcf.D, tcf.H),
        (tcf.H, 2 * tcf.I), (tcf.I, tcf.H), (tcf.H, tcf.V))}
    assert sc["part"].numel() == max(splits.values()) * B
    assert sc["kc"].shape == (tcf.L, B, tcf.NKV, tcf.CTX, tcf.D)
    assert sc["rope_c"].shape == (tcf.CTX, tcf.D)
    again = tcf._scratch(torch.device("cpu"), B, 1e6)
    assert all(again[k] is sc[k] for k in sc)
