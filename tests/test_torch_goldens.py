"""The port against tests/golden/tiny_activations.npz, the JAX package's
frozen tiny-model activations: the same recipe as tools/make_goldens.py
(its talker, vocoder and speaker-encoder parts), run through
qwen3_tts_tpu_torch with the JAX package's weights. Discrete outputs must
be equal; float outputs hold test_goldens.py's tolerances."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import speaker_encoder as jspk  # noqa: E402
from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu_torch.models import code_predictor, talker  # noqa: E402
from qwen3_tts_tpu_torch.models import speaker_encoder  # noqa: E402
from qwen3_tts_tpu_torch.models import vocoder  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime.generate import (  # noqa: E402
    generate_chunk, init_state, make_consts, required_ctx)

from .test_torch_config import port_cfg  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "tiny_activations.npz"


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def current():
    out = {}
    jcfg = tiny_talker_config()
    cfg = port_cfg(jcfg)
    w = W.talker_weights_from_numpy(jax.tree.map(
        np.asarray, init_talker_weights(np.random.default_rng(2024), jcfg)),
        "cpu")
    B = 2
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, cfg.text_vocab_size, (B, 16)),
                             dtype=torch.int32)
    lens = torch.full((B,), 16, dtype=torch.int32)
    spk = torch.as_tensor(rng.standard_normal((B, cfg.hidden_size)) * 0.05,
                          dtype=torch.float32)
    prefill = talker.build_prefill_inputs(w, cfg, tokens, lens, spk)
    out["prefill_embd"] = prefill.prefill_embd.numpy()
    out["trailing_hidden"] = prefill.trailing_hidden.numpy()

    ctx = required_ctx(prefill.prefill_embd.shape[1], 8, 8)
    state = init_state(w, cfg, prefill, ctx, None)
    # copies: generate_chunk updates the state's tensors in place
    out["prefill_logits"] = state.logits.numpy().copy()
    out["prefill_hidden"] = state.last_hidden.numpy().copy()

    consts = make_consts(prefill, 0.0, 1.05)
    state, codes, valid = generate_chunk(w, cfg, state, consts, 50, 8)
    out["greedy_codes"] = codes.numpy()
    out["greedy_valid"] = valid.numpy()

    out["code_pred_codes"] = code_predictor.predict_codes(
        w, cfg, state.last_hidden, torch.tensor([3, 99], dtype=torch.int32),
        0.0, 50).numpy()

    jvcfg = dataclasses.replace(jvoc.tiny_vocoder_config(),
                                codebook_size=2048)
    vcfg = port_cfg(jvcfg)
    vw = W.vocoder_weights_from_numpy(jax.tree.map(
        np.asarray, jvoc.init_vocoder_weights(np.random.default_rng(2025),
                                              jvcfg)), "cpu")
    vcodes = torch.as_tensor(rng.integers(0, 2048, (1, 6, 16)),
                             dtype=torch.int32)
    out["vocoder_audio"] = vocoder.vocoder_decode(vw, vcfg, vcodes).numpy()

    sw = W.tree_from_numpy(jax.tree.map(
        np.asarray, jspk.init_speaker_encoder_weights(
            np.random.default_rng(2026), jspk.tiny_speaker_encoder_config())),
        "cpu")
    scfg = speaker_encoder.tiny_speaker_encoder_config()
    mel = torch.as_tensor(rng.standard_normal((1, 32, scfg.n_mels)),
                          dtype=torch.float32)
    out["speaker_embedding"] = speaker_encoder.encode(
        sw, scfg, mel, torch.tensor([32])).numpy()
    samples = rng.standard_normal(600).astype(np.float32)
    out["mel_spectrogram"] = speaker_encoder.mel_spectrogram(samples, scfg)
    return out


@pytest.mark.parametrize("name,atol", [
    ("prefill_embd", 1e-4),
    ("trailing_hidden", 1e-4),
    ("prefill_logits", 5e-3),
    ("prefill_hidden", 1e-3),
    ("vocoder_audio", 1e-4),
    ("speaker_embedding", 1e-3),
    ("mel_spectrogram", 1e-4),
])
def test_activation_matches_golden(current, golden, name, atol):
    got, want = current[name], golden[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-3,
                               err_msg=f"{name}: port differs from golden")


@pytest.mark.parametrize("name", ["greedy_codes", "greedy_valid",
                                  "code_pred_codes"])
def test_discrete_outputs_match_golden(current, golden, name):
    np.testing.assert_array_equal(current[name], golden[name],
                                  err_msg=f"{name}: port differs from golden")
