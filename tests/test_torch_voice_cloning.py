"""Voice cloning on the port, mirroring tests/test_voice_cloning.py: WAV
-> speaker embedding (held to the JAX engine's on the same weights) ->
conditioned synthesis, bulk enrolment against single clips, and the .embd
cache through the CLI helper."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import speaker_encoder as jspk  # noqa: E402
from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.models import weights as JW  # noqa: E402
from qwen3_tts_tpu.runtime import pipeline as jpipe  # noqa: E402
from qwen3_tts_tpu_torch import cli  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime import audio_io  # noqa: E402
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe  # noqa: E402

from .test_tokenizer import make_tiny_tokenizer  # noqa: E402
from .test_torch_config import port_cfg, port_tokenizer  # noqa: E402


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, on the same tiny weights (the
    speaker encoder at the tiny mel geometry, its embedding the talker's
    width)."""
    rng = np.random.default_rng(100)
    cfg = JW.tiny_talker_config()
    jw = JW.init_talker_weights(rng, cfg)
    vcfg = dataclasses.replace(jvoc.tiny_vocoder_config(), codebook_size=2048)
    jvw = jvoc.init_vocoder_weights(rng, vcfg)
    scfg = dataclasses.replace(jspk.tiny_speaker_encoder_config(),
                               embedding_dim=cfg.hidden_size)
    jsw = jspk.init_speaker_encoder_weights(rng, scfg)
    tok = make_tiny_tokenizer()
    jeng = jpipe.Qwen3TTS.from_components(tok, cfg, jw, vcfg, jvw, scfg, jsw)

    def tree(t):
        return W.tree_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    teng = tpipe.Qwen3TTS.from_components(
        port_tokenizer(tok), port_cfg(cfg), tree(jw), port_cfg(vcfg),
        tree(jvw), "cpu", port_cfg(scfg), tree(jsw))
    return jeng, teng


def _ref_wav(tmp_path, seconds=0.3, sr=24000, name="ref.wav"):
    t = np.arange(int(seconds * sr)) / sr
    x = (0.4 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 881 * t)).astype(np.float32)
    path = str(tmp_path / name)
    audio_io.save_wav(path, x, sr)
    return path


@pytest.mark.parametrize("sr", [24000, 16000], ids=["24k", "16k-resampled"])
def test_encode_speaker_from_wav_matches_jax(engines, tmp_path, sr):
    jeng, teng = engines
    path = _ref_wav(tmp_path, sr=sr)
    emb = teng.encode_speaker(path)
    assert emb is not None and emb.dtype == np.float32
    assert emb.shape == (teng.talker_cfg.hidden_size,)
    assert np.all(np.isfinite(emb))
    np.testing.assert_array_equal(emb, teng.encode_speaker(path))
    np.testing.assert_allclose(emb, jeng.encode_speaker(path), atol=1e-4,
                               rtol=1e-4)


def test_encode_speaker_batch_matches_single(engines):
    """Bulk enrolment (device mel, one encode) == per-clip encoding (host
    mel) for mixed-length clips, and == the JAX bulk enrolment."""
    jeng, teng = engines
    sr = teng.spk_cfg.sample_rate
    rng = np.random.default_rng(743)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.3
             for n in (7200, 4100, 9600)]
    batch = teng.encode_speaker_batch(clips, sr)
    assert batch.shape == (3, teng.spk_cfg.embedding_dim)
    for i, c in enumerate(clips):
        np.testing.assert_allclose(batch[i], teng.encode_speaker_samples(c, sr),
                                   atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(batch, jeng.encode_speaker_batch(clips, sr),
                               atol=1e-3, rtol=1e-3)
    assert teng.encode_speaker_batch([], sr).shape == (
        0, teng.spk_cfg.embedding_dim)
    assert teng.encode_speaker_batch([clips[0], np.zeros(0)], sr) is None
    assert "empty" in teng.error_msg


def test_synthesize_with_voice(engines, tmp_path):
    _, teng = engines
    path = _ref_wav(tmp_path)
    p = tpipe.TTSParams(max_audio_tokens=10, temperature=0.0,
                        print_timing=False, seed=0)
    res = teng.synthesize_with_voice("hello world.", path, p)
    assert res.success, res.error_msg
    assert res.t_encode_ms > 0.0
    assert len(res.audio) == res.n_frames * teng.voc_cfg.samples_per_frame
    same = teng.synthesize_with_embedding("hello world.",
                                          teng.encode_speaker(path), p)
    np.testing.assert_array_equal(res.audio, same.audio)
    base = teng.synthesize("hello world.", p)
    assert (res.n_frames != base.n_frames
            or not np.allclose(res.audio, base.audio))


def test_synthesize_with_voice_bad_reference(engines, tmp_path):
    _, teng = engines
    res = teng.synthesize_with_voice("hello world.",
                                     str(tmp_path / "missing.wav"))
    assert not res.success
    assert res.error_msg.startswith("Failed to load reference audio")


def test_speaker_encoder_needs_weights_or_a_model_path(engines):
    _, teng = engines
    eng = tpipe.Qwen3TTS.from_components(
        teng.tokenizer, teng.talker_cfg, teng.talker_w, teng.voc_cfg,
        teng.voc_w, "cpu")
    assert eng.encode_speaker_samples(np.zeros(4000, np.float32),
                                      24000) is None
    assert "no model path" in eng.error_msg


def test_cli_resolve_embedding_cache(engines, tmp_path):
    _, teng = engines
    path = _ref_wav(tmp_path)
    cache = path + ".embd"
    emb = cli.resolve_embedding(teng, cache, path)
    assert emb is not None
    emb2 = cli.resolve_embedding(teng, cache, reference_audio=None)
    np.testing.assert_array_equal(np.asarray(emb, np.float32), emb2)
