"""The port's speaker encoder against the JAX package's: the host mel
against the naive DFT and against JAX, the device mel against the host
mel, ``encode`` against the JAX ``encode`` on the same weights, and the
masks that make an embedding independent of its bucket and its batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.config import SpeakerEncoderConfig as JCfg  # noqa: E402
from qwen3_tts_tpu.models import speaker_encoder as jse  # noqa: E402
from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig  # noqa: E402
from qwen3_tts_tpu_torch.models import speaker_encoder as se  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402

from .test_speaker_encoder import naive_reference_mel  # noqa: E402

MEL_CFG = dict(n_mels=8, n_fft=64, hop_length=16, win_length=64,
               sample_rate=24000, f_min=0.0, f_max=12000.0)


@pytest.fixture(scope="module")
def enc():
    """Tiny encoder weights drawn by the JAX package, and the same tree
    as tensors."""
    cfg = se.tiny_speaker_encoder_config()
    jw = jse.init_speaker_encoder_weights(np.random.default_rng(733),
                                          jse.tiny_speaker_encoder_config())
    return cfg, jw, W.tree_from_numpy(jax.tree.map(np.asarray, jw), "cpu")


def test_mel_matches_naive_dft_and_jax():
    cfg = SpeakerEncoderConfig(**MEL_CFG)
    samples = np.random.default_rng(731).standard_normal(300).astype(
        np.float32)
    fast = se.mel_spectrogram(samples, cfg)
    np.testing.assert_allclose(fast, naive_reference_mel(samples, cfg),
                               atol=1e-3)
    np.testing.assert_array_equal(fast,
                                  jse.mel_spectrogram(samples, JCfg(**MEL_CFG)))
    np.testing.assert_array_equal(
        se.mel_filterbank_slaney(128, 1024, 24000, 0.0, 12000.0),
        jse.mel_filterbank_slaney(128, 1024, 24000, 0.0, 12000.0))


def test_mel_batch_matches_host_mel_and_jax():
    """Device mel of mixed-length clips zero-padded to one bucket: equal
    to the host mel of each clip up to its frame count, zero past it; and
    to the JAX package's batched mel."""
    cfg = SpeakerEncoderConfig(**MEL_CFG)
    rng = np.random.default_rng(732)
    lens = [300, 190, 512]
    clips = [rng.standard_normal(n).astype(np.float32) for n in lens]
    batch = np.zeros((len(clips), max(lens)), np.float32)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    mel, n_frames = se.mel_spectrogram_batch(
        torch.from_numpy(batch), torch.tensor(lens, dtype=torch.int32), cfg)
    assert mel.dtype == torch.float32 and n_frames.dtype == torch.int32
    mel, n_frames = mel.numpy(), n_frames.numpy()
    jmel, jn = jse.mel_spectrogram_batch(
        jnp.asarray(batch), jnp.asarray(lens, dtype=jnp.int32), JCfg(**MEL_CFG))
    np.testing.assert_array_equal(n_frames, np.asarray(jn))
    np.testing.assert_allclose(mel, np.asarray(jmel), atol=1e-4, rtol=1e-4)
    for i, c in enumerate(clips):
        want = se.mel_spectrogram(c, cfg)
        assert n_frames[i] == want.shape[0] == se.mel_frames_for_samples(
            lens[i], cfg)
        np.testing.assert_allclose(mel[i, :n_frames[i]], want, atol=1e-4,
                                   rtol=1e-4)
        assert np.all(mel[i, n_frames[i]:] == 0.0)


def test_encode_matches_jax(enc):
    """Ragged valid lengths in one bucket: the embeddings of the JAX
    encode on the same weights (test_speaker_encoder.py's tolerance)."""
    cfg, jw, tw = enc
    rng = np.random.default_rng(734)
    mel = rng.standard_normal((3, 48, cfg.n_mels)).astype(np.float32)
    n = np.array([48, 20, 33], np.int32)
    want = np.asarray(jse.encode(jw, jse.tiny_speaker_encoder_config(),
                                 jnp.asarray(mel), jnp.asarray(n)))
    got = se.encode(tw, cfg, torch.from_numpy(mel), torch.from_numpy(n))
    assert got.shape == (3, cfg.embedding_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_bucket_padding_invariance(enc):
    cfg, _, tw = enc
    T = 20
    mel = np.random.default_rng(735).standard_normal(
        (1, T, cfg.n_mels)).astype(np.float32)
    padded = np.zeros((1, 48, cfg.n_mels), np.float32)
    padded[:, :T] = mel
    n_valid = torch.tensor([T])
    e_exact = se.encode(tw, cfg, torch.from_numpy(mel), n_valid)
    e_padded = se.encode(tw, cfg, torch.from_numpy(padded), n_valid)
    np.testing.assert_allclose(e_exact.numpy(), e_padded.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_batch_independent_lengths(enc):
    cfg, _, tw = enc
    rng = np.random.default_rng(736)
    m1 = rng.standard_normal((1, 24, cfg.n_mels)).astype(np.float32)
    m2 = rng.standard_normal((1, 40, cfg.n_mels)).astype(np.float32)
    batch = np.zeros((2, 40, cfg.n_mels), np.float32)
    batch[0, :24] = m1[0]
    batch[1] = m2[0]
    eb = se.encode(tw, cfg, torch.from_numpy(batch), torch.tensor([24, 40]))
    e1 = se.encode(tw, cfg, torch.from_numpy(m1), torch.tensor([24]))
    e2 = se.encode(tw, cfg, torch.from_numpy(m2), torch.tensor([40]))
    np.testing.assert_allclose(eb[0].numpy(), e1[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(eb[1].numpy(), e2[0].numpy(), atol=1e-4)


def test_reflect_pad_at_valid_lengths():
    """Each stream mirrors at its own valid length, not at the buffer's
    end; the JAX package's pad on the same input."""
    x = np.arange(12, dtype=np.float32).reshape(2, 6, 1)
    n = np.array([4, 6], np.int32)
    got = se.reflect_pad_time(torch.from_numpy(x).transpose(1, 2), 2,
                              torch.from_numpy(n)).transpose(1, 2).numpy()
    np.testing.assert_array_equal(got[0, :8, 0], [2, 1, 0, 1, 2, 3, 2, 1])
    np.testing.assert_array_equal(got[1, :, 0] - 6,
                                  [2, 1, 0, 1, 2, 3, 4, 5, 4, 3])
    np.testing.assert_array_equal(
        got, np.asarray(jse._reflect_pad_time(jnp.asarray(x), 2,
                                              jnp.asarray(n))))


def test_mel_batch_end_to_end_encode(enc):
    """Device mel -> encode equals host mel -> encode, clip by clip."""
    cfg, _, tw = enc
    mcfg = SpeakerEncoderConfig(**MEL_CFG, embedding_dim=cfg.embedding_dim,
                                hidden_dim=cfg.hidden_dim,
                                res2net_scale=cfg.res2net_scale)
    rng = np.random.default_rng(737)
    lens = [400, 256]
    clips = [rng.standard_normal(n).astype(np.float32) for n in lens]
    N = se.bucket_samples(max(lens), mcfg, bucket_s=512 / 24000)
    batch = np.zeros((len(clips), N), np.float32)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    mel, n_frames = se.mel_spectrogram_batch(
        torch.from_numpy(batch), torch.tensor(lens), mcfg)
    eb = se.encode(tw, mcfg, mel, n_frames)
    for i, c in enumerate(clips):
        m = se.mel_spectrogram(c, mcfg)
        e1 = se.encode(tw, mcfg, torch.from_numpy(m[None]),
                       torch.tensor([m.shape[0]]))
        np.testing.assert_allclose(eb[i].numpy(), e1[0].numpy(), atol=1e-3,
                                   rtol=1e-3)


def test_buckets_and_config_match_jax():
    cfg, jcfg = SpeakerEncoderConfig(), JCfg()
    for n in (1, 23999, 24000, 24001, 240000):
        assert se.bucket_samples(n, cfg) == jse.bucket_samples(n, jcfg)
        assert se.mel_frames_for_samples(n, cfg) == \
            jse.mel_frames_for_samples(n, jcfg)
    for t in (1, 127, 128, 129, 940):
        assert se.bucket_frames(t) == jse.bucket_frames(t)
    assert se.tiny_speaker_encoder_config() == SpeakerEncoderConfig(
        **vars(jse.tiny_speaker_encoder_config()))


def test_random_init_shapes_match_jax():
    cfg = se.tiny_speaker_encoder_config()
    tw = se.init_speaker_encoder_weights(cfg, torch.Generator().manual_seed(1),
                                         "cpu")
    jw = jse.init_speaker_encoder_weights(np.random.default_rng(738),
                                          jse.tiny_speaker_encoder_config())
    got = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tw)
    want = jax.tree.map(lambda a: (tuple(a.shape), torch.float32), jw)
    assert got == want
