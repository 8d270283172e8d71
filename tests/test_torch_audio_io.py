"""The port's runtime/audio_io.py against the JAX package's: WAV formats
and the mono downmix, the linear resampler, and the .embd cache."""

import struct

import numpy as np
import pytest

from qwen3_tts_tpu.runtime import audio_io as jio
from qwen3_tts_tpu_torch.runtime import audio_io as tio


def _wav(path, payload: bytes, fmt: int, n_ch: int, sr: int, bits: int,
         extra_chunk: bool = False):
    with open(path, "wb") as f:
        body = b"WAVE"
        if extra_chunk:                        # odd-sized chunk: padded
            body += b"LIST" + struct.pack("<I", 3) + b"abc\x00"
        body += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, n_ch, sr,
                                      sr * n_ch * bits // 8,
                                      n_ch * bits // 8, bits)
        body += b"data" + struct.pack("<I", len(payload)) + payload
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("kind", ["pcm16", "pcm32", "f32-stereo",
                                  "pcm16-list-chunk"])
def test_load_wav_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(751)
    x = rng.uniform(-0.9, 0.9, 600).astype(np.float32)
    path = str(tmp_path / f"{kind}.wav")
    if kind.startswith("pcm16"):
        _wav(path, (x * 32767).astype("<i2").tobytes(), 1, 1, 16000, 16,
             extra_chunk=kind.endswith("chunk"))
    elif kind == "pcm32":
        _wav(path, (x * 2**31).astype("<i4").tobytes(), 1, 1, 22050, 32)
    else:
        _wav(path, np.stack([x, -x / 2], 1).astype("<f4").tobytes(), 3, 2,
             24000, 32)
    got, sr = tio.load_wav(path)
    want, jsr = jio.load_wav(path)
    assert sr == jsr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_save_then_load_roundtrip(tmp_path):
    x = np.linspace(-1.2, 1.2, 1001).astype(np.float32)
    path = str(tmp_path / "out.wav")
    tio.save_wav(path, x, 24000)
    got, sr = tio.load_wav(path)
    assert sr == 24000 and got.shape == x.shape
    np.testing.assert_allclose(got, np.clip(x, -1, 1), atol=2 / 32767)
    assert open(path, "rb").read() == _jax_saved(tmp_path, x)


def _jax_saved(tmp_path, x):
    path = str(tmp_path / "jax.wav")
    jio.save_wav(path, x, 24000)
    return open(path, "rb").read()


def test_load_wav_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"NOTAWAVE" * 4)
    with pytest.raises(ValueError, match="RIFF"):
        tio.load_wav(str(bad))
    path = str(tmp_path / "u8.wav")
    _wav(path, bytes(10), 1, 1, 8000, 8)
    with pytest.raises(ValueError, match="unsupported"):
        tio.load_wav(path)


@pytest.mark.parametrize("rates", [(16000, 24000), (44100, 24000),
                                   (24000, 24000), (12500, 24000)])
def test_resample_linear_matches_jax(rates):
    x = np.random.default_rng(752).standard_normal(777).astype(np.float32)
    got = tio.resample_linear(x, *rates)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.resample_linear(x, *rates))
    assert tio.resample_linear(np.zeros(0, np.float32), *rates).shape == (0,)


def test_embedding_cache_roundtrip(tmp_path):
    e = np.random.default_rng(753).standard_normal(1024).astype(np.float32)
    path = str(tmp_path / "v.embd")
    assert tio.save_embedding(path, e)
    np.testing.assert_array_equal(tio.load_embedding(path), e)
    np.testing.assert_array_equal(jio.load_embedding(path), e)
    assert tio.load_embedding(str(tmp_path / "missing.embd")) is None
    (tmp_path / "odd.embd").write_bytes(b"abc")
    assert tio.load_embedding(str(tmp_path / "odd.embd")) is None
    assert not tio.save_embedding(str(tmp_path / "no" / "x.embd"), e)
