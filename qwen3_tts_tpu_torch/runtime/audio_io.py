"""WAV I/O, resampling and the speaker-embedding cache, on the host (the
port's own copy of qwen3_tts_tpu/runtime/audio_io.py).

16/32-bit PCM and 32-bit IEEE float input with a mono downmix, 16-bit PCM
output, the linear resampler of the reference, and the raw-f32 ``.embd``
speaker-embedding format. Plain numpy.
"""

from __future__ import annotations

import struct

import numpy as np


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Load a WAV file -> (mono float32 samples in [-1,1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if chunk_id == b"fmt ":
            audio_format, n_ch, sr, _, _, bits = struct.unpack_from(
                "<HHIIHH", data, body)
            fmt = (audio_format, n_ch, sr, bits)
        elif chunk_id == b"data":
            if fmt is None:
                raise ValueError(f"{path}: data chunk before fmt")
            audio_format, n_ch, sr, bits = fmt
            raw = data[body:body + chunk_size]
            if audio_format == 1 and bits == 16:
                x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
            elif audio_format == 1 and bits == 32:
                x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
            elif audio_format == 3 and bits == 32:
                x = np.frombuffer(raw, "<f4").astype(np.float32)
            else:
                raise ValueError(
                    f"{path}: unsupported format {audio_format}/{bits}-bit")
            n = len(x) // n_ch
            mono = x[:n * n_ch].reshape(n, n_ch).mean(axis=1)
            return mono.astype(np.float32), sr
        pos = body + chunk_size + (chunk_size & 1)
    raise ValueError(f"{path}: no data chunk found")


def save_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Save mono float samples as 16-bit PCM WAV."""
    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    data_size = pcm.nbytes
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(pcm.tobytes())


def resample_linear(x: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Linear-interpolation resampler (resample_linear, qwen3_tts.cpp:83-101)."""
    if in_rate == out_rate:
        return np.asarray(x, np.float32)
    if len(x) == 0:  # reference returns empty for empty (qwen3_tts.cpp:85)
        return np.zeros(0, np.float32)
    ratio = in_rate / out_rate
    out_len = int(len(x) / ratio)
    src = np.arange(out_len) * ratio
    idx0 = src.astype(np.int64)
    idx1 = idx0 + 1
    frac = (src - idx0).astype(np.float32)
    last = np.float32(x[-1])
    x = np.asarray(x, np.float32)
    x1 = np.where(idx1 >= len(x), last, x[np.minimum(idx1, len(x) - 1)])
    return ((1.0 - frac) * x[idx0] + frac * x1).astype(np.float32)


def load_embedding(path: str) -> np.ndarray | None:
    """Raw-f32 speaker embedding cache (.embd; main.cpp:38-50)."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return None
    if len(buf) == 0 or len(buf) % 4 != 0:
        return None
    return np.frombuffer(buf, "<f4").copy()


def save_embedding(path: str, embd: np.ndarray) -> bool:
    try:
        with open(path, "wb") as f:
            f.write(np.asarray(embd, "<f4").tobytes())
        return True
    except OSError:
        return False
