"""Speaker encoder: log-mel front end + ECAPA-TDNN -> voice embedding
(port of qwen3_tts_tpu/models/speaker_encoder.py).

- Mel front end: reflect pad (n_fft - hop) / 2, a periodic Hann window
  centred in n_fft, magnitude STFT, slaney mel filterbank,
  log(clamp(1e-5)). Two implementations of the same numerics: host numpy
  for one clip (``mel_spectrogram``) and ``torch.fft.rfft`` on the
  device for a batch of clips (``mel_spectrogram_batch``).
- ECAPA graph (``encode``): conv0 k=5 (reflect pad), 3 SE-Res2Net blocks
  (dilations 2 / 3 / 4), the MFA concat, attentive statistics pooling and
  the FC to the embedding. Layout [B, C, T] with ``F.conv1d``.

Clips are padded to length buckets; every reflect pad mirrors at each
stream's valid length and every pooling masks past it, so an embedding
does not depend on its bucket or its batch. The JAX package computes all
of this outside any Pallas kernel, so the port has no kernel here.

Precision: the graph is f32 and runs with TF32 off inside ``encode`` and
``mel_spectrogram_batch`` whatever the caller's global flags (PyTorch
leaves cuDNN's TF32 on by default, which would move the embedding ~1e-3).
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SpeakerEncoderConfig

WDT = torch.float32
NEG_INF = float(torch.finfo(torch.float32).min)


@contextlib.contextmanager
def full_f32():
    """f32 products and convolutions on the card: TF32 off for cuBLAS and
    cuDNN for the duration, the caller's settings restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


# ---------------------------------------------------------------------------
# Mel front end (host numpy)
# ---------------------------------------------------------------------------

def _hz_to_mel_slaney(hz: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(hz < min_log_hz, hz / f_sp,
                    min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep)


def _mel_to_hz_slaney(mel: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel < min_log_mel, f_sp * mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)))


def mel_filterbank_slaney(n_mels: int, n_fft: int, sample_rate: int,
                          f_min: float, f_max: float) -> np.ndarray:
    """librosa-compatible slaney-normalized triangular mel filterbank
    [n_mels, n_fft // 2 + 1]."""
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel_slaney(np.float64(f_min)),
                          _hz_to_mel_slaney(np.float64(f_max)), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fft_freqs = np.arange(n_bins) * sample_rate / n_fft

    fb = np.zeros((n_mels, n_bins), np.float32)
    for m in range(n_mels):
        f_l, f_c, f_r = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        enorm = 2.0 / (f_r - f_l)
        up = (fft_freqs - f_l) / max(f_c - f_l, 1e-10)
        down = (f_r - fft_freqs) / max(f_r - f_c, 1e-10)
        tri = np.where(
            (fft_freqs >= f_l) & (fft_freqs <= f_c), up,
            np.where((fft_freqs > f_c) & (fft_freqs <= f_r), down, 0.0))
        fb[m] = (enorm * tri).astype(np.float32)
    return fb


def _centered_hann(cfg: SpeakerEncoderConfig) -> np.ndarray:
    """Periodic Hann of win_length centred in an n_fft window."""
    window = np.zeros(cfg.n_fft, np.float32)
    off = (cfg.n_fft - cfg.win_length) // 2
    i = np.arange(cfg.win_length)
    window[off:off + cfg.win_length] = \
        0.5 * (1.0 - np.cos(2.0 * np.pi * i / cfg.win_length))
    return window


def mel_spectrogram(samples: np.ndarray,
                    cfg: SpeakerEncoderConfig) -> np.ndarray:
    """Log-mel [n_frames, n_mels] of one clip, on the host."""
    n = len(samples)
    pad = (cfg.n_fft - cfg.hop_length) // 2

    idx = np.arange(-pad, n + pad)
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= n, 2 * n - idx - 2, idx)
    idx = np.clip(idx, 0, n - 1)
    padded = samples[idx].astype(np.float32)

    n_frames = (len(padded) - cfg.n_fft) // cfg.hop_length + 1
    if n_frames <= 0:
        raise ValueError("audio too short for mel spectrogram")

    window = _centered_hann(cfg)
    starts = np.arange(n_frames) * cfg.hop_length
    frames = padded[starts[:, None] + np.arange(cfg.n_fft)[None, :]] * window
    spec = np.fft.rfft(frames, axis=1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9).astype(np.float32)

    fb = mel_filterbank_slaney(cfg.n_mels, cfg.n_fft, cfg.sample_rate,
                               cfg.f_min, cfg.f_max)
    mel = mag @ fb.T                                      # [n_frames, n_mels]
    return np.log(np.maximum(mel, 1e-5)).astype(np.float32)


def mel_frames_for_samples(n_samples: int, cfg: SpeakerEncoderConfig) -> int:
    pad = (cfg.n_fft - cfg.hop_length) // 2
    return (n_samples + 2 * pad - cfg.n_fft) // cfg.hop_length + 1


def bucket_samples(n_samples: int, cfg: SpeakerEncoderConfig,
                   bucket_s: float = 1.0) -> int:
    """A clip length rounded up to a whole `bucket_s` bucket."""
    step = max(int(cfg.sample_rate * bucket_s), 1)
    return max(((n_samples + step - 1) // step) * step, step)


def bucket_frames(n_frames: int, bucket: int = 128) -> int:
    return max(((n_frames + bucket - 1) // bucket) * bucket, bucket)


def _reflect_index(n_valid: torch.Tensor, length: int, pad: int
                   ) -> torch.Tensor:
    """[B, length + 2 pad] source positions of a reflect pad that mirrors
    at each stream's valid length n_valid[b], not at the buffer's end."""
    p = torch.arange(-pad, length + pad, device=n_valid.device)[None, :]
    n = n_valid.long()[:, None]
    src = torch.where(p < 0, -p, p)
    src = torch.where(src >= n, 2 * n - src - 2, src)
    return torch.minimum(src.clamp(min=0), (n - 1).clamp(min=0))


def mel_spectrogram_batch(samples: torch.Tensor, n_samples: torch.Tensor,
                          cfg: SpeakerEncoderConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-mel of a batch of clips on their device, matching
    `mel_spectrogram`. samples [B, N] f32 zero-padded to a length bucket;
    n_samples [B]. Returns (mel [B, F, n_mels] f32, n_frames [B] int32),
    F = mel_frames_for_samples(N), rows at and past n_frames[b] zero."""
    B, N = samples.shape
    dev = samples.device
    pad = (cfg.n_fft - cfg.hop_length) // 2
    F_ = (N + 2 * pad - cfg.n_fft) // cfg.hop_length + 1
    if F_ <= 0:
        raise ValueError("sample bucket too short for mel spectrogram")
    padded = torch.gather(samples.float(), 1,
                          _reflect_index(n_samples, N, pad))
    frames = padded.unfold(1, cfg.n_fft, cfg.hop_length)     # [B, F, n_fft]
    window = torch.as_tensor(_centered_hann(cfg), device=dev)
    fb = torch.as_tensor(mel_filterbank_slaney(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.f_min, cfg.f_max),
        device=dev)
    with full_f32():
        spec = torch.fft.rfft(frames * window, dim=-1)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
        mel = torch.log(torch.clamp(mag @ fb.t(), min=1e-5))
    n_frames = torch.clamp(
        (n_samples.long() + 2 * pad - cfg.n_fft) // cfg.hop_length + 1,
        min=0).to(torch.int32)
    valid = torch.arange(F_, device=dev)[None, :] < n_frames[:, None]
    return torch.where(valid[..., None], mel, 0.0), n_frames


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def load_speaker_encoder_weights(r, cfg: SpeakerEncoderConfig, device,
                                 stager=None) -> dict[str, Any]:
    """spk_enc.* tensors of the TTS GGUF (`r`, io.gguf.GGUFReader), f32 on
    `device`, in the JAX package's tree."""
    def t(name):
        return r.tensor(name, device, WDT, stager)

    def blk(i):
        p = f"spk_enc.blk.{i}"
        return {
            "tdnn1_w": t(f"{p}.tdnn1.weight"), "tdnn1_b": t(f"{p}.tdnn1.bias"),
            "res2net_w": torch.stack([t(f"{p}.res2net.{j}.weight")
                                      for j in range(cfg.res2net_scale - 1)]),
            "res2net_b": torch.stack([t(f"{p}.res2net.{j}.bias")
                                      for j in range(cfg.res2net_scale - 1)]),
            "tdnn2_w": t(f"{p}.tdnn2.weight"), "tdnn2_b": t(f"{p}.tdnn2.bias"),
            "se1_w": t(f"{p}.se.conv1.weight"), "se1_b": t(f"{p}.se.conv1.bias"),
            "se2_w": t(f"{p}.se.conv2.weight"), "se2_b": t(f"{p}.se.conv2.bias"),
        }
    return {
        "conv0_w": t("spk_enc.conv0.weight"),
        "conv0_b": t("spk_enc.conv0.bias"),
        "blocks": [blk(i) for i in (1, 2, 3)],
        "mfa_w": t("spk_enc.mfa.weight"), "mfa_b": t("spk_enc.mfa.bias"),
        "asp_tdnn_w": t("spk_enc.asp.tdnn.weight"),
        "asp_tdnn_b": t("spk_enc.asp.tdnn.bias"),
        "asp_conv_w": t("spk_enc.asp.conv.weight"),
        "asp_conv_b": t("spk_enc.asp.conv.bias"),
        "fc_w": t("spk_enc.fc.weight"), "fc_b": t("spk_enc.fc.bias"),
    }


def tiny_speaker_encoder_config() -> SpeakerEncoderConfig:
    return SpeakerEncoderConfig(n_mels=8, n_fft=64, hop_length=16,
                                win_length=64, embedding_dim=16,
                                hidden_dim=16, res2net_scale=4, f_max=12000.0)


def init_speaker_encoder_weights(cfg: SpeakerEncoderConfig,
                                 generator: torch.Generator, device
                                 ) -> dict[str, Any]:
    """Random f32 weights in the JAX package's tree: conv kernels
    normal(0, 1/sqrt(fan_in)), which keeps the activations O(1) at the
    full widths, and biases normal(0, 0.1) where the JAX init has zeros,
    so that a path that drops one is seen."""
    h = cfg.hidden_dim
    branch = h // cfg.res2net_scale
    se_mid = max(h // 4, 1)
    mfa = 3 * h

    def conv(*shape):
        fan_in = shape[-2] * shape[-1]
        return torch.randn(shape, generator=generator,
                           device=device) * fan_in ** -0.5

    def bias(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.1

    def blk():
        return {
            "tdnn1_w": conv(h, h, 1), "tdnn1_b": bias(h),
            "res2net_w": conv(cfg.res2net_scale - 1, branch, branch, 3),
            "res2net_b": bias(cfg.res2net_scale - 1, branch),
            "tdnn2_w": conv(h, h, 1), "tdnn2_b": bias(h),
            "se1_w": conv(se_mid, h, 1), "se1_b": bias(se_mid),
            "se2_w": conv(h, se_mid, 1), "se2_b": bias(h),
        }
    return {
        "conv0_w": conv(h, cfg.n_mels, 5), "conv0_b": bias(h),
        "blocks": [blk() for _ in range(3)],
        "mfa_w": conv(mfa, mfa, 1), "mfa_b": bias(mfa),
        "asp_tdnn_w": conv(se_mid, mfa * 3, 1), "asp_tdnn_b": bias(se_mid),
        "asp_conv_w": conv(mfa, se_mid, 1), "asp_conv_b": bias(mfa),
        "fc_w": conv(cfg.embedding_dim, 2 * mfa, 1),
        "fc_b": bias(cfg.embedding_dim),
    }


# ---------------------------------------------------------------------------
# Forward ([B, C, T], valid-length masks)
# ---------------------------------------------------------------------------

def reflect_pad_time(x: torch.Tensor, pad: int,
                     n_valid: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C, T + 2 pad], reflected at each stream's valid
    length (F.pad(mode="reflect") would reflect at the bucket's end)."""
    B, C, T = x.shape
    idx = _reflect_index(n_valid, T, pad)
    return torch.gather(x, 2, idx[:, None, :].expand(B, C, T + 2 * pad))


def _conv1d(x, w, b, n_valid, dilation: int = 1, reflect_pad: int = 0):
    if reflect_pad > 0:
        x = reflect_pad_time(x, reflect_pad, n_valid)
    return F.conv1d(x, w, b, dilation=dilation)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid time steps. x [B, C, T]; mask [B, T] -> [B, C]."""
    s = (x * mask[:, None, :]).sum(dim=2)
    return s / torch.clamp(mask.sum(dim=1), min=1.0)[:, None]


def encode(w, cfg: SpeakerEncoderConfig, mel: torch.Tensor,
           n_valid: torch.Tensor) -> torch.Tensor:
    """ECAPA-TDNN forward. mel [B, T, n_mels] f32 zero-padded to a bucket;
    n_valid [B] valid frames. Returns embeddings [B, embedding_dim] f32."""
    with full_f32():
        return _encode(w, cfg, mel, n_valid)


def _encode(w, cfg, mel, n_valid):
    B, T, _ = mel.shape
    n_valid = n_valid.to(mel.device)
    mask = (torch.arange(T, device=mel.device)[None, :]
            < n_valid[:, None]).float()
    x = torch.relu(_conv1d(mel.float().transpose(1, 2), w["conv0_w"],
                           w["conv0_b"], n_valid, reflect_pad=2))

    scale = cfg.res2net_scale
    block_outs = []
    for blk_w, dilation in zip(w["blocks"], (2, 3, 4)):
        residual = x
        x = torch.relu(_conv1d(x, blk_w["tdnn1_w"], blk_w["tdnn1_b"], n_valid))
        # Res2Net: branch 0 passes through; branch i >= 1 convolves its
        # slice plus (from branch 2 on) the previous branch's output
        branches = torch.chunk(x, scale, dim=1)
        outs = [branches[0]]
        for i in range(1, scale):
            inp = branches[i] if i == 1 else branches[i] + outs[-1]
            outs.append(torch.relu(_conv1d(
                inp, blk_w["res2net_w"][i - 1], blk_w["res2net_b"][i - 1],
                n_valid, dilation=dilation, reflect_pad=dilation)))
        x = torch.cat(outs, dim=1)
        x = torch.relu(_conv1d(x, blk_w["tdnn2_w"], blk_w["tdnn2_b"], n_valid))
        # squeeze-excitation over the valid frames
        se = _masked_mean(x, mask)[:, :, None]
        se = torch.relu(F.conv1d(se, blk_w["se1_w"], blk_w["se1_b"]))
        se = torch.sigmoid(F.conv1d(se, blk_w["se2_w"], blk_w["se2_b"]))
        x = x * se + residual
        block_outs.append(x)

    x = torch.relu(F.conv1d(torch.cat(block_outs, dim=1), w["mfa_w"],
                            w["mfa_b"]))

    # attentive statistics pooling
    g_mean = _masked_mean(x, mask)
    g_sq = _masked_mean(x * x, mask)
    g_std = torch.sqrt(torch.clamp(g_sq - g_mean * g_mean, 1e-12, 1e10))
    C = x.shape[1]
    attn_in = torch.cat([x, g_mean[:, :, None].expand(B, C, T),
                         g_std[:, :, None].expand(B, C, T)], dim=1)
    a = torch.tanh(torch.relu(F.conv1d(attn_in, w["asp_tdnn_w"],
                                       w["asp_tdnn_b"])))
    a = F.conv1d(a, w["asp_conv_w"], w["asp_conv_b"])
    a = torch.where(mask[:, None, :] > 0, a, NEG_INF)
    a = torch.softmax(a, dim=2)                           # over time

    wm = (a * x * mask[:, None, :]).sum(dim=2)
    var = (a * (x - wm[:, :, None]) ** 2 * mask[:, None, :]).sum(dim=2)
    ws = torch.sqrt(torch.clamp(var, 1e-12, 1e10))
    pooled = torch.cat([wm, ws], dim=1)[:, :, None]        # [B, 2C, 1]
    return F.conv1d(pooled, w["fc_w"], w["fc_b"])[:, :, 0]
