"""Operations and bytes of each layer's work, counted from shapes, and the
chip's peaks. A layer's roofline share is the least time the chip could
take (the larger of operations at the peak rate and bytes at the peak
bandwidth) over the time it took. Matrix products and convolutions count
2 operations a multiply-add; norms, activations and sampling are not
counted. Bytes count each input once and each output once: weights (bf16
matrices, f32 vectors), the valid KV positions of the cache (not the
bucket it is read in), the rows an embedding lookup gathers, and what a
call reads in and writes out.

Here are the peaks and the counts of the shared layers (a dense decoder
stack, the vocoder); each architecture (benchmark/archs/) counts its own
calls from them. Whatever implements a layer, these counts are the same,
so its share is comparable across implementations and configurations."""

from __future__ import annotations

import math

import torch

from .model import Stack

# NVIDIA H100 SXM5 80 GB data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth, at the full 700 W power limit.
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def share_pct(flops: float, nbytes: float, seconds: float) -> float:
    return 100.0 * bound_s(flops, nbytes) / seconds


def layer_matrix_params(s: Stack) -> int:
    """Matrix elements of one decoder layer (fused qkv, wo, gate|up,
    down)."""
    H, D = s.hidden, s.head_dim
    return (H * (s.heads + 2 * s.kv_heads) * D + s.heads * D * H
            + 3 * H * s.intermediate)


def layer_vector_params(s: Stack) -> int:
    return 2 * s.hidden + 2 * s.head_dim


def attn_flops(s: Stack, n_keys: int) -> int:
    """QK^T and PV of one query over n_keys keys, one layer."""
    return 4 * s.heads * s.head_dim * n_keys


def vocoder_flops_per_stream(m, frames: int) -> float:
    """Operations of decoding `frames` frames of one stream."""
    v, T = m.vocoder, frames
    w, q = v.hidden, v.latent_dim
    f = 2 * T * v.codebook_dim * w * 2                        # vq projections
    f += 2 * T * 3 * w * q                                    # pre_conv
    f += 2 * T * q * w * 2                                    # in / out
    f += v.layers * (2 * T * (4 * w * q + 6 * w * w)
                     + 4 * q * T * (T + 1) // 2)              # layers
    t = T
    for _ in range(2):                                        # ConvNeXt 2x
        f += 2 * t * q * q * 2
        t *= 2
        f += 2 * t * q * 7 + 2 * t * q * 2 * q * 2
    c = v.decoder_dim
    f += 2 * t * 7 * q * c                                    # dec0
    for r in v.upsample_rates:
        c2 = c // 2
        f += 2 * t * c * c2 * 2 * r                           # convT
        t *= r
        f += 3 * 2 * t * 8 * c2 * c2                          # 3 residual units
        c = c2
    f += 2 * t * 7 * c                                        # final conv
    return float(f)


def vocoder_weight_bytes(m) -> int:
    from .weights import vocoder_spec
    spec = vocoder_spec(m, torch.bfloat16)
    return sum(math.prod(l.shape) * l.dtype.itemsize for l in spec.leaves
               if "codebook" not in l.path[0])


def vocoder_chunk(m, n: int, frames: int = 40) -> tuple[float, float]:
    """One decode of n streams' `frames`-frame chunks into int16 PCM."""
    v = m.vocoder
    tables = v.n_codebooks * v.codebook_size * v.codebook_dim
    rows = min(n * frames * v.n_codebooks * v.codebook_dim, tables)
    nbytes = (vocoder_weight_bytes(m) + BF16 * rows
              + n * frames * (4 * v.n_codebooks + 2 * v.samples_per_frame))
    return n * vocoder_flops_per_stream(m, frames), nbytes
