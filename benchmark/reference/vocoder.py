"""The plain reference of the 12 Hz tokenizer's decoder (the vocoder):
codes to audio through the codebooks, the pre-transformer, two ConvNeXt
2x upsamples and the Snake decoder blocks, in the precision a ``Prec``
gives (benchmark/reference/layers.py). Architectures that share this
decoder call ``vocode`` with their configuration's vocoder shapes
(benchmark/model.py ``Vocoder``).

Departures from the published description that the program makes too,
and that the reference therefore follows: Snake's sin^2 is the exact sine
(the program's default polynomial differs by rounding only); each
40-frame chunk is decoded alone with its tail zero-padded and a causal
trim, as the program's streaming decode does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Prec, attention, rms_norm, rope


def _snake(x, a, b):
    """x + exp(-b) sin^2(exp(a) x) per channel, x [B, C, T]."""
    a = torch.exp(a.float())[None, :, None]
    return x + torch.exp(-b.float())[None, :, None] * torch.sin(a * x) ** 2


def _pre_transformer(p: Prec, t, v, x):
    """x [B, T, latent] -> [B, T, latent]: input projection, layers of
    causal attention and SwiGLU with layer scales, norm, output
    projection."""
    B, T, _ = x.shape
    x = p.mm(x, t["in_w"]) + t["in_b"]
    lw = t["layers"]
    for l in range(lw["wq"].shape[0]):
        h = rms_norm(x, lw["attn_norm"][l], v.rms_norm_eps)
        q, k, vv = (p.mm(h, lw[n][l]) for n in ("wq", "wk", "wv"))
        d = q.shape[-1] // v.heads
        q = rope(q.reshape(B, T, v.heads, d), v.rope_theta)
        k = rope(k.reshape(B, T, v.heads, d), v.rope_theta)
        vv = vv.reshape(B, T, v.heads, d)
        x = x + p.mm(attention(p, q, k, vv), lw["wo"][l]) * lw["attn_scale"][l]
        h = rms_norm(x, lw["ffn_norm"][l], v.rms_norm_eps)
        act = F.silu(p.mm(h, lw["w_gate"][l])) * p.mm(h, lw["w_up"][l])
        x = x + p.mm(act, lw["w_down"][l]) * lw["ffn_scale"][l]
    x = rms_norm(x, t["norm"], v.rms_norm_eps)
    return p.mm(x, t["out_w"]) + t["out_b"]


def _upsample(p: Prec, u, x):
    """ConvNeXt 2x upsample over x [B, C, T]: convT (stride 2, K 2), then
    a residual of causal depthwise conv k7, LayerNorm, pointwise MLP with
    tanh GELU and the layer scale gamma."""
    x = p.conv_t1d(x, u["conv_t_w"], 2) + u["conv_t_b"].float()[None, :, None]
    c = x.shape[1]
    y = p.conv1d(x, u["dw_w"], u["dw_b"], groups=c).transpose(1, 2)
    y = F.layer_norm(y, (c,), u["ln_w"].float(), u["ln_b"].float(), 1e-6)
    y = F.gelu(p.mm(y, u["pw1_w"]) + u["pw1_b"], approximate="tanh")
    y = p.mm(y, u["pw2_w"]) + u["pw2_b"]
    return x + (y * u["gamma"].float()).transpose(1, 2)


def _decoder_block(p: Prec, d, x, rate):
    """Snake, convT (stride `rate`, K 2*rate, the first K - rate samples
    cut: T*rate out), bias, then residual units of dilation 1, 3, 9:
    x + conv1(snake(conv7_dilated(snake(x))))."""
    k = d["conv_t_w"].shape[-1]
    x = p.conv_t1d(_snake(x, d["snake_a"], d["snake_b"]), d["conv_t_w"], rate)
    x = x[:, :, k - rate:] + d["conv_t_b"].float()[None, :, None]
    for r, dil in zip(d["res"], (1, 3, 9)):
        y = p.conv1d(_snake(x, r["a1"], r["b1"]), r["c1_w"], r["c1_b"],
                     dilation=dil)
        x = x + p.conv1d(_snake(y, r["a2"], r["b2"]), r["c2_w"], r["c2_b"])
    return x


def vocode(p: Prec, w, v, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, 16] -> audio [B, T * samples_per_frame] in [-1, 1]."""
    c = codes.long()
    x = p.mm(w["vq_first_codebook"][c[..., 0]].float(), w["vq_first_out_proj"])
    rest = sum(w["vq_rest_codebooks"][j][c[..., j + 1]].float()
               for j in range(c.shape[-1] - 1))
    x = x + p.mm(rest, w["vq_rest_out_proj"])                   # [B, T, 512]
    x = p.conv1d(x.transpose(1, 2), w["pre_conv_w"], w["pre_conv_b"])
    x = _pre_transformer(p, w["pre_tfm"], v, x.transpose(1, 2))
    x = x.transpose(1, 2)
    for u in w["upsample"]:
        x = _upsample(p, u, x)
    x = p.conv1d(x, w["dec0_w"], w["dec0_b"])
    for d, rate in zip(w["dec_blocks"], v.upsample_rates):
        x = _decoder_block(p, d, x, rate)
    x = p.conv1d(_snake(x, w["dec5_a"], w["dec5_b"]), w["dec6_w"],
                 w["dec6_b"])
    return torch.tanh(x[:, 0])
