"""The plain reference of Qwen3-Omni's Code2Wav (transformers'
``Qwen3OmniMoeCode2Wav``): codes to audio through the mean of the codes'
rows of one embedding table, a pre-transformer of causal sliding-window
attention and SwiGLU with layer scales and a final norm, two ConvNeXt 2x
upsamples with the exact GELU, the Snake decoder blocks of
benchmark/reference/vocoder.py, and a clamp to [-1, 1], in the precision
a ``Prec`` gives (benchmark/reference/layers.py). ``v`` is the
architecture's Code2Wav shapes (``heads``, ``sliding_window``,
``rms_norm_eps``, ``rope_theta``, ``upsample_rates``).

Departures from the published model that the program makes too, and that
the reference therefore follows: Snake's sin^2 is the exact sine (the
program's default polynomial differs by rounding only); each 40-frame
chunk is decoded alone with its tail zero-padded and the decoder blocks'
transposed convolutions cut on the left only, as the program's streaming
decode does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import NEG, Prec, rms_norm, rope
from .vocoder import _decoder_block, _snake


def _attention(p: Prec, q, k, v, window: int):
    """Causal attention over the `window` latest positions (the query's
    own included). q / k / v [B, T, heads, D] -> [B, T, heads * D]."""
    B, T, _, D = q.shape
    q, k, v = p.q(q, -1), p.q(k, -1), p.q(v, -1)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(D)
    i = torch.arange(T, device=q.device)
    seen = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    s = s.masked_fill(~seen, NEG).softmax(-1)
    return torch.einsum("bhts,bshd->bthd", p.q(s, -1), v).reshape(B, T, -1)


def _upsample(p: Prec, u, x):
    """ConvNeXt 2x upsample over x [B, C, T]: convT (stride 2, K 2), then
    a residual of causal depthwise conv k7, LayerNorm, pointwise MLP with
    the exact GELU and the layer scale gamma."""
    x = p.conv_t1d(x, u["conv_t_w"], 2) + u["conv_t_b"].float()[None, :, None]
    c = x.shape[1]
    y = p.conv1d(x, u["dw_w"], u["dw_b"], groups=c).transpose(1, 2)
    y = F.layer_norm(y, (c,), u["ln_w"].float(), u["ln_b"].float(), 1e-6)
    y = F.gelu(p.mm(y, u["pw1_w"]) + u["pw1_b"])
    y = p.mm(y, u["pw2_w"]) + u["pw2_b"]
    return x + (y * u["gamma"].float()).transpose(1, 2)


def vocode(p: Prec, w, v, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, n] -> audio [B, T * samples_per_frame] in [-1, 1]."""
    c = codes.long()
    n = c.shape[-1]
    table = w["code_embedding"]
    offset = (table.shape[0] // n) * torch.arange(n, device=c.device)
    x = table[c + offset].float().mean(dim=-2)                  # [B, T, H]
    B, T, H = x.shape
    d = H // v.heads
    lw = w["pre_tfm"]["layers"]
    for l in range(lw["wq"].shape[0]):
        h = rms_norm(x, lw["attn_norm"][l], v.rms_norm_eps)
        q, k, vv = (p.mm(h, lw[k_][l]) for k_ in ("wq", "wk", "wv"))
        q = rope(q.reshape(B, T, v.heads, d), v.rope_theta)
        k = rope(k.reshape(B, T, v.heads, d), v.rope_theta)
        a = _attention(p, q, k, vv.reshape(B, T, v.heads, d),
                       v.sliding_window)
        x = x + p.mm(a, lw["wo"][l]) * lw["attn_scale"][l]
        h = rms_norm(x, lw["ffn_norm"][l], v.rms_norm_eps)
        act = F.silu(p.mm(h, lw["w_gate"][l])) * p.mm(h, lw["w_up"][l])
        x = x + p.mm(act, lw["w_down"][l]) * lw["ffn_scale"][l]
    x = rms_norm(x, w["pre_tfm"]["norm"], v.rms_norm_eps).transpose(1, 2)
    for u in w["upsample"]:
        x = _upsample(p, u, x)
    x = p.conv1d(x, w["dec0_w"], w["dec0_b"])
    for dec, rate in zip(w["dec_blocks"], v.upsample_rates):
        x = _decoder_block(p, dec, x, rate)
    x = p.conv1d(_snake(x, w["dec5_a"], w["dec5_b"]), w["dec6_w"],
                 w["dec6_b"])
    return x[:, 0].clamp(-1.0, 1.0)
