"""The plain reference of multi-head latent attention as LongCat-Flash
runs it (transformers' ``LongcatFlashMLA``, DeepSeek-V3's MLA), without
absorption: float32 products (or the float8 control, ``Prec``), no cache,
no kernel. It reads the layout of benchmark/archs/longcat_flash_talker.py
(the program's, models/weights.mla_layers), linear weights [in, out]
stacked over double layers and their two sublayers.

One sublayer over normed rows h [B, T, H]: q = q_b(rmsnorm(q_a h)) *
sqrt(H / q_lora) per head [q_nope | q_rot]; [c | k_rot] = kv_a h, c =
rmsnorm(c) * sqrt(H / kv_lora); per head [k_nope | v] = kv_b c; the
interleaved RoPE (``apply_rotary_pos_emb_interleave``) on q_rot and the
one k_rot every head shares; causal softmax at (nope + rope)^-0.5; o_proj.
The low-rank norms take eps 1e-6 (``DeepseekV3RMSNorm``'s default, which
the model builds them with).
"""

from __future__ import annotations

import torch

from .layers import NEG, Prec, rms_norm

LORA_EPS = 1e-6


def rope_interleave(x, theta, positions=None):
    """Interleaved RoPE over x [B, T, heads, D] at positions [T] (0..T-1
    unless given): de-interleave the pairs, then rotate halves."""
    T, D = x.shape[1], x.shape[-1]
    x = x.reshape(*x.shape[:-1], D // 2, 2).transpose(-1, -2).reshape(x.shape)
    inv = theta ** (-torch.arange(0, D, 2, device=x.device,
                                  dtype=torch.float32) / D)
    if positions is None:
        positions = torch.arange(T, device=x.device)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mla(p: Prec, lw: dict, l: int, s: int, h, *, heads: int, q_lora: int,
        kv_lora: int, nope: int, rope: int, v_dim: int, theta: float):
    """Sublayer s of double layer l over rows h [B, T, H] -> [B, T, H]."""
    B, T, H = h.shape
    qa = rms_norm(p.mm(h, lw["wq_a"][l][s]), lw["q_a_norm"][l][s], LORA_EPS)
    q = p.mm(qa, lw["wq_b"][l][s]).reshape(B, T, heads, nope + rope)
    q = q * (H / q_lora) ** 0.5
    kv = p.mm(h, lw["wkv_a"][l][s])
    c = rms_norm(kv[..., :kv_lora], lw["kv_a_norm"][l][s], LORA_EPS)
    c = c * (H / kv_lora) ** 0.5
    kvb = p.mm(c, lw["wkv_b"][l][s]).reshape(B, T, heads, nope + v_dim)
    k_rot = rope_interleave(kv[..., None, kv_lora:], theta)
    q = torch.cat([q[..., :nope], rope_interleave(q[..., nope:], theta)], -1)
    k = torch.cat([kvb[..., :nope], k_rot.expand(B, T, heads, rope)], -1)
    scores = torch.einsum("bthd,bshd->bhts", p.q(q, -1), p.q(k, -1))
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    probs = (scores * (nope + rope) ** -0.5).masked_fill(~causal, NEG)
    o = torch.einsum("bhts,bshd->bthd", p.q(probs.softmax(-1), -1),
                     p.q(kvb[..., nope:], -1))
    return p.mm(o.reshape(B, T, heads * v_dim), lw["wo"][l][s])
