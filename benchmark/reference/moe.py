"""The plain reference of a sparse mixture-of-experts decoder stack:
Qwen3-Omni's talker (transformers' ``Qwen3OmniMoeTalkerDecoderLayer``
with ``Qwen3OmniMoeTalkerTextSparseMoeBlock``), built from
reference/layers.py's norms, RoPE and attention. Float32 products (or the
float8 control, ``Prec``), no cache, no batching tricks, no kernel; the
routed experts are computed one expert at a time over the tokens routed
to it, by indexing. It reads the layout of benchmark/archs/
qwen3_omni_moe_talker.py (the program's): router ``w_router`` [L, H, E],
experts ``w_gu_e`` [L, E, H, 2 Ie] ([gate | up]) and ``w_down_e`` [L, E,
Ie, H], shared expert ``w_gu_s`` [L, H, 2 Is], ``w_down_s`` [L, Is, H] and
its gate ``w_sgate`` [L, H].

The block: p = softmax(h W_router) in f32; (w, e) = top-k of p, w
renormalised over the k when ``norm_topk_prob``, then cast to bf16 (the
published block casts to the hidden dtype); y = sum_j w_j down_e(silu(
gate_e h) * up_e h) + sigmoid(h . w_sgate) shared(h).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Prec, attention, rms_norm, rope


def route(p: Prec, h, w_router, top_k: int, norm_topk_prob: bool):
    """(experts [N, k], weights [N, k]) of rows h [N, H]."""
    probs = torch.softmax(p.mm(h, w_router), dim=-1)
    w, e = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return e, w.to(torch.bfloat16).float()


def swiglu(p: Prec, h, w_gu, w_down):
    g, u = p.mm(h, w_gu).chunk(2, dim=-1)
    return p.mm(F.silu(g) * u, w_down)


def moe_block(p: Prec, lw: dict, l: int, h, n_experts: int, top_k: int,
              norm_topk_prob: bool, routes: list | None = None):
    """Layer l's sparse MoE block over rows h [N, H] -> [N, H] f32;
    `routes`, when a list, gains the experts chosen [N, k]."""
    e, w = route(p, h, lw["w_router"][l], top_k, norm_topk_prob)
    if routes is not None:
        routes.append(e)
    y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for ex in range(n_experts):
        t, j = (e == ex).nonzero(as_tuple=True)
        if len(t):
            o = swiglu(p, h[t], lw["w_gu_e"][l][ex], lw["w_down_e"][l][ex])
            y.index_add_(0, t, w[t, j, None] * o)
    gate = torch.sigmoid(p.mm(h, lw["w_sgate"][l][:, None])[:, 0])
    return y + gate[:, None] * swiglu(p, h, lw["w_gu_s"][l],
                                      lw["w_down_s"][l])


def moe_stack(p: Prec, lw: dict, x, *, heads, kv_heads, head_dim, eps,
              theta, n_experts, top_k, norm_topk_prob, routes=None):
    """Qwen3 attention layers with per-head q/k RMSNorm and a sparse MoE
    FFN: x [B, T, H] -> the last layer's output [B, T, H] (before the
    output norm). `routes`, when a list, gains each layer's experts
    [B * T, k]."""
    B, T, H = x.shape
    nq, nk = heads * head_dim, kv_heads * head_dim
    x = x.float()
    for l in range(lw["attn_norm"].shape[0]):
        h = rms_norm(x, lw["attn_norm"][l], eps)
        qkv = p.mm(h, lw["wqkv"][l])
        q = qkv[..., :nq].reshape(B, T, heads, head_dim)
        k = qkv[..., nq:nq + nk].reshape(B, T, kv_heads, head_dim)
        v = qkv[..., nq + nk:].reshape(B, T, kv_heads, head_dim)
        q = rope(rms_norm(q, lw["q_norm"][l], eps), theta)
        k = rope(rms_norm(k, lw["k_norm"][l], eps), theta)
        x = x + p.mm(attention(p, q, k, v), lw["wo"][l])
        h = rms_norm(x, lw["ffn_norm"][l], eps).reshape(B * T, H)
        x = x + moe_block(p, lw, l, h, n_experts, top_k, norm_topk_prob,
                          routes).reshape(B, T, H)
    return x
