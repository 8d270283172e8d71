"""Plain reference of a talker of LongCat-Flash double layers (transformers'
``modular_longcat_flash.py``: ``LongcatFlashDecoderLayer`` with
``LongcatFlashMLA`` and the shortcut ``LongcatFlashMoE``): the full forward
pass over a sequence of input rows, in float32 plain torch, with no
cache, no batching tricks, no kernel, and latent attention without
absorption. It imports nothing of the port, of JAX or of the benchmark; it
reads a weights dict in the port's layout (models/weights.mla_layers:
linear weights [in, out], stacked over double layers and sublayers; the
held routed experts [L, held, H, 2 Ie] / [L, held, Ie, H]).

A double layer, for x:
  y = x + MLA_0(norm_in0(x)); h1 = norm_post0(y); m = MoE(h1);
  y = y + FFN_0(h1); y = y + MLA_1(norm_in1(y));
  y = y + FFN_1(norm_post1(y)) + m.
MLA: q = q_b(rmsnorm(q_a h)) * sqrt(H / Rq) per head [q_nope | q_rot];
[c | k_rot] = kv_a h, c = rmsnorm(c) * sqrt(H / R); [k_nope | v] = kv_b c
per head; the interleaved RoPE on q_rot and the one shared k_rot; causal
softmax at (dn + dr)^-0.5; o_proj. The low-rank norms take eps 1e-6 (the
model builds them with ``DeepseekV3RMSNorm``'s default). MoE: p =
softmax(h W_router) over the real and the identity experts; the top_k of
p + e_bias; weights p * routed_scaling, not renormalised; a real expert a
SwiGLU, an identity expert h itself; no shared expert.

Departures from the published model, each also made by the port:
- inputs are given as embedding rows (the port's speech interface: its
  codec and text rows), and the codec head follows the output norm;
- the experts held are those of the tree (``moe["expert_offset"]`` on,
  ``w_gu_e``'s count): what experts held elsewhere would add is left out,
  as one chip of an expert-parallel deployment leaves it out; with every
  expert held this is the published layer;
- the published model runs in bf16 throughout. The reference is float32
  with the bf16 weights as they are (TF32 off). With
  ``program_rounding`` it also rounds to bf16 where the port's prefill
  does (every product's activation input, the cache rows [c | k_rot], q,
  k and v before attention, the probabilities before P.V, the identity
  experts' input).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _r(x: torch.Tensor, on: bool) -> torch.Tensor:
    """x rounded to bf16 (when `on`), as f32."""
    return x.to(torch.bfloat16).float() if on else x.float()


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope_interleave(x, positions, theta):
    """``apply_rotary_pos_emb_interleave`` over x [B, T, heads, D] at
    positions [T]: de-interleave, then rotate halves."""
    D = x.shape[-1]
    x = x.reshape(*x.shape[:-1], D // 2, 2).transpose(-1, -2).reshape(x.shape)
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device).float() / D)
    freqs = positions.float()[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos()[None, :, None], emb.sin()[None, :, None]
    rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * cos + rot * sin


def mla(lw: dict, l: int, s: int, h, heads: int, cfg: dict, theta: float,
        rnd: bool = False):
    """Sublayer s of double layer l over normed rows h [B, T, H] -> [B, T,
    H]. cfg: q_lora_rank, kv_lora_rank, qk_nope_head_dim,
    qk_rope_head_dim, v_head_dim."""
    B, T, H = h.shape
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    Rq, R = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    pos = torch.arange(T, device=h.device)
    qa = rms_norm(_r(h, rnd) @ lw["wq_a"][l][s].float(),
                  lw["q_a_norm"][l][s], 1e-6)
    q = (_r(qa, rnd) @ lw["wq_b"][l][s].float()).reshape(B, T, heads, dn + dr)
    q = q * (H / Rq) ** 0.5
    kv = _r(h, rnd) @ lw["wkv_a"][l][s].float()
    c = rms_norm(kv[..., :R], lw["kv_a_norm"][l][s], 1e-6) * (H / R) ** 0.5
    k_rot = rope_interleave(kv[..., None, R:], pos, theta)
    c, k_rot = _r(c, rnd), _r(k_rot, rnd)
    kvb = (c @ lw["wkv_b"][l][s].float()).reshape(B, T, heads, dn + dv)
    q = torch.cat([q[..., :dn], rope_interleave(q[..., dn:], pos, theta)], -1)
    k = torch.cat([kvb[..., :dn], k_rot.expand(B, T, heads, dr)], -1)
    scores = torch.einsum("bthd,bshd->bhts", _r(q, rnd), _r(k, rnd))
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    p = (scores * (dn + dr) ** -0.5).masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhts,bshd->bthd", _r(p.softmax(-1), rnd),
                     _r(kvb[..., dn:], rnd)).reshape(B, T, heads * dv)
    return _r(o, rnd) @ lw["wo"][l][s].float()


def swiglu(h, w_gu, w_down, rnd: bool = False):
    g, u = (_r(h, rnd) @ w_gu.float()).chunk(2, dim=-1)
    return _r(F.silu(g) * u, rnd) @ w_down.float()


def route(h, w_router, e_bias, moe: dict, rnd: bool = False):
    """(router ids [N, k], weights [N, k]) of rows h [N, H]: the top_k of
    softmax(h W_router) + e_bias, weighted by the probabilities times
    routed_scaling (``LongcatFlashTopkRouter``)."""
    p = torch.softmax(_r(h, rnd) @ w_router.float(), dim=-1)
    e = torch.topk(p + e_bias.float(), moe["top_k"], dim=-1).indices
    return e, p.gather(1, e) * moe["routed_scaling"]


def moe_block(h, lw: dict, l: int, moe: dict, rnd: bool = False,
              routes: list | None = None):
    """The shortcut MoE of double layer l over rows h [N, H] -> [N, H]:
    the held real experts and the identity experts; moe: n_experts,
    top_k, routed_scaling, expert_offset. `routes`, when a list, gains
    the ids chosen [N, k]."""
    e, w = route(h, lw["w_router"][l], lw["e_bias"][l], moe, rnd)
    if routes is not None:
        routes.append(e)
    e0, held = moe["expert_offset"], lw["w_gu_e"][l].shape[0]
    y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for ex in range(e0, e0 + held):
        t, j = (e == ex).nonzero(as_tuple=True)
        if len(t):
            o = swiglu(h[t], lw["w_gu_e"][l][ex - e0],
                       lw["w_down_e"][l][ex - e0], rnd)
            y.index_add_(0, t, w[t, j, None] * o)
    t, j = (e >= moe["n_experts"]).nonzero(as_tuple=True)
    return y.index_add_(0, t, w[t, j, None] * _r(h[t], rnd))


def talker_forward(w: dict, x, *, heads: int, eps: float, theta: float,
                   mla_cfg: dict, moe: dict, program_rounding: bool = False,
                   routes: list | None = None):
    """The talker over input rows x [B, T, H] (positions 0..T-1): returns
    (normed hidden [B, T, H], codec logits [B, T, V])."""
    lw, rnd = w["layers"], program_rounding
    B, T, H = x.shape
    x = x.float()
    with no_tf32():
        for l in range(lw["attn_norm"].shape[0]):
            for s in (0, 1):
                x = x + mla(lw, l, s, rms_norm(x, lw["attn_norm"][l][s], eps),
                            heads, mla_cfg, theta, rnd)
                h = rms_norm(x, lw["ffn_norm"][l][s], eps)
                if s == 0:
                    m = moe_block(h.reshape(B * T, H), lw, l, moe, rnd,
                                  routes).reshape(B, T, H)
                x = x + swiglu(h, lw["w_gu"][l][s], lw["w_down"][l][s], rnd)
            x = x + m
        hn = rms_norm(x, w["output_norm"], eps)
        return hn, _r(hn, rnd) @ w["codec_head"].float()
