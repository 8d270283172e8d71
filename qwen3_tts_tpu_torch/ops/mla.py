"""Multi-head latent attention (DeepSeek-V3's MLA as LongCat-Flash runs it,
transformers' ``LongcatFlashMLA``) over a latent cache: the projections
of one sublayer, its prefill attention, and its decode attention, which
on the card is a hand-written CUDA kernel (csrc/mla_decode.cu) beside its
plain torch twin.

It replaces no TPU kernel: the JAX package has no latent-attention
talker. One sublayer over normed rows h (config.MLAConfig, n heads):

- q = q_b(rmsnorm(q_a h)) * sqrt(H / q_lora_rank), per head
  [q_nope (128) | q_rot (64)]; [c | k_rot] = kv_a h, c = rmsnorm(c) *
  sqrt(H / kv_lora_rank); q_rot and the one k_rot that every head shares
  take the interleaved RoPE (ops/layers.rope_interleave);
- prefill (``prefill_sublayer``, torch): kv_b c gives per head [k_nope |
  v]; causal attention of [q_nope | q_rot] over [k_nope | k_rot] at
  scale (128 + 64)^-0.5, bf16 operands, f32 scores and softmax, the
  probabilities rounded to bf16 before P.V;
- the cache holds one bf16 row a position, [c | k_rot] (576 values), in
  place of per-head keys and values (~35x fewer bytes than kv_b's
  expansion);
- decode (``decode_sublayer``) absorbs kv_b: q_lat = [q_nope W_uk^T |
  q_rot] (bf16, [B, n, 576]) attends the rows as keys, their first 512
  values as values, giving o_lat [B, n, 512] (bf16); o = o_lat W_uv per
  head; then o_proj.

Decode attention semantics (``mla_decode``, shared by kernel and twin):
scores q_lat . row * scale and the softmax in f32 over the counted slots
(prefix: slot < n_valid; masked: the bitmask), never past read_ctx; the
probabilities rounded to bf16 and multiplied by the rows' latents with f32
sums; the result divided by the f32 sum of probabilities and rounded to
bf16. A stream with no counted slot gives 0. The kernel takes the
softmax online, tile by tile, so it rounds each probability against the
running maximum rather than the final one: the twin's results agree to
bf16 rounding, not bitwise.

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
``mla_decode.launches`` counts kernel calls.
"""

from __future__ import annotations

import torch

from .. import kernels
from .layers import NEG_INF, dot, rms_norm, rope_interleave

# the low-rank norms' eps: DeepseekV3RMSNorm's default, which the model
# builds them with (not the config's rms_norm_eps)
LORA_EPS = 1e-6
N_HEADS = 64          # query heads the kernel serves
LATENT = 512          # latent (value) width the kernel serves
ROPE = 64             # shared rope key width the kernel serves
TILE = 32             # cache slots a kernel tile
_SMS: dict = {}


def project(wl: dict, s: int, h: torch.Tensor, positions: torch.Tensor,
            n_heads: int, cfg, theta: float):
    """Sublayer s's (q_nope [..., n, dn], roped q_rot [..., n, dr], c
    [..., R], roped k_rot [..., 1, dr]), all f32, of rows h [..., T, H] at
    positions [..., T] (module docstring)."""
    H = h.shape[-1]
    dn, dr, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    qa = rms_norm(dot(h, wl["wq_a"][s]), wl["q_a_norm"][s], LORA_EPS)
    q = dot(qa, wl["wq_b"][s]) * (H / cfg.q_lora_rank) ** 0.5
    q = q.reshape(*h.shape[:-1], n_heads, dn + dr)
    kv = dot(h, wl["wkv_a"][s])
    c = rms_norm(kv[..., :R], wl["kv_a_norm"][s], LORA_EPS) * (H / R) ** 0.5
    k_rot = rope_interleave(kv[..., None, R:], positions, theta)
    return (q[..., :dn], rope_interleave(q[..., dn:], positions, theta), c,
            k_rot)


def latent_rows(c: torch.Tensor, k_rot: torch.Tensor) -> torch.Tensor:
    """The cache rows [..., R + dr] bf16 of c [..., R] and k_rot
    [..., 1, dr]."""
    return torch.cat([c, k_rot[..., 0, :]], dim=-1).to(torch.bfloat16)


def prefill_sublayer(wl: dict, s: int, h: torch.Tensor,
                     positions: torch.Tensor, n_heads: int, cfg,
                     theta: float):
    """Causal attention of sublayer s over rows h [B, T, H] from an empty
    cache, without absorption. Returns (o_proj output [B, T, H] f32, the
    cache rows [B, T, R + dr] bf16)."""
    q_nope, q_rot, c, k_rot = project(wl, s, h, positions, n_heads, cfg,
                                      theta)
    B, T = h.shape[:2]
    dn, dv, bf = cfg.qk_nope_head_dim, cfg.v_head_dim, torch.bfloat16
    kvb = dot(c, wl["wkv_b"][s]).reshape(B, T, n_heads, dn + dv)
    q = torch.cat([q_nope, q_rot], -1).to(bf).float()
    k = torch.cat([kvb[..., :dn], k_rot.expand(B, T, n_heads, -1)],
                  -1).to(bf).float()
    v = kvb[..., dn:].to(bf).float()
    scores = torch.einsum("bthd,bshd->bhts", q, k) * cfg.softmax_scale
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, NEG_INF), dim=-1)
    attn = torch.einsum("bhts,bshd->bthd", probs.to(bf).float(), v)
    return dot(attn.reshape(B, T, n_heads * dv), wl["wo"][s]), \
        latent_rows(c, k_rot)


def absorbed_weights(wkv_b: torch.Tensor, n_heads: int, cfg):
    """(W_uk [..., n, dn, R], W_uv [..., n, R, dv]) of kv_b [..., R,
    n (dn + dv)], contiguous: a head's q_nope W_uk is its latent query, its
    o_lat W_uv its value."""
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    R = wkv_b.shape[-2]
    w = wkv_b.reshape(*wkv_b.shape[:-1], n_heads, dn + dv)
    w = w.movedim(-3, -1)                          # [..., n, dn + dv, R]
    return (w[..., :dn, :].contiguous(),
            w[..., dn:, :].transpose(-1, -2).contiguous())


def _bmm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-head products, bf16 operands, f32 sums, a bf16 result: a [n, B,
    K] @ b [n, K, N] -> [n, B, N]."""
    a = a.to(torch.bfloat16)
    if a.is_cuda:
        return torch.bmm(a, b)
    return (a.float() @ b.float()).to(torch.bfloat16)


def _absorbed(wl: dict, s: int, n_heads: int, cfg):
    """Sublayer s's (W_uk, W_uv): the engine's precomputed leaves
    (runtime/pipeline.py) or, on a bare tree, from kv_b."""
    if "w_uk" in wl:
        return wl["w_uk"][s], wl["w_uv"][s]
    return absorbed_weights(wl["wkv_b"][s], n_heads, cfg)


def decode_sublayer(wl: dict, s: int, h: torch.Tensor,
                    positions: torch.Tensor, rows: torch.Tensor,
                    idx: torch.Tensor, n_heads: int, cfg, theta: float, *,
                    n_valid: torch.Tensor | None = None,
                    valid_mask: torch.Tensor | None = None,
                    read_ctx: int | None = None) -> torch.Tensor:
    """One decode token of sublayer s: h [B, H] normed rows at positions
    [B]; its cache row goes into slot `idx` ([1] long) of rows [B, S, W]
    in place, then absorbed attention over the counted slots (n_valid:
    prefix mode; valid_mask: ring mode). Returns o_proj's output [B, H]
    f32."""
    B = h.shape[0]
    q_nope, q_rot, c, k_rot = project(wl, s, h[:, None], positions[:, None],
                                      n_heads, cfg, theta)
    rows.index_copy_(1, idx, latent_rows(c, k_rot))
    w_uk, w_uv = _absorbed(wl, s, n_heads, cfg)
    q_abs = _bmm_bf16(q_nope[:, 0].transpose(0, 1), w_uk)
    q = torch.cat([q_abs.transpose(0, 1),
                   q_rot[:, 0].to(torch.bfloat16)], dim=-1).contiguous()
    if valid_mask is not None:
        o_lat = mla_decode_masked(q, rows, valid_mask, cfg.softmax_scale,
                                  cfg.qk_rope_head_dim, read_ctx=read_ctx)
    else:
        o_lat = mla_decode(q, rows, n_valid, cfg.softmax_scale,
                           cfg.qk_rope_head_dim, read_ctx=read_ctx)
    o = _bmm_bf16(o_lat.transpose(0, 1), w_uv).transpose(0, 1)
    return dot(o.reshape(B, -1), wl["wo"][s])


# -- decode attention over the latent cache -------------------------------

def mla_decode_twin(q: torch.Tensor, rows: torch.Tensor, scale: float,
                    rope_dim: int, *, n_valid: torch.Tensor | None = None,
                    valid_mask: torch.Tensor | None = None,
                    read_ctx: int | None = None) -> torch.Tensor:
    """Plain torch version of the kernel's semantics (module docstring):
    q [B, n, W] bf16, rows [B, S, W] bf16 whose last rope_dim values are
    the roped key -> [B, n, W - rope_dim] bf16."""
    S = rows.shape[1]
    ctx = min(read_ctx or S, S)
    R = rows.shape[2] - rope_dim
    kf = rows[:, :ctx].float()
    if n_valid is not None:
        counted = (torch.arange(ctx, device=q.device)[None, :]
                   < n_valid.long()[:, None])
    else:
        counted = valid_mask[:, :ctx].bool()
    scores = torch.einsum("bnw,bsw->bns", q.float(), kf) * scale
    scores = scores.masked_fill(~counted[:, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    out = torch.einsum("bns,bsr->bnr", p.to(torch.bfloat16).float(),
                       kf[..., :R])
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.to(torch.bfloat16)


def split_plan(B: int, n_tiles: int, sms: int) -> tuple[int, int]:
    """(tiles a split, splits) for B streams over n_tiles tiles: one CTA a
    SM fits the kernel, so a batch of at least `sms` streams takes one
    split a stream (no partials to merge); a smaller one splits each
    stream's tiles so that about `sms` CTAs run, two tiles a split at
    least."""
    per = n_tiles if B >= sms else max(2, -(-n_tiles // max(1, sms // B)))
    per = min(per, n_tiles)
    return per, -(-n_tiles // per)


def _launch(q, rows, scale, rope_dim, read_ctx, n_valid=None,
            valid_mask=None):
    B, n, W = q.shape
    S = rows.shape[1]
    if n != N_HEADS or W != LATENT + ROPE or rope_dim != ROPE:
        raise ValueError(f"mla kernel serves {N_HEADS} heads over rows of "
                         f"{LATENT} + {ROPE}; got {n} heads, width {W}")
    dev = q.device
    req = kernels.require
    req(q, "q", torch.bfloat16, (B, n, W))
    req(rows, "rows", torch.bfloat16, (B, S, W))
    if n_valid is not None:
        req(n_valid, "n_valid", torch.int32, (B,))
    if valid_mask is not None:
        req(valid_mask, "valid_mask", torch.bool, (B, S))
    ctx = min(read_ctx or S, S)
    n_tiles = max(-(-ctx // TILE), 1)
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    per, n_split = split_plan(B, n_tiles, _SMS[dev])
    out = torch.empty(B, n, LATENT, dtype=torch.bfloat16, device=dev)
    part_ml = part_o = None
    if n_split > 1:
        part_ml = torch.empty(B, n_split, n, 2, dtype=torch.float32,
                              device=dev)
        part_o = torch.empty(B, n_split, n, LATENT, dtype=torch.float32,
                             device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernels.check(kernels.lib().q3_mla_decode(
        q.data_ptr(), rows.data_ptr(), ptr(n_valid), ptr(valid_mask),
        ptr(part_ml), ptr(part_o), out.data_ptr(), B, S, ctx, per, n_split,
        float(scale), kernels.stream(dev)), "q3_mla_decode")
    mla_decode.launches += 1
    return out


def mla_decode(q: torch.Tensor, rows: torch.Tensor, n_valid: torch.Tensor,
               scale: float, rope_dim: int = ROPE, *,
               read_ctx: int | None = None) -> torch.Tensor:
    """Prefix mode (lock-step batches): stream b attends slots [0,
    n_valid[b]) of rows [B, S, W]. Returns [B, n, W - rope_dim] bf16."""
    if not q.is_cuda:
        return mla_decode_twin(q, rows, scale, rope_dim, n_valid=n_valid,
                               read_ctx=read_ctx)
    return _launch(q, rows, scale, rope_dim, read_ctx, n_valid=n_valid)


def mla_decode_masked(q: torch.Tensor, rows: torch.Tensor,
                      valid_mask: torch.Tensor, scale: float,
                      rope_dim: int = ROPE, *,
                      read_ctx: int | None = None) -> torch.Tensor:
    """Ring mode (serving): stream b attends the slots its bitmask
    valid_mask [B, S] sets. Returns [B, n, W - rope_dim] bf16."""
    if not q.is_cuda:
        return mla_decode_twin(q, rows, scale, rope_dim,
                               valid_mask=valid_mask, read_ctx=read_ctx)
    return _launch(q, rows, scale, rope_dim, read_ctx, valid_mask=valid_mask)


mla_decode.launches = 0
