"""Core transformer ops: f32-result matmul, RMSNorm, NEOX RoPE, SwiGLU,
GQA attention (prefill; decode over the seq-major and the kv-major
cache), fast sin^2 (port of qwen3_tts_tpu/ops/layers.py).

Numerics follow the JAX package: bf16 operands with f32 results
(``jnp.dot(..., preferred_element_type=f32)``), softmax and norms in f32.
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.astype(w.dtype) @ w`` with an f32 result.

    On the card, bf16 weights go through ``torch.mm(..., out_dtype=f32)``
    (a torch without it raises). On the CPU the operands are upcast: the
    products of bf16 values are exact in f32, so the f32 matmul equals the
    JAX dot up to summation order."""
    if x.is_cuda and w.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]).to(torch.bfloat16), w,
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(w.dtype).float() @ w.float()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * w, in f32."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale) * weight.float()


def rope_freqs(d: int, theta: float, device) -> torch.Tensor:
    """exp(arange(d/2) * (-2/d) * log(theta)) in f32, as the JAX package.
    The f32 log is taken on the host: a host-to-card copy would break a
    CUDA graph capture (runtime/graphs.py)."""
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32)).item()
    return torch.exp(torch.arange(d // 2, dtype=torch.float32, device=device)
                     * (-2.0 / d) * log_theta)


def rope_neox(x: torch.Tensor, positions: torch.Tensor,
              theta: float) -> torch.Tensor:
    """NEOX rotary embedding over the full head dim; pairs (i, i + D/2).

    x: [..., T, n_heads, D]; positions: broadcastable to [..., T]."""
    d = x.shape[-1]
    half = d // 2
    ang = positions.float()[..., None] * rope_freqs(d, theta, x.device)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_interleave(x: torch.Tensor, positions: torch.Tensor,
                    theta: float) -> torch.Tensor:
    """DeepSeek-V3's interleaved rotary embedding (transformers'
    ``apply_rotary_pos_emb_interleave``): the dims are de-interleaved
    (evens, then odds) and then rotated as NEOX pairs (i, i + D/2), so the
    result is laid out de-interleaved; a query and a key rotated alike give
    the interleaved form's scores. x: [..., T, n_heads, D]; positions:
    broadcastable to [..., T]."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2)
    return rope_neox(x.reshape(*x.shape[:-2], d), positions, theta)


def gqa_attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_past: int = 0) -> torch.Tensor:
    """Batched causal GQA. q: [B, T, n_heads, D]; k, v: [B, S, n_kv, D];
    query t attends positions <= n_past + t. Returns [B, T, n_heads*D] f32."""
    B, T, n_heads, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    G = n_heads // n_kv
    qh = q.reshape(B, T, n_kv, G, D).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    scores = torch.einsum("bkgtd,bksd->bkgts", qh, kh) * (1.0 / D ** 0.5)
    t_idx = torch.arange(T, device=q.device)[:, None]
    s_idx = torch.arange(S, device=q.device)[None, :]
    scores = scores.masked_fill(~(s_idx <= t_idx + n_past), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", probs.to(vh.dtype).float(),
                       vh.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, n_heads * D)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x @ Wg) * (x @ Wu)) @ Wd with f32 results, the
    activation rounded to Wd's dtype. Mixed dtypes promote, as ``jnp.dot``
    does (``dot`` would round x to the weights' dtype)."""
    gate = x.float() @ w_gate.float()
    up = x.float() @ w_up.float()
    act = (torch.nn.functional.silu(gate) * up).to(w_down.dtype)
    return act.float() @ w_down.float()


def gqa_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       n_valid: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention over a seq-major cache. q: [B, n_heads,
    D]; k, v: [B, S, n_kv, D]; n_valid: [B] valid slots per stream.
    Returns [B, n_heads*D] f32."""
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < n_valid[:, None])
    return gqa_attention_step_masked(q, k, v, mask)


def gqa_attention_step_masked(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Decode attention with a per-slot bitmask over a seq-major cache
    (k, v: [B, S, n_kv, D]; mask: [B, S] bool), the plain reference the
    JAX package keeps beside the kv-major production path. Returns
    [B, n_heads*D] f32."""
    return gqa_attention_step_kvmajor(q, k.transpose(1, 2), v.transpose(1, 2),
                                      mask)


def gqa_attention_step_kvmajor(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mask: torch.Tensor,
                               k_scale: torch.Tensor | None = None,
                               v_scale: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Decode attention over a kv-heads-major cache (k, v: [B, n_kv, S, D]).

    q: [B, n_heads, D]; mask: [B, S] bool. For an int8 cache, k_scale and
    v_scale [B, n_kv, S] fold into the math: the K scale multiplies the
    scores after QK^T, the V scale multiplies the probabilities before the
    PV product, which is then rounded to bf16. Returns [B, n_heads*D] f32."""
    B, n_heads, D = q.shape
    n_kv = k.shape[1]
    G = n_heads // n_kv
    scale = 1.0 / D ** 0.5
    qh = q.reshape(B, n_kv, G, D).float()
    scores = torch.einsum("bkgd,bksd->bkgs", qh, k.float())
    if k.dtype == torch.int8:
        scores = scores * (k_scale[:, :, None, :] * scale)
    else:
        scores = scores * scale
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v.dtype == torch.int8:
        pv = (probs * v_scale[:, :, None, :]).to(torch.bfloat16)
    else:
        pv = probs.to(v.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", pv.float(), v.float())
    return out.reshape(B, n_heads * D)


def fast_sin2(z: torch.Tensor) -> torch.Tensor:
    """sin^2(z) by pi-periodic Cody-Waite reduction and a 9th-order odd
    polynomial, constant for constant as the JAX package (the vocoder's
    audio depends on it). The argument is clamped to |z| <= 3e4."""
    pi_hi = 3.140625
    pi_lo = 0.0009676535897932
    z = z.clamp(-3e4, 3e4)
    n = torch.round(z * (1.0 / 3.14159265358979))
    r = z - n * pi_hi - n * pi_lo
    r2 = r * r
    s = r * (1.0 + r2 * (-0.16666662 + r2 * (0.0083331258
                                             + r2 * (-0.00019814119
                                                     + r2 * 2.6160287e-06))))
    return s * s
