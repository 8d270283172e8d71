"""Qwen2-style decoder stack shared by the talker and the code predictor
(port of qwen3_tts_tpu/models/stack.py, stacked cache only).

Layer recipe: x -> RMSNorm -> fused QKV -> per-head q/k RMSNorm -> NEOX
RoPE -> causal GQA -> wo -> +residual -> RMSNorm -> SwiGLU -> +residual.
A stack whose layers hold ``w_router`` (Qwen3-Omni's talker,
models/weights.moe_layers) has a sparse-MoE FFN in the SwiGLU's place, for
prefill and decode alike; its non-tensor entry ``moe`` (a
config.MoEConfig) configures it.

Both weight layouts run, as in the JAX package: fused (``wqkv``,
``w_gu``) and unfused (``wq``/``wk``/``wv``, ``w_gate``/``w_up``, what
parallel/mesh.py makes at tp > 1). A tp-split stack holds this rank's
heads and FFN columns; the head counts follow from its weights, and the
f32 partials after wo and w_down are summed over tp (``mesh.tp_sum``,
which does nothing on an unsplit stack).

KV cache: one stacked kv-heads-major tensor [L, 2, B, n_kv, S, D] in bf16,
or ``QuantKV`` (int8 values + f32 per-row scales). The cache is updated in
place: the torch counterpart of JAX's donated buffers.

A stack whose layers hold ``wkv_b`` is of LongCat-Flash double layers
(models/weights.mla_layers; its entries "mla" and "moe" configure it),
chosen here in Python, so a dense or Omni stack's step is unchanged. A
double layer, for x:
  y = x + MLA_0(norm_in0(x)); h1 = norm_post0(y); m = MoE(h1);
  y = y + FFN_0(h1); y = y + MLA_1(norm_in1(y));
  y = y + FFN_1(norm_post1(y)) + m
(the shortcut MoE starts after the first attention and joins at the end).
Its cache is ``LatentKV``: one bf16 row a position a sublayer
(ops/mla.py), no per-head K or V; int8 is refused.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import mla
from ..ops.attention import decode_attention, decode_attention_masked
from ..ops.layers import dot, gqa_attention_prefill, rms_norm, rope_neox
from ..ops.moe import moe_ffn
from ..parallel.mesh import tp_sum

CACHE_DTYPE = torch.bfloat16


class QuantKV(NamedTuple):
    """int8 KV cache with per-row (per token, per kv head) scales."""
    values: torch.Tensor   # [L, 2, B, n_kv, S, D] int8
    scales: torch.Tensor   # [L, 2, B, n_kv, S] f32


class LatentKV(NamedTuple):
    """The cache of a latent-attention stack (module docstring)."""
    rows: torch.Tensor     # [L, 2, B, S, latent width] bf16


def quantize_kv_rows(x: torch.Tensor):
    """[..., D] -> (int8 [..., D], f32 scale [...]): symmetric per-row
    absmax quantization, round half to even."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def init_kv_cache(n_layers: int, batch: int, max_ctx: int, n_kv: int,
                  head_dim: int, device, quant: bool = False,
                  latent: int = 0):
    """Allocate the stacked decode cache on `device` (QuantKV when
    `quant`; a LatentKV of `latent` values a row when `latent`, the heads
    then unused)."""
    if latent:
        if quant:
            raise ValueError("an int8 cache of a latent-attention talker is "
                             "not built: use the bf16 latent cache")
        return LatentKV(torch.zeros(n_layers, 2, batch, max_ctx, latent,
                                    dtype=CACHE_DTYPE, device=device))
    shape = (n_layers, 2, batch, n_kv, max_ctx, head_dim)
    if quant:
        return QuantKV(
            values=torch.zeros(shape, dtype=torch.int8, device=device),
            scales=torch.full(shape[:-1], 1e-8 / 127.0, dtype=torch.float32,
                              device=device))
    return torch.zeros(shape, dtype=CACHE_DTYPE, device=device)


def n_layers(layers_w: dict) -> int:
    return layers_w["attn_norm"].shape[0]


def layer_weights(layers_w: dict, l: int) -> dict:
    """Layer l's tensors (a tp split's group record is not one)."""
    return {name: a[l] for name, a in layers_w.items()
            if isinstance(a, torch.Tensor)}


def _qkv(wl, x_norm: torch.Tensor, n_heads: int, n_kv: int, head_dim: int,
         eps: float, theta: float, positions: torch.Tensor):
    """QKV projection (fused or unfused) + per-head norm + RoPE. x_norm:
    [B, T, H] f32. An unfused stack may hold a tp split's heads only:
    their counts follow from its weights."""
    B, T = x_norm.shape[:2]
    if "wqkv" in wl:
        nq, nk = n_heads * head_dim, n_kv * head_dim
        qkv = dot(x_norm, wl["wqkv"])
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
    else:
        q, k, v = (dot(x_norm, wl[n]) for n in ("wq", "wk", "wv"))
    q = q.reshape(B, T, -1, head_dim)
    k = k.reshape(B, T, -1, head_dim)
    v = v.reshape(B, T, -1, head_dim)
    q = rope_neox(rms_norm(q, wl["q_norm"], eps), positions, theta)
    k = rope_neox(rms_norm(k, wl["k_norm"], eps), positions, theta)
    return q, k, v


def _ffn(layers_w, wl, x: torch.Tensor, eps: float) -> torch.Tensor:
    """SwiGLU over [gate | up] (fused or unfused), summed over tp; or, on
    a layer that holds ``w_router``, the sparse-MoE FFN (ops/moe.py) that
    the stack's ``moe`` entry configures (never tp-split)."""
    h = rms_norm(x, wl["ffn_norm"], eps)
    if "w_router" in wl:
        return moe_ffn(h.reshape(-1, h.shape[-1]), wl,
                       layers_w["moe"]).reshape(h.shape)
    if "w_gu" in wl:
        gate, up = dot(h, wl["w_gu"]).chunk(2, -1)
    else:
        gate, up = dot(h, wl["w_gate"]), dot(h, wl["w_up"])
    return tp_sum(dot(torch.nn.functional.silu(gate) * up, wl["w_down"]),
                  layers_w)


def _swiglu(wl, s: int, h: torch.Tensor) -> torch.Tensor:
    gate, up = dot(h, wl["w_gu"][s]).chunk(2, -1)
    return dot(torch.nn.functional.silu(gate) * up, wl["w_down"][s])


def _double_layers(layers_w, x: torch.Tensor, attend, eps: float):
    """The double layers (module docstring) over x [..., H] f32, with
    ``attend(wl, l, s, h)`` giving sublayer s's attention output."""
    for l in range(n_layers(layers_w)):
        wl = layer_weights(layers_w, l)
        for s in (0, 1):
            x = x + attend(wl, l, s, rms_norm(x, wl["attn_norm"][s], eps))
            h = rms_norm(x, wl["ffn_norm"][s], eps)
            if s == 0:
                m = moe_ffn(h.reshape(-1, h.shape[-1]), wl,
                            layers_w["moe"]).reshape(h.shape)
            x = x + _swiglu(wl, s, h)
        x = x + m
    return x


def _mla_prefill(layers_w, x, positions, n_heads, eps, theta):
    cfg, rows = layers_w["mla"], []

    def attend(wl, l, s, h):
        o, r = mla.prefill_sublayer(wl, s, h, positions, n_heads, cfg, theta)
        rows.append(r)
        return o

    y = _double_layers(layers_w, x.float(), attend, eps)
    L = n_layers(layers_w)
    return y, torch.stack(rows).reshape(L, 2, *rows[0].shape), None


def stack_prefill(layers_w, x: torch.Tensor, positions: torch.Tensor, *,
                  n_heads: int, n_kv: int, head_dim: int, eps: float,
                  theta: float):
    """T-token prefill from an empty cache. x: [B, T, H]; positions: [B, T].
    Returns (y [B, T, H] f32 before the output norm, ks, vs [L, B, T, kv, D]
    bf16); a latent-attention stack returns (y, its cache rows [L, 2, B,
    T, W] bf16, None)."""
    if "wkv_b" in layers_w:
        return _mla_prefill(layers_w, x, positions, n_heads, eps, theta)
    x = x.float()
    ks, vs = [], []
    for l in range(n_layers(layers_w)):
        wl = layer_weights(layers_w, l)
        h = rms_norm(x, wl["attn_norm"], eps)
        q, k, v = _qkv(wl, h, n_heads, n_kv, head_dim, eps, theta, positions)
        k, v = k.to(CACHE_DTYPE), v.to(CACHE_DTYPE)
        attn = gqa_attention_prefill(q.to(CACHE_DTYPE), k, v)
        x = x + tp_sum(dot(attn, wl["wo"]), layers_w)
        x = x + _ffn(layers_w, wl, x, eps)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def write_prefill_to_cache(kv_cache, ks: torch.Tensor, vs: torch.Tensor,
                           start: int = 0):
    """Write prefill K/V ([L, B, T, kv, D]; a LatentKV takes stack_prefill's
    latent rows as `ks`) into the cache at `start`, in place. Returns the
    cache."""
    if isinstance(kv_cache, LatentKV):
        kv_cache.rows[:, :, :, start:start + ks.shape[3]] = ks
        return kv_cache
    kv = torch.stack([ks, vs], dim=1).transpose(3, 4)    # [L,2,B,kv,T,D]
    T = kv.shape[4]
    if isinstance(kv_cache, QuantKV):
        q, s = quantize_kv_rows(kv)
        kv_cache.values[:, :, :, :, start:start + T] = q
        kv_cache.scales[:, :, :, :, start:start + T] = s
    else:
        kv_cache[:, :, :, :, start:start + T] = kv.to(kv_cache.dtype)
    return kv_cache


def write_kv_rows(kv_cache, l: int, idx: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    """Write one token's K/V rows (k, v: [B, n_kv, D]) into cache slot
    `idx` ([1] long) of layer l, in place; an int8 cache takes them
    quantized (quantize_kv_rows) with their scales."""
    if isinstance(kv_cache, QuantKV):
        for i, rows in enumerate((k, v)):
            q, s = quantize_kv_rows(rows)
            kv_cache.values[l, i].index_copy_(2, idx, q[:, :, None])
            kv_cache.scales[l, i].index_copy_(2, idx, s[:, :, None])
    else:
        for i, rows in enumerate((k, v)):
            kv_cache[l, i].index_copy_(2, idx,
                                       rows[:, :, None].to(kv_cache.dtype))


def layer_kv(kv_cache, l: int):
    """Layer l's views (k, v [B, n_kv, S, D], k_scale, v_scale [B, n_kv, S]
    or None) of the stacked cache, in place."""
    if isinstance(kv_cache, QuantKV):
        return (kv_cache.values[l, 0], kv_cache.values[l, 1],
                kv_cache.scales[l, 0], kv_cache.scales[l, 1])
    return kv_cache[l, 0], kv_cache[l, 1], None, None


def decode_layers(layers_w, x: torch.Tensor, positions: torch.Tensor,
                  kv_cache, write_idx, attend, *, n_heads: int, n_kv: int,
                  head_dim: int, eps: float, theta: float):
    """The single-token decode loop of stack_step and of the talker
    megakernel's twin: per layer, the K/V rows go into cache slot
    `write_idx` (an int or a 0-d tensor) in place, then
    ``attend(q, k, v, k_scale, v_scale)`` (q [B, n_heads, D] bf16, the
    layer_kv views) gives [B, n_heads*D] f32. Returns (y [B, H] f32 before
    the output norm, kv_cache)."""
    # a fill, not a host-to-card copy, for an int: graphs capture this
    idx = (write_idx.to(torch.long).reshape(1)
           if isinstance(write_idx, torch.Tensor) else
           torch.full((1,), write_idx, dtype=torch.long, device=x.device))
    x = x.float()
    for l in range(n_layers(layers_w)):
        wl = layer_weights(layers_w, l)
        h = rms_norm(x, wl["attn_norm"], eps)[:, None, :]
        q, k, v = _qkv(wl, h, n_heads, n_kv, head_dim, eps, theta,
                       positions[:, None])
        write_kv_rows(kv_cache, l, idx, k[:, 0], v[:, 0])
        attn = attend(q[:, 0].to(CACHE_DTYPE), *layer_kv(kv_cache, l))
        x = x + tp_sum(dot(attn, wl["wo"]), layers_w)
        x = x + _ffn(layers_w, wl, x, eps)
    return x, kv_cache


def stack_step(layers_w, x: torch.Tensor, positions: torch.Tensor, kv_cache,
               write_idx, n_valid: torch.Tensor, *, n_heads: int, n_kv: int,
               head_dim: int, eps: float, theta: float,
               read_ctx: int | None = None,
               valid_mask: torch.Tensor | None = None,
               window_lo: torch.Tensor | None = None,
               window_hi: torch.Tensor | None = None,
               prefill_len: int = 0):
    """Single-token decode step; writes the token's K/V rows into cache
    slot `write_idx` (an int or a 0-d device tensor, shared by the batch)
    in place, then attends each stream's first n_valid slots.

    x: [B, H]; positions: [B] int32 RoPE positions; n_valid: [B] valid
    cache length after this token. valid_mask: [B, S] bool, when given,
    replaces the prefix by a bitmask (ring-slot cache, where a stream's
    slots are not contiguous); window_lo/window_hi + prefill_len bound
    each stream's valid slots to [0, prefill_len) U [lo, hi) so that the
    kernel skips the other blocks. Returns (y [B, H] f32 before the
    output norm, kv_cache)."""
    if "wkv_b" in layers_w:
        return _mla_step(layers_w, x, positions, kv_cache, write_idx,
                         n_valid, valid_mask, read_ctx, n_heads, eps, theta)

    def attend(q, k, v, k_scale, v_scale):
        if valid_mask is not None:
            return decode_attention_masked(
                q, k, v, valid_mask, read_ctx=read_ctx, window_lo=window_lo,
                window_hi=window_hi, prefill_len=prefill_len,
                k_scale=k_scale, v_scale=v_scale)
        return decode_attention(q, k, v, n_valid, read_ctx=read_ctx,
                                k_scale=k_scale, v_scale=v_scale)

    return decode_layers(layers_w, x, positions, kv_cache, write_idx, attend,
                         n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                         eps=eps, theta=theta)


def _mla_step(layers_w, x, positions, cache, write_idx, n_valid, valid_mask,
              read_ctx, n_heads, eps, theta):
    """stack_step of a latent-attention stack: each sublayer's row goes
    into slot `write_idx` of its LatentKV rows, then absorbed decode
    attention (ops/mla.py) in prefix or ring mode."""
    idx = (write_idx.to(torch.long).reshape(1)
           if isinstance(write_idx, torch.Tensor) else
           torch.full((1,), write_idx, dtype=torch.long, device=x.device))
    cfg = layers_w["mla"]

    def attend(wl, l, s, h):
        return mla.decode_sublayer(
            wl, s, h, positions, cache.rows[l, s], idx, n_heads, cfg, theta,
            n_valid=n_valid, valid_mask=valid_mask, read_ctx=read_ctx)

    return _double_layers(layers_w, x.float(), attend, eps), cache
