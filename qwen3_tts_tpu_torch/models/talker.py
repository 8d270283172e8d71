"""Talker decoder: prefill-embedding construction, prefill, decode step
(port of qwen3_tts_tpu/models/talker.py).

The decode step has two implementations, chosen per call by
``QWEN3_TTS_TALKER`` (or ``set_talker_step_impl``):
- ``fused``: ops/talker_fused.py, all layers of the step in one CUDA
  kernel on a CUDA tensor, its torch twin on a CPU tensor; raises when
  ``talker_fused.supported`` does not hold;
- ``xla``: ``stack_step``, the per-layer torch path, whose decode
  attention follows ``ops.attention.set_decode_attention_impl`` (the
  kernel on the card by default);
- ``auto`` (the default): ``fused`` on a CUDA tensor whenever
  ``supported`` holds, in lock-step and ring mode alike, else ``xla``;
  on the CPU always ``xla``.
On a tp-split tree (parallel/mesh.py, tp > 1) ``auto`` takes ``xla`` and
``fused`` raises: a persistent megakernel cannot all-reduce between
layers inside its one launch. A dp-only mesh keeps the megakernel, on
each rank's rows. The codec_head logits of a tp split are gathered over
tp (``mesh.tp_gather``).
The JAX package's ``fused_interpret`` (Pallas interpret mode) has no
counterpart: ``fused`` on CPU tensors runs the twin (models/impl_switch.py).

``forward_text`` (project, optional speaker add, prefill) is the
reference's ``TTSTransformer::forward_text``, as in the JAX package.

Every tensor carries a batch dimension over concurrent streams.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import TalkerConfig
from ..ops import talker_fused
from ..ops.layers import dot, rms_norm
from ..parallel.mesh import tp_gather, tp_size
from .impl_switch import ImplSwitch
from .stack import stack_prefill, stack_step, write_prefill_to_cache

_SWITCH = ImplSwitch("QWEN3_TTS_TALKER")
set_talker_step_impl = _SWITCH.set
_resolve_impl = _SWITCH.resolve


def project_text_tokens(w, tokens: torch.Tensor) -> torch.Tensor:
    """text_embd lookup -> fc1 -> SiLU -> fc2. tokens: [...] -> [..., H] f32."""
    tp = w["text_proj"]
    x = dot(w["text_embd"][tokens.long()], tp["fc1_w"]) + tp["fc1_b"]
    return dot(F.silu(x), tp["fc2_w"]) + tp["fc2_b"]


class PrefillInputs(NamedTuple):
    """Dense prefill + per-frame trailing-text schedule for a batch."""
    prefill_embd: torch.Tensor      # [B, P, hidden] f32
    trailing_hidden: torch.Tensor   # [B, T_trail, hidden] f32
    trailing_len: torch.Tensor      # [B] int32 (= n_tokens - 8)
    tts_pad_embed: torch.Tensor     # [B, hidden] f32
    n_text_tokens: torch.Tensor     # [B] int32


def build_prefill_inputs(w, cfg: TalkerConfig, tokens: torch.Tensor,
                         token_len: torch.Tensor, speaker_embd: torch.Tensor,
                         language_id: torch.Tensor | None = None,
                         use_think: bool = True) -> PrefillInputs:
    """Prefill-embedding matrix and trailing-text schedule:

      prefill = [ proj(tok[0:3]),
                  codec_rows + tts_pad overlay (last row + tts_bos),
                  proj(tok[3]) + codec_bos_row ]
      codec rows = think prefix (+ language id) ++ speaker ++ [pad, bos]
      trailing  = proj(tok[4 : n-5]) ++ [tts_eos]

    tokens: [B, T_max] int32 (templated ids, padded); token_len: [B];
    speaker_embd: [B, hidden] f32 (zeros = default voice)."""
    B, t_max = tokens.shape
    dev = tokens.device
    proj_all = project_text_tokens(w, tokens)                  # [B, T_max, H]
    specials = torch.tensor([cfg.tts_bos_token_id, cfg.tts_eos_token_id,
                             cfg.tts_pad_token_id], device=dev)
    tts_bos, tts_eos, tts_pad = project_text_tokens(w, specials)

    codec_embd = w["codec_embd"]
    if use_think:
        if language_id is None:
            language_id = torch.full((B,), cfg.english_language_id,
                                     dtype=torch.int32, device=dev)
        prefix_ids = torch.stack([
            torch.full((B,), cfg.codec_think_id, device=dev),
            torch.full((B,), cfg.codec_think_bos_id, device=dev),
            language_id.long(),
            torch.full((B,), cfg.codec_think_eos_id, device=dev),
        ], dim=1)
    else:
        prefix_ids = torch.tensor(
            [cfg.codec_nothink_id, cfg.codec_think_bos_id,
             cfg.codec_think_eos_id], device=dev).expand(B, 3)
    prefix_rows = codec_embd[prefix_ids].float()               # [B, P0, H]
    tail_rows = codec_embd[torch.tensor([cfg.codec_pad_id, cfg.codec_bos_id],
                                        device=dev)].float()
    codec_input = torch.cat([prefix_rows, speaker_embd[:, None, :].float(),
                             tail_rows[None].expand(B, -1, -1)], dim=1)
    n_codec = codec_input.shape[1]

    # rows 0..n_codec-2 get +tts_pad, the last of those +tts_bos
    overlay_len = n_codec - 1
    overlay = tts_pad.expand(overlay_len, -1).clone()
    overlay[overlay_len - 1] = tts_bos
    codec_overlaid = codec_input[:, :overlay_len] + overlay[None]
    last_row = proj_all[:, 3] + codec_input[:, n_codec - 1]
    prefill = torch.cat([proj_all[:, :3], codec_overlaid, last_row[:, None]],
                        dim=1)

    # trailing row i: proj(tok[4+i]) for i < len-9, tts_eos at len-9
    t_trail = max(t_max - 9 + 1, 1)
    trail_proj = proj_all[:, 4:4 + t_trail]
    if trail_proj.shape[1] < t_trail:
        trail_proj = F.pad(trail_proj, (0, 0, 0, t_trail - trail_proj.shape[1]))
    eos_pos = (token_len.long() - 9).clamp_min(0)[:, None]
    idx = torch.arange(t_trail, device=dev)[None, :]
    trailing = torch.where((idx == eos_pos)[..., None],
                           tts_eos[None, None, :], trail_proj)
    trailing_len = (token_len - 8).clamp_min(1).to(torch.int32)
    return PrefillInputs(prefill, trailing, trailing_len,
                         tts_pad[None].expand(B, -1).contiguous(),
                         token_len.to(torch.int32))


def _head(w, cfg: TalkerConfig, y: torch.Tensor):
    """(h = RMSNorm(y) [B, H] f32, codec logits [B, codec_vocab] f32),
    the logits gathered over tp on a tp-split tree."""
    h = rms_norm(y, w["output_norm"], cfg.rms_norm_eps)
    return h, tp_gather(dot(h, w["codec_head"]), w)


def forward_text(w, cfg: TalkerConfig, tokens: torch.Tensor,
                 speaker_embd: torch.Tensor | None, kv_cache):
    """Project text tokens [B, T] (+ a speaker embedding [B, H] added to
    every row, when given) and prefill from them: the reference's
    ``TTSTransformer::forward_text``. Returns ``talker_prefill``'s
    (last_hidden, last_logits, kv_cache)."""
    x = project_text_tokens(w, tokens)
    if speaker_embd is not None:
        x = x + speaker_embd[:, None, :].float()
    return talker_prefill(w, cfg, x, kv_cache)


def talker_prefill(w, cfg: TalkerConfig, prefill_embd: torch.Tensor, kv_cache):
    """Batched prefill into an empty cache (written in place).
    Returns (last_hidden [B, H] f32, last_logits [B, codec_vocab] f32,
    kv_cache)."""
    B, P = prefill_embd.shape[:2]
    positions = torch.arange(P, dtype=torch.int32,
                             device=prefill_embd.device).expand(B, P)
    y, ks, vs = stack_prefill(
        w["layers"], prefill_embd, positions,
        n_heads=cfg.n_attention_heads, n_kv=cfg.n_key_value_heads,
        head_dim=cfg.head_dim, eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    kv_cache = write_prefill_to_cache(kv_cache, ks, vs, 0)
    h, logits = _head(w, cfg, y[:, -1])
    return h, logits, kv_cache


def talker_step(w, cfg: TalkerConfig, step_embd: torch.Tensor, kv_cache,
                n_past: torch.Tensor, write_idx, read_ctx: int | None = None,
                valid_mask: torch.Tensor | None = None,
                window_lo: torch.Tensor | None = None,
                window_hi: torch.Tensor | None = None,
                prefill_len: int = 0):
    """Single-frame decode step. step_embd: [B, H]; n_past: [B] int32
    tokens already in each stream's cache (the RoPE position); write_idx:
    the cache slot all streams write (int or 0-d tensor). Lock-step
    batches attend each stream's first n_past + 1 slots; ring mode passes
    valid_mask [B, S] and the lifetime window (window_lo [B], window_hi,
    prefill_len) instead, which only the xla path's decode-attention
    kernel uses to skip blocks. The implementation follows
    QWEN3_TTS_TALKER (module docstring). Returns (hidden [B, H] f32,
    logits [B, codec_vocab] f32, kv_cache), the cache updated in place."""
    impl = _resolve_impl()
    B = step_embd.shape[0]
    n_valid = n_past + 1 if valid_mask is None else None
    kw = dict(n_heads=cfg.n_attention_heads, n_kv=cfg.n_key_value_heads,
              head_dim=cfg.head_dim, eps=cfg.rms_norm_eps,
              theta=cfg.rope_theta, read_ctx=read_ctx, valid_mask=valid_mask)
    if impl == "fused" and tp_size(w["layers"]) > 1:
        raise ValueError(
            "QWEN3_TTS_TALKER=fused on a tp-split talker (tp > 1): the "
            "megakernel cannot all-reduce between layers; use auto or xla")
    fused = impl == "fused" or (impl == "auto" and step_embd.is_cuda
                                and tp_size(w["layers"]) == 1)
    if fused and not talker_fused.supported(cfg, B, w, kv_cache, write_idx,
                                            valid_mask, read_ctx):
        if impl == "fused":
            raise ValueError(
                "QWEN3_TTS_TALKER=fused but the fused step does not support "
                "this config/batch/cache (see ops/talker_fused.supported)")
        fused = False
    if fused:
        y, kv_cache = talker_fused.talker_step_fused(
            w["layers"], step_embd, n_past, kv_cache, write_idx, n_valid,
            **kw)
    else:
        y, kv_cache = stack_step(
            w["layers"], step_embd, n_past, kv_cache, write_idx, n_valid,
            window_lo=window_lo, window_hi=window_hi, prefill_len=prefill_len,
            **kw)
    h, logits = _head(w, cfg, y)
    return h, logits, kv_cache
