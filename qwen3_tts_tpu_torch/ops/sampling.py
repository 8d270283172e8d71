"""Sampling: temperature/top-k/top-p, CB0 suppression, repetition penalty,
EOS ramp (port of qwen3_tts_tpu/ops/sampling.py).

A categorical draw is argmax(logits + Gumbel noise), which is what
``jax.random.categorical`` computes; every sampler takes the noise as an
optional tensor so that tests can feed both packages the same draws, and
otherwise draws it from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch

from .layers import NEG_INF


def gumbel_noise(shape, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """-log(-log(u)), u uniform in [tiny, 1) (jax.random.gumbel)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep logits >= the k-th largest (ties at the threshold survive)."""
    vocab = logits.shape[-1]
    if top_k <= 0 or top_k >= vocab:
        return logits
    threshold = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < threshold, NEG_INF)


def apply_top_p(scaled: torch.Tensor, top_p: float,
                top_k: int) -> torch.Tensor:
    """Nucleus filter, applied after top-k: keep the smallest prefix of
    descending-probability entries whose mass reaches top_p, the boundary
    entry included (HF semantics), so the argmax always survives; every
    entry tied with the smallest kept value survives too. Only the top_k
    largest (all, when top_k <= 0 or >= vocab) can carry mass."""
    vocab = scaled.shape[-1]
    k = top_k if 0 < top_k < vocab else vocab
    vals = torch.topk(scaled, k, dim=-1).values          # descending
    probs = torch.softmax(vals, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) <= top_p
    kth = torch.where(keep, vals, torch.inf).amin(dim=-1, keepdim=True)
    return scaled.masked_fill(scaled < kth, NEG_INF)


def sample_codes(logits: torch.Tensor, temperature: float, top_k: int,
                 generator: torch.Generator | None = None,
                 greedy: bool = False, top_p: float = 1.0,
                 gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Temperature + top-k (+ nucleus when top_p < 1) sampling of
    code-predictor logits [B, V] f32; greedy (first argmax) when `greedy`
    or temperature <= 0. -> [B] int32."""
    g = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy or temperature <= 0.0:
        return g
    scaled = apply_top_k(logits / max(temperature, 1e-6), top_k)
    if top_p < 1.0:
        scaled = apply_top_p(scaled, top_p, top_k)
    if gumbel is None:
        gumbel = gumbel_noise(scaled.shape, generator, scaled.device)
    return torch.argmax(gumbel + scaled, dim=-1).to(torch.int32)


def sample_cb0(logits: torch.Tensor, seen_mask: torch.Tensor,
               frame_idx: torch.Tensor, expected_frames: torch.Tensor,
               repetition_penalty: float, temperature: float, top_k: int,
               generator: torch.Generator | None = None, *, eos_id: int,
               suppress_start: int, greedy: bool = False, top_p: float = 1.0,
               gumbel: torch.Tensor | None = None,
               scores_out: torch.Tensor | None = None) -> torch.Tensor:
    """First-codebook sampling in the reference's order:

      1. suppress ids in [suppress_start, V) except EOS
      2. repetition penalty over previously emitted CB0 ids (seen_mask)
      3. EOS ramp after expected_frames frames
      4. greedy argmax, or temperature -> top-k (EOS survives) -> nucleus
         when top_p < 1 (over the top_k + 1 survivors; EOS survives it
         too, so the EOS ramp can still end the stream) -> sample

    With top_k <= 0 and top_p < 1 the nucleus sees top_k + 1 = 1 entry, so
    only the argmax and EOS survive: the JAX package does the same.
    logits: [B, V] f32; seen_mask: [B, V] bool; frame_idx, expected_frames:
    [B] int32. scores_out: optional [B, V] f32 that receives the logits
    after steps 1-3, which greedy takes the argmax of. Returns [B] int32."""
    vocab = logits.shape[-1]
    ids = torch.arange(vocab, device=logits.device)
    suppress = (ids >= suppress_start) & (ids != eos_id)
    logits = logits.masked_fill(suppress[None, :], NEG_INF)

    penalized = torch.where(logits > 0.0, logits / repetition_penalty,
                            logits * repetition_penalty)
    logits = torch.where(seen_mask, penalized, logits)

    exp_f = expected_frames.float()
    ramp = ((frame_idx.float() - exp_f) / exp_f).clamp(0.0, 1.0)
    active = frame_idx >= expected_frames
    target = logits.amax(dim=-1) + 5.0
    eos_lg = logits[:, eos_id]
    boosted = eos_lg + torch.where(active, ramp, 0.0) * (target - eos_lg)
    logits = logits.clone()
    logits[:, eos_id] = boosted
    if scores_out is not None:
        scores_out.copy_(logits)

    g = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy or temperature <= 0.0:
        return g
    scaled = logits / max(temperature, 1e-6)
    eos_saved = scaled[:, eos_id].clone()
    filtered = apply_top_k(scaled, top_k)
    filtered[:, eos_id] = eos_saved
    if top_p < 1.0:
        filtered = apply_top_p(filtered, top_p, top_k + 1)
        filtered[:, eos_id] = eos_saved
    if gumbel is None:
        gumbel = gumbel_noise(filtered.shape, generator, filtered.device)
    return torch.argmax(gumbel + filtered, dim=-1).to(torch.int32)
