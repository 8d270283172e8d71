"""Code predictor: the 15 residual codebooks of a frame (port of
qwen3_tts_tpu/models/code_predictor.py).

On a CUDA tensor ``predict_codes`` runs the hand-written kernels of
ops/codepred_fused.py. On a CPU tensor it runs this port of the JAX
package's XLA path, which is also what that package runs on a CPU: a
2-token prefill, then 14 single-token steps over a 16-slot bf16 cache.
"""

from __future__ import annotations

import torch

from ..config import TalkerConfig
from ..ops import codepred_fused
from ..ops.layers import dot, rms_norm
from ..ops.sampling import sample_codes
from .stack import stack_prefill, stack_step, write_prefill_to_cache


def _mtp(cp, x: torch.Tensor) -> torch.Tensor:
    """Talker-space -> code-predictor-space projection (1.7B only)."""
    if cp.get("mtp_w") is None:
        return x
    y = dot(x, cp["mtp_w"])
    if cp.get("mtp_b") is not None:
        y = y + cp["mtp_b"]
    return y


def predict_codes(w, cfg: TalkerConfig, hidden: torch.Tensor,
                  cb0: torch.Tensor, temperature: float, top_k: int,
                  generator: torch.Generator | None = None,
                  greedy: bool = False, top_p: float = 1.0,
                  gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Codebooks 1..15 for one frame, batched.

    hidden: [B, H] f32 (talker hidden after the output norm); cb0: [B]
    int32. gumbel: optional [15, B, V] noise, row s for the s-th sampled
    codebook (drawn from `generator` when absent). Returns [B, 15] int32."""
    if top_p < 1.0:
        raise NotImplementedError("top_p < 1 is not ported yet")
    if hidden.is_cuda:
        return codepred_fused.predict_codes_fused(
            w, cfg, hidden, cb0, temperature, top_k, generator,
            greedy=greedy, gumbel=gumbel)

    cp = w["code_pred"]
    n_steps = cfg.n_codebooks - 1
    B = hidden.shape[0]
    x0 = hidden.float()
    x1 = w["codec_embd"][cb0.long()].float()
    xs = _mtp(cp, torch.stack([x0, x1], dim=1))
    positions = torch.arange(2, dtype=torch.int32).expand(B, 2)
    kw = dict(n_heads=cfg.code_pred_n_attention_heads,
              n_kv=cfg.code_pred_n_kv_heads, head_dim=cfg.code_pred_head_dim,
              eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    y, ks, vs = stack_prefill(cp["layers"], xs, positions, **kw)
    kv_cache = torch.zeros(cfg.code_pred_layers, 2, B, cfg.code_pred_n_kv_heads,
                           n_steps + 1, cfg.code_pred_head_dim,
                           dtype=torch.bfloat16)
    write_prefill_to_cache(kv_cache, ks, vs, 0)

    def head(y, s):
        logits = dot(rms_norm(y, cp["output_norm"], cfg.rms_norm_eps),
                     cp["heads"][s])
        return sample_codes(logits, temperature, top_k, generator,
                            greedy=greedy,
                            gumbel=None if gumbel is None else gumbel[s])

    codes = [head(y[:, -1], 0)]
    for s in range(n_steps - 1):
        x = _mtp(cp, cp["embd"][s][codes[-1].long()].float())
        n_past = s + 2
        y, kv_cache = stack_step(
            cp["layers"], x, torch.full((B,), n_past, dtype=torch.int32),
            kv_cache, n_past, torch.full((B,), n_past + 1, dtype=torch.int32),
            **kw)
        codes.append(head(y, s + 1))
    return torch.stack(codes, dim=1)


def frame_step_embedding(w, cfg: TalkerConfig, frame_codes: torch.Tensor,
                         trailing_row: torch.Tensor) -> torch.Tensor:
    """Next talker input: codec_embd[cb0] + sum_cb code_pred.embd[cb-1][code]
    + the trailing text row (or tts_pad). frame_codes: [B, 16] int32."""
    cp = w["code_pred"]
    codes = frame_codes.long()
    cb0_embd = w["codec_embd"][codes[:, 0]].float()
    n_rest = codes.shape[1] - 1
    rest = cp["embd"][torch.arange(n_rest, device=codes.device)[None, :],
                      codes[:, 1:]].float().sum(dim=1)
    return cb0_embd + rest + trailing_row
