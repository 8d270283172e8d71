"""Code predictor: the 15 residual codebooks of a frame (port of
qwen3_tts_tpu/models/code_predictor.py).

``predict_codes`` has two implementations, chosen per call by
``QWEN3_TTS_CODEPRED`` (or ``set_codepred_impl``), with the JAX package's
semantics:
- ``fused``: ops/codepred_fused.py, the whole frame in one CUDA kernel on
  a CUDA tensor, its torch twin on a CPU tensor; raises unless
  ``codepred_fused.supported`` holds and top_p >= 1 (the kernel samples in
  the kernel, with no nucleus filter; an mtp projection it serves only
  through the f32 rows that ``codepred_fused.fold_mtp`` folds at engine
  set-up);
- ``xla``: this port of the JAX package's XLA path, on either device: a
  2-token prefill, then 14 single-token steps over a 16-slot bf16 cache
  (on the card its attention is the decode-attention kernel);
- ``auto`` (the default): ``fused`` on a CUDA tensor whenever
  ``supported`` holds and top_p >= 1, else ``xla``; on the CPU always
  ``xla``.
``fused_interpret`` raises (models/impl_switch.py).

On a tp-split tree (parallel/mesh.py, tp > 1) ``auto`` takes ``xla``, on
this rank's heads, with each head's logits gathered over tp before
sampling; ``fused`` raises there. A dp-only mesh keeps the kernel.
"""

from __future__ import annotations

import torch

from ..config import TalkerConfig
from ..ops import codepred_fused
from ..ops.layers import dot, rms_norm
from ..ops.sampling import sample_codes
from ..parallel.mesh import tp_gather, tp_size
from .impl_switch import ImplSwitch
from .stack import stack_prefill, stack_step, write_prefill_to_cache

_SWITCH = ImplSwitch("QWEN3_TTS_CODEPRED")
set_codepred_impl = _SWITCH.set
_resolve_impl = _SWITCH.resolve


def predict_codes(w, cfg: TalkerConfig, hidden: torch.Tensor,
                  cb0: torch.Tensor, temperature: float, top_k: int,
                  generator: torch.Generator | None = None,
                  greedy: bool = False, top_p: float = 1.0,
                  gumbel: torch.Tensor | None = None,
                  logits_out: torch.Tensor | None = None) -> torch.Tensor:
    """Codebooks 1..15 for one frame, batched, by the implementation that
    QWEN3_TTS_CODEPRED selects (module docstring).

    hidden: [B, H] f32 (talker hidden after the output norm); cb0: [B]
    int32. gumbel: optional [15, B, V] noise, row s for the s-th sampled
    codebook (drawn from `generator` when absent); logits_out: optional
    [15, B, V] f32 that receives each codebook's logits. Returns [B, 15]
    int32."""
    impl = _resolve_impl()
    cp = w["code_pred"]
    split = tp_size(cp["layers"])
    if impl == "fused" and split > 1:
        raise ValueError(
            "QWEN3_TTS_CODEPRED=fused on a tp-split code predictor (tp > 1):"
            " the kernel cannot all-reduce between layers; use auto or xla")
    if impl != "xla" and split == 1:
        ok = (codepred_fused.supported(cfg, hidden.shape[0], w)
              and top_p >= 1.0)
        if impl == "fused" and not ok:
            raise ValueError(
                "QWEN3_TTS_CODEPRED=fused but the kernel does not serve this "
                "config/batch/top_p (see codepred_fused.supported; it "
                "samples in the kernel, with no nucleus filter)")
        if impl == "fused" or (ok and hidden.is_cuda):
            return codepred_fused.predict_codes_fused(
                w, cfg, hidden, cb0, temperature, top_k, generator,
                greedy=greedy, gumbel=gumbel, logits_out=logits_out)

    n_steps = cfg.n_codebooks - 1
    B, dev = hidden.shape[0], hidden.device
    x0 = hidden.float()
    x1 = w["codec_embd"][cb0.long()].float()
    xs = codepred_fused.project_mtp(cp, torch.stack([x0, x1], dim=1))
    positions = torch.arange(2, dtype=torch.int32, device=dev).expand(B, 2)
    kw = dict(n_heads=cfg.code_pred_n_attention_heads,
              n_kv=cfg.code_pred_n_kv_heads, head_dim=cfg.code_pred_head_dim,
              eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    y, ks, vs = stack_prefill(cp["layers"], xs, positions, **kw)
    kv_cache = torch.zeros(cfg.code_pred_layers, 2, B,
                           cfg.code_pred_n_kv_heads // split,
                           n_steps + 1, cfg.code_pred_head_dim,
                           dtype=torch.bfloat16, device=dev)
    write_prefill_to_cache(kv_cache, ks, vs, 0)

    def head(y, s):
        logits = tp_gather(dot(rms_norm(y, cp["output_norm"],
                                        cfg.rms_norm_eps), cp["heads"][s]),
                           cp)
        if logits_out is not None:
            logits_out[s] = logits
        return sample_codes(logits, temperature, top_k, generator,
                            greedy=greedy, top_p=top_p,
                            gumbel=None if gumbel is None else gumbel[s])

    codes = [head(y[:, -1], 0)]
    for s in range(n_steps - 1):
        x = codepred_fused.project_mtp(
            cp, cp["embd"][s][codes[-1].long()].float())
        n_past = s + 2
        y, kv_cache = stack_step(
            cp["layers"], x,
            torch.full((B,), n_past, dtype=torch.int32, device=dev), kv_cache,
            n_past, torch.full((B,), n_past + 1, dtype=torch.int32,
                               device=dev), **kw)
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
