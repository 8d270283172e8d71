"""Decode attention over the kv-heads-major cache (port of
qwen3_tts_tpu/ops/attention.py).

``set_decode_attention_impl`` / ``get_decode_attention_impl`` choose the
implementation for every later call (models/impl_switch.py; no
environment variable, as in the JAX package):
- ``auto`` (the default): the hand-written kernel (ops/flash_decode.py)
  on a CUDA tensor, in both modes and for both cache dtypes; it raises if
  the kernel cannot serve the call. A CPU tensor takes the port of the
  JAX package's XLA path (``layers.gqa_attention_step_kvmajor``), which
  keeps the goldens and greedy parity with the JAX package exact;
- ``flash``: the kernel on a CUDA tensor, its torch twin on a CPU tensor;
- ``xla``: the XLA-path port on any device (no kernel launch).
The JAX package's ``auto`` means its XLA path because of a TPU
measurement (its module docstring); on the H100 the kernel is the
measured choice (PERF.md §6 row 4: 0.038 ms a layer call against
``scaled_dot_product_attention``'s 0.148 at B=8), so ``auto`` means the
kernel there. ``flash_interpret`` raises ``ValueError``. A frame's CUDA
graph bakes the choice in, so it is part of the graph key
(runtime/graphs.gen_key).
"""

from __future__ import annotations

import torch

from ..models.impl_switch import ImplSwitch
from .flash_decode import flash_decode, flash_decode_masked
from .layers import gqa_attention_step_kvmajor

_SWITCH = ImplSwitch(None, "set_decode_attention_impl",
                     ("auto", "flash", "xla"))
set_decode_attention_impl = _SWITCH.set
get_decode_attention_impl = _SWITCH.resolve


def _kernel(q: torch.Tensor) -> bool:
    """Whether the call takes the kernel (or, on the CPU, its twin)."""
    impl = _SWITCH.resolve()
    return impl == "flash" or (impl == "auto" and q.is_cuda)


def _xla_path(q, k, v, mask, read_ctx, k_scale, v_scale) -> torch.Tensor:
    if read_ctx is not None:
        k, v, mask = k[:, :, :read_ctx], v[:, :, :read_ctx], mask[:, :read_ctx]
        if k_scale is not None:
            k_scale = k_scale[:, :, :read_ctx]
            v_scale = v_scale[:, :, :read_ctx]
    return gqa_attention_step_kvmajor(q, k, v, mask, k_scale, v_scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: torch.Tensor, read_ctx: int | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Prefix-validity decode attention. q: [B, n_heads, D]; k, v:
    [B, n_kv, S, D]; n_valid: [B]; read_ctx bounds every stream's valid
    length (attention reads only that many cache rows). k_scale/v_scale:
    [B, n_kv, S] for an int8 cache. Returns [B, n_heads*D] f32."""
    if _kernel(q):
        return flash_decode(q, k, v, n_valid, read_ctx=read_ctx,
                            k_scale=k_scale, v_scale=v_scale)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < n_valid[:, None]
    return _xla_path(q, k, v, mask, read_ctx, k_scale, v_scale)


def decode_attention_masked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid_mask: torch.Tensor,
                            read_ctx: int | None = None,
                            window_lo: torch.Tensor | None = None,
                            window_hi: torch.Tensor | None = None,
                            prefill_len: int = 0,
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Bitmask decode attention (ring-slot cache serving). valid_mask:
    [B, S]; window_lo/window_hi + prefill_len bound each stream's valid
    slots to [0, prefill_len) U [lo, hi), which the kernel uses to skip
    blocks (the XLA path reads every row under read_ctx; the bitmask is
    exact either way). Returns [B, n_heads*D] f32."""
    if _kernel(q):
        return flash_decode_masked(
            q, k, v, valid_mask, window_lo=window_lo, window_hi=window_hi,
            prefill_len=prefill_len, read_ctx=read_ctx, k_scale=k_scale,
            v_scale=v_scale)
    return _xla_path(q, k, v, valid_mask, read_ctx, k_scale, v_scale)
