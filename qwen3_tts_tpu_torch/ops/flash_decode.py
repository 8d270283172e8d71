"""Decode attention on the card: a hand-written flash-decoding kernel
(csrc/flash_decode.cu) over the kv-major KV cache, and its plain torch
twin.

Replaces the Pallas kernel qwen3_tts_tpu/ops/flash_decode.py::
flash_decode / flash_decode_masked. Semantics, shared by the kernel and
the twin:

- q [B, n_heads, D]; k, v [B, n_kv, S, D], the per-layer views
  ``kv_cache[l, 0]`` / ``kv_cache[l, 1]`` of the stacked cache, read in
  place (no transpose, no copy); int8 rows times their f32 scales
  [B, n_kv, S]. Query head h*G + g reads kv head h.
- Slots past read_ctx are never read. The other slots are cut into blocks
  of BLOCK; a block is read only if the mode needs it: the prefix
  ``j*BLOCK < n_valid``; or the ring window ``[0, prefill_len) U [lo, hi)``,
  ``[.., hi) U [lo, ..)`` when lo > hi (the TPU kernel's
  ``_window_needed``); or every block for a bare bitmask. Inside a read
  block each slot counts only if it is valid (prefix or bitmask).
- Scores (q / sqrt(D)) . k and the softmax in f32, f32 probabilities
  times v; a stream with no counted slot outputs 0.

The wrappers take n_valid, lo and hi as device tensors and never read
them on the host: the ring's ``window_hi = write_slot + 1`` stays on the
device. A CPU tensor runs the twin; a CUDA tensor launches the kernel or
raises. ``flash_decode.launches`` counts kernel calls through either
wrapper (``launches_by_mode`` splits them by prefix / mask / window);
``flash_decode.wrapped``, when set to a device int32 [1] tensor, gains
one per (call, stream) that the kernel served with a wrapped window.
The wrapper keeps the SM count per device and the splits' scratch per
(device, shape); a call allocates only its output.
"""

from __future__ import annotations

import torch

from .. import kernels

BLOCK = 64            # slots per needed-block decision and kernel tile
HEAD_DIM = 128        # the kernel's head dim
GROUPS = (1, 2, 4, 8) # query heads per kv head the kernel serves
CTAS_PER_SM = 3       # resident CTAs a SM (the kernel's __launch_bounds__)

_SMS: dict = {}       # device -> SM count
_SCRATCH: dict = {}   # (device, rows, n_split) -> (part_ml, part_acc)


def split_plan(n_pairs: int, n_tiles: int, sms: int) -> tuple[int, int]:
    """(tiles per split, n_split) for n_pairs (stream, kv head) pairs over
    n_tiles 64-slot tiles. A CTA walks its split's tiles one after another
    and the tiles a call needs cluster (a prefix, a ring window), so
    splits are short: two tiles, or one where two-tile splits would leave
    some of the card's CTA slots (CTAS_PER_SM on each of `sms` SMs) idle."""
    per = 2 if n_pairs * -(-n_tiles // 2) >= CTAS_PER_SM * sms else 1
    per = min(per, n_tiles)
    return per, -(-n_tiles // per)


def _sm_count(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _scratch(dev, rows: int, n_split: int):
    """The splits' (m, l) and acc partials, allocated once per shape and
    reused by every later call (calls on one stream run in order; the
    kernel writes every entry it reads)."""
    key = (dev, rows, n_split)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.empty(rows, n_split, 2, dtype=torch.float32, device=dev),
            torch.empty(rows, n_split, HEAD_DIM, dtype=torch.float32,
                        device=dev))
    return _SCRATCH[key]


def _window_needed(n_blocks: int, prefill_len: int, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """[B, n_blocks]: blocks overlapping [0, prefill_len) or the modular
    window [lo, hi) (wrapping when lo > hi)."""
    start = torch.arange(n_blocks, device=lo.device)[None, :] * BLOCK
    end = start + BLOCK
    lo_, hi_ = lo.long()[:, None], hi.long().reshape(-1)[:, None]
    main = (start < hi_) & (end > lo_)
    wrap = (start < hi_) | (end > lo_)
    return (start < prefill_len) | torch.where(lo_ > hi_, wrap, main)


def _slots_read(B: int, ctx: int, device, n_valid=None, valid_mask=None,
                window_lo=None, window_hi=None, prefill_len: int = 0):
    """[B, ctx] bool: the slots the kernel counts (module docstring)."""
    n_blocks = -(-ctx // BLOCK)
    slot = torch.arange(ctx, device=device)
    if n_valid is not None:
        need = (torch.arange(n_blocks, device=device)[None, :] * BLOCK
                < n_valid.long()[:, None])
        valid = slot[None, :] < n_valid.long()[:, None]
    else:
        valid = valid_mask[:, :ctx].bool()
        if window_lo is None:
            return valid
        need = _window_needed(n_blocks, prefill_len, window_lo,
                              window_hi.expand(B) if window_hi.numel() == 1
                              else window_hi)
    return valid & need.repeat_interleave(BLOCK, dim=1)[:, :ctx]


def flash_decode_twin(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      n_valid: torch.Tensor | None = None,
                      valid_mask: torch.Tensor | None = None,
                      window_lo: torch.Tensor | None = None,
                      window_hi: torch.Tensor | None = None,
                      prefill_len: int = 0, read_ctx: int | None = None,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernel's semantics (module docstring),
    for any float or int8 cache dtype. Returns [B, n_heads*D] f32."""
    B, n_heads, D = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    G = n_heads // n_kv
    ctx = min(read_ctx or S, S)
    if window_hi is not None:
        window_hi = torch.as_tensor(window_hi, device=q.device)
    counted = _slots_read(B, ctx, q.device, n_valid, valid_mask, window_lo,
                          window_hi, prefill_len)
    kf, vf = k[:, :, :ctx].float(), v[:, :, :ctx].float()
    if k_scale is not None:
        kf = kf * k_scale[:, :, :ctx, None]
        vf = vf * v_scale[:, :, :ctx, None]
    qg = q.float().reshape(B, n_kv, G, D) * (1.0 / D ** 0.5)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, kf)
    scores = scores.masked_fill(~counted[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)                     # exp(-inf) = 0
    out = torch.einsum("bkgs,bksd->bkgd", p, vf)
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, n_heads * D)


def _int32(t, name: str, device) -> torch.Tensor:
    """A Python int becomes a device int32; a tensor must be int32 on
    `device` already (converting it would cost a launch per call)."""
    if not isinstance(t, torch.Tensor):
        return torch.tensor(t, dtype=torch.int32, device=device)
    if t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name}: expected int32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    return t.contiguous()


def _launch(mode: str, q, k, v, read_ctx, k_scale, v_scale, n_valid=None,
            valid_mask=None, lo=None, hi=None, prefill_len: int = 0
            ) -> torch.Tensor:
    B, n_heads, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k: expected [B, n_kv, S, {D}], got "
                         f"{tuple(k.shape)}")
    n_kv, S = k.shape[1], k.shape[2]
    G = n_heads // n_kv
    if D != HEAD_DIM or n_heads != n_kv * G or G not in GROUPS:
        raise ValueError(f"kernel serves D={HEAD_DIM} and {GROUPS} query "
                         f"heads per kv head; got D={D}, heads {n_heads}/"
                         f"{n_kv}")
    dev = q.device
    req = kernels.require
    req(q, "q", torch.bfloat16, (B, n_heads, D))
    int8 = k.dtype == torch.int8
    for name, t in (("k", k), ("v", v)):
        req(t, name, k.dtype if int8 else torch.bfloat16, (B, n_kv, S, D))
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte alignment")
    if int8:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 cache needs k_scale and v_scale")
        req(k_scale, "k_scale", torch.float32, (B, n_kv, S))
        req(v_scale, "v_scale", torch.float32, (B, n_kv, S))
    ctx = min(read_ctx or S, S)
    n_blocks = max(-(-ctx // BLOCK), 1)
    if n_valid is not None:
        n_valid = _int32(n_valid, "n_valid", dev)
        req(n_valid, "n_valid", torch.int32, (B,))
    if valid_mask is not None:
        req(valid_mask, "valid_mask", torch.bool, (B, S))
    hi_stride = 0
    if lo is not None:
        lo = _int32(lo, "window_lo", dev)
        req(lo, "window_lo", torch.int32, (B,))
        hi = _int32(hi, "window_hi", dev)
        if hi.numel() not in (1, B):
            raise ValueError(f"window_hi: expected 1 or {B} values")
        hi_stride = 0 if hi.numel() == 1 else 1
    per_split, n_split = split_plan(B * n_kv, n_blocks, _sm_count(dev))
    part_ml, part_acc = _scratch(dev, B * n_heads, n_split)
    out = torch.empty(B, n_heads * D, dtype=torch.float32, device=dev)
    wrapped = flash_decode.wrapped

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernels.check(kernels.lib().q3_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale),
        ptr(n_valid), ptr(valid_mask), ptr(lo), ptr(hi), hi_stride,
        int(prefill_len), B, n_kv, G, S, ctx, per_split, n_split,
        1.0 / D ** 0.5, int(int8), part_ml.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), ptr(wrapped), kernels.stream(dev)), "q3_flash_decode")
    flash_decode.launches += 1
    flash_decode.launches_by_mode[mode] += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 n_valid: torch.Tensor, *, read_ctx: int | None = None,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Prefix-validity decode attention (lock-step batches): stream b
    attends slots [0, n_valid[b]), read_ctx bounding every stream.
    Returns [B, n_heads*D] f32."""
    if not q.is_cuda:
        return flash_decode_twin(q, k, v, n_valid=n_valid, read_ctx=read_ctx,
                                 k_scale=k_scale, v_scale=v_scale)
    return _launch("prefix", q, k, v, read_ctx, k_scale, v_scale,
                   n_valid=n_valid)


def flash_decode_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_mask: torch.Tensor, *,
                        window_lo: torch.Tensor | None = None,
                        window_hi: torch.Tensor | int | None = None,
                        prefill_len: int = 0, read_ctx: int | None = None,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Bitmask decode attention for the ring-slot cache (serving).
    valid_mask [B, S] bool; window_lo [B] with window_hi (one value or
    [B]) and prefill_len bound the blocks read (module docstring).
    Returns [B, n_heads*D] f32."""
    if (window_lo is None) != (window_hi is None):
        raise ValueError("window_lo and window_hi must be given together")
    if not q.is_cuda:
        return flash_decode_twin(q, k, v, valid_mask=valid_mask,
                                 window_lo=window_lo, window_hi=window_hi,
                                 prefill_len=prefill_len, read_ctx=read_ctx,
                                 k_scale=k_scale, v_scale=v_scale)
    return _launch("mask" if window_lo is None else "window", q, k, v,
                   read_ctx, k_scale, v_scale, valid_mask=valid_mask,
                   lo=window_lo, hi=window_hi, prefill_len=prefill_len)


flash_decode.launches = 0
flash_decode.launches_by_mode = {"prefix": 0, "mask": 0, "window": 0}
flash_decode.wrapped = None
