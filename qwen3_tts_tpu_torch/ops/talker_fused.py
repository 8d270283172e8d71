"""The talker's decode step on the card: all layers of one step in one
persistent cooperative CUDA kernel (csrc/talker_fused.cu), and its plain
torch twin.

Replaces the Pallas kernel qwen3_tts_tpu/ops/talker_fused.py::
talker_step_fused. Semantics, shared by the kernel and the twin, per
layer l:

- xn = bf16(RMSNorm(x) * attn_norm[l]); qkv = xn @ wqkv[l], f32 sums;
- q and k: head RMSNorm, then NEOX RoPE at `positions`, in f32;
- k and v go into slot `write_idx` of ``kv_cache[l, 0]`` /
  ``kv_cache[l, 1]`` in place: bf16, or for an int8 cache
  ``stack.quantize_kv_rows`` (round half to even) with its f32 scale;
- decode attention as ops/flash_decode.py computes it (q rounded to
  bf16, scores and softmax in f32, f32 probabilities times the rows read
  back from the cache, int8 rows dequantized), over the slots s <
  read_ctx that count: s < n_valid[b] (prefix mode) or valid_mask[b, s]
  (ring mode; the caller has set bit write_idx to the stream's
  liveness). The current slot is read back like any other, which gives
  the TPU kernel's current-row term (the dequantized row for int8);
- x += bf16(attn) @ wo[l]; x += bf16(silu(g) * u) @ w_down[l] with
  [g | u] = bf16(RMSNorm(x) * ffn_norm[l]) @ w_gu[l].

The TPU kernel's f32-rounded-to-bf16 probabilities become f32 here (as
in the port's decode-attention kernel), and the ring's lifetime window
is not needed: the bitmask is exact and every slot under read_ctx is
masked (the TPU kernel ignores the window too).

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
``talker_step_fused.launches`` counts kernel launches. The kernel reads
positions, n_valid, write_idx and valid_mask from device memory (no host
sync per step) and the weights in the JAX layout as they are ([in, out]
row-major, stacked over layers): nothing is packed at load. Its scratch
is sized by the kernel (``q3_talker_scratch``, from its product plan) and
cached (``_scratch``): a step allocates only its output y.
``talker_step_fused.phase_ns``, when set, gathers the kernel's phase
clock (ms by phase kind).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..models.stack import QuantKV, decode_layers
from .flash_decode import _int32, flash_decode_twin

HEAD_DIM = 128        # the kernel's head dim
K_TILE = 256          # K rows of a QKV or gate/up item (kernel); H a multiple
WEIGHTS = ("wqkv", "wo", "w_gu", "w_down")
# the kernel's scratch, in q3_talker_scratch's order: the normed residual,
# the K-split partials of QKV and gate/up, of wo and down, and attention's
# split partials (m, l) and acc
SCRATCH = (("abuf", torch.bfloat16), ("part0", torch.float32),
           ("part1", torch.float32), ("part_ml", torch.float32),
           ("part_acc", torch.float32))
_SCRATCH: dict = {}   # (device, element counts) -> tensors


def _scratch_counts(B: int, H: int, n_kv: int, read_ctx: int) -> tuple:
    """The element counts of the kernel's scratch for a step of this shape
    (SCRATCH order), as the kernel's own product plan gives them."""
    n = (ctypes.c_longlong * len(SCRATCH))()
    if kernels.lib().q3_talker_scratch(B, H, n_kv, read_ctx, n) != 0:
        raise ValueError(f"talker kernel has no product plan for B={B}, "
                         f"H={H}, n_kv={n_kv}, read_ctx={read_ctx}")
    return tuple(n)


def _scratch(dev, counts: tuple) -> tuple:
    """Flat scratch tensors of `counts` elements (SCRATCH order and
    dtypes), allocated once and reused by later steps (steps on one stream
    run in order, and the kernel writes every entry before it reads it):
    abuf and the K-split partials per (device, their counts), the
    attention partials per (device, theirs), so a new read_ctx reallocates
    only the latter."""
    out = []
    for lo, hi in ((0, 3), (3, len(SCRATCH))):
        key = (str(dev), counts[lo:hi])
        if key not in _SCRATCH:
            _SCRATCH[key] = tuple(
                torch.empty(n, device=dev, dtype=dtype)
                for n, (_, dtype) in zip(counts[lo:hi], SCRATCH[lo:hi]))
        out += _SCRATCH[key]
    return tuple(out)


def _geometry_ok(cfg) -> bool:
    """The reference talker's ratios (tts_transformer.h:21-35)."""
    H, NH, NKV, D, I = (cfg.hidden_size, cfg.n_attention_heads,
                        cfg.n_key_value_heads, cfg.head_dim,
                        cfg.intermediate_size)
    return NKV * D == H and NH == 2 * NKV and I == 3 * H


def supported(cfg, B: int, w, kv_cache, write_idx, valid_mask,
              read_ctx: int | None) -> bool:
    """The fused step's preconditions: the reference geometry, bf16
    product weights, one write slot for the batch (0-d), a bitmask of the
    cache's width, read_ctx <= S. On the card the kernel also needs head
    dim 128 and a hidden size that its 256-row product tiles divide. A
    sparse-MoE talker (``w_router``, ops/moe.py) is never supported: the
    kernel's FFN is the dense SwiGLU; nor is a latent-attention one
    (``wkv_b``, ops/mla.py): its attention is grouped-query."""
    lw = w["layers"] if "layers" in w else w
    if "w_router" in lw or "wkv_b" in lw:
        return False
    vals = kv_cache.values if isinstance(kv_cache, QuantKV) else kv_cache
    S = vals.shape[4]
    rc = S if read_ctx is None else read_ctx
    ok = (_geometry_ok(cfg)
          and all(lw[n].dtype == torch.bfloat16 for n in WEIGHTS)
          and getattr(write_idx, "ndim", 0) == 0
          and (valid_mask is None or tuple(valid_mask.shape) == (B, S))
          and rc <= S)
    if vals.is_cuda:
        ok = ok and (cfg.head_dim == HEAD_DIM
                     and cfg.hidden_size % K_TILE == 0)
    return ok


def talker_step_fused_twin(layers_w, x: torch.Tensor,
                           positions: torch.Tensor, kv_cache, write_idx,
                           n_valid: torch.Tensor, *, n_heads: int, n_kv: int,
                           head_dim: int, eps: float, theta: float,
                           read_ctx: int | None = None,
                           valid_mask: torch.Tensor | None = None):
    """Plain torch version of the kernel's semantics (module docstring).
    Returns (y [B, H] f32 before the output norm, kv_cache updated in
    place)."""
    kw = (dict(n_valid=n_valid) if valid_mask is None
          else dict(valid_mask=valid_mask))

    def attend(q, k, v, k_scale, v_scale):
        return flash_decode_twin(q, k, v, read_ctx=read_ctx, k_scale=k_scale,
                                 v_scale=v_scale, **kw)

    return decode_layers(layers_w, x, positions, kv_cache, write_idx, attend,
                         n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                         eps=eps, theta=theta)


def _launch(layers_w, x, positions, kv_cache, write_idx, n_valid, *,
            n_heads, n_kv, head_dim, eps, theta, read_ctx, valid_mask):
    dev = x.device
    B, H = x.shape
    req = kernels.require
    if (head_dim != HEAD_DIM or n_kv * head_dim != H
            or n_heads != 2 * n_kv or H % K_TILE):
        raise ValueError(f"kernel serves head_dim {HEAD_DIM}, n_kv * "
                         f"head_dim == H, 2 query heads per kv head and H "
                         f"a multiple of {K_TILE}; got H={H}, heads "
                         f"{n_heads}/{n_kv}, head_dim {head_dim}")
    int8 = isinstance(kv_cache, QuantKV)
    vals = kv_cache.values if int8 else kv_cache
    L, S = vals.shape[0], vals.shape[4]
    req(x, "x", torch.float32, (B, H))
    req(vals, "kv_cache", torch.int8 if int8 else torch.bfloat16,
        (L, 2, B, n_kv, S, head_dim))
    if int8:
        req(kv_cache.scales, "kv_cache.scales", torch.float32,
            (L, 2, B, n_kv, S))
    shapes = {"wqkv": (L, H, 4 * H), "wo": (L, 2 * H, H),
              "w_gu": (L, H, 6 * H), "w_down": (L, 3 * H, H),
              "attn_norm": (L, H), "ffn_norm": (L, H),
              "q_norm": (L, head_dim), "k_norm": (L, head_dim)}
    for name, shape in shapes.items():
        req(layers_w[name], name,
            torch.bfloat16 if name in WEIGHTS else torch.float32, shape)
    positions = _int32(positions, "positions", dev)
    req(positions, "positions", torch.int32, (B,))
    widx = _int32(write_idx, "write_idx", dev)
    req(widx, "write_idx", torch.int32, ())
    if valid_mask is None:
        n_valid = _int32(n_valid, "n_valid", dev)
        req(n_valid, "n_valid", torch.int32, (B,))
    else:
        req(valid_mask, "valid_mask", torch.bool, (B, S))
    rc = S if read_ctx is None else int(read_ctx)
    if not 0 < rc <= S:
        raise ValueError(f"read_ctx {rc} outside (0, {S}]")

    sc = _scratch(dev, _scratch_counts(B, H, n_kv, rc))
    y = torch.empty(B, H, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lw = layers_w
    kernels.check(kernels.lib().q3_talker_step(
        x.data_ptr(), positions.data_ptr(),
        None if valid_mask is not None else n_valid.data_ptr(),
        ptr(valid_mask), widx.data_ptr(),
        *(lw[n].data_ptr() for n in (*WEIGHTS, "attn_norm", "ffn_norm",
                                      "q_norm", "k_norm")),
        vals.data_ptr(), ptr(kv_cache.scales) if int8 else None,
        *(t.data_ptr() for t in sc), y.data_ptr(),
        ptr(talker_step_fused.phase_ns), B, L, H, n_kv, S, rc, int(int8),
        float(eps), float(theta), 1.0 / head_dim ** 0.5,
        kernels.stream(dev)), "q3_talker_step")
    talker_step_fused.launches += 1
    return y, kv_cache


def talker_step_fused(layers_w, x: torch.Tensor, positions: torch.Tensor,
                      kv_cache, write_idx, n_valid: torch.Tensor, *,
                      n_heads: int, n_kv: int, head_dim: int, eps: float,
                      theta: float, read_ctx: int | None = None,
                      valid_mask: torch.Tensor | None = None):
    """One decode step of every layer (the JAX signature, less
    `interpret`): x [B, H] f32; positions, n_valid [B] int32 (n_valid is
    ignored when valid_mask [B, S] bool is given); write_idx: the batch's
    cache slot, 0-d; kv_cache: stacked [L, 2, B, n_kv, S, D] bf16 or
    stack.QuantKV, updated in place. Returns (y [B, H] f32 before the
    output norm, kv_cache)."""
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps,
              theta=theta, read_ctx=read_ctx, valid_mask=valid_mask)
    if x.device.type == "cpu":
        return talker_step_fused_twin(layers_w, x, positions, kv_cache,
                                      write_idx, n_valid, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"talker_step_fused: no kernel for {x.device}")
    return _launch(layers_w, x, positions, kv_cache, write_idx, n_valid,
                   **kw)


talker_step_fused.launches = 0
# a device int64 [6] tensor, when set: the kernel adds the ns of each phase
# kind to it (PHASES order)
talker_step_fused.phase_ns = None
PHASES = ("norm", "qkv", "attention", "wo", "gate/up", "down")
# phases of each kind in one step of L layers: two norms a layer and the
# final one, one of each other kind
PHASES_PER_LAYER = {"norm": 2, "qkv": 1, "attention": 1, "wo": 1,
                    "gate/up": 1, "down": 1}
BARRIERS_PER_LAYER = sum(PHASES_PER_LAYER.values())   # 7
