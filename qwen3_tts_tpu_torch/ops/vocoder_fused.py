"""Vocoder decoder-block kernels on the card (csrc/vocoder.cu) and their
plain torch twins.

Replaces the Pallas kernels of qwen3_tts_tpu/ops/vocoder_fused.py:

- ``fused_residual_chain``: x += conv1(snake(conv7_d(snake(x)))) for
  d = 1, 3, 9 (causal), as tensor-core implicit GEMMs: a snake pre-pass
  writes s = bf16(snake1(x)) once per element, then per unit one conv7
  launch (its epilogue writes y2 = bf16(snake2(. + b1))) and one conv1
  launch (its epilogue writes x + . + b2 and the next unit's s). A CUDA
  block cannot carry the causal halo from the previous tile as the TPU's
  in-order grid does, so each conv7 tile reads its 6d-row halo of s from
  global memory. The bf16 s and y2 buffers and the f32 ping-pong buffer
  are cached per (device, C) (``_chain_scratch``); a call allocates only
  its output. Twin: the port of the XLA chain
  (models/vocoder._residual_block).
- ``fused_snake_convt``: decoder-block head, snake + stride-r transposed
  conv (K = 2r) with the causal trim, + bias. Phase-major packing
  Whi[:, p*C2 + c] = W[:, c, p + r], Wlo[:, p*C2 + c] = W[:, c, p] makes it
  one GEMM over [s[t] | s[t+1]] (s[T] = 0): a snake pre-pass writes
  s = bf16(snake(x)) once per element into a bf16 scratch cached per
  (device, C) (``_head_scratch``), then the chain's tensor-core implicit
  GEMM in a mode of its own reads rows t and t + 1 of s, the streams
  folded into its rows. Two launches a call. Twin: the XLA head.

Matmul operands are bf16 with f32 accumulation, as in the JAX package
(the production vocoder weights are bf16, models/vocoder.cast_weights);
snake and the residual adds are f32. Both wrappers take a decoder block's
weight dict: a CPU tensor runs the twin on its parameters; a CUDA tensor
launches the kernel on the block's ``kernel`` entry (``pack_block``, made
once at load time) or raises.

Snake's sin^2 follows ``set_snake_sin2_impl`` (the JAX package's
models/vocoder.py switch, which its two Pallas kernels honour; models/
vocoder.py re-exports it): ``fast`` (the default) is the fast_sin2
polynomial, ``exact`` the accurate sine, in the plain path, both twins and
both kernels alike (a template parameter of the kernels' snake; the
``fast`` code is the one compiled before the switch existed).
"""

from __future__ import annotations

import torch

from .. import kernels
from .layers import fast_sin2

DILATIONS = (1, 3, 9)
# the GEMMs' column tiles (csrc/vocoder.cu): the chain's C and the head's
# r * C2 must be a multiple of one of them
TILES_N = (128, 96)
HEAD_K_STAGE = 64   # the head's K rows a ring stage: C must be a multiple

_CHAIN_SCRATCH: dict = {}   # (device, C) -> flat (s, y2, tmp)
_HEAD_SCRATCH: dict = {}    # (device, C) -> flat (s,)

SIN2_IMPLS = ("fast", "exact")
_sin2_impl = "fast"


def set_snake_sin2_impl(impl: str) -> None:
    """Snake's sin^2 for every later call: ``fast`` (fast_sin2, the
    default) or ``exact`` (the accurate sine). The engine's vocoder graphs
    are keyed by it (runtime/graphs.voc_key), so a change takes a new
    graph."""
    global _sin2_impl
    if impl not in SIN2_IMPLS:
        raise ValueError(f"impl must be one of {SIN2_IMPLS}")
    _sin2_impl = impl


def snake_sin2_impl() -> str:
    return _sin2_impl


def sin2(z: torch.Tensor) -> torch.Tensor:
    """sin^2(z) as ``set_snake_sin2_impl`` says."""
    if _sin2_impl == "fast":
        return fast_sin2(z)
    s = torch.sin(z)
    return s * s


def _snake_consts(alpha_log, beta_log):
    return (torch.exp(alpha_log.float()).contiguous(),
            torch.exp(-beta_log.float()).contiguous())


def pack_block(blk_w) -> dict:
    """Kernel-ready copies of one decoder block's parameters, made once
    when the weights are loaded (models/vocoder.pack_kernel_weights):
    ``head``: (w [2C, r*C2] bf16 = [Whi; Wlo], bias [r*C2], a [C], ib [C]);
    ``res``: per residual block (a1, ib1, w7 [7, C, C] bf16 (tap, in, out),
    b1, a2, ib2, w1 [C, C] bf16 (in, out), b2). a = exp(alpha),
    ib = exp(-beta); vectors are f32."""
    conv_t_w = blk_w["conv_t_w"]
    C, C2, K = conv_t_w.shape
    rate = K // 2
    wf = conv_t_w.float()
    whi = wf[:, :, rate:].permute(0, 2, 1).reshape(C, rate * C2)
    wlo = wf[:, :, :rate].permute(0, 2, 1).reshape(C, rate * C2)
    head = (torch.cat([whi, wlo], dim=0).to(torch.bfloat16).contiguous(),
            blk_w["conv_t_b"].float().repeat(rate).contiguous(),
            *_snake_consts(blk_w["snake_a"], blk_w["snake_b"]))
    res = []
    for rw in blk_w["res"]:
        a1, ib1 = _snake_consts(rw["a1"], rw["b1"])
        a2, ib2 = _snake_consts(rw["a2"], rw["b2"])
        w7 = rw["c1_w"].permute(2, 1, 0).to(torch.bfloat16).contiguous()
        w1 = rw["c2_w"][:, :, 0].t().to(torch.bfloat16).contiguous()
        res.append((a1, ib1, w7, rw["c1_b"].float().contiguous(), a2, ib2,
                    w1, rw["c2_b"].float().contiguous()))
    return {"head": head, "res": res}


def _packed(blk_w, part: str):
    if "kernel" not in blk_w:
        raise ValueError("decoder block has no kernel parameters: pack the "
                         "weights once with models.vocoder."
                         "pack_kernel_weights")
    return blk_w["kernel"][part]


def residual_chain_twin(x: torch.Tensor, blk_w) -> torch.Tensor:
    """The XLA residual chain, in plain torch."""
    from ..models.vocoder import _residual_block
    for rw, d in zip(blk_w["res"], DILATIONS):
        x = _residual_block(rw, x, d)
    return x


def tile_n(n: int) -> int:
    """The GEMM kernels' column tile for n output columns (0: none serves
    n)."""
    return next((t for t in TILES_N if n % t == 0), 0)


def _scratch(store: dict, dev, B: int, T: int, C: int, dtypes) -> tuple:
    """[B, T, C] views of flat buffers of `dtypes`, kept in `store` per
    (device, C) and grown to the largest B * T seen (calls on one stream
    run in order, and every launch writes what the next reads)."""
    n = B * T * C
    key = (str(dev), C)
    bufs = store.get(key)
    if bufs is None or bufs[0].numel() < n:
        bufs = store[key] = tuple(torch.empty(n, dtype=dt, device=dev)
                                  for dt in dtypes)
    return tuple(t[:n].view(B, T, C) for t in bufs)


def _chain_scratch(dev, B: int, T: int, C: int) -> tuple:
    """(s, y2, tmp) for one chain call: s and y2 bf16, tmp f32."""
    return _scratch(_CHAIN_SCRATCH, dev, B, T, C,
                    (torch.bfloat16, torch.bfloat16, torch.float32))


def _head_scratch(dev, B: int, T: int, C: int) -> torch.Tensor:
    """The head's s = bf16(snake(x)) [B, T, C]."""
    return _scratch(_HEAD_SCRATCH, dev, B, T, C, (torch.bfloat16,))[0]


def fused_residual_chain(x: torch.Tensor, blk_w) -> torch.Tensor:
    """The decoder block's 3-block residual Snake chain.
    x: [B, T, C] f32 -> [B, T, C] f32."""
    if not x.is_cuda:
        return residual_chain_twin(x, blk_w)
    if x.ndim != 3:
        raise ValueError(f"x: expected [B, T, C], got {tuple(x.shape)}")
    B, T, C = x.shape
    kernels.require(x, "x", torch.float32)
    if not tile_n(C):
        raise ValueError(f"kernel serves C a multiple of one of "
                         f"{TILES_N}, got C={C}")
    res = _packed(blk_w, "res")
    if len(res) != 3:
        raise ValueError(f"kernel serves 3 residual blocks, got {len(res)}")
    for a1, ib1, w7, b1, a2, ib2, w1, b2 in res:
        for name, t in (("a1", a1), ("ib1", ib1), ("b1", b1), ("a2", a2),
                        ("ib2", ib2), ("b2", b2)):
            kernels.require(t, name, torch.float32, (C,))
        kernels.require(w7, "w7", torch.bfloat16, (7, C, C))
        kernels.require(w1, "w1", torch.bfloat16, (C, C))
    lib = kernels.lib()
    st = kernels.stream(x.device)
    exact = int(_sin2_impl == "exact")
    s, y2, tmp = _chain_scratch(x.device, B, T, C)
    out = torch.empty_like(x)
    kernels.check(lib.q3_snake_bf16(x.data_ptr(), s.data_ptr(), B, T, C,
                                    res[0][0].data_ptr(),
                                    res[0][1].data_ptr(), exact, st),
                  "q3_snake_bf16")
    for u, ((_, _, w7, b1, a2, ib2, w1, b2), d, (src, dst)) in enumerate(zip(
            res, DILATIONS, ((x, out), (out, tmp), (tmp, out)))):
        kernels.check(lib.q3_res_conv7(
            s.data_ptr(), y2.data_ptr(), B, T, C, d, w7.data_ptr(),
            b1.data_ptr(), a2.data_ptr(), ib2.data_ptr(), exact, st),
            "q3_res_conv7")
        nxt = res[u + 1] if u + 1 < len(res) else None
        kernels.check(lib.q3_res_conv1(
            y2.data_ptr(), src.data_ptr(), dst.data_ptr(),
            s.data_ptr() if nxt else None, B, T, C, w1.data_ptr(),
            b2.data_ptr(), nxt[0].data_ptr() if nxt else None,
            nxt[1].data_ptr() if nxt else None, exact, st), "q3_res_conv1")
    fused_residual_chain.launches += 1
    return out


fused_residual_chain.launches = 0


def snake_convt_twin(x: torch.Tensor, blk_w, rate: int) -> torch.Tensor:
    """The XLA head: snake -> conv_transpose1d -> [:, K-r:] + bias."""
    from ..models.vocoder import conv_transpose1d, snake
    k = blk_w["conv_t_w"].shape[-1]
    y = conv_transpose1d(snake(x, blk_w["snake_a"], blk_w["snake_b"]),
                         blk_w["conv_t_w"], rate)
    return y[:, k - rate:] + blk_w["conv_t_b"].float()


def fused_snake_convt(x: torch.Tensor, blk_w, rate: int) -> torch.Tensor:
    """Decoder-block head with the causal trim. x: [B, T, C] f32;
    blk_w["conv_t_w"]: [C, C2, 2*rate] (torch ConvTranspose1d order) ->
    [B, T*rate, C2] f32."""
    if not x.is_cuda:
        return snake_convt_twin(x, blk_w, rate)
    if x.ndim != 3:
        raise ValueError(f"x: expected [B, T, C], got {tuple(x.shape)}")
    B, T, C = x.shape
    kernels.require(x, "x", torch.float32)
    C2, K = blk_w["conv_t_w"].shape[1:]
    N = rate * C2
    if K != 2 * rate:
        raise ValueError(f"kernel serves convT kernels of 2*rate taps, got "
                         f"K={K} at rate={rate}")
    if C % HEAD_K_STAGE or not tile_n(N):
        raise ValueError(f"kernel serves C a multiple of {HEAD_K_STAGE} and "
                         f"rate*C2 a multiple of one of {TILES_N}, got C={C}"
                         f", rate*C2={N}")
    w, bias, a, ib = _packed(blk_w, "head")
    kernels.require(w, "w", torch.bfloat16, (2 * C, N))
    kernels.require(bias, "bias", torch.float32, (N,))
    kernels.require(a, "a", torch.float32, (C,))
    kernels.require(ib, "ib", torch.float32, (C,))
    s = _head_scratch(x.device, B, T, C)
    out = torch.empty(B, T, N, dtype=torch.float32, device=x.device)
    kernels.check(kernels.lib().q3_snake_convt(
        x.data_ptr(), s.data_ptr(), out.data_ptr(), B, T, C, N, w.data_ptr(),
        bias.data_ptr(), a.data_ptr(), ib.data_ptr(),
        int(_sin2_impl == "exact"), kernels.stream(x.device)),
        "q3_snake_convt")
    fused_snake_convt.launches += 1
    return out.view(B, T * rate, C2)


fused_snake_convt.launches = 0
