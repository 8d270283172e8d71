"""The plain reference's shared layers, which every architecture's
reference (benchmark/archs/) is built from: full forward passes in float32
with plain torch operations, no cache, no batching tricks, no kernel. It
imports nothing of the program; it reads the weights that the benchmark
made (benchmark/weights.py), in the same layouts.

``Prec`` picks the arithmetic of every matrix product and convolution:
"f32" (the reference; TF32 is switched off by ``no_tf32``) or "fp8", the
control: both operands rounded to float8 e4m3 with one scale per row (per
output channel for weights) before an f32 product, the precision step
below the configuration's bf16. Norms, softmax and activations stay f32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG = float("-inf")


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (the card's default may be TF32)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Prec:
    """The arithmetic of products: "f32" or "fp8" (module docstring)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor, dims) -> torch.Tensor:
        """x rounded as the mode says, one scale per slice over `dims`."""
        x = x.float()
        if self.mode == "f32":
            return x
        amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., in] @ w [in, out] in f32."""
        return self.q(x, -1) @ self.q(w, 0)

    def conv1d(self, x, w, b=None, dilation=1, groups=1, left_pad=None):
        """Causal conv over x [B, C, T] (left zero padding)."""
        if left_pad is None:
            left_pad = dilation * (w.shape[-1] - 1)
        x = F.pad(self.q(x, 1), (left_pad, 0))
        y = F.conv1d(x, self.q(w, (1, 2)), dilation=dilation, groups=groups)
        return y if b is None else y + b.float()[None, :, None]

    def conv_t1d(self, x, w, stride):
        """ConvTranspose1d over x [B, C_in, T], w [C_in, C_out, K]."""
        return F.conv_transpose1d(self.q(x, 1), self.q(w, (0, 2)),
                                  stride=stride)


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, theta):
    """NEOX rotary embedding over x [B, T, heads, D] at positions 0..T-1."""
    T, D = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, D // 2, device=x.device,
                                  dtype=torch.float32) * 2.0 / D)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: Prec, q, k, v):
    """Causal attention. q [B, T, Hq, D], k/v [B, T, Hkv, D] (GQA)."""
    B, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = p.q(q, -1), p.q(k, -1), p.q(v, -1)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, NEG).softmax(-1)
    return torch.einsum("bhts,bshd->bthd", p.q(s, -1), v).reshape(B, T, -1)


def decoder_stack(p: Prec, lw: dict, x, *, heads, kv_heads, head_dim, eps,
                  theta):
    """Qwen2-style layers with per-head q/k RMSNorm: x [B, T, H] -> the
    last layer's output [B, T, H] (before the output norm)."""
    B, T, _ = x.shape
    nq, nk = heads * head_dim, kv_heads * head_dim
    x = x.float()
    for l in range(lw["attn_norm"].shape[0]):
        h = rms_norm(x, lw["attn_norm"][l], eps)
        qkv = p.mm(h, lw["wqkv"][l])
        q = qkv[..., :nq].reshape(B, T, heads, head_dim)
        k = qkv[..., nq:nq + nk].reshape(B, T, kv_heads, head_dim)
        v = qkv[..., nq + nk:].reshape(B, T, kv_heads, head_dim)
        q = rope(rms_norm(q, lw["q_norm"][l], eps), theta)
        k = rope(rms_norm(k, lw["k_norm"][l], eps), theta)
        x = x + p.mm(attention(p, q, k, v), lw["wo"][l])
        h = rms_norm(x, lw["ffn_norm"][l], eps)
        gate, up = p.mm(h, lw["w_gu"][l]).chunk(2, dim=-1)
        x = x + p.mm(F.silu(gate) * up, lw["w_down"][l])
    return x
