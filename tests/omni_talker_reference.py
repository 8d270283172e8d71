"""Plain reference of Qwen3-Omni's MoE talker (transformers'
``modeling_qwen3_omni_moe.py``: ``Qwen3OmniMoeTalkerDecoderLayer`` with
the Qwen3 attention and ``Qwen3OmniMoeTalkerTextSparseMoeBlock``): the
full forward pass over a sequence of input rows, in float32 plain torch,
with no cache, no batching tricks and no kernel. It imports nothing of the
port, of JAX or of the benchmark; it reads a weights dict in the port's
layouts (models/weights.moe_layers: linear weights [in, out], stacked over
layers; the routed experts [L, E, H, 2 Ie] / [L, E, Ie, H]).

Per layer: x += o_proj(attn(RoPE(q_norm(q)), RoPE(k_norm(k)), v)) of
RMSNorm(x); x += moe(RMSNorm(x)), where moe(h) = sum over the top-k
experts e of softmax(h W_router) of w_e down_e(silu(gate_e h) * up_e h),
the weights renormalised over the k when ``norm_topk_prob``, plus
sigmoid(h . w_sgate) shared(h). The routed experts are computed one expert
at a time over the tokens routed to it, by indexing.

Departures from the published model, each also made by the port:
- M-RoPE with equal temporal / height / width positions, what the talker
  sees for speech from text, is plain NEOX RoPE over the whole head;
- inputs are given as embedding rows; the thinker's multimodal hidden
  states (``hidden_projection``) do not enter;
- the published model runs in bf16 throughout. The reference is float32
  with the bf16 weights as they are (TF32 off), and the top-k weights are
  rounded to bf16 as the block casts them to the hidden dtype. With
  ``program_rounding`` it also rounds to bf16 where the port's numerics
  say it does (every product's activation input, q, k and v before
  attention, the attention probabilities before P.V), so that a test can
  hold the port to summation order alone.

``code2wav`` is the plain reference of Omni's Code2Wav
(``Qwen3OmniMoeCode2Wav``: the mean code embedding, the sliding-window
pre-transformer with layer scales, two ConvNeXt 2x upsamples with the
exact GELU, the Snake decoder blocks, the clamp), in float32 over the
port's Code2Wav layout (models/weights.init_code2wav_weights). Its one
departure, also the port's: trim="causal" cuts each decoder block's
transposed convolution on the left only (T * rate samples out), as the
port's streaming decode does; trim="both" is the published cut.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _r(x: torch.Tensor, on: bool) -> torch.Tensor:
    """x rounded to bf16 (when `on`), as f32."""
    return x.to(torch.bfloat16).float() if on else x.float()


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta):
    """NEOX rotary embedding over x [B, T, heads, D] at positions [T]."""
    D = x.shape[-1]
    inv = theta ** (-torch.arange(0, D // 2, device=x.device,
                                  dtype=torch.float32) * 2.0 / D)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def route(h, w_router, top_k: int, norm_topk_prob: bool, rnd: bool = False):
    """(experts [N, k], weights [N, k]) of rows h [N, H]: f32 softmax of the
    router logits, top-k, renormalised when asked, cast to bf16."""
    p = torch.softmax(_r(h, rnd) @ w_router.float(), dim=-1)
    w, e = torch.topk(p, top_k, dim=-1)
    if norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return e, w.to(torch.bfloat16).float()


def swiglu(h, w_gu, w_down, rnd: bool = False):
    g, u = (_r(h, rnd) @ w_gu.float()).chunk(2, dim=-1)
    return _r(F.silu(g) * u, rnd) @ w_down.float()


def moe_block(h, lw: dict, l: int, moe: dict, rnd: bool = False):
    """The sparse MoE block of layer l over rows h [N, H] -> [N, H].
    moe: n_experts, top_k, norm_topk_prob."""
    e, w = route(h, lw["w_router"][l], moe["top_k"], moe["norm_topk_prob"],
                 rnd)
    y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for ex in range(moe["n_experts"]):
        t, j = (e == ex).nonzero(as_tuple=True)
        if len(t):
            o = swiglu(h[t], lw["w_gu_e"][l][ex], lw["w_down_e"][l][ex], rnd)
            y.index_add_(0, t, w[t, j, None] * o)
    gate = torch.sigmoid(_r(h, rnd) @ lw["w_sgate"][l].float())
    return y + gate[:, None] * swiglu(h, lw["w_gu_s"][l], lw["w_down_s"][l],
                                      rnd)


def attention(q, k, v, rnd: bool = False):
    """Causal GQA. q [B, T, Hq, D], k / v [B, T, Hkv, D] -> [B, T, Hq D]."""
    B, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    k = _r(k, rnd).repeat_interleave(rep, dim=2)
    v = _r(v, rnd).repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", _r(q, rnd), k) / D ** 0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = s.masked_fill(~causal, float("-inf")).softmax(-1)
    return torch.einsum("bhts,bshd->bthd", _r(p, rnd), v).reshape(B, T, -1)


def talker_forward(w: dict, x, *, heads: int, kv_heads: int, head_dim: int,
                   eps: float, theta: float, moe: dict,
                   program_rounding: bool = False, routes: list | None = None):
    """The talker over input rows x [B, T, H] (positions 0..T-1): returns
    (normed hidden [B, T, H], codec logits [B, T, V]). `routes`, when a
    list, gains each layer's experts [B * T, k]."""
    lw, rnd = w["layers"], program_rounding
    B, T, H = x.shape
    nq, nk = heads * head_dim, kv_heads * head_dim
    pos = torch.arange(T, device=x.device)
    x = x.float()
    with no_tf32():
        for l in range(lw["attn_norm"].shape[0]):
            h = rms_norm(x, lw["attn_norm"][l], eps)
            qkv = _r(h, rnd) @ lw["wqkv"][l].float()
            q = qkv[..., :nq].reshape(B, T, heads, head_dim)
            k = qkv[..., nq:nq + nk].reshape(B, T, kv_heads, head_dim)
            v = qkv[..., nq + nk:].reshape(B, T, kv_heads, head_dim)
            q = rope(rms_norm(q, lw["q_norm"][l], eps), pos, theta)
            k = rope(rms_norm(k, lw["k_norm"][l], eps), pos, theta)
            x = x + _r(attention(q, k, v, rnd), rnd) @ lw["wo"][l].float()
            h = rms_norm(x, lw["ffn_norm"][l], eps).reshape(B * T, H)
            if routes is not None:
                routes.append(route(h, lw["w_router"][l], moe["top_k"],
                                    moe["norm_topk_prob"], rnd)[0])
            x = x + moe_block(h, lw, l, moe, rnd).reshape(B, T, H)
        hn = rms_norm(x, w["output_norm"], eps)
        return hn, _r(hn, rnd) @ w["codec_head"].float()


def _snake(x, a, b):
    """SnakeBeta over x [B, C, T]: x + exp(-b) sin^2(exp(a) x)."""
    return x + torch.exp(-b.float())[:, None] * torch.sin(
        torch.exp(a.float())[:, None] * x) ** 2


def _causal_conv(x, w, b, dilation: int = 1, groups: int = 1):
    """Conv1d with (K - 1) * dilation zeros on the left, x [B, C, T]."""
    pad = (w.shape[-1] - 1) * dilation
    return F.conv1d(F.pad(x, (pad, 0)), w.float(), b.float(),
                    dilation=dilation, groups=groups)


def code2wav(w: dict, codes, *, heads: int, eps: float, theta: float,
             window: int | None, rates, trim: str = "both",
             gelu: str = "none"):
    """Code2Wav over codes [B, T, n] -> audio [B, samples] in [-1, 1]
    (module docstring). `window`: the keys a query sees, itself included
    (None: all earlier ones); `gelu`: the ConvNeXt GELU's approximation."""
    codes = codes.long()
    n = codes.shape[-1]
    table = w["code_embedding"].float()
    offset = (table.shape[0] // n) * torch.arange(n, device=codes.device)
    x = table[codes + offset].mean(dim=-2)
    B, T, H = x.shape
    D = H // heads
    lw = w["pre_tfm"]["layers"]
    pos = torch.arange(T, device=x.device)
    seen = pos[:, None] >= pos[None, :]
    if window is not None:
        seen &= pos[:, None] - pos[None, :] < window
    with no_tf32():
        for l in range(lw["wq"].shape[0]):
            h = rms_norm(x, lw["attn_norm"][l], eps)
            q, k, v = (h @ lw[n_][l].float() for n_ in ("wq", "wk", "wv"))
            q = rope(q.reshape(B, T, heads, D), pos, theta)
            k = rope(k.reshape(B, T, heads, D), pos, theta)
            s = torch.einsum("bthd,bshd->bhts", q, k) / D ** 0.5
            p = s.masked_fill(~seen, float("-inf")).softmax(-1)
            a = torch.einsum("bhts,bshd->bthd", p, v.reshape(B, T, heads, D))
            x = x + (a.reshape(B, T, H) @ lw["wo"][l].float()) * lw[
                "attn_scale"][l].float()
            h = rms_norm(x, lw["ffn_norm"][l], eps)
            g = (F.silu(h @ lw["w_gate"][l].float())
                 * (h @ lw["w_up"][l].float()))
            x = x + (g @ lw["w_down"][l].float()) * lw["ffn_scale"][l].float()
        x = rms_norm(x, w["pre_tfm"]["norm"], eps).transpose(1, 2)
        for u in w["upsample"]:
            x = F.conv_transpose1d(x, u["conv_t_w"].float(),
                                   u["conv_t_b"].float(), stride=2)
            y = _causal_conv(x, u["dw_w"], u["dw_b"], groups=H).transpose(1, 2)
            y = F.layer_norm(y, (H,), u["ln_w"].float(), u["ln_b"].float(),
                             1e-6)
            y = F.gelu(y @ u["pw1_w"].float() + u["pw1_b"].float(),
                       approximate=gelu)
            y = y @ u["pw2_w"].float() + u["pw2_b"].float()
            x = x + (y * u["gamma"].float()).transpose(1, 2)
        x = _causal_conv(x, w["dec0_w"], w["dec0_b"])
        for d, r in zip(w["dec_blocks"], rates):
            x = F.conv_transpose1d(_snake(x, d["snake_a"], d["snake_b"]),
                                   d["conv_t_w"].float(),
                                   d["conv_t_b"].float(), stride=r)
            cut = d["conv_t_w"].shape[-1] - r
            x = (x[..., cut:x.shape[-1] - cut] if trim == "both"
                 else x[..., cut:])
            for res, dil in zip(d["res"], (1, 3, 9)):
                y = _causal_conv(_snake(x, res["a1"], res["b1"]), res["c1_w"],
                                 res["c1_b"], dilation=dil)
                x = x + _causal_conv(_snake(y, res["a2"], res["b2"]),
                                     res["c2_w"], res["c2_b"])
        x = _causal_conv(_snake(x, w["dec5_a"], w["dec5_b"]), w["dec6_w"],
                         w["dec6_b"])
    return x[:, 0].clamp(-1.0, 1.0)
