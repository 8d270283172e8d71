"""The plain reference of Qwen3-TTS-12Hz: the talker, the code predictor
and the 12 Hz tokenizer's decoder (the vocoder), as full forward passes in
float32 with plain torch operations: no cache, no batching tricks, no
kernel. It imports nothing of the program; it reads the weights that the
benchmark made (benchmark/weights.py), in the same layouts.

``Prec`` picks the arithmetic of every matrix product and convolution:
"f32" (the reference; TF32 is switched off by ``no_tf32``) or "fp8", the
control: both operands rounded to float8 e4m3 with one scale per row (per
output channel for weights) before an f32 product, the precision step
below the configuration's bf16. Norms, softmax and activations stay f32.

Departures from the published description that the program makes too,
and that the reference therefore follows: the text template's first three
tokens and the codec prefix are laid out as runtime/talker.py documents
(think prefix, language id, speaker row, pad, bos; tts_pad over the codec
rows, tts_bos over the last of them); Snake's sin^2 is the exact sine (the
program's default polynomial differs by rounding only); each 40-frame
chunk is decoded alone with its tail zero-padded and a causal trim, as the
program's streaming decode does.
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


# -- the talker ----------------------------------------------------------

def project_text(p: Prec, w, ids: torch.Tensor) -> torch.Tensor:
    """text embedding -> fc1 -> SiLU -> fc2, ids [...] -> [..., H]."""
    t = w["text_proj"]
    x = p.mm(w["text_embd"][ids.long()].float(), t["fc1_w"]) + t["fc1_b"]
    return p.mm(F.silu(x), t["fc2_w"]) + t["fc2_b"]


def talker_inputs(p: Prec, w, m, tokens: list[int], speaker: torch.Tensor):
    """(prefill rows [P, H], trailing rows [L - 8, H], tts_pad [H]) of one
    request whose templated ids are `tokens` (3 template ids, the text, 5
    template ids): the text's first token rides on the last prefill row,
    the rest (and then tts_eos) arrive one a frame after it."""
    s, dev = m.special, speaker.device
    ids = torch.tensor(tokens, device=dev)
    proj = project_text(p, w, ids)
    tts_bos, tts_eos, tts_pad = project_text(p, w, torch.tensor(
        [s["tts_bos_token_id"], s["tts_eos_token_id"],
         s["tts_pad_token_id"]], device=dev))
    cemb = w["codec_embd"]
    prefix = cemb[torch.tensor([s["codec_think_id"], s["codec_think_bos_id"],
                                s["english_language_id"],
                                s["codec_think_eos_id"]], device=dev)].float()
    tail = cemb[torch.tensor([s["codec_pad_id"], s["codec_bos_id"]],
                             device=dev)].float()
    codec = torch.cat([prefix, speaker.float()[None], tail])      # 7 rows
    over = tts_pad.expand(codec.shape[0] - 1, -1).clone()
    over[-1] = tts_bos
    prefill = torch.cat([proj[:3], codec[:-1] + over,
                         (proj[3] + codec[-1])[None]])
    trailing = torch.cat([proj[4:len(tokens) - 5], tts_eos[None]])
    return prefill, trailing, tts_pad


def step_embedding(w, codes: torch.Tensor) -> torch.Tensor:
    """The talker's next input for frames codes [F, 16] (without the text
    row): codec_embd[cb0] + sum over codebooks j >= 1 of the code
    predictor's embedding j - 1 of code j."""
    cp = w["code_pred"]
    x = w["codec_embd"][codes[:, 0].long()].float()
    for j in range(1, codes.shape[1]):
        x = x + cp["embd"][j - 1][codes[:, j].long()].float()
    return x


def talker_sequence(p: Prec, w, m, tokens, speaker, codes):
    """The talker's whole input for a request that served codes [F, 16]:
    the prefill, then one row a frame for frames 0..F-2 (the last frame's
    row is never read). Returns ([P + F - 1, H], P)."""
    prefill, trailing, pad = talker_inputs(p, w, m, tokens, speaker)
    n = codes.shape[0] - 1
    rows = step_embedding(w, codes[:n])
    text = torch.cat([trailing, pad.expand(max(n - len(trailing), 0), -1)])
    return torch.cat([prefill, rows + text[:n]]), prefill.shape[0]


def talker_hidden(p: Prec, w, m, seqs: list[torch.Tensor]) -> list:
    """The talker's normed hidden state at every position of each
    sequence (right-padded into one batch: causal attention never reads
    the pad)."""
    T = max(s.shape[0] for s in seqs)
    x = torch.stack([F.pad(s, (0, 0, 0, T - s.shape[0])) for s in seqs])
    t = m.talker
    y = decoder_stack(p, w["layers"], x, heads=t.heads, kv_heads=t.kv_heads,
                      head_dim=t.head_dim, eps=m.rms_norm_eps,
                      theta=m.rope_theta)
    h = rms_norm(y, w["output_norm"], m.rms_norm_eps)
    return [h[i, :s.shape[0]] for i, s in enumerate(seqs)]


def cb0_scores(m, logits, codes, n_tokens: int, penalty: float):
    """The first codebook's scores at frames 0..F-1 (logits [F, V]) as the
    model's sampler sees them: ids from V - 1024 up suppressed but EOS, the
    repetition penalty on the codes served before, the EOS ramp after
    max(20, 4 * n_tokens) frames."""
    Fn, V = logits.shape
    eos = m.special["codec_eos_id"]
    ids = torch.arange(V, device=logits.device)
    x = logits.masked_fill(((ids >= V - 1024) & (ids != eos))[None], NEG)
    seen = torch.zeros(Fn, V, dtype=torch.bool, device=logits.device)
    prev = codes[:-1, 0].long()
    if len(prev):
        seen[torch.arange(1, Fn, device=logits.device), prev] = True
        seen = seen.int().cumsum(0).bool()
    x = torch.where(seen, torch.where(x > 0, x / penalty, x * penalty), x)
    expected = max(20, 4 * n_tokens)
    f = torch.arange(Fn, device=logits.device, dtype=torch.float32)
    ramp = ((f - expected) / expected).clamp(0, 1)
    target = x.amax(-1) + 5.0
    x[:, eos] = x[:, eos] + ramp * (target - x[:, eos])
    return x


# -- the code predictor --------------------------------------------------

def code_logits(p: Prec, w, m, hidden, codes) -> torch.Tensor:
    """Logits of codebooks 1..15 for frames with talker hidden states
    hidden [F, H] and codes [F, 16]: the 5-layer stack over [hidden,
    codec_embd[cb0], embd_0[c1], ..., embd_13[c14]] (each through the
    small_to_mtp projection where the model has one). -> [F, 15, V]."""
    cp, c = w["code_pred"], m.code_pred
    xs = [hidden.float(), w["codec_embd"][codes[:, 0].long()].float()]
    xs += [cp["embd"][j][codes[:, j + 1].long()].float()
           for j in range(m.n_codebooks - 2)]
    x = torch.stack(xs, dim=1)                                 # [F, 16, H]
    if cp.get("mtp_w") is not None:
        x = p.mm(x, cp["mtp_w"]) + cp["mtp_b"]
    y = decoder_stack(p, cp["layers"], x, heads=c.heads, kv_heads=c.kv_heads,
                      head_dim=c.head_dim, eps=m.rms_norm_eps,
                      theta=m.rope_theta)
    h = rms_norm(y[:, 1:], cp["output_norm"], m.rms_norm_eps)  # [F, 15, Hc]
    return torch.stack([p.mm(h[:, j], cp["heads"][j])
                        for j in range(h.shape[1])], dim=1)


# -- the vocoder ---------------------------------------------------------

def _snake(x, a, b):
    """x + exp(-b) sin^2(exp(a) x) per channel, x [B, C, T]."""
    a = torch.exp(a.float())[None, :, None]
    return x + torch.exp(-b.float())[None, :, None] * torch.sin(a * x) ** 2


def _pre_transformer(p: Prec, t, v, x):
    """x [B, T, latent] -> [B, T, latent]: input projection, layers of
    causal attention and SwiGLU with layer scales, norm, output
    projection."""
    B, T, _ = x.shape
    x = p.mm(x, t["in_w"]) + t["in_b"]
    lw = t["layers"]
    for l in range(lw["wq"].shape[0]):
        h = rms_norm(x, lw["attn_norm"][l], v.rms_norm_eps)
        q, k, vv = (p.mm(h, lw[n][l]) for n in ("wq", "wk", "wv"))
        d = q.shape[-1] // v.heads
        q = rope(q.reshape(B, T, v.heads, d), v.rope_theta)
        k = rope(k.reshape(B, T, v.heads, d), v.rope_theta)
        vv = vv.reshape(B, T, v.heads, d)
        x = x + p.mm(attention(p, q, k, vv), lw["wo"][l]) * lw["attn_scale"][l]
        h = rms_norm(x, lw["ffn_norm"][l], v.rms_norm_eps)
        act = F.silu(p.mm(h, lw["w_gate"][l])) * p.mm(h, lw["w_up"][l])
        x = x + p.mm(act, lw["w_down"][l]) * lw["ffn_scale"][l]
    x = rms_norm(x, t["norm"], v.rms_norm_eps)
    return p.mm(x, t["out_w"]) + t["out_b"]


def _upsample(p: Prec, u, x):
    """ConvNeXt 2x upsample over x [B, C, T]: convT (stride 2, K 2), then
    a residual of causal depthwise conv k7, LayerNorm, pointwise MLP with
    tanh GELU and the layer scale gamma."""
    x = p.conv_t1d(x, u["conv_t_w"], 2) + u["conv_t_b"].float()[None, :, None]
    c = x.shape[1]
    y = p.conv1d(x, u["dw_w"], u["dw_b"], groups=c).transpose(1, 2)
    y = F.layer_norm(y, (c,), u["ln_w"].float(), u["ln_b"].float(), 1e-6)
    y = F.gelu(p.mm(y, u["pw1_w"]) + u["pw1_b"], approximate="tanh")
    y = p.mm(y, u["pw2_w"]) + u["pw2_b"]
    return x + (y * u["gamma"].float()).transpose(1, 2)


def _decoder_block(p: Prec, d, x, rate):
    """Snake, convT (stride `rate`, K 2*rate, the first K - rate samples
    cut: T*rate out), bias, then residual units of dilation 1, 3, 9:
    x + conv1(snake(conv7_dilated(snake(x))))."""
    k = d["conv_t_w"].shape[-1]
    x = p.conv_t1d(_snake(x, d["snake_a"], d["snake_b"]), d["conv_t_w"], rate)
    x = x[:, :, k - rate:] + d["conv_t_b"].float()[None, :, None]
    for r, dil in zip(d["res"], (1, 3, 9)):
        y = p.conv1d(_snake(x, r["a1"], r["b1"]), r["c1_w"], r["c1_b"],
                     dilation=dil)
        x = x + p.conv1d(_snake(y, r["a2"], r["b2"]), r["c2_w"], r["c2_b"])
    return x


def vocode(p: Prec, w, v, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, 16] -> audio [B, T * samples_per_frame] in [-1, 1]."""
    c = codes.long()
    x = p.mm(w["vq_first_codebook"][c[..., 0]].float(), w["vq_first_out_proj"])
    rest = sum(w["vq_rest_codebooks"][j][c[..., j + 1]].float()
               for j in range(c.shape[-1] - 1))
    x = x + p.mm(rest, w["vq_rest_out_proj"])                   # [B, T, 512]
    x = p.conv1d(x.transpose(1, 2), w["pre_conv_w"], w["pre_conv_b"])
    x = _pre_transformer(p, w["pre_tfm"], v, x.transpose(1, 2))
    x = x.transpose(1, 2)
    for u in w["upsample"]:
        x = _upsample(p, u, x)
    x = p.conv1d(x, w["dec0_w"], w["dec0_b"])
    for d, rate in zip(w["dec_blocks"], v.upsample_rates):
        x = _decoder_block(p, d, x, rate)
    x = p.conv1d(_snake(x, w["dec5_a"], w["dec5_b"]), w["dec6_w"],
                 w["dec6_b"])
    return torch.tanh(x[:, 0])
