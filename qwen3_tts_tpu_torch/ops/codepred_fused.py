"""Code predictor for one frame on the card: one persistent cooperative
CUDA kernel (csrc/codepred.cu) that runs every position, layer, head and
sampler of the frame, and its plain torch twin.

Replaces the Pallas megakernel qwen3_tts_tpu/ops/codepred_fused.py::
predict_codes_fused. Semantics, shared by the kernels and the twin:

- 16 uniform single-token positions: position 0 is the talker hidden,
  position 1 codec_embd[cb0], position p >= 2 code_pred.embd[p-2][code of
  p-1] (a row gather). The XLA path's 2-token prefill is the same math.
- Behind an mtp projection (the 1.7B shape: a 2048-wide talker before the
  1024-wide code predictor) every position's input is projected,
  ``dot(x, mtp_w) + mtp_b``. The projection is linear and every row after
  position 0 is one of a fixed table's, so ``fold_mtp`` projects both
  tables once, at engine set-up, into f32 rows; a frame projects only
  position 0's hidden and gathers the folded rows (``input_rows``).
- Per layer: RMSNorm -> bf16 -> fused QKV (f32) -> q/k head RMSNorm ->
  NEOX RoPE -> K/V rows into a 16-slot bf16 cache -> attention with f32
  probabilities -> bf16 -> wo -> residual; RMSNorm -> bf16 -> [gate|up]
  -> bf16(silu(g)*u) -> down -> residual.
- Position p >= 1: output RMSNorm -> bf16 -> heads[p-1] -> sampling:
  greedy (or temperature <= 0) takes the first argmax; otherwise
  z = logits * (1 / temperature), keep z >= its k-th largest (ties kept),
  first argmax of z + gumbel[p-1].

Against the XLA-path port (models/code_predictor.py) the twin differs by
design: it keeps attention probabilities in f32 where the XLA path rounds
them to bf16, and samples by Gumbel-argmax, so argmax can flip at bf16
near-ties (tests/test_codepred_fused.py says the same of the TPU kernel).

The TPU kernel's batch split and its GQA head permutation exist for VMEM
and ``pltpu.repeat`` and are not carried over; its weight-tile ring
becomes a ring of TMA tiles in shared memory, each weight tile multiplied
against every stream row of the batch (csrc/codepred.cu).

``predict_codes_fused.launches`` counts frames launched on the card, one
cooperative kernel launch each (``kernels.codepred_launches()`` reads the
count the C side keeps). The scratch (16-slot K/V cache, partial sums,
RoPE tables) is allocated once per (device, batch) and reused; a frame
allocates only the codes it returns.
"""

from __future__ import annotations

import torch

from .. import kernels
from .layers import dot, rope_freqs
from .sampling import apply_top_k, gumbel_noise

CTX = 16                               # positions per frame
# dims the kernels are written for (the 0.6B code predictor)
H, NH, NKV, D, I, V, L = 1024, 16, 8, 128, 3072, 2048, 5
# the partial sums' floats a stream: the most any of the kernel's five
# products writes (K / span splits of N columns; csrc/codepred.cu's
# static_assert on PART_COLS holds the two equal)
PART_COLS = 16 * 1024

_SCRATCH: dict = {}                    # (device, B, theta) -> scratch
# what fold_mtp adds to the code_pred tree: codec_embd and code_pred.embd
# projected through the mtp projection, f32
FOLDED = ("codec_embd_mtp", "embd_mtp")


def rope_tables(theta: float, head_dim: int, device):
    """[CTX, D] rows c = [cos|cos], s = [-sin|sin]: NEOX RoPE at position p
    is x * c[p] + roll(x, D/2) * s[p]."""
    ang = (torch.arange(CTX, dtype=torch.float32, device=device)[:, None]
           * rope_freqs(head_dim, theta, device)[None, :])
    c = torch.cat([torch.cos(ang), torch.cos(ang)], dim=1)
    s = torch.cat([-torch.sin(ang), torch.sin(ang)], dim=1)
    return c.contiguous(), s.contiguous()


def _noise(gumbel, generator, B, vocab, device):
    if gumbel is None:
        gumbel = gumbel_noise((CTX - 1, B, vocab), generator, device)
    return gumbel


def project_mtp(cp, x: torch.Tensor) -> torch.Tensor:
    """Talker space -> code-predictor space, ``dot(x, mtp_w) + mtp_b`` in
    f32 (the 1.7B shape); x as it is where the tree has no mtp_w."""
    if cp.get("mtp_w") is None:
        return x
    y = dot(x, cp["mtp_w"])
    if cp.get("mtp_b") is not None:
        y = y + cp["mtp_b"]
    return y


def kernel_dims(cfg) -> bool:
    """Whether the code predictor has the dims the kernel is written for
    (H, heads, D, I, V, L and 16 positions: the 0.6B's, the 1.7B's,
    Omni's)."""
    return (cfg.code_pred_hidden_size, cfg.code_pred_n_attention_heads,
            cfg.code_pred_n_kv_heads, cfg.code_pred_head_dim,
            cfg.code_pred_intermediate_size, cfg.code_pred_vocab_size,
            cfg.code_pred_layers, cfg.n_codebooks) == (H, NH, NKV, D, I, V,
                                                       L, CTX)


def fold_mtp(w, cfg):
    """The talker tree `w` with, behind an mtp projection, the FOLDED
    tables added to its code_pred: codec_embd_mtp [n_codec, H] and
    embd_mtp [15, V, H], f32, each row ``project_mtp`` of its raw row,
    computed as the XLA path computes it for a gathered row (bf16 operand,
    f32 sums, plus the bias). The raw tables stay: frame_step_embedding
    reads them. A tree without an mtp_w, or whose code predictor the
    kernel cannot serve (``kernel_dims``), comes back as it is. Once per
    weight set, when an engine on a card is made (``Qwen3TTS``), never
    inside a CUDA-graph capture (a captured fold would replay every
    frame)."""
    cp = w["code_pred"]
    if cp.get("mtp_w") is None or not kernel_dims(cfg):
        return w
    embd = torch.stack([project_mtp(cp, e) for e in cp["embd"]])
    codec = project_mtp(cp, w["codec_embd"])
    return {**w, "code_pred": {**cp, **dict(zip(FOLDED, (codec, embd)))}}


def drop_folded(cp):
    """The code_pred tree `cp` without the FOLDED tables: for a code
    predictor that never runs the kernel (a tp-split one)."""
    return {k: v for k, v in cp.items() if k not in FOLDED}


def input_rows(w):
    """(codec rows, code rows): the tables that position 1 and positions
    2.. gather from. codec_embd and code_pred.embd, or behind an mtp
    projection their FOLDED tables (None where the tree lacks them)."""
    cp = w["code_pred"]
    if cp.get("mtp_w") is None:
        return w["codec_embd"], cp["embd"]
    return tuple(cp.get(k) for k in FOLDED)


def supported(cfg, B: int, w) -> bool:
    """The kernel's preconditions: ``kernel_dims``, bf16 weights and
    heads, B >= 1, and the rows it gathers: the bf16 embeddings, or behind
    an mtp projection its FOLDED f32 tables (an mtp tree without them is
    refused). The TPU kernel's conditions on B (a multiple of 8, halves
    that fit in VMEM) are not carried over: the CUDA kernel serves any
    B >= 1."""
    cp = w["code_pred"]
    lw = cp["layers"]
    bf16 = [lw[n] for n in ("wqkv", "wo", "w_gu", "w_down")] + [cp["heads"]]
    rows = torch.bfloat16 if cp.get("mtp_w") is None else torch.float32
    return (kernel_dims(cfg) and B >= 1
            and all(t.dtype == torch.bfloat16 for t in bf16)
            and all(t is not None and t.dtype == rows
                    for t in input_rows(w)))


def predict_codes_twin(w, cfg, hidden: torch.Tensor, cb0: torch.Tensor,
                       temperature: float, top_k: int,
                       generator: torch.Generator | None = None,
                       greedy: bool = False,
                       gumbel: torch.Tensor | None = None,
                       logits_out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernels' semantics (module docstring).
    Returns codes [B, 15] int32; logits_out [15, B, V], when given,
    receives each sampled position's logits."""
    cp = w["code_pred"]
    lw = cp["layers"]
    eps = cfg.rms_norm_eps
    n_layers = lw["wqkv"].shape[0]
    nh, nkv, d = (cfg.code_pred_n_attention_heads, cfg.code_pred_n_kv_heads,
                  cfg.code_pred_head_dim)
    nq, nk = nh * d, nkv * d
    B, dev = hidden.shape[0], hidden.device
    codec_rows, rows = input_rows(w)
    if rows is None:
        raise ValueError("an mtp projection without its folded rows: "
                         "fold_mtp(w, cfg) first")
    greedy = greedy or temperature <= 0.0
    if not greedy:
        gumbel = _noise(gumbel, generator, B, cp["heads"].shape[-1], dev)
    rope_c, rope_s = rope_tables(cfg.rope_theta, d, dev)

    def rms(x, wr):
        ms = (x * x).mean(-1, keepdim=True)
        return (x * torch.rsqrt(ms + eps)) * wr.float()

    def mm(a, wt):
        return a.to(torch.bfloat16).float() @ wt.float()

    def rope(x3, p):
        return x3 * rope_c[p] + torch.roll(x3, d // 2, dims=-1) * rope_s[p]

    kc = torch.zeros(n_layers, CTX, B, nkv, d, device=dev)
    vc = torch.zeros_like(kc)
    codes = []
    code = None
    for p in range(CTX):
        if p == 0:
            x = project_mtp(cp, hidden.float())
        elif p == 1:
            x = codec_rows[cb0.long()].float()
        else:
            x = rows[p - 2][code.long()].float()
        for l in range(n_layers):
            qkv = mm(rms(x, lw["attn_norm"][l]), lw["wqkv"][l])
            q = rope(rms(qkv[:, :nq].reshape(B, nh, d), lw["q_norm"][l]), p)
            k = rope(rms(qkv[:, nq:nq + nk].reshape(B, nkv, d),
                         lw["k_norm"][l]), p)
            kc[l, p] = k.to(torch.bfloat16).float()
            vc[l, p] = qkv[:, nq + nk:].reshape(B, nkv, d).to(
                torch.bfloat16).float()
            krep = kc[l, :p + 1].repeat_interleave(nh // nkv, dim=2)
            vrep = vc[l, :p + 1].repeat_interleave(nh // nkv, dim=2)
            sc = torch.einsum("bhd,sbhd->bhs", q * (d ** -0.5), krep)
            probs = torch.softmax(sc, dim=-1)
            attn = torch.einsum("bhs,sbhd->bhd", probs, vrep)
            x = x + mm(attn.reshape(B, nq), lw["wo"][l])
            gate, up = mm(rms(x, lw["ffn_norm"][l]), lw["w_gu"][l]).chunk(2, -1)
            x = x + mm(torch.nn.functional.silu(gate) * up, lw["w_down"][l])
        if p == 0:
            continue
        logits = mm(rms(x, cp["output_norm"]), cp["heads"][p - 1])
        if logits_out is not None:
            logits_out[p - 1] = logits
        if greedy:
            code = torch.argmax(logits, dim=-1)
        else:
            z = apply_top_k(logits * (1.0 / max(temperature, 1e-6)), top_k)
            code = torch.argmax(z + gumbel[p - 1], dim=-1)
        codes.append(code.to(torch.int32))
    return torch.stack(codes, dim=1)


def predict_codes_fused(w, cfg, hidden: torch.Tensor, cb0: torch.Tensor,
                        temperature: float, top_k: int,
                        generator: torch.Generator | None = None,
                        greedy: bool = False,
                        gumbel: torch.Tensor | None = None,
                        logits_out: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Codes [B, 15] int32 for one frame. hidden: [B, H] f32 (the talker's
    width: behind an mtp projection it is projected here); cb0: [B];
    gumbel: optional [15, B, V] noise; logits_out: optional [15, B, V] f32
    that receives each sampled position's logits.
    A CPU tensor runs the twin; a CUDA tensor launches the kernel or
    raises (where ``supported`` does not hold)."""
    if not hidden.is_cuda:
        return predict_codes_twin(w, cfg, hidden, cb0, temperature, top_k,
                                  generator, greedy=greedy, gumbel=gumbel,
                                  logits_out=logits_out)
    cp = w["code_pred"]
    lw = cp["layers"]
    dev = hidden.device
    B = hidden.shape[0]
    if not supported(cfg, B, w):
        raise ValueError(f"the code-predictor kernel serves H={H} heads="
                         f"{NH}/{NKV} D={D} I={I} V={V} L={L}, bf16 weights, "
                         f"an mtp projection only with its folded f32 rows "
                         f"(fold_mtp) and B >= 1; got H="
                         f"{cfg.code_pred_hidden_size}, L={cfg.code_pred_layers}"
                         f", mtp {cp.get('mtp_w') is not None}, folded rows "
                         f"{all(k in cp for k in FOLDED)}, B={B}")
    bf, f32 = torch.bfloat16, torch.float32
    req = kernels.require
    x0 = project_mtp(cp, hidden)
    req(x0, "hidden", f32, (B, H))
    for name, shape in (("wqkv", (L, H, (NH + 2 * NKV) * D)),
                        ("wo", (L, NH * D, H)), ("w_gu", (L, H, 2 * I)),
                        ("w_down", (L, I, H))):
        req(lw[name], name, bf, shape)
    for name in ("attn_norm", "ffn_norm"):
        req(lw[name], name, f32, (L, H))
    for name in ("q_norm", "k_norm"):
        req(lw[name], name, f32, (L, D))
    req(cp["output_norm"], "output_norm", f32, (H,))
    req(cp["heads"], "heads", bf, (CTX - 1, H, V))
    codec_rows, rows = input_rows(w)
    req(rows, "embd rows", rows.dtype, (CTX - 1, V, H))
    req(codec_rows, "codec_embd rows", rows.dtype)
    if codec_rows.dim() != 2 or codec_rows.shape[1] != H:
        raise ValueError(f"codec_embd rows: expected [n, {H}], got "
                         f"{tuple(codec_rows.shape)}")
    sample_greedy = greedy or temperature <= 0.0
    noise = None
    if not sample_greedy:
        noise = _noise(gumbel, generator, B, V, dev)
        req(noise, "gumbel", f32, (CTX - 1, B, V))

    if logits_out is not None:
        req(logits_out, "logits_out", f32, (CTX - 1, B, V))
    cb0_i = cb0.to(torch.int32).contiguous()
    sc = _scratch(dev, B, float(cfg.rope_theta))
    codes = torch.empty(B, CTX - 1, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernels.check(kernels.lib().q3_codepred_frame(
        x0.data_ptr(), cb0_i.data_ptr(), codec_rows.data_ptr(),
        *(lw[n].data_ptr() for n in ("wqkv", "wo", "w_gu", "w_down",
                                     "attn_norm", "ffn_norm", "q_norm",
                                     "k_norm")),
        cp["output_norm"].data_ptr(), cp["heads"].data_ptr(),
        rows.data_ptr(), ptr(noise), sc["rope_c"].data_ptr(),
        sc["rope_s"].data_ptr(), ptr(logits_out), codes.data_ptr(),
        *(sc[n].data_ptr() for n in ("x", "xn", "attn", "act", "part", "kc",
                                     "vc")),
        ptr(predict_codes_fused.phase_ns), codec_rows.shape[0], B,
        int(top_k), int(sample_greedy), int(rows.dtype == f32),
        float(cfg.rms_norm_eps),
        1.0 / max(temperature, 1e-6), kernels.stream(dev)),
        "q3_codepred_frame")
    predict_codes_fused.launches += 1
    return codes


def _scratch(dev, B: int, theta: float) -> dict:
    """The kernel's scratch for batch B, allocated once per (device, B)
    and reused by every later frame (frames on one stream run in order,
    and the kernel writes every entry before it reads it): the residual
    stream and the products' bf16 inputs, the split-K partial sums
    (PART_COLS a stream) with the grid barrier's state, the 16-slot
    K/V cache [L, B, NKV, CTX, D], and the RoPE tables."""
    key = (dev, B, theta)
    if key not in _SCRATCH:
        bf, f32 = torch.bfloat16, torch.float32

        def new(*shape, dtype=f32):
            return torch.empty(shape, dtype=dtype, device=dev)

        rope_c, rope_s = rope_tables(theta, D, dev)
        _SCRATCH[key] = dict(
            x=new(B, H), xn=new(B, H, dtype=bf), attn=new(B, NH * D, dtype=bf),
            act=new(B, I, dtype=bf),
            # the partial sums, then the kernel's grid-barrier word (zero
            # before the first frame; every barrier leaves it as it was,
            # up to its top bit)
            part=torch.zeros(PART_COLS * B + 4, dtype=f32, device=dev),
            kc=new(L, B, NKV, CTX, D, dtype=bf),
            vc=new(L, B, NKV, CTX, D, dtype=bf), rope_c=rope_c, rope_s=rope_s)
    return _SCRATCH[key]


predict_codes_fused.launches = 0
# a device int64 [9] tensor, when set: the kernel adds the ns of each phase
# kind to it (PHASES order)
predict_codes_fused.phase_ns = None
PHASES = ("norm", "qkv", "attention", "wo", "gate/up", "act", "down", "head",
          "sample")
