"""The speech stage of Qwen3-Omni-30B-A3B: its talker, a Qwen3-MoE decoder
(every layer the Qwen3 attention with q/k norms, 16 query heads over 2 KV
heads of 128, and a sparse MoE FFN: 128 routed experts of 384, 6 a token,
renormalised top-k, and a 768-wide shared expert behind a sigmoid gate),
which emits the first codebook of a frame; the code predictor (5 x 1024,
the 0.6B's); and Code2Wav at its published widths (the mean of 16 code
embeddings of 1024, 8 pre-transformer layers at 1024 with SwiGLU 3072 and
sliding-window attention over 72 frames, ConvNeXt upsampling at 1024, the
12 Hz decoder's Snake blocks from 1536, a clamp). The text template and
codec prefix, the code predictor and the sampler's scores come from
benchmark/archs/qwen3_tts_12hz.py. The MoE reference layer is
benchmark/reference/moe.py, Code2Wav's benchmark/reference/code2wav.py.

Departures from the published model, which the program makes too and the
reference therefore follows: M-RoPE at equal temporal / height / width
positions (speech from text) is plain NEOX RoPE; the thinker's token
embeddings enter through the talker's text projection (2048 -> 2048 ->
1024), and its multimodal hidden states (``hidden_projection``) do not
enter; the prompt template and codec special ids are Qwen3-TTS's, which
the program's prefill layout uses.

Counts: only active parameters are operations (6 experts of 128, the
shared expert, the router); bytes are the weights of the experts that the
timed input itself routes to (the reference router on that input; at
B = 192 nearly all of them), read once. Code2Wav counts as
benchmark/roofline.py counts the 12 Hz decoder: its matrices and
convolutions (the gather of the code rows none), its weights once but the
code table, the rows gathered, codes in and PCM out.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import model, program
from benchmark import weights as W
from benchmark.archs import qwen3_tts_12hz as base
from benchmark.archs.qwen3_tts_12hz import (  # noqa: F401 (the surface)
    cb0_scores, code_logits, codepred_frame, talker_config, talker_sequence)
from benchmark.reference import moe as ref_moe
from benchmark.reference.code2wav import vocode  # noqa: F401 (the surface)
from benchmark.reference.layers import Prec, rms_norm
from benchmark.roofline import BF16, F32, attn_flops
from benchmark.seeds import sub_seed


# -- shapes -------------------------------------------------------------

@dataclass(frozen=True)
class Code2Wav:
    """The ``code2wav_config`` group's widths."""
    sample_rate: int
    n_codebooks: int
    codebook_size: int
    hidden: int
    intermediate: int
    layers: int
    heads: int
    sliding_window: int
    decoder_dim: int
    upsample_rates: tuple
    upsampling_ratios: tuple
    rms_norm_eps: float
    rope_theta: float

    @property
    def samples_per_frame(self) -> int:
        return math.prod(self.upsampling_ratios + self.upsample_rates)


def code2wav(c: dict) -> Code2Wav:
    if c["num_key_value_heads"] != c["num_attention_heads"]:
        raise ValueError("Code2Wav's attention is read as multi-head")
    return Code2Wav(
        sample_rate=c["sample_rate"], n_codebooks=c["num_quantizers"],
        codebook_size=c["codebook_size"], hidden=c["hidden_size"],
        intermediate=c["intermediate_size"], layers=c["num_hidden_layers"],
        heads=c["num_attention_heads"], sliding_window=c["sliding_window"],
        decoder_dim=c["decoder_dim"],
        upsample_rates=tuple(c["upsample_rates"]),
        upsampling_ratios=tuple(c["upsampling_ratios"]),
        rms_norm_eps=c["rms_norm_eps"], rope_theta=c["rope_theta"])


@dataclass(frozen=True)
class Model(base.Model):
    n_experts: int
    top_k: int
    expert_inter: int
    shared_inter: int
    norm_topk_prob: bool


def load(raw: dict) -> Model:
    """The configuration file's dict (benchmark/configs/<name>.json)."""
    t = raw["talker_config"]
    return Model(
        name=raw["name"], source=raw["source"],
        talker=model.Stack(layers=t["num_hidden_layers"],
                           hidden=t["hidden_size"], intermediate=0,
                           heads=t["num_attention_heads"],
                           kv_heads=t["num_key_value_heads"],
                           head_dim=t["head_dim"]),
        code_pred=model.stack(raw["code_predictor_config"]),
        codec_vocab=t["vocab_size"], n_codebooks=t["num_code_groups"],
        cp_vocab=raw["code_predictor_config"]["vocab_size"],
        text_vocab=t["text_vocab_size"], text_dim=t["text_hidden_size"],
        rms_norm_eps=t["rms_norm_eps"], rope_theta=t["rope_theta"],
        vocoder=code2wav(raw["code2wav_config"]),
        special=dict(raw["special_tokens"]),
        random=dict(raw["random_weights"]),
        n_experts=t["num_experts"], top_k=t["num_experts_per_tok"],
        expert_inter=t["moe_intermediate_size"],
        shared_inter=t["shared_expert_intermediate_size"],
        norm_topk_prob=bool(t["norm_topk_prob"]))


# -- weights ------------------------------------------------------------

def talker_spec(m: Model) -> W.Spec:
    """The 12 Hz arch's talker + code predictor leaves with the talker's
    dense FFN replaced by the MoE leaves (the program's layout,
    models/weights.moe_layers)."""
    spec = base.talker_spec(m)
    spec.leaves = [l for l in spec.leaves
                   if l.path not in (("layers", "w_gu"), ("layers", "w_down"))]
    r, bf = m.random, torch.bfloat16
    std, L, H = r["matrix_std"], m.talker.layers, m.talker.hidden
    E, Ie, Is = m.n_experts, m.expert_inter, m.shared_inter
    for name, shape, s in (
            ("w_router", (L, H, E), r["router_std"]),
            ("w_gu_e", (L, E, H, 2 * Ie), std),
            ("w_down_e", (L, E, Ie, H), std),
            ("w_gu_s", (L, H, 2 * Is), std),
            ("w_down_s", (L, Is, H), std),
            ("w_sgate", (L, H), std)):
        spec.add(("layers", name), shape, bf, "normal", s)
    return spec


def code2wav_spec(m: Model, matrix_dtype: torch.dtype) -> W.Spec:
    """Code2Wav's leaves (the program's layout, models/weights.
    init_code2wav_weights) at weights.vocoder_spec's scales: matrices and
    convolutions normal(0, 1/sqrt(fan_in)) in `matrix_dtype`, norms 1 +
    normal(0, norm_std), layer scales 0.5; the code table normal(0,
    sqrt(n_codebooks)), so that a frame's mean of n rows has unit
    variance; dec0 and the decoder blocks are vocoder_spec's own leaves."""
    v, f32, md = m.vocoder, torch.float32, matrix_dtype
    nstd, H, I, L = m.random["norm_std"], v.hidden, v.intermediate, v.layers
    spec = W.Spec()

    def mat(path, shape, fan_in):
        spec.add(path, shape, md, "normal", fan_in ** -0.5)

    def vec(path, n, kind="const", arg=0.0):
        spec.add(path, (n,), f32, kind, arg)

    spec.add(("code_embedding",), (v.n_codebooks * v.codebook_size, H), md,
             "normal", math.sqrt(v.n_codebooks))
    vec(("pre_tfm", "norm"), H, "one_plus_normal", nstd)
    lp = ("pre_tfm", "layers")
    for k, shape, fan_in in (("wq", (L, H, H), H), ("wk", (L, H, H), H),
                             ("wv", (L, H, H), H), ("wo", (L, H, H), H),
                             ("w_gate", (L, H, I), H), ("w_up", (L, H, I), H),
                             ("w_down", (L, I, H), I)):
        mat(lp + (k,), shape, fan_in)
    for k, kind, arg in (("attn_norm", "one_plus_normal", nstd),
                         ("ffn_norm", "one_plus_normal", nstd),
                         ("attn_scale", "const", 0.5),
                         ("ffn_scale", "const", 0.5)):
        spec.add(lp + (k,), (L, H), f32, kind, arg)
    for i in range(len(v.upsampling_ratios)):
        u = ("upsample", i)
        mat(u + ("conv_t_w",), (H, H, 2), H)
        vec(u + ("conv_t_b",), H)
        mat(u + ("dw_w",), (H, 1, 7), 7)
        vec(u + ("dw_b",), H)
        vec(u + ("ln_w",), H, "one_plus_normal", nstd)
        vec(u + ("ln_b",), H)
        mat(u + ("pw1_w",), (H, 4 * H), H)
        vec(u + ("pw1_b",), 4 * H)
        mat(u + ("pw2_w",), (4 * H, H), 4 * H)
        vec(u + ("pw2_b",), H)
        vec(u + ("gamma",), H, "const", 0.5)
    tail = model.Vocoder(
        sample_rate=v.sample_rate, n_codebooks=v.n_codebooks,
        codebook_size=v.codebook_size, codebook_dim=1, latent_dim=H,
        hidden=H, layers=0, heads=v.heads, decoder_dim=v.decoder_dim,
        upsample_rates=v.upsample_rates, rms_norm_eps=v.rms_norm_eps,
        rope_theta=v.rope_theta)
    for leaf in W.vocoder_spec(dataclasses.replace(m, vocoder=tail),
                               md).leaves:
        if leaf.path[0] in ("dec0_w", "dec0_b", "dec_blocks", "dec5_a",
                            "dec5_b", "dec6_w", "dec6_b"):
            spec.leaves.append(leaf)
    return spec


def make_weights(m: Model, seed: int, device, vocoder_dtype=None
                 ) -> W.Weights:
    """The weights of configuration `m` for `seed` on `device` (as the
    12 Hz arch makes them, with this talker's leaves and Code2Wav's)."""
    device = torch.device(device)
    if vocoder_dtype is None:
        vocoder_dtype = (torch.bfloat16 if device.type == "cuda"
                         else torch.float32)

    def gen(k):
        return torch.Generator(device=device).manual_seed(sub_seed(seed, k))

    with torch.no_grad():
        talker = W.as_lists(talker_spec(m).materialize(gen("talker"), device))
        talker["codec_head"][:, m.special["codec_eos_id"]] = 0
        talker["code_pred"]["mtp_w"] = talker["code_pred"]["mtp_b"] = None
        voc = W.as_lists(code2wav_spec(m, vocoder_dtype).materialize(
            gen("vocoder"), device))
        voices = torch.randn(int(m.random["voices"]), m.talker.hidden,
                             generator=gen("voices"), device=device)
        voices *= m.random["speaker_std"]
    return W.Weights(talker, voc, voices)


# -- the reference ------------------------------------------------------

def _moe_kw(m: Model) -> dict:
    return dict(n_experts=m.n_experts, top_k=m.top_k,
                norm_topk_prob=m.norm_topk_prob)


def talker_hidden(p: Prec, w, m, seqs: list[torch.Tensor],
                  routes: list | None = None) -> list:
    """The talker's normed hidden state at every position of each
    sequence (right-padded into one batch: causal attention never reads
    the pad; the pad's rows are routed too, which changes no real row)."""
    T = max(s.shape[0] for s in seqs)
    x = torch.stack([torch.nn.functional.pad(s, (0, 0, 0, T - s.shape[0]))
                     for s in seqs])
    t = m.talker
    y = ref_moe.moe_stack(p, w["layers"], x, heads=t.heads,
                          kv_heads=t.kv_heads, head_dim=t.head_dim,
                          eps=m.rms_norm_eps, theta=m.rope_theta,
                          routes=routes, **_moe_kw(m))
    h = rms_norm(y, w["output_norm"], m.rms_norm_eps)
    return [h[i, :s.shape[0]] for i, s in enumerate(seqs)]


def step_experts(w, m: Model, x: torch.Tensor, n_past: int) -> list:
    """The experts each layer routes to (sorted ids) in one decode step of
    rows x [B, H] at position n_past over a cache of zeros (what
    ``layer_calls`` times): the float32 reference of that step."""
    lw, t, eps = w["layers"], m.talker, m.rms_norm_eps
    B, D = x.shape[0], t.head_dim
    nq, nk = t.heads * D, t.kv_heads * D
    inv = m.rope_theta ** (-torch.arange(0, D // 2, device=x.device,
                                         dtype=torch.float32) * 2.0 / D)
    cos, sin = torch.cos(n_past * inv), torch.sin(n_past * inv)

    def rope1(a):
        a1, a2 = a[..., :D // 2], a[..., D // 2:]
        return torch.cat([a1 * cos - a2 * sin, a1 * sin + a2 * cos], -1)

    p, x, out = Prec("f32"), x.float(), []
    for l in range(t.layers):
        qkv = p.mm(rms_norm(x, lw["attn_norm"][l], eps), lw["wqkv"][l])
        q = rope1(rms_norm(qkv[:, :nq].reshape(B, t.heads, D),
                           lw["q_norm"][l], eps))
        k = rope1(rms_norm(qkv[:, nq:nq + nk].reshape(B, t.kv_heads, D),
                           lw["k_norm"][l], eps))
        v = qkv[:, nq + nk:].reshape(B, t.kv_heads, D)
        g = t.heads // t.kv_heads
        s = (q * k.repeat_interleave(g, 1)).sum(-1) / math.sqrt(D)
        # n_past zero keys score 0 and carry zero values
        share = torch.exp(s) / (torch.exp(s) + n_past)
        a = (share[..., None] * v.repeat_interleave(g, 1)).reshape(B, nq)
        x = x + p.mm(a, lw["wo"][l])
        h = rms_norm(x, lw["ffn_norm"][l], eps)
        routes: list = []
        x = x + ref_moe.moe_block(p, lw, l, h, routes=routes, **_moe_kw(m))
        out.append(routes[0].unique())
    return out


# -- counts -------------------------------------------------------------

def _expert_params(m: Model) -> int:
    return 3 * m.talker.hidden * m.expert_inter


def _ffn_fixed_params(m: Model) -> int:
    """The shared expert, its gate and the router: read for every row."""
    H = m.talker.hidden
    return 3 * H * m.shared_inter + H + H * m.n_experts


def _attn_params(s) -> int:
    H, D = s.hidden, s.head_dim
    return H * (s.heads + 2 * s.kv_heads) * D + s.heads * D * H


def _expected_experts(m: Model, B: int) -> float:
    """Distinct experts B rows touch when routing is uniform."""
    return m.n_experts * (1 - (1 - m.top_k / m.n_experts) ** B)


def moe_layer(m: Model, B: int, n_experts_read: float
              ) -> tuple[float, float]:
    """One layer's MoE FFN over B rows (router, top-k experts a row, the
    gated shared expert) whose routing reads n_experts_read experts:
    (operations of the active parameters, bytes: those experts' weights,
    the shared expert, router and gate once, rows in and out in f32)."""
    H = m.talker.hidden
    flops = 2 * B * (m.top_k * _expert_params(m) + _ffn_fixed_params(m))
    nbytes = (BF16 * (n_experts_read * _expert_params(m) + _ffn_fixed_params(m))
              + 2 * B * F32 * H)
    return float(flops), float(nbytes)


def talker_step(m: Model, B: int, n_past: int,
                experts: list | None = None) -> tuple[float, float]:
    """One decode step of B streams at n_past cached positions: every
    layer (attention, the MoE FFN of the active parameters), the output
    norm and the codec head. `experts`: distinct experts each layer read
    (None: the count uniform routing expects)."""
    t = m.talker
    if experts is None:
        experts = [_expected_experts(m, B)] * t.layers
    moe_f, moe_b = zip(*(moe_layer(m, B, n) for n in experts))
    flops = (sum(moe_f) + B * (2 * t.layers * _attn_params(t)
                               + t.layers * attn_flops(t, n_past + 1)
                               + 2 * t.hidden * m.codec_vocab))
    weights = (sum(moe_b) - t.layers * 2 * B * F32 * t.hidden
               + BF16 * (t.layers * _attn_params(t) + t.hidden * m.codec_vocab)
               + F32 * (t.layers * (2 * t.hidden + 2 * t.head_dim) + t.hidden))
    row = t.layers * 2 * t.kv_heads * t.head_dim * BF16
    io = B * F32 * (t.hidden + t.hidden + m.codec_vocab)
    return flops, weights + B * row * (n_past + 1) + io


def prefill_flops(m: Model, n_tokens: int, P: int) -> float:
    """A request's prefill: the text projection of its n_tokens ids and the
    talker over its P prefill rows (active parameters), the codec head
    once."""
    t = m.talker
    proj = 2 * (n_tokens + 3) * (m.text_dim * m.text_dim
                                 + m.text_dim * t.hidden)
    per_row = 2 * (_attn_params(t) + m.top_k * _expert_params(m)
                   + _ffn_fixed_params(m))
    layers = t.layers * (per_row * P
                         + sum(attn_flops(t, k) for k in range(1, P + 1)))
    return float(proj + layers + 2 * t.hidden * m.codec_vocab)


def code2wav_flops_per_stream(m: Model, frames: int) -> float:
    """Operations of decoding `frames` frames of one stream alone."""
    v, T = m.vocoder, frames
    H, c = v.hidden, v.decoder_dim
    keys = sum(min(t + 1, v.sliding_window) for t in range(T))
    f = v.layers * (2 * T * (4 * H * H + 3 * H * v.intermediate)
                    + 4 * H * keys)                           # layers
    t = T
    for r in v.upsampling_ratios:                             # ConvNeXt
        f += 2 * t * H * H * r
        t *= r
        f += 2 * t * H * 7 + 2 * t * H * 4 * H * 2
    f += 2 * t * 7 * H * c                                    # dec0
    for r in v.upsample_rates:
        c2 = c // 2
        f += 2 * t * c * c2 * 2 * r                           # convT
        t *= r
        f += 3 * 2 * t * 8 * c2 * c2                          # 3 residual units
        c = c2
    f += 2 * t * 7 * c                                        # final conv
    return float(f)


def vocoder_chunk(m: Model, n: int, frames: int = 40) -> tuple[float, float]:
    """One decode of n streams' `frames`-frame chunks into int16 PCM:
    Code2Wav's weights once but the code table, the table rows the codes
    gather, codes in and PCM out."""
    v = m.vocoder
    spec = code2wav_spec(m, torch.bfloat16)
    weights = sum(math.prod(l.shape) * l.dtype.itemsize for l in spec.leaves
                  if l.path[0] != "code_embedding")
    rows = min(n * frames * v.n_codebooks, v.n_codebooks * v.codebook_size)
    nbytes = (weights + BF16 * rows * v.hidden
              + n * frames * (4 * v.n_codebooks + 2 * v.samples_per_frame))
    return n * code2wav_flops_per_stream(m, frames), float(nbytes)


def frame_flops(m: Model, n_past: int) -> float:
    """Model operations of one delivered frame of one stream (active
    parameters only): the step, the code predictor and Code2Wav's share
    of its chunk."""
    return (talker_step(m, 1, n_past)[0] + codepred_frame(m, 1)[0]
            + code2wav_flops_per_stream(m, 40) / 40)


# -- the program --------------------------------------------------------

def moe_config(m: Model):
    from qwen3_tts_tpu_torch.config import MoEConfig
    return MoEConfig(n_experts=m.n_experts, top_k=m.top_k,
                     expert_intermediate=m.expert_inter,
                     shared_intermediate=m.shared_inter,
                     norm_topk_prob=m.norm_topk_prob)


def vocoder_config(v: Code2Wav):
    """The program's VocoderConfig of Code2Wav: every width the hidden
    one, the rest as the 12 Hz decoder's fields read them."""
    from qwen3_tts_tpu_torch.config import VocoderConfig
    cfg = VocoderConfig(
        sample_rate=v.sample_rate, n_codebooks=v.n_codebooks,
        codebook_size=v.codebook_size, codebook_dim=v.hidden,
        latent_dim=v.hidden, hidden_dim=v.hidden, n_pre_tfm_layers=v.layers,
        n_heads=v.heads, decoder_dim=v.decoder_dim,
        upsample_rates=tuple(v.upsample_rates), rms_norm_eps=v.rms_norm_eps,
        rope_theta=v.rope_theta)
    if cfg.samples_per_frame != v.samples_per_frame:
        raise ValueError("the program upsamples 4x before the decoder "
                         f"blocks, Code2Wav {v.upsampling_ratios}")
    return cfg


def make_engine(m: Model, weights, tokenizer: program.TokenTable, device):
    """The engine, its vocoder tree holding the "code2wav" entry that
    makes the program's vocoder Code2Wav (config.Code2WavConfig)."""
    from qwen3_tts_tpu_torch.config import Code2WavConfig
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS
    v = m.vocoder
    voc = {**weights.vocoder, "code2wav": Code2WavConfig(
        sliding_window=v.sliding_window, intermediate_size=v.intermediate)}
    return Qwen3TTS.from_components(tokenizer, talker_config(m),
                                    weights.talker, vocoder_config(v), voc,
                                    device, moe=moe_config(m))


def layer_calls(run, engine, B: int):
    """The calls the rooflines time (benchmark/timing.py) at batch B, as
    the 12 Hz arch's: ``talker.talker_step`` over a bf16 cache of the
    lock-step size at the mix's median position (its bytes from the
    experts its input routes to, by ``step_experts``), the code predictor
    for one frame, the engine's decode of one 40-frame chunk (Code2Wav's
    counts); and ``moe``: layer 0's MoE FFN alone over B rows of a normed
    hidden state (ops/moe.moe_ffn), its bytes from the experts those rows
    route to."""
    from qwen3_tts_tpu_torch.models import code_predictor, talker
    from qwen3_tts_tpu_torch.models.stack import init_kv_cache, layer_weights
    from qwen3_tts_tpu_torch.ops.moe import moe_ffn
    from qwen3_tts_tpu_torch.runtime.generate import ctx_bucket, required_ctx
    m, dev, mix = run.cell.model, run.device, run.cell.mix
    cap, P, t = mix["frame_cap"], m.prefill_len, m.talker
    cfg, w = engine.talker_cfg, engine.talker_w
    n_past = P + cap // 2
    gen = torch.Generator(device=dev).manual_seed(run.seed % (1 << 62))
    hidden = torch.randn(B, t.hidden, generator=gen, device=dev)
    steps = step_experts(w, m, hidden, n_past)
    ctx = required_ctx(P, cap, 40)
    kv = init_kv_cache(t.layers, B, ctx, t.kv_heads, t.head_dim, dev)
    pos = torch.full((B,), n_past, dtype=torch.int32, device=dev)
    rc = ctx_bucket(n_past, 40, ctx)
    slot = pos.max()                # the lock-step write slot, on the card
    yield ("talker", lambda: talker.talker_step(
        w, cfg, hidden, kv, pos, slot, read_ctx=rc), 20, True,
        talker_step(m, B, n_past, [len(e) for e in steps]))
    del kv
    cb0 = torch.randint(0, m.cp_vocab, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    yield ("codepred", lambda: code_predictor.predict_codes(
        w, cfg, hidden, cb0, mix["temperature"], mix["top_k"],
        top_p=mix["top_p"]), 20, True, codepred_frame(m, B))
    codes = np.random.default_rng(run.seed % (1 << 32)).integers(
        0, m.vocoder.codebook_size, (B, 40, m.n_codebooks), dtype=np.int32)
    yield ("vocoder", lambda: engine._decode_chunk_batch(codes, pcm16=True),
           5, False, vocoder_chunk(m, B))
    lw = layer_weights(w["layers"], 0)
    h = torch.randn(B, t.hidden, generator=gen, device=dev)
    e = ref_moe.route(Prec("f32"), h, lw["w_router"], m.top_k,
                      m.norm_topk_prob)[0]
    cfg_moe = w["layers"]["moe"]
    yield ("moe", lambda: moe_ffn(h, lw, cfg_moe), 50, True,
           moe_layer(m, B, len(e.unique())))
