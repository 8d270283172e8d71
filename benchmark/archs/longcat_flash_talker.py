"""LongCat-Flash-Omni's backbone block as the talker of the port's speech
pipeline: LongCat-Flash double layers (``LongcatFlashDecoderLayer``: two
latent-attention sublayers, two dense SwiGLUs of 12,288 and a shortcut MoE
that starts after the first attention and joins at the end), at the
published widths (hidden 6,144; 64 heads, q_lora 1,536, kv_lora 512, 128
nope + 64 rope, values 128; a router of 512 real and 256 identity experts,
top-12, weights p x 6; experts of 2,048; no shared expert), one chip's
share of a wide expert-parallel decode pool (its 16 of the 512 experts,
one pipeline stage of 4 double layers). Around it the port's own speech
interface: the codec embedding and head, the 0.6B's code predictor behind
a 6144 -> 1024 mtp projection, the 12 Hz decoder, text through the port's
text table and projection (configuration file, ``assumed``). The
template, the code predictor, the sampler's scores and the vocoder come
from benchmark/archs/qwen3_tts_12hz.py; the block's reference is
benchmark/reference/longcat_moe.py on reference/mla.py.

Counts: operations are the active parameters of this chip's work (every
matrix of attention, the dense FFNs and the router; the held experts'
pairs, under uniform routing top_k x held / (real + identity) a token;
identity experts add no product), decode attention absorbed (scores over
576-wide rows, values 512 wide, a query's and an output's products the
kv_b parameters); bytes the weights once (the held experts that the timed
input routes to, at B = 192 nearly all 16), the latent cache's valid
rows (576 values a position a sublayer) and the rows in and out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import model, program
from benchmark import weights as W
from benchmark.archs import qwen3_tts_12hz as base
from benchmark.archs.qwen3_tts_12hz import (  # noqa: F401 (the surface)
    cb0_scores, code_logits, codepred_frame, talker_sequence)
from benchmark.reference import longcat_moe as ref_moe
from benchmark.reference.layers import Prec, rms_norm
from benchmark.reference.mla import rope_interleave
from benchmark.reference.vocoder import vocode  # noqa: F401 (the surface)
from benchmark.roofline import (BF16, F32, vocoder_chunk,
                                vocoder_flops_per_stream)
from benchmark.seeds import sub_seed


# -- shapes -------------------------------------------------------------

@dataclass(frozen=True)
class Model(base.Model):
    q_lora: int
    kv_lora: int
    nope: int
    rope: int
    v_dim: int
    n_experts: int          # real experts of the router (the published 512)
    n_zero: int             # identity experts
    top_k: int
    expert_inter: int
    held: int               # experts held on this chip
    expert_offset: int
    scaling: float

    @property
    def router_width(self) -> int:
        return self.n_experts + self.n_zero

    @property
    def latent_width(self) -> int:
        return self.kv_lora + self.rope


def load(raw: dict) -> Model:
    """The configuration file's dict (benchmark/configs/<name>.json)."""
    si, dep = raw["speech_interface"], raw["deployment"]
    heads = raw["num_attention_heads"]
    nope, rope = raw["qk_nope_head_dim"], raw["qk_rope_head_dim"]
    held0, held1 = dep["held_experts"]
    if held1 - held0 != raw["n_routed_experts"]:
        raise ValueError("held_experts disagrees with n_routed_experts")
    return Model(
        name=raw["name"], source=raw["source"],
        talker=model.Stack(layers=raw["num_layers"], hidden=raw["hidden_size"],
                           intermediate=raw["ffn_hidden_size"], heads=heads,
                           kv_heads=heads, head_dim=nope + rope),
        code_pred=model.stack(raw["code_predictor_config"]),
        codec_vocab=si["vocab_size"], n_codebooks=si["num_code_groups"],
        cp_vocab=raw["code_predictor_config"]["vocab_size"],
        text_vocab=si["text_vocab_size"], text_dim=si["text_hidden_size"],
        rms_norm_eps=raw["rms_norm_eps"], rope_theta=raw["rope_theta"],
        vocoder=model.vocoder(raw["vocoder_config"]),
        special=dict(raw["special_tokens"]),
        random=dict(raw["random_weights"]),
        q_lora=raw["q_lora_rank"], kv_lora=raw["kv_lora_rank"], nope=nope,
        rope=rope, v_dim=raw["v_head_dim"],
        n_experts=raw["published"]["n_routed_experts"],
        n_zero=raw["zero_expert_num"], top_k=raw["moe_topk"],
        expert_inter=raw["expert_ffn_hidden_size"],
        held=raw["n_routed_experts"], expert_offset=held0,
        scaling=float(raw["routed_scaling_factor"]))


# -- weights ------------------------------------------------------------

def talker_spec(m: Model) -> W.Spec:
    """The 12 Hz arch's talker + code predictor leaves with the talker's
    stack replaced by the double layers' (the program's layout,
    models/weights.mla_layers)."""
    spec = base.talker_spec(m)
    spec.leaves = [l for l in spec.leaves if l.path[0] != "layers"]
    r, bf, f32 = m.random, torch.bfloat16, torch.float32
    std, nstd = r["matrix_std"], r["norm_std"]
    t = m.talker
    L, H, n, I = t.layers, t.hidden, t.heads, t.intermediate
    for name, shape, dtype, kind, arg in (
            ("attn_norm", (L, 2, H), f32, "one_plus_normal", nstd),
            ("ffn_norm", (L, 2, H), f32, "one_plus_normal", nstd),
            ("wq_a", (L, 2, H, m.q_lora), bf, "normal", std),
            ("q_a_norm", (L, 2, m.q_lora), f32, "one_plus_normal", nstd),
            ("wq_b", (L, 2, m.q_lora, n * (m.nope + m.rope)), bf, "normal",
             std),
            ("wkv_a", (L, 2, H, m.latent_width), bf, "normal", std),
            ("kv_a_norm", (L, 2, m.kv_lora), f32, "one_plus_normal", nstd),
            ("wkv_b", (L, 2, m.kv_lora, n * (m.nope + m.v_dim)), bf,
             "normal", std),
            ("wo", (L, 2, n * m.v_dim, H), bf, "normal", std),
            ("w_gu", (L, 2, H, 2 * I), bf, "normal", std),
            ("w_down", (L, 2, I, H), bf, "normal", std),
            ("w_router", (L, H, m.router_width), bf, "normal",
             r["router_std"]),
            ("e_bias", (L, m.router_width), f32, "normal", r["e_bias_std"]),
            ("w_gu_e", (L, m.held, H, 2 * m.expert_inter), bf, "normal",
             std),
            ("w_down_e", (L, m.held, m.expert_inter, H), bf, "normal",
             std)):
        spec.add(("layers", name), shape, dtype, kind, arg)
    return spec


def make_weights(m: Model, seed: int, device, vocoder_dtype=None
                 ) -> W.Weights:
    """The weights of configuration `m` for `seed` on `device` (as the
    12 Hz arch makes them, with this talker's leaves)."""
    device = torch.device(device)
    if vocoder_dtype is None:
        vocoder_dtype = (torch.bfloat16 if device.type == "cuda"
                         else torch.float32)

    def gen(k):
        return torch.Generator(device=device).manual_seed(sub_seed(seed, k))

    with torch.no_grad():
        talker = W.as_lists(talker_spec(m).materialize(gen("talker"), device))
        talker["codec_head"][:, m.special["codec_eos_id"]] = 0
        voc = W.as_lists(W.vocoder_spec(m, vocoder_dtype).materialize(
            gen("vocoder"), device))
        voices = torch.randn(int(m.random["voices"]), m.talker.hidden,
                             generator=gen("voices"), device=device)
        voices *= m.random["speaker_std"]
    return W.Weights(talker, voc, voices)


# -- the reference ------------------------------------------------------

def _mla_kw(m: Model) -> dict:
    return dict(heads=m.talker.heads, q_lora=m.q_lora, kv_lora=m.kv_lora,
                nope=m.nope, rope=m.rope, v_dim=m.v_dim, theta=m.rope_theta)


def _moe_kw(m: Model) -> dict:
    return dict(n_experts=m.n_experts, top_k=m.top_k, scaling=m.scaling,
                expert_offset=m.expert_offset)


def talker_hidden(p: Prec, w, m, seqs: list[torch.Tensor],
                  routes: list | None = None) -> list:
    """The talker's normed hidden state at every position of each
    sequence (right-padded into one batch: causal attention never reads
    the pad; the pad's rows are routed too, which changes no real row)."""
    T = max(s.shape[0] for s in seqs)
    x = torch.stack([torch.nn.functional.pad(s, (0, 0, 0, T - s.shape[0]))
                     for s in seqs])
    y = ref_moe.longcat_stack(p, w["layers"], x, eps=m.rms_norm_eps,
                              mla_kw=_mla_kw(m), moe_kw=_moe_kw(m),
                              routes=routes)
    h = rms_norm(y, w["output_norm"], m.rms_norm_eps)
    return [h[i, :s.shape[0]] for i, s in enumerate(seqs)]


def step_experts(w, m: Model, x: torch.Tensor, n_past: int) -> list:
    """(distinct held experts read, held pairs) of each double layer's MoE
    in one decode step of rows x [B, H] at position n_past over a latent
    cache of zeros (what ``layer_calls`` times): the float32 reference of
    that step (a zero row scores 0 and carries a zero value)."""
    lw, eps, t = w["layers"], m.rms_norm_eps, m.talker
    B, n, H = x.shape[0], t.heads, t.hidden
    pos = torch.full((1,), n_past, device=x.device)
    p, x, out = Prec("f32"), x.float(), []
    for l in range(t.layers):
        for s in (0, 1):
            h = rms_norm(x, lw["attn_norm"][l][s], eps)[:, None]
            qa = rms_norm(p.mm(h, lw["wq_a"][l][s]), lw["q_a_norm"][l][s],
                          1e-6)
            q = p.mm(qa, lw["wq_b"][l][s]).reshape(B, 1, n, m.nope + m.rope)
            q = q * (H / m.q_lora) ** 0.5
            kv = p.mm(h, lw["wkv_a"][l][s])
            c = rms_norm(kv[..., :m.kv_lora], lw["kv_a_norm"][l][s], 1e-6)
            kvb = p.mm(c * (H / m.kv_lora) ** 0.5, lw["wkv_b"][l][s])
            kvb = kvb.reshape(B, 1, n, m.nope + m.v_dim)
            k_rot = rope_interleave(kv[..., None, m.kv_lora:], m.rope_theta,
                                    pos)
            q_rot = rope_interleave(q[..., m.nope:], m.rope_theta, pos)
            sc = ((q[..., :m.nope] * kvb[..., :m.nope]).sum(-1)
                  + (q_rot * k_rot).sum(-1)) * (m.nope + m.rope) ** -0.5
            share = torch.exp(sc) / (torch.exp(sc) + n_past)
            o = (share[..., None] * kvb[..., m.nope:]).reshape(B, -1)
            x = x + p.mm(o, lw["wo"][l][s])
            h = rms_norm(x, lw["ffn_norm"][l][s], eps)
            if s == 0:
                routes: list = []
                moe = ref_moe.moe_block(p, lw, l, h, routes=routes,
                                        **_moe_kw(m))
                e = routes[0] - m.expert_offset
                e = e[(e >= 0) & (e < m.held)]
                out.append((len(e.unique()), len(e)))
            g, u = p.mm(h, lw["w_gu"][l][s]).chunk(2, -1)
            x = x + p.mm(torch.nn.functional.silu(g) * u, lw["w_down"][l][s])
        x = x + moe
    return out


# -- counts -------------------------------------------------------------

def _mla_params(m: Model) -> int:
    """Matrix elements of one latent-attention sublayer (q_a, q_b, kv_a,
    kv_b, o_proj)."""
    H, n = m.talker.hidden, m.talker.heads
    return (H * m.q_lora + m.q_lora * n * (m.nope + m.rope)
            + H * m.latent_width + m.kv_lora * n * (m.nope + m.v_dim)
            + n * m.v_dim * H)


def _dense_params(m: Model) -> int:
    return 3 * m.talker.hidden * m.talker.intermediate


def _expert_params(m: Model) -> int:
    return 3 * m.talker.hidden * m.expert_inter


def _pairs_per_token(m: Model) -> float:
    """Held experts a token's top_k reaches under uniform routing."""
    return m.top_k * m.held / m.router_width


def _expected_read(m: Model, B: int) -> float:
    """Distinct held experts B rows touch under uniform routing."""
    return m.held * (1 - (1 - m.top_k / m.router_width) ** B)


def _attn_flops(m: Model, n_keys: int) -> int:
    """One query's absorbed decode attention over n_keys rows, one
    sublayer: scores over the 576-wide rows, the 512-wide values."""
    return 2 * m.talker.heads * (m.latent_width + m.kv_lora) * n_keys


def moe_layer(m: Model, B: int, n_read: float, pairs: float
              ) -> tuple[float, float]:
    """One double layer's MoE over B rows whose routing reads n_read held
    experts over `pairs` held pairs: (operations of the router and those
    pairs, bytes: those experts' weights, the router and its bias once,
    rows in and out in f32)."""
    H, Et = m.talker.hidden, m.router_width
    flops = 2 * (pairs * _expert_params(m) + B * H * Et)
    nbytes = (BF16 * (n_read * _expert_params(m) + H * Et) + F32 * Et
              + 2 * B * F32 * H)
    return float(flops), float(nbytes)


def mla_call(m: Model, B: int, n_keys: int) -> tuple[float, float]:
    """One sublayer's decode attention (ops/mla.mla_decode) of B streams
    over n_keys valid rows each: (operations, bytes of the rows read once,
    the latent queries in and the latent outputs out, bf16)."""
    n, Wd = m.talker.heads, m.latent_width
    nbytes = BF16 * B * (n_keys * Wd + n * Wd + n * m.kv_lora)
    return float(B * _attn_flops(m, n_keys)), float(nbytes)


def talker_step(m: Model, B: int, n_past: int,
                experts: list | None = None) -> tuple[float, float]:
    """One decode step of B streams at n_past cached positions: every
    double layer (two sublayers of attention and dense FFN, the MoE),
    the output norm and the codec head. `experts`: each double layer's
    (held experts read, held pairs) (None: uniform routing's)."""
    t = m.talker
    L, H = t.layers, t.hidden
    if experts is None:
        experts = [(_expected_read(m, B), B * _pairs_per_token(m))] * L
    moe_f, moe_b = zip(*(moe_layer(m, B, n, pr) for n, pr in experts))
    flops = (sum(moe_f) + B * (2 * 2 * L * (_mla_params(m) + _dense_params(m))
                               + 2 * L * _attn_flops(m, n_past + 1)
                               + 2 * H * m.codec_vocab))
    weights = (sum(moe_b) - L * 2 * B * F32 * H
               + BF16 * (2 * L * (_mla_params(m) + _dense_params(m))
                         + H * m.codec_vocab)
               + F32 * (2 * L * (2 * H + m.q_lora + m.kv_lora) + H))
    cache = B * (n_past + 1) * 2 * L * m.latent_width * BF16
    io = B * F32 * (H + H + m.codec_vocab)
    return flops, weights + cache + io


def prefill_flops(m: Model, n_tokens: int, P: int) -> float:
    """A request's prefill: the text projection of its n_tokens ids and the
    double layers over its P rows (non-absorbed causal attention), the
    codec head once."""
    t = m.talker
    n = t.heads
    proj = 2 * (n_tokens + 3) * (m.text_dim * m.text_dim
                                 + m.text_dim * t.hidden)
    per_row = 2 * (2 * (_mla_params(m) + _dense_params(m))
                   + t.hidden * m.router_width
                   + _pairs_per_token(m) * _expert_params(m))
    attn = 2 * sum(2 * n * (m.nope + m.rope + m.v_dim) * k
                   for k in range(1, P + 1))
    return float(proj + t.layers * (per_row * P + attn)
                 + 2 * t.hidden * m.codec_vocab)


def frame_flops(m: Model, n_past: int) -> float:
    """Model operations of one delivered frame of one stream (this chip's
    active parameters): the step, the code predictor and the vocoder's
    share of its chunk."""
    return (talker_step(m, 1, n_past)[0] + codepred_frame(m, 1)[0]
            + vocoder_flops_per_stream(m, 40) / 40)


# -- the program --------------------------------------------------------

def mla_config(m: Model):
    from qwen3_tts_tpu_torch.config import MLAConfig
    return MLAConfig(q_lora_rank=m.q_lora, kv_lora_rank=m.kv_lora,
                     qk_nope_head_dim=m.nope, qk_rope_head_dim=m.rope,
                     v_head_dim=m.v_dim)


def moe_config(m: Model):
    from qwen3_tts_tpu_torch.config import MoEConfig
    return MoEConfig(n_experts=m.n_experts, top_k=m.top_k,
                     expert_intermediate=m.expert_inter,
                     shared_intermediate=0, norm_topk_prob=False,
                     n_zero_experts=m.n_zero, routed_scaling=m.scaling,
                     expert_offset=m.expert_offset, n_held=m.held)


def make_engine(m: Model, weights, tokenizer: program.TokenTable, device):
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS
    return Qwen3TTS.from_components(
        tokenizer, base.talker_config(m), weights.talker,
        program.vocoder_config(m.vocoder), weights.vocoder, device,
        moe=moe_config(m), mla=mla_config(m))


def layer_calls(run, engine, B: int):
    """The calls the rooflines time (benchmark/timing.py) at batch B, as
    the 12 Hz arch's: ``talker.talker_step`` over a latent cache of the
    lock-step size at the mix's median position (its bytes from the held
    experts its input routes to, by ``step_experts``), the code predictor
    for one frame, the engine's decode of one 40-frame chunk; ``moe``:
    layer 0's MoE alone over B rows of a normed hidden state
    (ops/moe.moe_ffn), its bytes from the held experts those rows route
    to; ``mla``: one sublayer's decode attention (ops/mla.mla_decode)
    over a bf16 latent cache of random rows, every stream at the median
    position."""
    from qwen3_tts_tpu_torch.models import code_predictor, talker
    from qwen3_tts_tpu_torch.models.stack import init_kv_cache, layer_weights
    from qwen3_tts_tpu_torch.ops.mla import mla_decode
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
    kv = init_kv_cache(t.layers, B, ctx, 1, 1, dev, latent=m.latent_width)
    pos = torch.full((B,), n_past, dtype=torch.int32, device=dev)
    rc = ctx_bucket(n_past, 40, ctx)
    slot = pos.max()                # the lock-step write slot, on the card
    yield ("talker", lambda: talker.talker_step(
        w, cfg, hidden, kv, pos, slot, read_ctx=rc), 20, True,
        talker_step(m, B, n_past, steps))
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
    e = ref_moe.route(Prec("f32"), h.to(torch.bfloat16), lw["w_router"],
                      lw["e_bias"], m.top_k, m.scaling)[0] - m.expert_offset
    e = e[(e >= 0) & (e < m.held)]
    cfg_moe = w["layers"]["moe"]
    yield ("moe", lambda: moe_ffn(h, lw, cfg_moe), 50, True,
           moe_layer(m, B, len(e.unique()), len(e)))
    del h
    q = torch.randn(B, t.heads, m.latent_width, generator=gen,
                    device=dev).to(torch.bfloat16)
    rows = torch.randn(B, ctx, m.latent_width, generator=gen,
                       device=dev).to(torch.bfloat16)
    n_valid = torch.full((B,), n_past + 1, dtype=torch.int32, device=dev)
    scale = (m.nope + m.rope) ** -0.5
    yield ("mla", lambda: mla_decode(q, rows, n_valid, scale, m.rope,
                                     read_ctx=rc), 50, True,
           mla_call(m, B, n_past + 1))

