"""Qwen3-TTS-12Hz (the 0.6B and 1.7B Base models): a dense Qwen3 talker
that emits the first codebook of a frame, a 5-layer code predictor that
fills codebooks 1..15 (behind a ``small_to_mtp_projection`` where its width
differs from the talker's), and the 12 Hz tokenizer's decoder. Everything
in the harness that knows these layers is here, behind the surface that
benchmark/archs/__init__.py documents; the shared layers come from
benchmark/model.py, weights.py, roofline.py, program.py and reference/.

Departures from the published description that the program makes too,
and that the reference therefore follows: the text template's first
three tokens and the codec prefix are laid out as runtime/talker.py
documents (think prefix, language id, speaker row, pad, bos; tts_pad over
the codec rows, tts_bos over the last of them).

EOS shaping (the configuration's ``random_weights``): the codec head's EOS
column is zero and its other columns have ``codec_head_logit_std /
sqrt(hidden)``, so the EOS logit sits far below the best code until the
program's own EOS ramp lifts it, and output lengths come from that ramp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import model, program
from benchmark import weights as W
from benchmark.reference.layers import NEG, Prec, decoder_stack, rms_norm
from benchmark.reference.vocoder import vocode  # noqa: F401 (the surface)
from benchmark.roofline import (BF16, F32, attn_flops, layer_matrix_params,
                                layer_vector_params, vocoder_chunk,
                                vocoder_flops_per_stream)
from benchmark.seeds import sub_seed


# -- shapes -------------------------------------------------------------

@dataclass(frozen=True)
class Model:
    name: str
    source: str
    talker: model.Stack
    code_pred: model.Stack
    codec_vocab: int
    n_codebooks: int
    cp_vocab: int
    text_vocab: int
    text_dim: int
    rms_norm_eps: float
    rope_theta: float
    vocoder: model.Vocoder
    special: dict
    random: dict

    @property
    def prefill_len(self) -> int:
        """Rows of a request's prefill: three template ids, the think
        prefix (think, think_bos, language, think_eos), the speaker row,
        pad, and bos carrying the text's first id; the rest of the text
        arrives a row a frame."""
        return 3 + 4 + 1 + 2

    @property
    def has_mtp(self) -> bool:
        """The 2048 -> 1024 small_to_mtp_projection of the larger models."""
        return self.code_pred.hidden != self.talker.hidden


def load(raw: dict) -> Model:
    """The configuration file's dict (benchmark/configs/<name>.json)."""
    t, v = raw["talker_config"], raw["vocoder_config"]
    return Model(
        name=raw["name"], source=raw["source"], talker=model.stack(t),
        code_pred=model.stack(raw["code_predictor_config"]),
        codec_vocab=t["vocab_size"], n_codebooks=t["num_code_groups"],
        cp_vocab=raw["code_predictor_config"]["vocab_size"],
        text_vocab=t["text_vocab_size"], text_dim=t["text_hidden_size"],
        rms_norm_eps=t["rms_norm_eps"], rope_theta=t["rope_theta"],
        vocoder=model.vocoder(v), special=dict(raw["special_tokens"]),
        random=dict(raw["random_weights"]))


# -- weights ------------------------------------------------------------

def talker_spec(m: Model) -> W.Spec:
    """Talker + code predictor leaves (the program's layout)."""
    r = m.random
    std, nstd = r["matrix_std"], r["norm_std"]
    bf, f32 = torch.bfloat16, torch.float32
    H, Hc, n_rest = m.talker.hidden, m.code_pred.hidden, m.n_codebooks - 1
    spec = W.Spec()
    spec.add(("text_embd",), (m.text_vocab, m.text_dim), bf, "normal", std)
    spec.add(("text_proj", "fc1_w"), (m.text_dim, m.text_dim), bf, "normal",
             std)
    spec.add(("text_proj", "fc1_b"), (m.text_dim,), f32, "const", 0.0)
    spec.add(("text_proj", "fc2_w"), (m.text_dim, H), bf, "normal", std)
    spec.add(("text_proj", "fc2_b"), (H,), f32, "const", 0.0)
    spec.add(("codec_embd",), (m.codec_vocab, H), bf, "normal", std)
    spec.add(("codec_head",), (H, m.codec_vocab), bf, "normal",
             r["codec_head_logit_std"] / math.sqrt(H))
    spec.add(("output_norm",), (H,), f32, "one_plus_normal", nstd)
    W.stack_spec(spec, ("layers",), m.talker, std, nstd)
    W.stack_spec(spec, ("code_pred", "layers"), m.code_pred, std, nstd)
    spec.add(("code_pred", "output_norm"), (Hc,), f32, "one_plus_normal", nstd)
    spec.add(("code_pred", "embd"), (n_rest, m.cp_vocab, H), bf, "normal", std)
    spec.add(("code_pred", "heads"), (n_rest, Hc, m.cp_vocab), bf, "normal",
             std)
    if m.has_mtp:
        spec.add(("code_pred", "mtp_w"), (H, Hc), bf, "normal", std)
        spec.add(("code_pred", "mtp_b"), (Hc,), f32, "const", 0.0)
    return spec


def make_weights(m: Model, seed: int, device, vocoder_dtype=None
                 ) -> W.Weights:
    """The weights of configuration `m` for `seed` on `device`. The
    vocoder's matrices are bf16 on a card and f32 on the CPU (as the
    program keeps them), unless `vocoder_dtype` says otherwise."""
    device = torch.device(device)
    if vocoder_dtype is None:
        vocoder_dtype = (torch.bfloat16 if device.type == "cuda"
                         else torch.float32)

    def gen(k):
        return torch.Generator(device=device).manual_seed(sub_seed(seed, k))

    with torch.no_grad():
        talker = W.as_lists(talker_spec(m).materialize(gen("talker"), device))
        talker["codec_head"][:, m.special["codec_eos_id"]] = 0
        if not m.has_mtp:
            talker["code_pred"]["mtp_w"] = talker["code_pred"]["mtp_b"] = None
        voc = W.as_lists(W.vocoder_spec(m, vocoder_dtype).materialize(
            gen("vocoder"), device))
        voices = torch.randn(int(m.random["voices"]), m.talker.hidden,
                             generator=gen("voices"), device=device)
        voices *= m.random["speaker_std"]
    return W.Weights(talker, voc, voices)


# -- the reference ------------------------------------------------------

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


def cb0_scores(p: Prec, w, m, hidden, codes, n_tokens: int,
               penalty: float):
    """The first codebook's scores at frames 0..F-1 of codes [F, 16], from
    the talker's hidden states hidden [F, H] through the codec head, as the
    model's sampler sees them: ids from V - 1024 up suppressed but EOS, the
    repetition penalty on the codes served before, the EOS ramp after
    max(20, 4 * n_tokens) frames. -> [F, V]."""
    logits = p.mm(hidden, w["codec_head"])
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


# -- counts -------------------------------------------------------------

def talker_step(m: Model, B: int, n_past: int) -> tuple[float, float]:
    """One decode step of B streams, each with n_past cached positions:
    every layer, the output norm and the codec head."""
    t = m.talker
    flops = B * (2 * t.layers * layer_matrix_params(t)
                 + t.layers * attn_flops(t, n_past + 1)
                 + 2 * t.hidden * m.codec_vocab)
    weights = (BF16 * (t.layers * layer_matrix_params(t)
                       + t.hidden * m.codec_vocab)
               + F32 * (t.layers * layer_vector_params(t) + t.hidden))
    row = t.layers * 2 * t.kv_heads * t.head_dim * BF16
    io = B * F32 * (t.hidden + t.hidden + m.codec_vocab)
    return flops, weights + B * row * (n_past + 1) + io


def codepred_frame(m: Model, B: int) -> tuple[float, float]:
    """Codebooks 1..15 of one frame for B streams: 16 positions through
    the stack (the talker's state and 15 codes), 15 heads, the
    small_to_mtp projection where there is one."""
    c, H = m.code_pred, m.talker.hidden
    n_pos, n_heads = m.n_codebooks, m.n_codebooks - 1
    attn = sum(attn_flops(c, k) for k in range(1, n_pos + 1))
    flops = B * (2 * c.layers * layer_matrix_params(c) * n_pos
                 + c.layers * attn + 2 * n_heads * c.hidden * m.cp_vocab
                 + (2 * n_pos * H * c.hidden if m.has_mtp else 0))
    weights = (BF16 * (c.layers * layer_matrix_params(c)
                       + n_heads * c.hidden * m.cp_vocab
                       + (H * c.hidden if m.has_mtp else 0))
               + F32 * (c.layers * layer_vector_params(c) + c.hidden
                        + (c.hidden if m.has_mtp else 0)))
    rows = BF16 * H * (min(B * (n_pos - 2), (n_pos - 2) * m.cp_vocab)
                       + min(B, m.codec_vocab))
    io = B * (F32 * H + 4 + 4 * n_heads)
    return flops, weights + rows + io


def prefill_flops(m: Model, n_tokens: int, P: int) -> float:
    """A request's prefill: the text projection of its n_tokens ids and the
    talker over its P prefill rows, with the codec head once."""
    t = m.talker
    proj = 2 * (n_tokens + 3) * (m.text_dim * m.text_dim
                                 + m.text_dim * t.hidden)
    layers = t.layers * (2 * layer_matrix_params(t) * P
                         + sum(attn_flops(t, k) for k in range(1, P + 1)))
    return float(proj + layers + 2 * t.hidden * m.codec_vocab)


def frame_flops(m: Model, n_past: int) -> float:
    """Model operations of one delivered frame of one stream whose talker
    step saw n_past cached positions: the step, the code predictor and
    the vocoder's share of its chunk."""
    return (talker_step(m, 1, n_past)[0] + codepred_frame(m, 1)[0]
            + vocoder_flops_per_stream(m, 40) / 40)


# -- the program --------------------------------------------------------

def talker_config(m: Model):
    from qwen3_tts_tpu_torch.config import TalkerConfig
    t, c, s = m.talker, m.code_pred, m.special
    return TalkerConfig(
        text_vocab_size=m.text_vocab, text_embd_dim=m.text_dim,
        hidden_size=t.hidden, n_layers=t.layers, n_attention_heads=t.heads,
        n_key_value_heads=t.kv_heads, intermediate_size=t.intermediate,
        head_dim=t.head_dim, rms_norm_eps=m.rms_norm_eps,
        rope_theta=m.rope_theta, codec_vocab_size=m.codec_vocab,
        n_codebooks=m.n_codebooks, code_pred_layers=c.layers,
        code_pred_vocab_size=m.cp_vocab, code_pred_hidden_size=c.hidden,
        code_pred_intermediate_size=c.intermediate,
        code_pred_n_attention_heads=c.heads, code_pred_n_kv_heads=c.kv_heads,
        code_pred_head_dim=c.head_dim,
        **{k: s[k] for k in (
            "codec_pad_id", "codec_bos_id", "codec_eos_id", "codec_think_id",
            "codec_nothink_id", "codec_think_bos_id", "codec_think_eos_id",
            "english_language_id", "tts_bos_token_id", "tts_eos_token_id",
            "tts_pad_token_id")})


def make_engine(m: Model, weights, tokenizer: program.TokenTable, device):
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS
    return Qwen3TTS.from_components(tokenizer, talker_config(m),
                                    weights.talker,
                                    program.vocoder_config(m.vocoder),
                                    weights.vocoder, device)


def layer_calls(run, engine, B: int):
    """The calls the rooflines time (benchmark/timing.py) at batch B, one
    at a time. Talker: ``talker.talker_step`` over a bf16 cache of the
    lock-step size, every stream at the median position of the mix (the
    prefill plus half the frame cap). Code predictor:
    ``code_predictor.predict_codes`` for one frame. Vocoder: the engine's
    decode of one 40-frame chunk of the batch, at the sub-batch the
    pipeline picks, replaying the program's own graphs."""
    from qwen3_tts_tpu_torch.models import code_predictor, talker
    from qwen3_tts_tpu_torch.models.stack import init_kv_cache
    from qwen3_tts_tpu_torch.runtime.generate import ctx_bucket, required_ctx
    m, dev, mix = run.cell.model, run.device, run.cell.mix
    cap, P = mix["frame_cap"], m.prefill_len
    cfg, w = engine.talker_cfg, engine.talker_w
    t = m.talker
    n_past = P + cap // 2
    gen = torch.Generator(device=dev).manual_seed(run.seed % (1 << 62))
    hidden = torch.randn(B, t.hidden, generator=gen, device=dev)
    ctx = required_ctx(P, cap, 40)
    kv = init_kv_cache(t.layers, B, ctx, t.kv_heads, t.head_dim, dev)
    pos = torch.full((B,), n_past, dtype=torch.int32, device=dev)
    rc = ctx_bucket(n_past, 40, ctx)
    slot = pos.max()                # the lock-step write slot, on the card
    yield ("talker", lambda: talker.talker_step(
        w, cfg, hidden, kv, pos, slot, read_ctx=rc), 20, True,
        talker_step(m, B, n_past))
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
