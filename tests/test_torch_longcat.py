"""The port's talker of LongCat-Flash double layers (latent attention over
a latent cache, a shortcut MoE with identity experts, one chip's share of
the experts) against the plain reference tests/longcat_talker_reference.py,
and that reference against transformers' ``LongcatFlash`` where it is
installed. CPU only: the kernels' twins."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from qwen3_tts_tpu_torch.config import MLAConfig, MoEConfig
from qwen3_tts_tpu_torch.models import talker
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.models.stack import LatentKV, init_kv_cache
from qwen3_tts_tpu_torch.ops import mla, moe, talker_fused
from qwen3_tts_tpu_torch.runtime import generate
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe
from qwen3_tts_tpu_torch.runtime import serve as tserve
from qwen3_tts_tpu_torch.runtime.stream import ChunkCopies
from qwen3_tts_tpu_torch.utils import trace

from . import longcat_talker_reference as ref
from .test_tokenizer import make_tiny_tokenizer
from .test_torch_config import port_tokenizer
from .test_torch_moe import FrameTap, stream_rows

H = 96
MLA = MLAConfig(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16)
# 8 real experts, 4 identity ones, top-3; this chip holds experts 2..5
MOE = MoEConfig(n_experts=8, top_k=3, expert_intermediate=32,
                shared_intermediate=0, norm_topk_prob=False,
                n_zero_experts=4, routed_scaling=6.0, expert_offset=2,
                n_held=4)
# Relative L2 errors, each with what it reads and what one more rounding
# reads (test_tolerances_see_the_roundings):
# - the MoE op alone: f32 sums in another order, ~2e-8; rounding the
#   experts' products to bf16 (stated f32) reads 1.6e-3;
OP_TOL = 1e-4
# - one sublayer's decode attention, absorbed (the port) against the
#   reference's non-absorbed pass over the same bf16 rows: the port rounds
#   the latent query, the probabilities against the running maximum and
#   the latent output to bf16 where the reference rounds kv_b's keys and
#   values, ~2e-3; cache rows a precision lower (float8 e4m3, a scale a
#   row) read several times that;
MLA_TOL = 1e-2
# - the talker's logits after a prefill and decode steps through the cache
#   (two double layers: the decode attention's roundings above, carried
#   through the layers and the codec head): ~5e-3 at most over the
#   steps and the served streams.
LOGIT_TOL = 2e-2
TEXTS = ["hello world.", "hello hello world hello.", "world."]


def tiny_cfg():
    return dataclasses.replace(W.tiny_talker_config(), hidden_size=H,
                               n_layers=2, n_attention_heads=4,
                               intermediate_size=128)


def ref_mla(c=MLA) -> dict:
    return dataclasses.asdict(c)


def ref_moe(m=MOE) -> dict:
    return dict(n_experts=m.n_experts, top_k=m.top_k,
                routed_scaling=m.routed_scaling,
                expert_offset=m.expert_offset)


def tiny_weights(moe_cfg=MOE, seed=3):
    """Random weights whose router decides (logits of a few units), whose
    experts' outputs are of the identity experts' size, and whose
    correction bias is nonzero."""
    w = W.init_talker_weights(tiny_cfg(), torch.Generator().manual_seed(seed),
                              "cpu", moe=moe_cfg, mla=MLA)
    lw = w["layers"]
    g = torch.Generator().manual_seed(seed + 100)
    lw["w_router"] = (lw["w_router"].float() * 5).to(torch.bfloat16)
    for k in ("w_gu_e", "w_down_e"):
        lw[k] = (lw[k].float() * 20).to(torch.bfloat16)
    lw["e_bias"] = torch.randn(lw["e_bias"].shape, generator=g) * 0.2
    return w


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def layer(w, l=0):
    return {k: v[l] for k, v in w["layers"].items()
            if isinstance(v, torch.Tensor)}


def _ref_talker(w, x, **kw):
    cfg = tiny_cfg()
    return ref.talker_forward(w, x, heads=cfg.n_attention_heads,
                              eps=cfg.rms_norm_eps, theta=cfg.rope_theta,
                              mla_cfg=ref_mla(), moe=ref_moe(), **kw)


# -- the reference against transformers ------------------------------------

def _hf_model(w, cfg, moe_cfg):
    """transformers' LongcatFlashModel at the tiny sizes, holding `w`
    (linear weights transposed to nn.Linear's [out, in])."""
    lf = pytest.importorskip("transformers.models.longcat_flash."
                             "modeling_longcat_flash")
    from transformers import LongcatFlashConfig
    c = LongcatFlashConfig(
        vocab_size=16, hidden_size=H, num_layers=cfg.n_layers,
        num_attention_heads=cfg.n_attention_heads,
        ffn_hidden_size=cfg.intermediate_size, q_lora_rank=MLA.q_lora_rank,
        kv_lora_rank=MLA.kv_lora_rank,
        qk_nope_head_dim=MLA.qk_nope_head_dim,
        qk_rope_head_dim=MLA.qk_rope_head_dim, head_dim=MLA.qk_rope_head_dim,
        v_head_dim=MLA.v_head_dim, moe_topk=moe_cfg.top_k,
        n_routed_experts=moe_cfg.n_experts,
        zero_expert_num=moe_cfg.n_zero_experts,
        expert_ffn_hidden_size=moe_cfg.expert_intermediate,
        routed_scaling_factor=moe_cfg.routed_scaling,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta)
    c._attn_implementation = "eager"
    model = lf.LongcatFlashModel(c).float().eval()
    lw = w["layers"]

    def put(lin, a):
        lin.weight.data.copy_(a.float().T)

    def put_glu(mlp, gu, down):
        i = gu.shape[-1] // 2
        put(mlp.gate_proj, gu[:, :i])
        put(mlp.up_proj, gu[:, i:])
        put(mlp.down_proj, down)

    for l, dl in enumerate(model.layers):
        for s in (0, 1):
            a = dl.self_attn[s]
            for lin, name in ((a.q_a_proj, "wq_a"), (a.q_b_proj, "wq_b"),
                              (a.kv_a_proj_with_mqa, "wkv_a"),
                              (a.kv_b_proj, "wkv_b"), (a.o_proj, "wo")):
                put(lin, lw[name][l][s])
            a.q_a_layernorm.weight.data.copy_(lw["q_a_norm"][l][s])
            a.kv_a_layernorm.weight.data.copy_(lw["kv_a_norm"][l][s])
            dl.input_layernorm[s].weight.data.copy_(lw["attn_norm"][l][s])
            dl.post_attention_layernorm[s].weight.data.copy_(
                lw["ffn_norm"][l][s])
            put_glu(dl.mlps[s], lw["w_gu"][l][s], lw["w_down"][l][s])
        r = dl.mlp.router
        put(r.classifier, lw["w_router"][l])
        r.e_score_correction_bias.copy_(lw["e_bias"][l])
        for ex in range(moe_cfg.n_experts):
            put_glu(dl.mlp.experts[ex], lw["w_gu_e"][l][ex],
                    lw["w_down_e"][l][ex])
    model.norm.weight.data.copy_(w["output_norm"])
    return model


def test_reference_matches_transformers():
    """Every expert held (the uncut layer): the reference's double layers
    and its whole stack with the output norm equal transformers'
    ``LongcatFlashDecoderLayer`` / ``LongcatFlashModel`` on the same
    weights, up to f32 sums in another order."""
    cfg = tiny_cfg()
    full = dataclasses.replace(MOE, expert_offset=0, n_held=0)
    w = tiny_weights(full)
    model = _hf_model(w, cfg, full)
    x = torch.randn(2, 9, H, generator=torch.Generator().manual_seed(5)) * 0.5
    with torch.no_grad():
        pos = torch.arange(9)[None]
        emb = model.rotary_emb(x, pos)
        y = model.layers[0](x, position_ids=pos, position_embeddings=emb,
                            attention_mask=torch.full((9, 9), float("-inf"))
                            .triu(1)[None, None])
        got = model(inputs_embeds=x).last_hidden_state
    one = dict(w, layers={k: (v[:1] if isinstance(v, torch.Tensor) else v)
                          for k, v in w["layers"].items()})
    mo = dict(ref_moe(full))
    want1 = ref.talker_forward(
        {**one, "output_norm": torch.ones(H)}, x, heads=4,
        eps=cfg.rms_norm_eps, theta=cfg.rope_theta, mla_cfg=ref_mla(),
        moe=mo)[0]
    # the reference returns the normed output: norm the layer's output too
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.rms_norm_eps)
    assert rel(y, want1) < 1e-5
    want = ref.talker_forward(w, x, heads=4, eps=cfg.rms_norm_eps,
                              theta=cfg.rope_theta, mla_cfg=ref_mla(),
                              moe=mo)[0]
    assert rel(got, want) < 1e-5


# -- latent attention ---------------------------------------------------

def _mla_case(mode: str, B=3, T=13, S=24, seed=6):
    """(port's decode output, reference's output) of sublayer 1 of double
    layer 0 for the last of T rows: the port prefills T - 1 rows into its
    latent cache and decodes the last through it, absorbed; prefix mode
    keeps the rows at slots 0..T-1, masked mode scatters them over a ring
    of S slots with garbage rows between."""
    w = tiny_weights()
    cfg = tiny_cfg()
    lw = layer(w)
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, T, H, generator=g)
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    _, rows_p = mla.prefill_sublayer(lw, 1, h[:, :T - 1], pos[:, :T - 1], 4,
                                     MLA, cfg.rope_theta)
    rows = torch.randn(B, S, MLA.latent_width, generator=g).to(torch.bfloat16)
    if mode == "prefix":
        slots = torch.arange(T).expand(B, T)
        rows[:, :T - 1] = rows_p
        kw = dict(n_valid=torch.full((B,), T, dtype=torch.int32))
    else:
        slots = torch.stack([torch.randperm(S, generator=g)[:T]
                             for _ in range(B)])
        rows[torch.arange(B)[:, None], slots[:, :T - 1]] = rows_p
        mask = torch.zeros(B, S, dtype=torch.bool)
        mask[torch.arange(B)[:, None], slots] = True
        kw = dict(valid_mask=mask)
    got = []
    for b in range(B):       # each stream writes its own slot
        got.append(mla.decode_sublayer(
            lw, 1, h[b:b + 1, T - 1],
            pos[b:b + 1, T - 1], rows[b:b + 1], slots[b, T - 1:T].long(), 4,
            MLA, cfg.rope_theta, **{k: v[b:b + 1] for k, v in kw.items()}))
    want = ref.mla(w["layers"], 0, 1, h, 4, ref_mla(), cfg.rope_theta,
                   rnd=True)[:, -1]
    return torch.cat(got), want


@pytest.mark.parametrize("mode", ["prefix", "masked"])
def test_mla_decode_absorbed_matches_reference(mode):
    got, want = _mla_case(mode)
    assert rel(got, want) < MLA_TOL


def test_mla_twin_modes_and_read_ctx():
    """The decode twin: prefix and bitmask modes agree on the same counted
    slots, read_ctx cuts what is read, a stream with no slot gives 0."""
    g = torch.Generator().manual_seed(2)
    B, S, W = 3, 40, 24
    q = torch.randn(B, 4, W, generator=g).to(torch.bfloat16)
    rows = torch.randn(B, S, W, generator=g).to(torch.bfloat16)
    n_valid = torch.tensor([0, 17, 40], dtype=torch.int32)
    mask = torch.arange(S)[None] < n_valid[:, None]
    a = mla.mla_decode(q, rows, n_valid, 0.3, 8)
    b = mla.mla_decode_masked(q, rows, mask, 0.3, 8)
    assert a.shape == (B, 4, W - 8) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and not a[0].any()
    rows2 = rows.clone()
    rows2[:, 20:] = float("nan")
    c = mla.mla_decode(q, rows2, n_valid, 0.3, 8, read_ctx=20)
    assert torch.equal(c[:2], a[:2]) and not c.isnan().any()
    # against plain f32 attention (the twin rounds P and its output only)
    s = torch.einsum("bnw,bsw->bns", q.float(), rows.float()) * 0.3
    p = s.masked_fill(~mask[:, None], float("-inf")).softmax(-1)
    want = torch.einsum("bns,bsr->bnr", p, rows.float()[..., :W - 8])
    assert rel(a[1:].float(), want[1:]) < 1e-2


def test_latent_cache_layout():
    """One 576-wide row (here R + dr) a position a sublayer, no heads; the
    int8 cache is refused."""
    kv = init_kv_cache(2, 3, 16, 8, 128, "cpu", latent=MLA.latent_width)
    assert isinstance(kv, LatentKV)
    assert kv.rows.shape == (2, 2, 3, 16, MLA.latent_width)
    assert kv.rows.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="int8"):
        init_kv_cache(2, 3, 16, 8, 128, "cpu", quant=True, latent=24)


def test_rope_interleave_is_the_interleaved_form():
    """De-interleaved NEOX equals rotating the adjacent pairs (2i, 2i + 1),
    up to the layout, and scores match the pairwise form."""
    from qwen3_tts_tpu_torch.ops.layers import rope_interleave
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 3, 8, generator=g)
    pos = torch.arange(5).expand(2, 5)
    got = rope_interleave(x, pos, 1e4)
    inv = 1e4 ** (-torch.arange(0, 8, 2).float() / 8)
    ang = pos[..., None, None].float() * inv
    x0, x1 = x[..., 0::2], x[..., 1::2]
    pair = torch.cat([x0 * ang.cos() - x1 * ang.sin(),
                      x0 * ang.sin() + x1 * ang.cos()], -1)
    assert torch.allclose(got, pair, atol=1e-6)
    assert torch.allclose(ref.rope_interleave(x[0], torch.arange(5), 1e4),
                          got[0], atol=1e-6)


# -- the router and the experts -----------------------------------------

def _rows(n=37, seed=1):
    return torch.randn(n, H, generator=torch.Generator().manual_seed(seed))


def test_moe_op_matches_reference():
    w = tiny_weights()
    h = _rows()
    cnt = torch.zeros(5, dtype=torch.int32)
    lw = dict(layer(w, 1), moe_counts=cnt)
    got = moe.moe_ffn(h, lw, MOE)
    routes = []
    want = ref.moe_block(h, w["layers"], 1, ref_moe(), rnd=True,
                         routes=routes)
    assert rel(got, want) < OP_TOL
    e = routes[0]
    held = (e >= 2) & (e < 6)
    per = torch.bincount(e[held] - 2, minlength=4)
    assert cnt.tolist() == [int(held.sum()),
                            int(((per + 15) // 16 * 16).sum()),
                            int(per.max()), int((e >= 8).sum()),
                            int(((e < 2) | ((e >= 6) & (e < 8))).sum())]
    assert sum(cnt[[0, 3, 4]].tolist()) == e.numel()


def test_router_bias_scaling_and_ties():
    """The bias picks and the probability weighs; the weights are p times
    the scaling, not renormalised; equal choices go to the lower id."""
    N, E = 4, MOE.router_width
    wr = torch.zeros(H, E)
    wr[0, 5] = 3.0                   # expert 5: the largest probability
    h = torch.zeros(N, H)
    h[:, 0] = 1.0
    bias = torch.zeros(E)
    bias[9] = 1.0                    # identity expert 9 chosen by the bias
    x, e, w = moe.route_ep(h, wr.to(torch.bfloat16), bias, MOE)
    p = torch.softmax(h @ wr, -1)
    assert e[:, 0].tolist() == [9] * N and e[:, 1].tolist() == [5] * N
    # the rest tie at the same probability: the lower ids, in order
    assert e[:, 2].tolist() == [0] * N
    assert torch.allclose(w, p.gather(1, e) * MOE.routed_scaling)
    norm = dataclasses.replace(MOE, norm_topk_prob=True)
    w2 = moe.route_ep(h, wr.to(torch.bfloat16), bias, norm)[2]
    assert torch.allclose(w2.sum(-1), torch.full((N,), 6.0))


def _route_to(lw, chosen):
    """Every row routed to the ids `chosen`, in that order, by the bias
    alone (a zero router: equal probabilities)."""
    E = MOE.router_width
    lw["w_router"] = torch.zeros(H, E, dtype=torch.bfloat16)
    lw["e_bias"] = torch.zeros(E)
    lw["e_bias"][list(chosen)] = torch.tensor([3.0, 2.0, 1.0])


def test_identity_and_remote_experts():
    """An identity expert adds w bf16(h); a real expert held elsewhere adds
    nothing and is counted; a held one adds its SwiGLU."""
    lw = layer(tiny_weights())
    h = _rows(3, 4)
    w = MOE.routed_scaling / MOE.router_width     # p x scaling, p uniform
    x = h.to(torch.bfloat16).float()
    cases = (((8, 9, 10), 3 * w * x, [0, 0, 0, 9, 0]),
             ((0, 1, 7), torch.zeros_like(x), [0, 0, 0, 0, 9]),
             ((3, 8, 0), w * moe.swiglu(x, lw["w_gu_e"][1], lw["w_down_e"][1])
              + w * x, [3, 16, 3, 3, 3]))
    for chosen, want, counts in cases:
        _route_to(lw, chosen)
        cnt = torch.zeros(5, dtype=torch.int32)
        got = moe.moe_ffn(h, dict(lw, moe_counts=cnt), MOE)
        assert moe.route_ep(h, lw["w_router"], lw["e_bias"],
                            MOE)[1][0].tolist() == list(chosen)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-7)
        assert cnt.tolist() == counts


def test_expert_shares_add_up_to_the_uncut_layer():
    """Expert parallelism's share test: four chips each hold a quarter of
    the 8 real experts; the held parts of every share, with the identity
    experts (computed alike on every chip) counted once, add up to the
    reference's uncut layer."""
    full = dataclasses.replace(MOE, expert_offset=0, n_held=0)
    w = tiny_weights(full)
    lw = layer(w, 1)
    h = _rows(29, 8)
    want = ref.moe_block(h, w["layers"], 1,
                         dict(ref_moe(full), expert_offset=0), rnd=True)
    x, e, ww = moe.route_ep(h, lw["w_router"], lw["e_bias"], full)
    ident = (torch.where(e >= 8, ww, 0.0).sum(-1, keepdim=True) * x.float())
    total = ident.clone()
    for share in range(4):
        cfg = dataclasses.replace(full, expert_offset=2 * share, n_held=2)
        part = dict(lw, w_gu_e=lw["w_gu_e"][2 * share:2 * share + 2],
                    w_down_e=lw["w_down_e"][2 * share:2 * share + 2])
        total = total + (moe.moe_ffn(h, part, cfg) - ident)
    assert rel(total, want) < OP_TOL
    assert rel(moe.moe_ffn(h, lw, full), want) < OP_TOL


# -- the talker: prefill, then decode through the cache -------------------

def decode_errors(w, B=3, P=6, steps=5, seed=7) -> list:
    """Relative errors of the talker's logits over a prefill of P rows and
    `steps` decode steps through the latent cache, against the
    reference's full forward over the same rows."""
    cfg = tiny_cfg()
    x = torch.randn(B, P + steps, H,
                    generator=torch.Generator().manual_seed(seed)) * 0.5
    _, want = _ref_talker(w, x, program_rounding=True)
    kv = init_kv_cache(cfg.n_layers, B, 16, 1, 1, "cpu",
                       latent=MLA.latent_width)
    _, logits, kv = talker.talker_prefill(w, cfg, x[:, :P], kv)
    errs = [rel(logits, want[:, P - 1])]
    for s in range(steps):
        n_past = torch.full((B,), P + s, dtype=torch.int32)
        _, logits, kv = talker.talker_step(w, cfg, x[:, P + s], kv, n_past,
                                           P + s)
        errs.append(rel(logits, want[:, P + s]))
    return errs


def test_prefill_then_decode_matches_reference():
    errs = decode_errors(tiny_weights())
    # the prefill is the reference's computation with its roundings
    assert errs[0] < 1e-5
    assert max(errs) < LOGIT_TOL


@pytest.fixture(scope="module")
def engine():
    tok = port_tokenizer(make_tiny_tokenizer())
    return tpipe.Qwen3TTS.from_components(tok, tiny_cfg(), tiny_weights(),
                                          None, None, "cpu", moe=MOE,
                                          mla=MLA)


def served_error(eng, tap, texts, rows_of) -> float:
    worst = 0.0
    for i, text in enumerate(texts):
        logits, codes = tap.stream(rows_of[i])
        x, P = stream_rows(eng, text, codes)
        _, want = _ref_talker(eng.talker_w, x[None], program_rounding=True)
        worst = max(worst, rel(logits, want[0, P - 1:P - 1 + len(codes)]))
    return worst


def _check_spans(spans):
    assert spans
    for s in spans:
        a = s.attrs
        assert a["pairs"] + a["zero"] + a["remote"] > 0
        assert (a["pairs"] + a["zero"] + a["remote"]) % MOE.top_k == 0
        assert a["rows"] >= a["pairs"] and a["max_rows"] <= a["pairs"]
    c = trace.counters()
    for key, attr in (("moe.pairs", "pairs"), ("moe.rows", "rows"),
                      ("moe.zero_pairs", "zero"),
                      ("moe.remote_pairs", "remote")):
        assert c[key] == sum(s.attrs[attr] for s in spans)


def test_synthesize_batch_against_reference(engine, monkeypatch):
    tap = FrameTap(monkeypatch)
    trace.reset()
    res = engine.synthesize_batch(TEXTS, params=tpipe.TTSParams(
        max_audio_tokens=12, temperature=0.9, seed=3, print_timing=False))
    assert all(r.error_msg == "Vocoder not loaded" for r in res)
    assert served_error(engine, tap, TEXTS, range(len(TEXTS))) < LOGIT_TOL
    _check_spans([s for s in trace.spans() if s.name == "talker.moe"])


def test_continuous_batcher_against_reference(engine, monkeypatch):
    tap = FrameTap(monkeypatch)
    trace.reset()
    cb = tserve.ContinuousBatcher(engine, n_slots=len(TEXTS),
                                  params=tpipe.TTSParams(
                                      max_audio_tokens=12, temperature=0.9,
                                      seed=5, print_timing=False),
                                  max_frames=48)
    rids = [cb.submit(t) for t in TEXTS]
    out = cb.run_all()
    assert all(out[r].n_frames > 0 for r in rids)
    assert isinstance(cb.state.kv_cache, LatentKV)
    assert served_error(engine, tap, TEXTS, range(len(TEXTS))) < LOGIT_TOL
    _check_spans([s for s in trace.spans() if s.name == "talker.moe"])


def test_span_and_counters_of_the_expert_parallel_counts():
    """Five columns a layer: pairs, rows, max_rows, zero, remote."""
    counts = torch.tensor([[3, 16, 2, 4, 5], [1, 16, 1, 6, 2]],
                          dtype=torch.int32)
    before = trace.counters()
    t0 = time.monotonic_ns()
    copies = ChunkCopies(torch.zeros(40, 2, 16, dtype=torch.int32),
                         torch.ones(40, 2, dtype=torch.bool),
                         torch.zeros(2, dtype=torch.bool), counts, t0)
    copies.take()
    (sp,) = [s for s in trace.spans(t0) if s.name == "talker.moe"]
    assert sp.attrs == {"pairs": 4, "rows": 32, "max_rows": 2, "zero": 10,
                        "remote": 7}
    after = trace.counters()
    assert after["moe.zero_pairs"] - before.get("moe.zero_pairs", 0) == 10
    assert after["moe.remote_pairs"] - before.get("moe.remote_pairs", 0) == 7


def test_tolerances_see_the_roundings(monkeypatch):
    """Each tolerance fails one more rounding: the experts' products
    rounded to bf16 (stated f32) fail OP_TOL; latent cache rows a
    precision below their bf16 (float8 e4m3, a scale a row) fail
    MLA_TOL."""
    w = tiny_weights()
    h = _rows()
    inner = moe.swiglu
    monkeypatch.setattr(moe, "swiglu", lambda *a: inner(*a).to(
        torch.bfloat16).float())
    got = moe.moe_ffn(h, layer(w, 1), MOE)
    assert rel(got, ref.moe_block(h, w["layers"], 1, ref_moe(),
                                  rnd=True)) > OP_TOL
    monkeypatch.setattr(moe, "swiglu", inner)
    rows_of = mla.latent_rows

    def fp8(*a):
        r = rows_of(*a).float()
        s = r.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 448
        return ((r / s).to(torch.float8_e4m3fn).float() * s).to(
            torch.bfloat16)

    monkeypatch.setattr(mla, "latent_rows", fp8)
    for mode in ("prefix", "masked"):
        got, want = _mla_case(mode)
        assert rel(got, want) > MLA_TOL


def test_guards(engine, monkeypatch):
    """The megakernel refuses a latent-attention talker, tp > 1 refuses
    it, the int8 KV cache raises, and the engine wants the MLA settings
    exactly when the layers hold ``wkv_b``."""
    cfg, w = engine.talker_cfg, engine.talker_w
    kv = init_kv_cache(cfg.n_layers, 2, 16, 1, 1, "cpu",
                       latent=MLA.latent_width)
    assert not talker_fused.supported(cfg, 2, w, kv.rows, torch.tensor(3),
                                      None, None)
    talker.set_talker_step_impl("fused")
    try:
        with pytest.raises(ValueError, match="fused"):
            talker.talker_step(w, cfg, torch.zeros(2, H), kv,
                               torch.zeros(2, dtype=torch.int32), 0)
    finally:
        talker.set_talker_step_impl(None)
    monkeypatch.setattr(tpipe, "mesh_dims", lambda mesh: (1, 2))
    with pytest.raises(ValueError, match="latent-attention"):
        engine.shard(type("Mesh", (), {"device_type": "cpu"})())
    monkeypatch.setenv("QWEN3_TTS_KV", "int8")
    with pytest.raises(ValueError, match="int8"):
        engine.synthesize_batch(["hello."], params=tpipe.TTSParams(
            max_audio_tokens=4, seed=1, print_timing=False))
    monkeypatch.delenv("QWEN3_TTS_KV")
    bare = {**w, "layers": {k: v for k, v in w["layers"].items()
                            if k not in ("mla", "w_uk", "w_uv")}}
    with pytest.raises(ValueError, match="MLAConfig"):
        tpipe.Qwen3TTS.from_components(None, cfg, bare, None, None, "cpu")
    dense = W.init_talker_weights(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    with pytest.raises(ValueError, match="no wkv_b"):
        tpipe.Qwen3TTS.from_components(None, cfg, dense, None, None, "cpu",
                                       mla=MLA)
    assert moe.supported(6144, dataclasses.replace(
        MOE, n_experts=512, n_zero_experts=256, top_k=12, n_held=16,
        expert_offset=0, expert_intermediate=2048)) is None
    assert "LongCat" in moe.supported(1024, dataclasses.replace(
        MoEConfig(), routed_scaling=6.0))


def test_ring_admission_writes_latent_rows(engine):
    """admit_slots writes a request's latent rows [0, P) into its slot
    only, the ring's slots and other streams untouched."""
    cfg, w = engine.talker_cfg, engine.talker_w
    toks = engine.tokenizer.encode_for_tts("hello world.")
    pre = talker.build_prefill_inputs(
        w, cfg, torch.tensor([toks] * 2, dtype=torch.int32),
        torch.tensor([len(toks)] * 2, dtype=torch.int32),
        torch.zeros(2, H))
    state = generate.init_state(w, cfg, pre, 64, None)
    consts = generate.make_consts(pre, 0.9, 1.05)
    P = pre.prefill_embd.shape[1]
    before = state.kv_cache.rows.clone()
    state.kv_cache.rows[:, :, 1, P:] = 1.0
    generate.admit_slots(w, cfg, state, consts, torch.tensor([1]), pre)
    rows = state.kv_cache.rows
    assert torch.equal(rows[:, :, 0], before[:, :, 0])
    assert torch.equal(rows[:, :, 1, :P], before[:, :, 1, :P])
    assert (rows[:, :, 1, P:] == 1.0).all()
