"""Qwen3-Omni's sparse-MoE talker on the port, against the plain reference
tests/omni_talker_reference.py, on seeded random weights at a small size
(H 64, 4 layers, 16 experts of 32, top-4, 4 / 1 heads of 16): the MoE op
(ops/moe.py's twin) and its edge cases, the talker's prefill and decode
through the cache, flash-decode's twin at 8 query heads a KV head, the
engine end to end (lock-step and ContinuousBatcher) and the guards.

Tolerances. The reference with ``program_rounding`` rounds to bf16 where
the port says it does, so the two differ by float32 summation order (and
RoPE's angles, taken two ways): relative errors under 1e-6. Each tolerance
sits well above that and below what one more bf16 rounding gives:
``test_tolerances_see_bf16_expert_products`` rounds the experts' products
to bf16 in the port and finds each test's number over its tolerance."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu_torch.config import MoEConfig  # noqa: E402
from qwen3_tts_tpu_torch.models import talker  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.models.stack import init_kv_cache  # noqa: E402
from qwen3_tts_tpu_torch.ops import flash_decode as fd  # noqa: E402
from qwen3_tts_tpu_torch.ops import moe  # noqa: E402
from qwen3_tts_tpu_torch.ops import talker_fused  # noqa: E402
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe  # noqa: E402
from qwen3_tts_tpu_torch.runtime import serve as tserve  # noqa: E402
from qwen3_tts_tpu_torch.utils import trace  # noqa: E402

from . import omni_talker_reference as ref  # noqa: E402
from .test_tokenizer import make_tiny_tokenizer  # noqa: E402
from .test_torch_config import port_tokenizer  # noqa: E402

MOE = MoEConfig(n_experts=16, top_k=4, expert_intermediate=32,
                shared_intermediate=64, norm_topk_prob=True)
# relative L2 errors: the op alone (one layer's f32 sums; reads ~4e-8)
# and the talker's logits (4 layers, attention, the codec head; reads 0 to
# ~1e-7: the bf16 roundings absorb the sums' order). One more bf16
# rounding of the experts' products reads 1.7e-3 and 5.8e-4
OP_TOL = 1e-4
LOGIT_TOL = 1e-4
TEXTS = ["hello world.", "hello hello world hello.", "world."]


def tiny_cfg():
    return dataclasses.replace(W.tiny_talker_config(), n_layers=4,
                               n_attention_heads=4, n_key_value_heads=1)


def tiny_weights(moe_cfg=MOE, seed=3):
    w = W.init_talker_weights(tiny_cfg(), torch.Generator().manual_seed(seed),
                              "cpu", moe=moe_cfg)
    # a router that decides: logits of a few units, not ~0.2
    w["layers"]["w_router"] = (w["layers"]["w_router"].float()
                               * 15).to(torch.bfloat16)
    return w


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def ref_moe(moe_cfg):
    return dict(n_experts=moe_cfg.n_experts, top_k=moe_cfg.top_k,
                norm_topk_prob=moe_cfg.norm_topk_prob)


def layer(w, l=0):
    lw = w["layers"]
    return {k: v[l] for k, v in lw.items() if isinstance(v, torch.Tensor)}


def op_error(h, w, moe_cfg, l=0, counts=None):
    lw = layer(w, l)
    if counts is not None:
        lw["moe_counts"] = counts
    got = moe.moe_ffn(h, lw, moe_cfg)
    want = ref.moe_block(h, w["layers"], l, ref_moe(moe_cfg), rnd=True)
    return rel(got, want)


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "raw"])
def test_moe_op_matches_reference(norm):
    cfg = dataclasses.replace(MOE, norm_topk_prob=norm)
    w = tiny_weights(cfg)
    h = torch.randn(37, 64, generator=torch.Generator().manual_seed(1))
    lw = layer(w, 2)
    e_port = moe.route(h, lw["w_router"], lw["w_sgate"], cfg.top_k,
                       norm)[1]
    e_ref = ref.route(h, w["layers"]["w_router"][2], cfg.top_k, norm,
                      rnd=True)[0]
    assert torch.equal(e_port, e_ref)
    assert op_error(h, w, cfg, l=2) < OP_TOL


def _dominated_rows(n, chosen, seed=4):
    """Rows h and a router under which every row picks `chosen`, with the
    other experts far below (no routing near-tie)."""
    h = torch.randn(n, 64, generator=torch.Generator().manual_seed(seed)).abs()
    wr = torch.zeros(64, MOE.n_experts)
    for i, e in enumerate(chosen):
        wr[:, e] = 0.05 * (i + 1)
    return h, wr.to(torch.bfloat16)


@pytest.mark.parametrize("case", ["same-k-experts", "one-row", "empty-experts"])
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "raw"])
def test_moe_op_edge_cases(case, norm):
    cfg = dataclasses.replace(MOE, norm_topk_prob=norm)
    w = tiny_weights(cfg)
    chosen = (3, 5, 7, 11)
    if case == "same-k-experts":
        h, wr = _dominated_rows(70, chosen)        # over one 64-row chunk
        w["layers"]["w_router"][0] = wr
    elif case == "one-row":
        h = torch.randn(1, 64, generator=torch.Generator().manual_seed(5))
    else:
        h, wr = _dominated_rows(9, chosen)
        w["layers"]["w_router"][0] = wr
    cnt = torch.zeros(3, dtype=torch.int32)
    assert op_error(h, w, cfg, counts=cnt) < OP_TOL
    e = ref.route(h, w["layers"]["w_router"][0], cfg.top_k, norm,
                  rnd=True)[0]
    if case != "one-row":
        assert set(e.unique().tolist()) == set(chosen)
    per = torch.bincount(e.reshape(-1), minlength=cfg.n_experts)
    assert cnt.tolist() == [h.shape[0] * cfg.top_k,
                            int(((per + 15) // 16 * 16).sum()),
                            int(per.max())]


def _ref_talker(w, x, **kw):
    cfg = tiny_cfg()
    return ref.talker_forward(
        w, x, heads=cfg.n_attention_heads, kv_heads=cfg.n_key_value_heads,
        head_dim=cfg.head_dim, eps=cfg.rms_norm_eps, theta=cfg.rope_theta,
        moe=ref_moe(MOE), **kw)


def decode_error(w, B=3, P=6, steps=5) -> float:
    """Worst relative error of the talker's logits over a prefill of P rows
    and `steps` decode steps through the bf16 cache, against the
    reference's full forward over the same rows."""
    cfg = tiny_cfg()
    x = torch.randn(B, P + steps, 64,
                    generator=torch.Generator().manual_seed(7)) * 0.5
    _, want = _ref_talker(w, x, program_rounding=True)
    kv = init_kv_cache(cfg.n_layers, B, 16, cfg.n_key_value_heads,
                       cfg.head_dim, "cpu")
    _, logits, kv = talker.talker_prefill(w, cfg, x[:, :P], kv)
    worst = rel(logits, want[:, P - 1])
    for s in range(steps):
        n_past = torch.full((B,), P + s, dtype=torch.int32)
        _, logits, kv = talker.talker_step(w, cfg, x[:, P + s], kv, n_past,
                                           P + s)
        worst = max(worst, rel(logits, want[:, P + s]))
    return worst


def test_prefill_then_decode_matches_reference():
    w = tiny_weights()
    routes = []
    cfg = tiny_cfg()
    x = torch.randn(3, 11, 64, generator=torch.Generator().manual_seed(7))
    _ref_talker(w, x * 0.5, routes=routes)
    assert len(routes) == cfg.n_layers     # every layer routed
    assert decode_error(w) < LOGIT_TOL


def _twin_ref(q, k, v, counted):
    """Plain f32 attention of q [B, Hq, D] over k / v [B, Hkv, S, D] at the
    slots `counted` [B, S] (query head h*G + g reads kv head h)."""
    G = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kf) / q.shape[-1] ** 0.5
    s = s.masked_fill(~counted[:, None], float("-inf")).softmax(-1)
    return torch.einsum("bhs,bhsd->bhd", s, vf).reshape(q.shape[0], -1)


@pytest.mark.parametrize("mode", ["prefix", "masked"])
def test_flash_decode_twin_g8(mode):
    """8 query heads a kv head (16 / 2, Qwen3-Omni's talker): the kernel's
    twin against plain attention, f32 probabilities both."""
    g = torch.Generator().manual_seed(11)
    B, n_kv, S, D = 3, 2, 200, 128
    q = torch.randn(B, 8 * n_kv, D, generator=g).to(torch.bfloat16)
    k = torch.randn(B, n_kv, S, D, generator=g).to(torch.bfloat16)
    v = torch.randn(B, n_kv, S, D, generator=g).to(torch.bfloat16)
    slot = torch.arange(S)
    if mode == "prefix":
        n_valid = torch.tensor([1, 77, 190], dtype=torch.int32)
        got = fd.flash_decode(q, k, v, n_valid)
        counted = slot[None] < n_valid[:, None]
    else:
        mask = torch.rand(B, S, generator=g) < 0.6
        lo = torch.tensor([70, 10, 150], dtype=torch.int32)
        hi = torch.tensor(140, dtype=torch.int32)
        got = fd.flash_decode_masked(q, k, v, mask, window_lo=lo,
                                     window_hi=hi, prefill_len=8)
        counted = fd._slots_read(B, S, q.device, valid_mask=mask,
                                 window_lo=lo, window_hi=hi, prefill_len=8)
    assert 8 in fd.GROUPS
    # f32 sums in another order: ~1e-7 relative
    assert rel(got, _twin_ref(q, k, v, counted)) < 1e-5


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_cfg()
    tok = port_tokenizer(make_tiny_tokenizer())
    return tpipe.Qwen3TTS.from_components(tok, cfg, tiny_weights(), None,
                                          None, "cpu", moe=MOE)


class FrameTap:
    """Every frame the engine generates (runtime/pipeline and serve call
    ``generate_frame`` eagerly on the CPU): the logits its first codebook
    was drawn from, its codes and which rows were valid."""

    def __init__(self, monkeypatch):
        self.frames = []
        inner = tpipe.generate_frame

        def tap(w, cfg, state, *a, **kw):
            logits = state.logits.clone()
            codes, valid = inner(w, cfg, state, *a, **kw)
            self.frames.append((logits, codes.clone(), valid.clone()))
            return codes, valid

        monkeypatch.setattr(tpipe, "generate_frame", tap)

    def stream(self, b):
        """(program logits [F, V], codes [F, 16]) of row b's valid frames."""
        got = [(lg[b], c[b]) for lg, c, v in self.frames if v[b]]
        return (torch.stack([g for g, _ in got]),
                torch.stack([c for _, c in got]))


def stream_rows(eng, text, codes):
    """The talker's input rows for a stream that served `codes` [F, 16]:
    its prefill, then one row a frame (the port's own embedding
    construction; what is under test is the stack above it)."""
    cfg, w = eng.talker_cfg, eng.talker_w
    toks = eng.tokenizer.encode_for_tts(text)
    pre = talker.build_prefill_inputs(
        w, cfg, torch.tensor([toks], dtype=torch.int32),
        torch.tensor([len(toks)], dtype=torch.int32),
        torch.zeros(1, cfg.hidden_size))
    from qwen3_tts_tpu_torch.models.code_predictor import frame_step_embedding
    rows = [pre.prefill_embd[0]]
    for f in range(codes.shape[0] - 1):
        trail = (pre.trailing_hidden[0, f] if f < int(pre.trailing_len[0])
                 else pre.tts_pad_embed[0])
        rows.append(frame_step_embedding(w, cfg, codes[f:f + 1],
                                         trail[None]))
    return torch.cat(rows), pre.prefill_embd.shape[1]


def served_error(eng, tap, texts, rows_of) -> float:
    worst = 0.0
    for i, text in enumerate(texts):
        logits, codes = tap.stream(rows_of[i])
        x, P = stream_rows(eng, text, codes)
        _, want = _ref_talker(eng.talker_w, x[None], program_rounding=True)
        worst = max(worst, rel(logits, want[0, P - 1:P - 1 + len(codes)]))
    return worst


def test_synthesize_batch_against_reference(engine, monkeypatch):
    tap = FrameTap(monkeypatch)
    trace.reset()
    res = engine.synthesize_batch(TEXTS, params=tpipe.TTSParams(
        max_audio_tokens=12, temperature=0.9, seed=3, print_timing=False))
    assert all(r.error_msg == "Vocoder not loaded" for r in res)
    assert served_error(engine, tap, TEXTS, range(len(TEXTS))) < LOGIT_TOL
    spans = [s for s in trace.spans() if s.name == "talker.moe"]
    assert spans and all(s.attrs["pairs"] % MOE.top_k == 0 for s in spans)
    a = spans[0].attrs
    assert a["rows"] >= a["pairs"] and 1 <= a["max_rows"] <= a["pairs"]
    c = trace.counters()
    assert c["moe.pairs"] == sum(s.attrs["pairs"] for s in spans)
    assert c["moe.rows"] == sum(s.attrs["rows"] for s in spans)


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
    # the requests join together, slot i taking request i
    assert served_error(engine, tap, TEXTS, range(len(TEXTS))) < LOGIT_TOL
    assert any(s.name == "talker.moe" for s in trace.spans())


def test_tolerances_see_bf16_expert_products(monkeypatch):
    """Each tolerance above fails a port that rounds the experts' products
    to bf16 where it states f32."""
    w = tiny_weights()
    h = torch.randn(37, 64, generator=torch.Generator().manual_seed(1))
    inner = moe.swiglu
    monkeypatch.setattr(moe, "swiglu", lambda *a: inner(*a).to(
        torch.bfloat16).float())
    assert op_error(h, w, MOE, l=2) > OP_TOL
    assert decode_error(w) > LOGIT_TOL


def test_guards(engine, monkeypatch):
    """The megakernel refuses an MoE talker (``auto`` takes the per-layer
    path), tp > 1 refuses it (no expert parallelism), and the engine wants
    the MoE settings exactly when the layers hold the MoE leaves."""
    cfg, w = engine.talker_cfg, engine.talker_w
    kv = init_kv_cache(cfg.n_layers, 2, 16, 1, cfg.head_dim, "cpu")
    assert not talker_fused.supported(cfg, 2, w, kv, torch.tensor(3), None,
                                      None)
    monkeypatch.setattr(tpipe, "mesh_dims", lambda mesh: (1, 2))
    with pytest.raises(ValueError, match="expert parallelism"):
        engine.shard(type("Mesh", (), {"device_type": "cpu"})())
    bare = {**w, "layers": {k: v for k, v in w["layers"].items()
                            if k != "moe"}}
    with pytest.raises(ValueError, match="MoEConfig"):
        tpipe.Qwen3TTS.from_components(None, cfg, bare, None, None, "cpu")
    assert tpipe.Qwen3TTS.from_components(
        None, cfg, bare, None, None, "cpu", moe=MOE).talker_w["layers"][
            "moe"] == MOE
    dense = W.init_talker_weights(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    with pytest.raises(ValueError, match="no w_router"):
        tpipe.Qwen3TTS.from_components(None, cfg, dense, None, None, "cpu",
                                       moe=MOE)
    # the same geometry check passes a dense talker of the kernel's ratios
    dcfg = dataclasses.replace(cfg, n_key_value_heads=2, hidden_size=32,
                               intermediate_size=96)
    assert talker_fused.supported(
        dcfg, 2, W.init_talker_weights(dcfg, torch.Generator().manual_seed(0),
                                       "cpu"),
        init_kv_cache(4, 2, 16, 2, 16, "cpu"), torch.tensor(3), None, None)
