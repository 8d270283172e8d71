"""Port parity: the code predictor.

- models.code_predictor.predict_codes (CPU = the XLA-path port) against
  the JAX XLA path at tiny dims: greedy exact, sampled exact with JAX's
  Gumbel draws fed in.
- ops.codepred_fused twin against the JAX Pallas megakernel run in
  interpret mode at the real dims (B=8, greedy).
- the QWEN3_TTS_CODEPRED switch, top_p < 1, and the mtp projection of the
  1.7B shape, against the JAX XLA path.
- the 1.7B shape on the twin: the mtp projection folded into f32 rows
  (codepred_fused.fold_mtp) against the JAX XLA path on the raw weights,
  and against the XLA-path port's projection.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.config import TalkerConfig  # noqa: E402
from qwen3_tts_tpu.models import code_predictor as jcp  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu.ops import codepred_fused as jcf  # noqa: E402
from qwen3_tts_tpu_torch.models import code_predictor as tcp  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.ops import codepred_fused as tcf  # noqa: E402

from .test_torch_config import port_cfg  # noqa: E402

CFG = tiny_talker_config()
TCFG = port_cfg(CFG)
B = 4
# logit margin that counts as a bf16 near-tie between two implementations
NEAR_TIE = 5e-2


@pytest.fixture(scope="module")
def tiny():
    jw = init_talker_weights(np.random.default_rng(2024), CFG)
    tw = W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    rng = np.random.default_rng(11)
    hidden = (rng.standard_normal((B, CFG.hidden_size))).astype(np.float32)
    cb0 = rng.integers(0, CFG.codec_vocab_size - 1024, B).astype(np.int32)
    return jw, tw, hidden, cb0


def _xla_path_noise(key, n_steps, shape):
    """The Gumbel draws behind predict_codes' categorical samples: one
    split per sampled codebook, in its order."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_predict_codes_matches_xla_path(tiny, greedy):
    jw, tw, hidden, cb0 = tiny
    key = jax.random.PRNGKey(5)
    want = jcp.predict_codes(jw, CFG, jnp.asarray(hidden), jnp.asarray(cb0),
                             jnp.float32(0.8), 20, key, greedy=greedy)
    noise = _xla_path_noise(key, CFG.n_codebooks - 1,
                            (B, CFG.code_pred_vocab_size))
    got = tcp.predict_codes(tw, TCFG, torch.from_numpy(hidden),
                            torch.from_numpy(cb0), 0.8, 20, greedy=greedy,
                            gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def impl():
    yield tcp.set_codepred_impl
    tcp.set_codepred_impl(None)


def _xla_path_pair(jw, tw, cfg, hidden, cb0, greedy, top_p=1.0, seed=5,
                   temperature=0.8):
    """(JAX XLA path codes, the port's predict_codes codes) on the same
    inputs, the port fed JAX's draws."""
    key = jax.random.PRNGKey(seed)
    want = jcp.predict_codes(jw, cfg, jnp.asarray(hidden), jnp.asarray(cb0),
                             jnp.float32(temperature), 20, key,
                             greedy=greedy, top_p=top_p)
    noise = _xla_path_noise(key, cfg.n_codebooks - 1,
                            (hidden.shape[0], cfg.code_pred_vocab_size))
    got = tcp.predict_codes(tw, port_cfg(cfg), torch.from_numpy(hidden),
                            torch.from_numpy(cb0), temperature, 20,
                            greedy=greedy, top_p=top_p,
                            gumbel=torch.from_numpy(noise))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("top_p", [0.9, 0.5])
def test_predict_codes_top_p_matches_xla_path(tiny, top_p):
    jw, tw, hidden, cb0 = tiny
    want, got = _xla_path_pair(jw, tw, CFG, hidden, cb0, False, top_p)
    np.testing.assert_array_equal(got, want)


def test_predict_codes_tiny_top_p_is_greedy(tiny):
    """top_p -> 0 keeps only each position's argmax: sampled draws give
    the JAX package's greedy codes."""
    jw, tw, hidden, cb0 = tiny
    want, _ = _xla_path_pair(jw, tw, CFG, hidden, cb0, True)
    for seed in (1, 2):
        got = tcp.predict_codes(tw, TCFG, torch.from_numpy(hidden),
                                torch.from_numpy(cb0), 0.8, 20,
                                torch.Generator().manual_seed(seed),
                                top_p=1e-6)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("how", ["auto", "xla", "env_auto", "env_xla",
                                 "env_unknown"])
def test_switch_on_cpu_takes_xla_path(tiny, impl, monkeypatch, how):
    """auto and xla on CPU tensors run the XLA-path port (never the
    kernel's wrapper); an unknown QWEN3_TTS_CODEPRED reads as auto."""
    jw, tw, hidden, cb0 = tiny
    want, _ = _xla_path_pair(jw, tw, CFG, hidden, cb0, True)
    if how.startswith("env_"):
        monkeypatch.setenv("QWEN3_TTS_CODEPRED", how[4:])
    else:
        impl(how)
    monkeypatch.setattr(tcf, "predict_codes_fused", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("took the kernel's wrapper")))
    got = tcp.predict_codes(tw, TCFG, torch.from_numpy(hidden),
                            torch.from_numpy(cb0), 0.8, 20, greedy=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_switch_fused_interpret_raises(tiny, impl, monkeypatch):
    _, tw, hidden, cb0 = tiny
    with pytest.raises(ValueError, match="'fused'"):
        impl("fused_interpret")
    impl(None)
    monkeypatch.setenv("QWEN3_TTS_CODEPRED", "fused_interpret")
    with pytest.raises(ValueError, match="'fused'"):
        tcp.predict_codes(tw, TCFG, torch.from_numpy(hidden),
                          torch.from_numpy(cb0), 0.8, 20, greedy=True)


@pytest.fixture(scope="module")
def real():
    """Code-predictor weights at the 0.6B dims (the kernel's), drawn by the
    port (``real_17b`` makes the 1.7B-shaped copy)."""
    gen = torch.Generator().manual_seed(3)
    cfg = TCFG.__class__(text_vocab_size=16, n_layers=1)
    w = W.init_talker_weights(cfg, gen, "cpu")
    w = {"codec_embd": w["codec_embd"], "code_pred": w["code_pred"]}
    rng = np.random.default_rng(4)
    hidden = (rng.standard_normal((2, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    cb0 = rng.integers(0, cfg.code_pred_vocab_size, 2).astype(np.int32)
    return cfg, w, torch.from_numpy(hidden), torch.from_numpy(cb0)


@pytest.fixture(scope="module")
def real_17b(real):
    """The 1.7B-shaped copy of ``real``: the same code predictor behind a
    2,048-wide talker, so codec_embd and code_pred.embd are 2,048 wide and
    an mtp_w (and a non-zero mtp_b) projects them into the code
    predictor; folded (``fold_mtp``) and not."""
    cfg, w, _, cb0 = real
    cfg = dataclasses.replace(cfg, hidden_size=2048)
    gen = torch.Generator().manual_seed(17)

    def rn(*shape, std=0.02):
        return (torch.randn(shape, generator=gen) * std).to(torch.bfloat16)

    cp = dict(w["code_pred"], embd=rn(15, cfg.code_pred_vocab_size, 2048),
              mtp_w=rn(2048, cfg.code_pred_hidden_size),
              mtp_b=torch.randn(cfg.code_pred_hidden_size, generator=gen)
              * 0.02)
    raw = {"codec_embd": rn(cfg.codec_vocab_size, 2048), "code_pred": cp}
    hidden = torch.randn(2, 2048, generator=gen) * 0.5
    return cfg, raw, tcf.fold_mtp(raw, cfg), hidden, cb0


def test_fold_mtp_rows_equal_the_xla_paths_projection(real, real_17b):
    """The folded f32 rows are the XLA path's projection of the raw rows
    it gathers (project_mtp of bf16 rows, the bias added), up to f32
    summation order; the raw tables stay, the kernel takes the folded tree
    and refuses the raw one; a tree without an mtp_w, or at other dims,
    comes back as it is."""
    cfg, raw, folded, _, _ = real_17b
    cp, fcp = raw["code_pred"], folded["code_pred"]
    assert set(fcp) - set(cp) == set(tcf.FOLDED)
    assert fcp["embd"] is cp["embd"] and folded["codec_embd"] is raw[
        "codec_embd"]
    rows = torch.tensor([0, 5, 1023, 2047])
    tol = dict(rtol=1e-5, atol=1e-6)
    for s in (0, 7, 14):
        want = tcf.project_mtp(cp, cp["embd"][s][rows].float())
        got = fcp["embd_mtp"][s][rows]
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, **tol)
    codes = torch.tensor([0, 17, cfg.codec_vocab_size - 1])
    torch.testing.assert_close(
        fcp["codec_embd_mtp"][codes],
        tcf.project_mtp(cp, raw["codec_embd"][codes].float()), **tol)
    assert fcp["embd_mtp"].shape == (15, cfg.code_pred_vocab_size,
                                     cfg.code_pred_hidden_size)
    assert tcf.supported(cfg, 2, folded) and not tcf.supported(cfg, 2, raw)
    _, w, _, _ = real
    assert tcf.fold_mtp(w, cfg) is w
    narrow = dataclasses.replace(cfg, code_pred_layers=4)
    assert tcf.fold_mtp(raw, narrow) is raw


def _scores(logits, temperature, noise):
    """What each position's code is the first argmax of: the logits
    (greedy), or logits / T + the Gumbel draws (sampled, top-k 50)."""
    if noise is None:
        return logits
    keep = logits >= torch.topk(logits, 50).values[..., -1:]
    return torch.where(keep, logits / temperature, -1e30) + noise


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_twin_with_mtp_matches_xla_path(real_17b, impl, greedy):
    """At the 1.7B shape the twin (folded rows, position 0 projected)
    against the XLA-path port (the projection of each gathered row), fed
    the same Gumbel draws: codes agree, and a stream that parts does so
    first at a bf16 near-tie of the XLA path's scores."""
    cfg, raw, folded, hidden, cb0 = real_17b
    V = cfg.code_pred_vocab_size
    noise = None if greedy else torch.from_numpy(
        np.random.default_rng(9).gumbel(size=(15, 2, V)).astype(np.float32))
    lt, lx = torch.empty(15, 2, V), torch.empty(15, 2, V)
    got = tcf.predict_codes_twin(folded, cfg, hidden, cb0, 0.8, 50,
                                 greedy=greedy, gumbel=noise, logits_out=lt)
    impl("xla")
    ref = tcp.predict_codes(raw, cfg, hidden, cb0, 0.8, 50, greedy=greedy,
                            gumbel=noise, logits_out=lx)
    margins = _near_tie_divergences(got.numpy(), ref.numpy(),
                                    _scores(lx, 0.8, noise).numpy())
    assert (got == ref).all(dim=1).float().mean() >= 0.5, margins
    assert all(m <= NEAR_TIE for m in margins), margins


def _to_jax(tree):
    """A port weight tree as the JAX package holds it: the same keys,
    bf16 and f32 arrays of the same values."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree is None:
        return None
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_twin_with_mtp_matches_jax_xla_path(real_17b, greedy):
    """At the 1.7B shape the twin on the folded f32 rows against the JAX
    package's XLA path on the raw weights (each gathered row projected
    through mtp_w), the twin fed JAX's Gumbel draws: codes agree, and a
    stream that parts does so first at a bf16 near-tie of the twin's
    scores."""
    cfg, raw, folded, hidden, cb0 = real_17b
    key = jax.random.PRNGKey(19)
    jcfg = TalkerConfig(**dataclasses.asdict(cfg))
    want = np.asarray(jcp.predict_codes(
        _to_jax(raw), jcfg, jnp.asarray(hidden.numpy()),
        jnp.asarray(cb0.numpy()), jnp.float32(0.8), 50, key, greedy=greedy))
    noise = None if greedy else torch.from_numpy(_xla_path_noise(
        key, cfg.n_codebooks - 1, (2, cfg.code_pred_vocab_size)))
    lt = torch.empty(15, 2, cfg.code_pred_vocab_size)
    got = tcf.predict_codes_twin(folded, cfg, hidden, cb0, 0.8, 50,
                                 greedy=greedy, gumbel=noise, logits_out=lt)
    margins = _near_tie_divergences(want, got.numpy(),
                                    _scores(lt, 0.8, noise).numpy())
    assert (got.numpy() == want).all(axis=1).mean() >= 0.5, margins
    assert all(m <= NEAR_TIE for m in margins), margins


def test_switch_fused_on_cpu_runs_the_twin_with_mtp(real_17b, impl,
                                                    monkeypatch):
    """fused on an mtp tree with its folded rows runs the twin on CPU
    tensors; auto there keeps the XLA path."""
    cfg, _, folded, hidden, cb0 = real_17b
    ran = []
    twin = tcf.predict_codes_twin
    monkeypatch.setattr(tcf, "predict_codes_twin",
                        lambda *a, **k: ran.append(1) or twin(*a, **k))
    impl("fused")
    got = tcp.predict_codes(folded, cfg, hidden, cb0, 0.8, 20, greedy=True)
    assert ran == [1]
    np.testing.assert_array_equal(
        got.numpy(),
        twin(folded, cfg, hidden, cb0, 0.8, 20, greedy=True).numpy())
    impl("auto")
    tcp.predict_codes(folded, cfg, hidden, cb0, 0.8, 20, greedy=True)
    assert ran == [1]


def test_switch_fused_on_cpu_runs_the_twin(real, impl, monkeypatch):
    cfg, w, hidden, cb0 = real
    assert tcf.supported(cfg, 2, w)
    ran = []
    twin = tcf.predict_codes_twin
    monkeypatch.setattr(tcf, "predict_codes_twin",
                        lambda *a, **k: ran.append(1) or twin(*a, **k))
    impl("fused")
    got = tcp.predict_codes(w, cfg, hidden, cb0, 0.8, 20, greedy=True)
    assert ran == [1]
    np.testing.assert_array_equal(
        got.numpy(), twin(w, cfg, hidden, cb0, 0.8, 20, greedy=True).numpy())


@pytest.mark.parametrize("case", ["top_p", "mtp", "f32_weights", "dims"])
def test_switch_fused_refuses_what_the_kernel_does_not_serve(real, impl,
                                                             case):
    """fused raises, on either device, where auto would take the XLA path:
    top_p < 1, an mtp projection without its folded rows (fold_mtp),
    weights not in bf16, other dims."""
    cfg, w, hidden, cb0 = real
    top_p = 0.9 if case == "top_p" else 1.0
    if case == "mtp":
        w = dict(w, code_pred=dict(w["code_pred"], mtp_w=torch.zeros(
            cfg.hidden_size, cfg.code_pred_hidden_size)))
    elif case == "f32_weights":
        cp = w["code_pred"]
        w = dict(w, code_pred=dict(cp, layers=dict(
            cp["layers"], wo=cp["layers"]["wo"].float())))
    elif case == "dims":
        cfg = dataclasses.replace(cfg, code_pred_layers=4)
    assert tcf.supported(cfg, 2, w) == (case == "top_p")
    impl("fused")
    with pytest.raises(ValueError, match="QWEN3_TTS_CODEPRED=fused"):
        tcp.predict_codes(w, cfg, hidden, cb0, 0.8, 20, top_p=top_p)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_mtp_config_matches_xla_path(greedy):
    """A tiny config with code_pred_hidden_size != hidden_size (the 1.7B
    shape: an mtp_w projects talker space into the code predictor's) under
    auto, against the JAX XLA path."""
    cfg = dataclasses.replace(CFG, hidden_size=96)
    jw = init_talker_weights(np.random.default_rng(7), cfg)
    assert jw["code_pred"]["mtp_w"].shape == (96, 64)
    tw = W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    rng = np.random.default_rng(8)
    hidden = rng.standard_normal((B, 96)).astype(np.float32)
    cb0 = rng.integers(0, 2048, B).astype(np.int32)
    want, got = _xla_path_pair(jw, tw, cfg, hidden, cb0, greedy)
    np.testing.assert_array_equal(got, want)


def test_frame_step_embedding(tiny):
    jw, tw, _, _ = tiny
    rng = np.random.default_rng(12)
    codes = np.concatenate(
        [rng.integers(0, 2048, (B, 1)),
         rng.integers(0, CFG.code_pred_vocab_size, (B, 15))], 1).astype(
             np.int32)
    trail = rng.standard_normal((B, CFG.hidden_size)).astype(np.float32)
    want = jcp.frame_step_embedding(jw, CFG, jnp.asarray(codes),
                                    jnp.asarray(trail))
    got = tcp.frame_step_embedding(tw, TCFG, torch.from_numpy(codes),
                                   torch.from_numpy(trail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_twin_greedy_equals_xla_path_at_tiny_dims(tiny):
    """The twin keeps attention probabilities in f32 where the XLA path
    rounds them to bf16; at tiny dims that moves no argmax."""
    _, tw, hidden, cb0 = tiny
    args = (tw, TCFG, torch.from_numpy(hidden), torch.from_numpy(cb0), 0.8,
            20)
    np.testing.assert_array_equal(
        tcf.predict_codes_twin(*args, greedy=True).numpy(),
        tcp.predict_codes(*args, greedy=True).numpy())


def _real_code_pred_weights(seed=0, scale=0.02):
    """Code-predictor weights at the real dims (the kernel's only inputs):
    bf16 matrices, unit norms, as init_talker_weights_fast draws them."""
    cfg = TalkerConfig()
    rng = np.random.default_rng(seed)
    L, H, I = cfg.code_pred_layers, cfg.code_pred_hidden_size, 3072
    qkv = (cfg.code_pred_n_attention_heads + 2 * cfg.code_pred_n_kv_heads) \
        * cfg.code_pred_head_dim

    def rnd(*shape):
        return jnp.asarray(rng.standard_normal(shape, np.float32) * scale,
                           jnp.bfloat16)

    ones = lambda *shape: jnp.ones(shape, jnp.float32)  # noqa: E731
    w = {"codec_embd": rnd(cfg.codec_vocab_size, H),
         "code_pred": {
             "layers": {"attn_norm": ones(L, H), "wqkv": rnd(L, H, qkv),
                        "wo": rnd(L, 2048, H), "q_norm": ones(L, 128),
                        "k_norm": ones(L, 128), "ffn_norm": ones(L, H),
                        "w_gu": rnd(L, H, 2 * I), "w_down": rnd(L, I, H)},
             "output_norm": ones(H),
             "embd": rnd(15, cfg.code_pred_vocab_size, H),
             "heads": rnd(15, H, cfg.code_pred_vocab_size),
             "mtp_w": None, "mtp_b": None}}
    return cfg, w


def _near_tie_divergences(got, ref, logits):
    """First-divergence margins of the reference's logits per differing
    stream (the fed-back codes agree before that position)."""
    margins = []
    for b in np.nonzero((got != ref).any(axis=1))[0]:
        p = int(np.nonzero(got[b] != ref[b])[0][0])
        margins.append(float(logits[p, b, ref[b, p]] - logits[p, b, got[b, p]]))
    return margins


def test_twin_matches_pallas_kernel_interpret():
    """Twin vs the JAX megakernel in interpret mode, real dims, B=8,
    greedy: codes agree, and a stream that differs does so first at a
    bf16 near-tie of the twin's logits."""
    cfg, jw = _real_code_pred_weights()
    tw = W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    rng = np.random.default_rng(1)
    hidden = (rng.standard_normal((8, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    cb0 = rng.integers(0, cfg.code_pred_vocab_size, 8).astype(np.int32)
    want = np.asarray(jcf.predict_codes_fused(
        jw, cfg, jnp.asarray(hidden), jnp.asarray(cb0), jnp.float32(0.9), 50,
        jax.random.PRNGKey(3), greedy=True, interpret=True))
    logits = torch.empty(15, 8, cfg.code_pred_vocab_size)
    got = tcf.predict_codes_twin(tw, port_cfg(cfg),
                                 torch.from_numpy(hidden),
                                 torch.from_numpy(cb0), 0.9, 50, greedy=True,
                                 logits_out=logits).numpy()
    margins = _near_tie_divergences(want, got, logits.numpy())
    assert (got == want).all(axis=1).mean() >= 0.5, margins
    assert all(m <= NEAR_TIE for m in margins), margins


def test_cpu_wrapper_runs_twin(tiny):
    _, tw, hidden, cb0 = tiny
    args = (tw, TCFG, torch.from_numpy(hidden), torch.from_numpy(cb0), 0.8,
            20)
    np.testing.assert_array_equal(
        tcf.predict_codes_fused(*args, greedy=True).numpy(),
        tcf.predict_codes_twin(*args, greedy=True).numpy())



def test_kernel_scratch_is_allocated_once_and_holds_every_product():
    """The kernel's per-(device, batch) scratch: the partial sums hold the
    largest product's K splits (wo's and down's 16 x 1,024 columns, the
    kernel's static_assert on PART_COLS) and then the grid barrier's word, zero before the first frame; the K/V
    cache is [L, B, NKV, CTX, D], and a second frame of the same batch
    gets the same tensors."""
    B = 3
    sc = tcf._scratch(torch.device("cpu"), B, 1e6)
    assert tcf.PART_COLS == 16384
    assert sc["part"].numel() == tcf.PART_COLS * B + 4
    assert not sc["part"][-4:].any()
    assert sc["kc"].shape == (tcf.L, B, tcf.NKV, tcf.CTX, tcf.D)
    assert sc["rope_c"].shape == (tcf.CTX, tcf.D)
    again = tcf._scratch(torch.device("cpu"), B, 1e6)
    assert all(again[k] is sc[k] for k in sc)
