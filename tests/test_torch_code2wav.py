"""Qwen3-Omni's Code2Wav on the port (models/vocoder.py with the
"code2wav" entry; models/weights.init_code2wav_weights), against the plain
reference ``code2wav`` of tests/omni_talker_reference.py, which is itself
held against transformers' ``Qwen3OmniMoeCode2Wav`` where transformers is
installed; at a small size (hidden 32, 2 layers of 4 heads, SwiGLU 48,
sliding window 5 over 12 frames, decoder 32 wide, rates 2, 2, 2, 2), in
float32 with the exact sin^2.

Tolerance (relative L2 over the audio): the three differ by float32
summation order, 1.07e-6 to 1.09e-6 here. TOL sits 9x over that and under
what each part of Code2Wav that differs from the 12 Hz decoder moves: the
tanh GELU in the ConvNeXt blocks reads 2.5e-4, attention past the window
0.44 (``test_tolerance_sees_the_window_and_the_gelu``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu_torch.config import Code2WavConfig  # noqa: E402
from qwen3_tts_tpu_torch.models import vocoder as V  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe  # noqa: E402
from qwen3_tts_tpu_torch.runtime import serve as tserve  # noqa: E402

from . import omni_talker_reference as ref  # noqa: E402
from .test_tokenizer import make_tiny_tokenizer  # noqa: E402
from .test_torch_config import port_tokenizer  # noqa: E402
from .test_torch_moe import (  # noqa: E402
    MOE, TEXTS, rel, tiny_cfg, tiny_weights)

TOL = 1e-5
VCFG = dataclasses.replace(V.tiny_vocoder_config(), codebook_size=2048,
                           codebook_dim=32, hidden_dim=32, latent_dim=32,
                           n_pre_tfm_layers=2, n_heads=4)
C2W = Code2WavConfig(sliding_window=5, intermediate_size=48)


@pytest.fixture(autouse=True)
def exact_sin2():
    """The reference's sin^2 is the exact sine (the port's default is a
    polynomial that differs by rounding)."""
    old = V.snake_sin2_impl()
    V.set_snake_sin2_impl("exact")
    yield
    V.set_snake_sin2_impl(old)


def tiny_code2wav(seed=0):
    return W.init_code2wav_weights(VCFG, torch.Generator().manual_seed(seed),
                                   "cpu", C2W, dtype=None)


def codes_of(B, T, seed=1):
    return torch.randint(0, VCFG.codebook_size, (B, T, VCFG.n_codebooks),
                         generator=torch.Generator().manual_seed(seed))


def reference(w, codes, trim="both", **kw):
    args = dict(heads=VCFG.n_heads, eps=VCFG.rms_norm_eps,
                theta=VCFG.rope_theta, window=C2W.sliding_window,
                rates=VCFG.upsample_rates, trim=trim)
    return ref.code2wav(w, codes, **{**args, **kw})


def published_module(w):
    """transformers' Qwen3OmniMoeCode2Wav at VCFG / C2W holding `w`."""
    mod = pytest.importorskip(
        "transformers.models.qwen3_omni_moe.modeling_qwen3_omni_moe")
    from transformers.models.qwen3_omni_moe.configuration_qwen3_omni_moe \
        import Qwen3OmniMoeCode2WavConfig
    cfg = Qwen3OmniMoeCode2WavConfig(
        codebook_size=VCFG.codebook_size, hidden_size=VCFG.hidden_dim,
        num_attention_heads=VCFG.n_heads, num_key_value_heads=VCFG.n_heads,
        sliding_window=C2W.sliding_window,
        intermediate_size=C2W.intermediate_size,
        num_hidden_layers=VCFG.n_pre_tfm_layers,
        num_quantizers=VCFG.n_codebooks, upsample_rates=VCFG.upsample_rates,
        upsampling_ratios=(2, 2), decoder_dim=VCFG.decoder_dim,
        rms_norm_eps=VCFG.rms_norm_eps, rope_theta=VCFG.rope_theta)
    cfg._attn_implementation = "eager"
    m = mod.Qwen3OmniMoeCode2Wav(cfg).eval()
    lw, sd = w["pre_tfm"]["layers"], {"code_embedding.weight":
                                      w["code_embedding"]}
    for i in range(VCFG.n_pre_tfm_layers):
        p = f"pre_transformer.layers.{i}."
        sd[p + "input_layernorm.weight"] = lw["attn_norm"][i]
        sd[p + "post_attention_layernorm.weight"] = lw["ffn_norm"][i]
        sd[p + "self_attn_layer_scale.scale"] = lw["attn_scale"][i]
        sd[p + "mlp_layer_scale.scale"] = lw["ffn_scale"][i]
        for name, key in (
                ("self_attn.q_proj", "wq"), ("self_attn.k_proj", "wk"),
                ("self_attn.v_proj", "wv"), ("self_attn.o_proj", "wo"),
                ("mlp.gate_proj", "w_gate"), ("mlp.up_proj", "w_up"),
                ("mlp.down_proj", "w_down")):
            sd[p + name + ".weight"] = lw[key][i].t()
    sd["pre_transformer.norm.weight"] = w["pre_tfm"]["norm"]
    for i, u in enumerate(w["upsample"]):
        p = f"upsample.{i}."
        sd.update({p + "0.conv.weight": u["conv_t_w"],
                   p + "0.conv.bias": u["conv_t_b"],
                   p + "1.dwconv.conv.weight": u["dw_w"],
                   p + "1.dwconv.conv.bias": u["dw_b"],
                   p + "1.norm.weight": u["ln_w"],
                   p + "1.norm.bias": u["ln_b"],
                   p + "1.pwconv1.weight": u["pw1_w"].t(),
                   p + "1.pwconv1.bias": u["pw1_b"],
                   p + "1.pwconv2.weight": u["pw2_w"].t(),
                   p + "1.pwconv2.bias": u["pw2_b"],
                   p + "1.gamma": u["gamma"]})
    sd["decoder.0.conv.weight"], sd["decoder.0.conv.bias"] = (w["dec0_w"],
                                                              w["dec0_b"])
    for i, d in enumerate(w["dec_blocks"]):
        p = f"decoder.{i + 1}.block."
        sd.update({p + "0.alpha": d["snake_a"], p + "0.beta": d["snake_b"],
                   p + "1.conv.weight": d["conv_t_w"],
                   p + "1.conv.bias": d["conv_t_b"]})
        for j, r in enumerate(d["res"]):
            q = p + f"{j + 2}."
            sd.update({q + "act1.alpha": r["a1"], q + "act1.beta": r["b1"],
                       q + "conv1.conv.weight": r["c1_w"],
                       q + "conv1.conv.bias": r["c1_b"],
                       q + "act2.alpha": r["a2"], q + "act2.beta": r["b2"],
                       q + "conv2.conv.weight": r["c2_w"],
                       q + "conv2.conv.bias": r["c2_b"]})
    n = len(w["dec_blocks"])
    sd.update({f"decoder.{n + 1}.alpha": w["dec5_a"],
               f"decoder.{n + 1}.beta": w["dec5_b"],
               f"decoder.{n + 2}.conv.weight": w["dec6_w"],
               f"decoder.{n + 2}.conv.bias": w["dec6_b"]})
    m.load_state_dict(sd, strict=True)
    return m


def test_reference_matches_the_published_module():
    w, codes = tiny_code2wav(), codes_of(2, 12)
    with torch.no_grad():
        published = published_module(w)(codes.transpose(1, 2))[:, 0]
    assert rel(reference(w, codes), published) < TOL


@pytest.mark.parametrize("trim", ["both", "causal"])
def test_port_matches_reference(trim):
    """The port's decode (the full-sequence cut and the streaming one),
    over more frames than the window."""
    w, codes = tiny_code2wav(), codes_of(2, 12)
    got = V.vocoder_decode(V.pack_kernel_weights(w), VCFG, codes, trim)
    want = reference(w, codes, trim)
    assert got.shape == want.shape
    assert rel(got, want) < TOL


def test_tolerance_sees_the_window_and_the_gelu():
    w, codes = tiny_code2wav(), codes_of(2, 12)
    got = V.vocoder_decode(V.pack_kernel_weights(w), VCFG, codes)
    assert rel(got, reference(w, codes, window=None)) > TOL
    assert rel(got, reference(w, codes, gelu="tanh")) > TOL


def test_clamp_not_tanh():
    """Code2Wav clamps its waveform: a loud output reaches +-1 exactly."""
    w = tiny_code2wav()
    w["dec6_w"] = w["dec6_w"] * 1e3
    audio = V.vocoder_decode(V.pack_kernel_weights(w), VCFG, codes_of(1, 6))
    assert audio.abs().max().item() == 1.0
    assert (audio.abs() == 1.0).float().mean().item() > 0.3


@pytest.fixture(scope="module")
def engine():
    tok = port_tokenizer(make_tiny_tokenizer())
    return tpipe.Qwen3TTS.from_components(tok, tiny_cfg(), tiny_weights(),
                                          VCFG, tiny_code2wav(), "cpu",
                                          moe=MOE)


def _tap_decodes(eng, monkeypatch):
    """Every vocoder batch the engine decodes: (codes, audio as f32)."""
    seen, inner = [], eng._decode_chunk_batch

    def decode(codes, *a, **kw):
        out = inner(codes, *a, **kw)
        audio = torch.as_tensor(np.asarray(out.cpu() if hasattr(out, "cpu")
                                           else out))
        if audio.dtype == torch.int16:
            audio = audio.float() / 32767.0
        seen.append((torch.as_tensor(np.array(codes, copy=True)), audio))
        return out

    monkeypatch.setattr(eng, "_decode_chunk_batch", decode)
    return seen


def _check_decodes(seen):
    """Each decode is the reference's streaming decode of its codes (each
    row a chunk alone, the causal cut), within 2 int16 steps."""
    assert seen
    for codes, audio in seen:
        want = reference(tiny_code2wav(), codes, "causal")
        assert audio.shape == want.shape
        assert (audio - want).abs().max().item() <= 2.0 / 32767


def test_engine_lockstep_and_serving_decode_code2wav(engine, monkeypatch):
    """The MoE talker's engine with Code2Wav as its vocoder, through
    synthesize_batch and ContinuousBatcher: every request succeeds with
    n_frames * samples_per_frame samples, and every vocoder batch is the
    reference's decode of its codes."""
    seen = _tap_decodes(engine, monkeypatch)
    res = engine.synthesize_batch(TEXTS, params=tpipe.TTSParams(
        max_audio_tokens=12, temperature=0.9, seed=3, print_timing=False))
    assert all(r.success for r in res)
    assert all(len(r.audio) == r.n_frames * VCFG.samples_per_frame
               for r in res)
    _check_decodes(seen)
    seen.clear()
    cb = tserve.ContinuousBatcher(engine, n_slots=2, params=tpipe.TTSParams(
        max_audio_tokens=12, temperature=0.9, seed=5, print_timing=False),
        max_frames=48)
    rids = [cb.submit(t) for t in TEXTS]
    out = cb.run_all()
    assert all(out[r].success and len(out[r].audio) > 0 for r in rids)
    _check_decodes(seen)


def test_settings_entry_survives_the_engine(engine):
    """The "code2wav" entry rides the tree through the engine's packing
    and its tree maps, and keys the engine's graphs apart from a 12 Hz
    decoder's of the same VocoderConfig."""
    assert engine.voc_w["code2wav"] == C2W
    assert tpipe._tree_map(torch.clone, engine.voc_w)["code2wav"] == C2W
    assert isinstance(tpipe._first_leaf(engine.voc_w), torch.Tensor)
    dense = tpipe.Qwen3TTS.from_components(
        engine.tokenizer, engine.talker_cfg, engine.talker_w, VCFG,
        W.init_vocoder_weights(VCFG, torch.Generator().manual_seed(0), "cpu",
                               dtype=None), "cpu")
    assert dense.model_tag() != engine.model_tag()
