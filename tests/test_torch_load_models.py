"""Loading a model directory into the port: converter-built GGUF files
(tools/convert_checkpoints.py over synthetic HF checkpoints, in f32 and
q8_0) give, bitwise, the trees that the JAX loaders give carried across
by tree_from_numpy; a loaded engine's greedy codes are the JAX engine's;
a file with the 1.7B shape's mtp projection loads and runs the code
predictor's XLA path; low-memory mode decodes the same audio; and without
a card, loading for the card fails."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
pytest.importorskip("safetensors.numpy")

from qwen3_tts_tpu.config import (SpeakerEncoderConfig as JSpkCfg,  # noqa: E402
                                  TalkerConfig as JTalkerCfg,
                                  VocoderConfig as JVocCfg)
from qwen3_tts_tpu.io.gguf import GGUFReader as JReader  # noqa: E402
from qwen3_tts_tpu.models import speaker_encoder as jspk  # noqa: E402
from qwen3_tts_tpu.models import talker as jtalker  # noqa: E402
from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.models import weights as JW  # noqa: E402
from qwen3_tts_tpu.runtime import generate as jgen  # noqa: E402
from qwen3_tts_tpu.runtime import pipeline as jpipe  # noqa: E402
from qwen3_tts_tpu_torch import cli  # noqa: E402
from qwen3_tts_tpu_torch.config import (SpeakerEncoderConfig,  # noqa: E402
                                        TalkerConfig, VocoderConfig)
from qwen3_tts_tpu_torch.io import gguf as tg  # noqa: E402
from qwen3_tts_tpu_torch.models import code_predictor  # noqa: E402
from qwen3_tts_tpu_torch.models import speaker_encoder as tspk  # noqa: E402
from qwen3_tts_tpu_torch.models import talker as ttalker  # noqa: E402
from qwen3_tts_tpu_torch.models import vocoder as tvoc  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.ops import codepred_fused  # noqa: E402
from qwen3_tts_tpu_torch.runtime import generate as tgen  # noqa: E402
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe  # noqa: E402
from qwen3_tts_tpu_torch.tools import convert_checkpoints as tcc  # noqa: E402

from .test_converter import (make_codec_checkpoint,  # noqa: E402
                             make_tts_checkpoint)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import convert_checkpoints as cc  # noqa: E402

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

# special ids inside the synthetic model's vocabularies (codec 128, text
# 96), so that every id the prompt embeds names a row of the tables
SPECIAL_IDS = {"codec_pad_id": 120, "codec_bos_id": 121,
               "codec_eos_token_id": 122, "codec_think_id": 123,
               "codec_nothink_id": 124, "codec_think_bos_id": 125,
               "codec_think_eos_id": 126, "english_language_id": 127,
               "tts_bos_token_id": 93, "tts_eos_token_id": 94,
               "tts_pad_token_id": 95}
TEXT = "a b a b a"
FRAMES = 8


def _converted_dir(root: Path, out_type: str, seed: int) -> str:
    rng = np.random.default_rng(seed)
    tts, codec, mdir = root / "hf_tts", root / "hf_codec", root / "models"
    for d in (tts, codec, mdir):
        d.mkdir()
    make_tts_checkpoint(tts, rng)
    cfg = json.loads((tts / "config.json").read_text())
    cfg["talker_config"].update(SPECIAL_IDS)
    (tts / "config.json").write_text(json.dumps(cfg))
    make_codec_checkpoint(codec, rng)
    cc.convert_tts(tts, root / "tts.gguf", out_type)
    # the converter writes no BOS id; the vocabulary has <|im_start|> at 4
    _copy_with_metadata(root / "tts.gguf", mdir / tpipe.TTS_FILE,
                        {"tokenizer.ggml.bos_token_id": 4})
    cc.convert_codec(codec, mdir / tpipe.CODEC_FILE, out_type)
    return str(mdir)


def _copy_with_metadata(src, dst, extra: dict) -> None:
    """A GGUF copy with more metadata; tensor payloads copied as bytes."""
    with tg.GGUFReader(str(src)) as r:
        w = tg.GGUFWriter(r.get("general.architecture"))
        for key, value in {**r.metadata, **extra}.items():
            if key != "general.architecture":
                w.add(key, value)
        for name, info in r.tensors.items():
            w._tensors.append((name, info.shape, info.ggml_type,
                               bytes(r.raw_tensor(name))))
        w.write(str(dst))


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    out = {}
    for i, out_type in enumerate(("f32", "q8_0")):
        out[out_type] = _converted_dir(
            tmp_path_factory.mktemp(f"models_{out_type}"), out_type, 300 + i)
    return out


def assert_trees_bitwise(got, want):
    chip_smoke._check_bits(got, want, torch.device("cpu"), "loaded")


def _jax_tree(tree):
    return W.tree_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("out_type", ["f32", "q8_0"])
def test_talker_weights_bitwise(model_dirs, out_type):
    path = f"{model_dirs[out_type]}/{tpipe.TTS_FILE}"
    with JReader(path) as r:
        want = _jax_tree(JW.load_talker_weights(r, JTalkerCfg.from_gguf(r)))
    with tg.GGUFReader(path) as r:
        types = {info.ggml_type for info in r.tensors.values()}
        got = W.load_talker_weights(r, TalkerConfig.from_gguf(r), "cpu")
    if out_type == "q8_0":
        assert {tg.GGML_Q8_0, tg.GGML_F16, tg.GGML_F32} <= types
    assert got["code_pred"]["mtp_w"] is None
    assert_trees_bitwise(got, want)


@pytest.mark.parametrize("out_type", ["f32", "q8_0"])
def test_vocoder_weights_bitwise(model_dirs, out_type):
    path = f"{model_dirs[out_type]}/{tpipe.CODEC_FILE}"
    with JReader(path) as r:
        want = _jax_tree(jvoc.load_vocoder_weights(r, JVocCfg.from_gguf(r)))
    with tg.GGUFReader(path) as r:
        got = tvoc.load_vocoder_weights(r, VocoderConfig.from_gguf(r), "cpu")
    assert_trees_bitwise(got, want)


@pytest.mark.parametrize("out_type", ["f32", "q8_0"])
def test_speaker_encoder_weights_bitwise(model_dirs, out_type):
    path = f"{model_dirs[out_type]}/{tpipe.TTS_FILE}"
    with JReader(path) as r:
        want = _jax_tree(jspk.load_speaker_encoder_weights(
            r, JSpkCfg.from_gguf(r)))
    with tg.GGUFReader(path) as r:
        got = tspk.load_speaker_encoder_weights(
            r, SpeakerEncoderConfig.from_gguf(r), "cpu")
    assert_trees_bitwise(got, want)


@pytest.mark.parametrize("out_type", ["f32", "q8_0"])
def test_port_converter_output_loads_bitwise(tmp_path, out_type):
    """The same checkpoint converted by the port's converter
    (qwen3_tts_tpu_torch/tools) and by tools/convert_checkpoints.py loads
    into bitwise the same talker, speaker-encoder and vocoder trees."""
    rng = np.random.default_rng(320)
    tts, codec = tmp_path / "hf_tts", tmp_path / "hf_codec"
    tts.mkdir()
    codec.mkdir()
    make_tts_checkpoint(tts, rng)
    make_codec_checkpoint(codec, rng)
    trees = []
    for i, conv in enumerate((cc, tcc)):
        d = tmp_path / f"out{i}"
        d.mkdir()
        conv.convert_tts(tts, d / "tts.gguf", out_type)
        conv.convert_codec(codec, d / "codec.gguf", out_type)
        with tg.GGUFReader(str(d / "tts.gguf")) as r:
            talker_w = W.load_talker_weights(r, TalkerConfig.from_gguf(r),
                                             "cpu")
            spk_w = tspk.load_speaker_encoder_weights(
                r, SpeakerEncoderConfig.from_gguf(r), "cpu")
        with tg.GGUFReader(str(d / "codec.gguf")) as r:
            voc_w = tvoc.load_vocoder_weights(r, VocoderConfig.from_gguf(r),
                                              "cpu")
        trees.append((talker_w, spk_w, voc_w))
    for got, want in zip(*trees):
        assert_trees_bitwise(got, want)


def test_codebook_usage_normalised_as_jax(tmp_path):
    """A codec file that still carries usage tensors: the codebook is
    divided by clamp(usage, 1e-5) as the JAX loader divides it."""
    rng = np.random.default_rng(311)
    w = tg.GGUFWriter("t")
    w.add_tensor("cb", rng.standard_normal((16, 8)).astype(np.float32))
    usage = np.abs(rng.standard_normal(16)).astype(np.float32)
    usage[3] = 0.0
    w.add_tensor("usage", usage)
    w.add_tensor("plain", rng.standard_normal((16, 8)).astype(np.float32))
    path = str(tmp_path / "cb.gguf")
    w.write(path)
    with JReader(path) as r:
        want = [np.asarray(jvoc._maybe_normalize_codebook(r, "cb", "usage")),
                np.asarray(jvoc._maybe_normalize_codebook(r, "plain", "x"))]
    with tg.GGUFReader(path) as r:
        got = [tvoc._maybe_normalize_codebook(r, "cb", "usage", "cpu", None),
               tvoc._maybe_normalize_codebook(r, "plain", "x", "cpu", None)]
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), wnt)


def _jax_codes(eng, text, frames):
    cfg = eng.talker_cfg
    toks = np.asarray([eng.tokenizer.encode_for_tts(text)], np.int32)
    p = jtalker.build_prefill_inputs(
        eng.talker_w, cfg, jnp.asarray(toks),
        jnp.asarray([toks.shape[1]], jnp.int32),
        jnp.zeros((1, cfg.hidden_size), jnp.float32))
    ctx = jgen.required_ctx(p.prefill_embd.shape[1], frames, frames)
    st = jgen.init_state(eng.talker_w, cfg, p, ctx, jax.random.PRNGKey(0))
    _, codes, valid = jgen.generate_chunk(
        eng.talker_w, cfg, st, jgen.make_consts(p, 0.0, 1.05), 50, frames,
        greedy=True, lockstep=True)
    return np.asarray(codes), np.asarray(valid)


def _port_codes(eng, text, frames):
    cfg = eng.talker_cfg
    toks = torch.tensor([eng.tokenizer.encode_for_tts(text)],
                        dtype=torch.int32)
    p = ttalker.build_prefill_inputs(
        eng.talker_w, cfg, toks, torch.tensor([toks.shape[1]]),
        torch.zeros(1, cfg.hidden_size))
    ctx = tgen.required_ctx(p.prefill_embd.shape[1], frames, frames)
    st = tgen.init_state(eng.talker_w, cfg, p, ctx, None)
    _, codes, valid = tgen.generate_chunk(
        eng.talker_w, cfg, st, tgen.make_consts(p, 0.0, 1.05), 50, frames,
        greedy=True)
    return codes.numpy(), valid.numpy()


def _engines(mdir):
    jeng = jpipe.Qwen3TTS()
    assert jeng.load_models(mdir), jeng.error_msg
    teng = tpipe.Qwen3TTS()
    assert teng.load_models(mdir, device="cpu"), teng.error_msg
    return jeng, teng


@pytest.mark.parametrize("out_type", ["f32", "q8_0"])
def test_greedy_codes_match_jax(model_dirs, out_type):
    """Greedy codes of a chunk from the engines that loaded the converted
    files, equal. (In this synthetic model every CB0 id but EOS is
    suppressed, so EOS ends the stream at once; the code predictor's 15
    codebooks still run every frame.)"""
    jeng, teng = _engines(model_dirs[out_type])
    assert teng.device == torch.device("cpu")
    jc, jv = _jax_codes(jeng, TEXT, FRAMES)
    tc, tv = _port_codes(teng, TEXT, FRAMES)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """The JAX package's tiny model (test_torch_pipeline's weights, whose
    greedy frames sit at no bf16 near-tie) with a speaker encoder, written
    as a model directory by chip_smoke's writer."""
    import dataclasses
    from .test_tokenizer import make_tiny_tokenizer
    from .test_torch_config import port_cfg, port_tokenizer
    rng = np.random.default_rng(52)
    cfg = JW.tiny_talker_config()
    jw = JW.init_talker_weights(rng, cfg)
    vcfg = dataclasses.replace(jvoc.tiny_vocoder_config(), codebook_size=2048)
    jvw = jvoc.init_vocoder_weights(rng, vcfg)
    scfg = JSpkCfg(hidden_dim=16, embedding_dim=cfg.hidden_size)
    jsw = jspk.init_speaker_encoder_weights(np.random.default_rng(53), scfg)
    root = tmp_path_factory.mktemp("tiny_model")
    chip_smoke.write_model_dir(
        str(root), port_tokenizer(make_tiny_tokenizer()), port_cfg(cfg),
        _jax_tree(jw), port_cfg(scfg), _jax_tree(jsw), port_cfg(vcfg),
        _jax_tree(jvw))
    return str(root)


TEXTS = ["hello world.", "hello hello world hello.", "world."]


def test_loaded_engine_synthesizes_as_jax(tiny_dir):
    """Both packages load the same directory; greedy streaming synthesis
    gives the same frames per stream and the same PCM up to a step."""
    jeng, teng = _engines(tiny_dir)
    kw = dict(max_audio_tokens=56, temperature=0.0, seed=0,
              print_timing=False)
    want = jeng.synthesize_batch(TEXTS, params=jpipe.TTSParams(**kw))
    got = teng.synthesize_batch(TEXTS, params=tpipe.TTSParams(**kw))
    for g, w in zip(got, want):
        assert g.success and w.success, (g.error_msg, w.error_msg)
        assert g.n_frames == w.n_frames
        assert len(g.audio) == g.n_frames * teng.voc_cfg.samples_per_frame
        np.testing.assert_allclose(g.audio, w.audio, atol=2.5 / 32767)
        assert g.mem_rss_peak_bytes > 0


def _mtp_model(tmp_path):
    """A tiny model with the 1.7B shape (the code predictor narrower than
    the talker, an mtp projection between), written by chip_smoke's
    writer, and its in-memory weights."""
    import dataclasses
    from qwen3_tts_tpu_torch.config import TokenizerSpecialTokens
    from qwen3_tts_tpu_torch.tokenizer import TextTokenizer
    gen = torch.Generator().manual_seed(312)
    cfg = dataclasses.replace(W.tiny_talker_config(), code_pred_hidden_size=32,
                              code_pred_intermediate_size=64,
                              code_pred_head_dim=8)
    vcfg = dataclasses.replace(tvoc.tiny_vocoder_config(), codebook_size=2048)
    scfg = SpeakerEncoderConfig(hidden_dim=16, embedding_dim=cfg.hidden_size)
    tw = W.init_talker_weights(cfg, gen, "cpu")
    tw["code_pred"]["mtp_b"] = torch.randn(32, generator=gen) * 0.1
    vw = W.init_vocoder_weights(vcfg, gen, "cpu", dtype=None)
    sw = tspk.init_speaker_encoder_weights(scfg, gen, "cpu")
    tok = TextTokenizer(["<|im_start|>", "<|im_end|>", "assistant", "Ċ", "a",
                         "b", "a b"], ["a b"],
                        TokenizerSpecialTokens(bos_token_id=0, eos_token_id=1,
                                               pad_token_id=1))
    chip_smoke.write_model_dir(str(tmp_path), tok, cfg, tw, scfg, sw, vcfg,
                               vw)
    return cfg, tw, vw, sw


def test_mtp_file_loads_and_runs_the_xla_path(tmp_path, monkeypatch):
    """code_pred.mtp_proj loads (weight and bias, bitwise), the kernel
    refuses the tree (fused raises), and under auto the loaded engine's
    greedy codes are the JAX engine's on the same file."""
    _, tw, _, _ = _mtp_model(tmp_path)
    jeng, teng = _engines(str(tmp_path))
    cp = teng.talker_w["code_pred"]
    assert_trees_bitwise(teng.talker_w, tw)
    assert cp["mtp_w"] is not None and cp["mtp_b"] is not None
    assert not codepred_fused.supported(teng.talker_cfg, 1, teng.talker_w)
    monkeypatch.setenv("QWEN3_TTS_CODEPRED", "fused")
    with pytest.raises(ValueError):
        code_predictor.predict_codes(
            teng.talker_w, teng.talker_cfg,
            torch.zeros(1, teng.talker_cfg.hidden_size),
            torch.zeros(1, dtype=torch.int32), 0.0, 50, greedy=True)
    monkeypatch.setenv("QWEN3_TTS_CODEPRED", "auto")
    jc, jv = _jax_codes(jeng, "a b a b", FRAMES)
    tc, tv = _port_codes(teng, "a b a b", FRAMES)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)


def test_written_model_dir_loads_bitwise(tmp_path):
    """chip_smoke.write_model_dir -> load_models gives back the weights it
    was given, vocoder packed as from_components packs it."""
    _, tw, vw, sw = _mtp_model(tmp_path)
    eng = tpipe.Qwen3TTS()
    assert eng.load_models(str(tmp_path), device="cpu"), eng.error_msg
    assert_trees_bitwise(eng.talker_w, tw)
    assert_trees_bitwise(eng.voc_w, tvoc.pack_kernel_weights(vw))
    assert eng.spk_w is None                       # loads on first use
    assert eng._ensure_speaker_encoder()
    assert_trees_bitwise(eng.spk_w, sw)


def test_low_memory_audio_is_the_normal_audio(tiny_dir, monkeypatch):
    kw = dict(max_audio_tokens=56, temperature=0.0, seed=0,
              print_timing=False)
    normal = tpipe.Qwen3TTS()
    assert normal.load_models(tiny_dir, device="cpu")
    monkeypatch.setenv("QWEN3_TTS_LOW_MEM", "1")
    low = tpipe.Qwen3TTS()
    assert low.load_models(tiny_dir, device="cpu")
    assert low.low_mem and not normal.low_mem
    a = normal.synthesize_batch(TEXTS, params=tpipe.TTSParams(**kw))
    b = low.synthesize_batch(TEXTS, params=tpipe.TTSParams(**kw))
    for x, y in zip(a, b):
        assert x.success and y.success
        np.testing.assert_array_equal(x.audio, y.audio)


def test_load_needs_a_card_unless_asked_for_the_cpu(model_dirs, monkeypatch,
                                                    tmp_path):
    """No card and no CPU request: load_models returns False with an
    error and the CLI exits 1; neither falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = tpipe.Qwen3TTS()
    assert not eng.load_models(model_dirs["f32"])
    assert "CUDA" in eng.error_msg and eng.talker_w is None
    out = str(tmp_path / "out.wav")
    assert cli.main(["-m", model_dirs["f32"], "-t", TEXT, "-o", out]) == 1
    assert not Path(out).exists()


def test_load_failures_set_error_msg(tmp_path):
    eng = tpipe.Qwen3TTS()
    assert not eng.load_models(str(tmp_path / "nope"), device="cpu")
    assert eng.error_msg.startswith("Failed to load models")
    (tmp_path / tpipe.TTS_FILE).write_bytes(b"NOPE" + bytes(64))
    assert not eng.load_models(str(tmp_path), device="cpu")
    assert "not a GGUF" in eng.error_msg
    assert not eng.load_models(str(tmp_path), device="nonsense")
    res = eng.synthesize("a b a b")
    assert not res.success and res.error_msg == "Models not loaded"
