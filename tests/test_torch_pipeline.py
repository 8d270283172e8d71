"""The port's slice end to end: text -> lock-step generation -> streaming
vocoder -> PCM, against the JAX package's pipeline on the same tiny
weights (CPU); the port free of JAX; chip_smoke.py refusing to run
without a card."""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu.runtime import pipeline as jpipe  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime import pipeline as tpipe  # noqa: E402

from .test_tokenizer import make_tiny_tokenizer  # noqa: E402
from .test_torch_config import port_cfg, port_tokenizer  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TEXTS = ["hello world.", "hello hello world hello.", "world."]


@pytest.fixture(scope="module")
def engines():
    # weights under which no code of these frames sits at a bf16 near-tie
    # (other seeds flip a code-predictor argmax at a ~1e-3 logit margin
    # and the streams part from there, as ROADMAP.md C describes)
    rng = np.random.default_rng(52)
    cfg = tiny_talker_config()
    jw = init_talker_weights(rng, cfg)
    vcfg = dataclasses.replace(jvoc.tiny_vocoder_config(),
                               codebook_size=2048)
    jvw = jvoc.init_vocoder_weights(rng, vcfg)
    tok = make_tiny_tokenizer()
    jeng = jpipe.Qwen3TTS.from_components(tok, cfg, jw, vcfg, jvw)
    teng = tpipe.Qwen3TTS.from_components(
        port_tokenizer(tok), port_cfg(cfg),
        W.talker_weights_from_numpy(jax.tree.map(np.asarray, jw), "cpu"),
        port_cfg(vcfg),
        W.vocoder_weights_from_numpy(jax.tree.map(np.asarray, jvw), "cpu"),
        "cpu")
    return jeng, teng


def test_synthesize_batch_matches_jax(engines):
    """Greedy streaming synthesis (a full 40-frame chunk and a flushed
    tail): the same frames per stream, and the same int16 PCM up to a
    step."""
    jeng, teng = engines
    kw = dict(max_audio_tokens=56, temperature=0.0, seed=0)
    want = jeng.synthesize_batch(TEXTS, params=jpipe.TTSParams(
        print_timing=False, **kw))
    got = teng.synthesize_batch(TEXTS, params=tpipe.TTSParams(**kw))
    for g, w in zip(got, want):
        assert g.success and w.success, (g.error_msg, w.error_msg)
        assert g.n_frames == w.n_frames
        assert len(g.audio) == g.n_frames * 64     # tiny: 4*2^4 per frame
        np.testing.assert_allclose(g.audio, w.audio, atol=2.5 / 32767)


def test_streaming_chunks_sampled(engines):
    _, teng = engines
    seen = []
    res = teng.synthesize_batch(
        TEXTS, params=tpipe.TTSParams(max_audio_tokens=48, temperature=0.9,
                                      seed=3),
        on_chunk=lambda b, pcm: seen.append((b, len(pcm))))
    for b, r in enumerate(res):
        assert r.success and np.isfinite(r.audio).all()
        assert sum(n for s, n in seen if s == b) == len(r.audio)
        assert r.t_total_ms >= r.t_generate_ms


def test_decode_codes_chunked_length(engines):
    _, teng = engines
    frames = np.random.default_rng(2).integers(0, 256, (50, 16)).astype(
        np.int32)
    audio = teng.decode_codes_chunked(frames, chunk=40)
    assert audio.shape == (50 * 64,)
    assert teng.voc_bucket(3, 16) == 4 and teng.voc_bucket(20, 16) == 16


def test_port_imports_no_jax():
    """Every module of the port imports (the CLI, GGUF, speaker-encoder,
    trace and audio modules by name), and a tiny synthesis and speaker
    encode run, in a process where importing jax or anything of the JAX
    package fails; no module of either is loaded afterwards."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["qwen3_tts_tpu"] = None
        import importlib, pkgutil, dataclasses
        import qwen3_tts_tpu_torch as P
        for m in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
            importlib.import_module(m.name)
        for name in ("cli", "io.gguf", "models.speaker_encoder",
                     "utils.trace", "runtime.audio_io"):
            importlib.import_module("qwen3_tts_tpu_torch." + name)
        import torch
        from qwen3_tts_tpu_torch.config import TokenizerSpecialTokens
        from qwen3_tts_tpu_torch.tokenizer import TextTokenizer
        from qwen3_tts_tpu_torch.models import weights as W
        from qwen3_tts_tpu_torch.models.vocoder import tiny_vocoder_config
        from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS, TTSParams
        torch.set_num_threads(2)
        gen = torch.Generator().manual_seed(0)
        cfg = W.tiny_talker_config()
        vcfg = dataclasses.replace(tiny_vocoder_config(), codebook_size=2048)
        tok = TextTokenizer(["<|im_start|>", "<|im_end|>", "assistant", "a"],
                            [], TokenizerSpecialTokens(bos_token_id=0,
                                                       eos_token_id=1))
        eng = Qwen3TTS.from_components(
            tok, cfg, W.init_talker_weights(cfg, gen, "cpu"), vcfg,
            W.init_vocoder_weights(vcfg, gen, "cpu"), "cpu")
        r = eng.synthesize("aaa", TTSParams(max_audio_tokens=8, seed=1))
        assert r.success and len(r.audio) == r.n_frames * 64, r.error_msg
        from qwen3_tts_tpu_torch import cli
        from qwen3_tts_tpu_torch.models import speaker_encoder as spk
        scfg = spk.tiny_speaker_encoder_config()
        emb = spk.encode(spk.init_speaker_encoder_weights(scfg, gen, "cpu"),
                         scfg, torch.zeros(1, 32, scfg.n_mels),
                         torch.tensor([32]))
        assert emb.shape == (1, scfg.embedding_dim)
        assert cli.build_parser().parse_args(["-m", "m"]).device == "cuda"
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "qwen3_tts_tpu")]
        assert not loaded, loaded
        print("NOJAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "NOJAX_OK" in out.stdout, out.stderr


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    out = _run_smoke(cwd)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
