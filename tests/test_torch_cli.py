"""The port's CLI (qwen3_tts_tpu_torch/cli.py), mirroring the JAX
package's CLI tests: the flags, the stdin TSV protocol of the batched and
continuous servers, the embedding cache and its size check, and main()
over a model directory on the CPU (single shot, voice cloning with the
.embd cache, continuous serving, load failures)."""

import dataclasses
import io
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import speaker_encoder as jspk  # noqa: E402
from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.models import weights as JW  # noqa: E402
from qwen3_tts_tpu_torch import cli  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime import audio_io  # noqa: E402
from qwen3_tts_tpu_torch.runtime.pipeline import (Qwen3TTS,  # noqa: E402
                                                  TTSParams)

from .test_tokenizer import make_tiny_tokenizer  # noqa: E402
from .test_torch_config import port_cfg, port_tokenizer  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _tiny_parts(seed):
    """Port-side tiny talker, vocoder and speaker encoder drawn by the
    JAX package (as test_cli.py's engines)."""
    rng = np.random.default_rng(seed)
    cfg = JW.tiny_talker_config()
    vcfg = dataclasses.replace(jvoc.tiny_vocoder_config(), codebook_size=2048)
    scfg = jspk.SpeakerEncoderConfig(hidden_dim=16,
                                     embedding_dim=cfg.hidden_size)

    def tree(t):
        return W.tree_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    return (port_tokenizer(make_tiny_tokenizer()), port_cfg(cfg),
            tree(JW.init_talker_weights(rng, cfg)), port_cfg(scfg),
            tree(jspk.init_speaker_encoder_weights(rng, scfg)),
            port_cfg(vcfg), tree(jvoc.init_vocoder_weights(rng, vcfg)))


@pytest.fixture(scope="module")
def engine():
    tok, cfg, tw, _, _, vcfg, vw = _tiny_parts(80)
    return Qwen3TTS.from_components(tok, cfg, tw, vcfg, vw, "cpu")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_model")
    chip_smoke.write_model_dir(str(root), *_tiny_parts(200))
    return str(root)


PARAMS = dict(temperature=0.0, print_timing=False, seed=0)


def test_parser_flags():
    p = cli.build_parser()
    args = p.parse_args(["-m", "models", "-t", "hi", "-o", "out.wav",
                         "--temperature", "0.5", "--top-k", "10",
                         "--max-tokens", "100", "--repetition-penalty", "1.1",
                         "-j", "8", "--device", "cpu"])
    assert (args.model, args.temperature, args.top_k, args.max_tokens,
            args.repetition_penalty, args.threads, args.device) == \
        ("models", 0.5, 10, 100, 1.1, 8, "cpu")
    d = p.parse_args(["-m", "m"])
    assert (d.output, d.temperature, d.top_k, d.top_p, d.max_tokens,
            d.repetition_penalty, d.device, d.batch, d.max_frames) == \
        ("output.wav", 0.9, 50, 1.0, 4096, 1.05, "cuda", 1, 1024)
    from qwen3_tts_tpu import cli as jcli
    jflags = {a.dest for a in jcli.build_parser()._actions}
    assert jflags | {"device"} == {a.dest for a in p._actions}


@pytest.mark.parametrize("line,want", [
    ("hello\tout.wav\n", ("hello", "out.wav")),
    ("a\tb\tc.wav\r\n", ("a", "b\tc.wav")),
    ("just text\n", ("just text", "output.wav")),
    ("\n", None), ("quit\n", "quit"), ("exit", "quit")])
def test_parse_request_line(line, want):
    assert cli._parse_request_line(line) == want


def _ok_lines(stdout, outs):
    lines = stdout.getvalue().strip().split("\n")
    assert len(lines) == len(outs)
    for line, out in zip(lines, outs):
        parts = line.split("\t")
        assert parts[0] == "OK", line
        assert float(parts[1]) > 0 and float(parts[2]) > 0
        assert parts[3] == out and os.path.exists(out)


@pytest.mark.parametrize("batch", [1, 2])
def test_serve_protocol(engine, tmp_path, batch):
    outs = [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")]
    stdin = io.StringIO(f"hello world.\t{outs[0]}\nhello.\t{outs[1]}\nquit\n")
    stdout = io.StringIO()
    rc = cli.run_server(engine, None, TTSParams(max_audio_tokens=12, **PARAMS),
                        batch=batch, stdin=stdin, stdout=stdout)
    assert rc == 0
    _ok_lines(stdout, outs)
    samples, sr = audio_io.load_wav(outs[0])
    assert sr == engine.voc_cfg.sample_rate and len(samples) > 0


def test_serve_default_output_and_blank_lines(engine, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    stdout = io.StringIO()
    cli.run_server(engine, None, TTSParams(max_audio_tokens=8, **PARAMS),
                   stdin=io.StringIO("\nhello.\nexit\n"), stdout=stdout)
    line = stdout.getvalue().strip()
    assert line.startswith("OK\t") and line.endswith("output.wav")
    assert (tmp_path / "output.wav").exists()


def test_serve_reports_errors(engine, tmp_path):
    """A too-short text and an unwritable output: one ERR line each."""
    stdout = io.StringIO()
    cli.run_server(engine, None, TTSParams(max_audio_tokens=8, **PARAMS),
                   stdin=io.StringIO(
                       f"hello.\t{tmp_path}/missing/x.wav\n"),
                   stdout=stdout)
    assert stdout.getvalue().startswith("ERR\tfailed to save")


def test_serve_batched_burst_on_real_pipe(engine, tmp_path):
    """A burst of piped lines synthesizes as one lock-step batch."""

    class _RecordBatches:
        def __init__(self, inner):
            self._inner = inner
            self.batch_sizes = []

        def synthesize_batch(self, texts, embs, params):
            self.batch_sizes.append(len(texts))
            return self._inner.synthesize_batch(texts, embs, params)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    outs = [str(tmp_path / f"burst{i}.wav") for i in range(3)]
    r_fd, w_fd = os.pipe()
    with os.fdopen(w_fd, "w") as w:
        for i, out in enumerate(outs):
            w.write(f"hello world {i}.\t{out}\n")
        w.write("quit\n")
    rec = _RecordBatches(engine)
    stdout = io.StringIO()
    with os.fdopen(r_fd, "r") as stdin:
        rc = cli.run_server(rec, None, TTSParams(max_audio_tokens=8, **PARAMS),
                            batch=3, stdin=stdin, stdout=stdout)
    assert rc == 0 and rec.batch_sizes == [3]
    _ok_lines(stdout, outs)


def test_resolve_embedding_rejects_wrong_size(engine, tmp_path):
    p = str(tmp_path / "stale.embd")
    audio_io.save_embedding(p, np.zeros(7, np.float32))
    assert cli.resolve_embedding(engine, p, None) is None
    assert cli.resolve_embedding(engine, None, None) is None


def test_continuous_server_protocol(engine, tmp_path):
    outs = [str(tmp_path / f"{i}.wav") for i in range(3)]
    stdin = io.StringIO(f"hello world.\t{outs[0]}\nhello.\t{outs[1]}\n"
                        f"hello hello.\t{outs[2]}\nquit\n")
    stdout = io.StringIO()
    rc = cli.run_server_continuous(engine, None, TTSParams(**PARAMS),
                                   n_slots=2, max_frames=8, stdin=stdin,
                                   stdout=stdout)
    assert rc == 0
    lines = [l for l in stdout.getvalue().strip().split("\n") if l]
    assert len(lines) == 3 and all(l.startswith("OK\t") for l in lines)
    assert {l.split("\t")[3] for l in lines} == set(outs)
    assert all(os.path.exists(o) for o in outs)


def test_continuous_server_warms_up_before_reading(engine, tmp_path,
                                                  monkeypatch):
    """The continuous server calls ContinuousBatcher.warmup() before it
    reads its first line, as the JAX CLI does before "Server ready"."""
    from qwen3_tts_tpu_torch.runtime import serve
    events = []
    real = serve.ContinuousBatcher.warmup

    def warmup(self, *a, **kw):
        events.append("warmup")
        return real(self, *a, **kw)

    class Lines(io.StringIO):
        def __iter__(self):
            events.append("read")
            return super().__iter__()

    monkeypatch.setattr(serve.ContinuousBatcher, "warmup", warmup)
    out = str(tmp_path / "w.wav")
    stdout = io.StringIO()
    rc = cli.run_server_continuous(
        engine, None, TTSParams(**PARAMS), n_slots=2, max_frames=8,
        stdin=Lines(f"hello world.\t{out}\nquit\n"), stdout=stdout)
    assert rc == 0 and events == ["warmup", "read"]
    assert stdout.getvalue().startswith("OK\t")


def test_continuous_server_stress_mixed(engine, tmp_path):
    """16 mixed requests over 4 slots, several turnovers, 2 with
    unwritable outputs: exactly one OK or ERR line per request."""
    texts = ["hello.", "hello world.", "hello world. hello world.",
             "hello hello hello."]
    bad = {5, 11}
    outs = {i: str(tmp_path / ("no_such_dir" if i in bad else "")
                   / f"s{i}.wav") for i in range(16)}
    stdin = io.StringIO("\n".join(f"{texts[i % 4]}\t{outs[i]}"
                                  for i in range(16)) + "\nquit\n")
    stdout = io.StringIO()
    rc = cli.run_server_continuous(engine, None, TTSParams(**PARAMS),
                                   n_slots=4, max_frames=6, stdin=stdin,
                                   stdout=stdout)
    assert rc == 0
    got = [l for l in stdout.getvalue().strip().split("\n") if l]
    assert len(got) == 16
    assert sum(l.startswith("ERR\t") for l in got) == len(bad)
    ok_files = {l.split("\t")[3] for l in got if l.startswith("OK\t")}
    assert ok_files == {outs[i] for i in range(16) if i not in bad}
    assert all(os.path.exists(f) for f in ok_files)


def _ref_wav(path, seconds=0.4, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    audio_io.save_wav(str(path), (0.4 * np.sin(2 * np.pi * 220 * t)
                                  + 0.1 * np.sin(2 * np.pi * 881 * t)), sr)
    return str(path)


def test_main_single_shot(model_dir, tmp_path):
    out = str(tmp_path / "out.wav")
    rc = cli.main(["-m", model_dir, "-t", "hello world.", "-o", out,
                   "--max-tokens", "6", "--temperature", "0", "--seed", "0",
                   "--device", "cpu"])
    assert rc == 0
    samples, sr = audio_io.load_wav(out)
    assert sr == 24000 and len(samples) == 6 * 64


def test_main_voice_clone_and_cache(model_dir, tmp_path):
    """-r encodes the reference (a 16 kHz WAV: the resample path) and
    caches <reference>.embd; -e then reads the cache without -r, and the
    same cached voice gives the same audio."""
    ref = _ref_wav(tmp_path / "ref.wav")
    args = ["-m", model_dir, "-t", "hello world.", "--max-tokens", "6",
            "--temperature", "0", "--seed", "0", "--device", "cpu"]
    out1, out2 = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    assert cli.main(args + ["-r", ref, "-o", out1]) == 0
    emb = audio_io.load_embedding(ref + ".embd")
    assert emb is not None and emb.shape == (64,) and np.isfinite(emb).all()
    assert cli.main(args + ["-e", ref + ".embd", "-o", out2]) == 0
    np.testing.assert_array_equal(audio_io.load_wav(out1)[0],
                                  audio_io.load_wav(out2)[0])
    assert cli.main(args + ["-e", str(tmp_path / "none.embd")]) == 1


def test_main_serve_continuous(model_dir, tmp_path, monkeypatch, capsys):
    outs = [str(tmp_path / f"{i}.wav") for i in range(3)]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(f"hello{' world' * i}.\t{o}\n" for i, o in enumerate(outs))))
    rc = cli.main(["-m", model_dir, "--serve", "--continuous", "--batch", "4",
                   "--max-frames", "6", "--temperature", "0", "--seed", "0",
                   "--device", "cpu"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith(("OK", "ERR"))]
    assert len(lines) == 3 and all(l.startswith("OK\t") for l in lines)
    assert all(os.path.exists(o) for o in outs)


def test_main_missing_text_and_load_failure(model_dir, tmp_path):
    assert cli.main(["-m", model_dir, "--device", "cpu"]) == 1
    assert cli.main(["-m", str(tmp_path / "nope"), "-t", "x",
                     "--device", "cpu"]) == 1
