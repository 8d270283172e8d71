"""The port's offline tools on the CPU: tools/parity.py's independent
reference, copied into qwen3_tts_tpu_torch/tools/parity.py, gives bitwise
the JAX tool's dumps on the same inputs; ``run_parity`` passes its f32
pass on the synthetic fixtures of tests/test_converter.py and both passes
on a checkpoint with the kernels' geometry, the bf16 pass through their
torch twins; the synthetic acceptance run passes every step under the
JAX tool's step names; the setup driver (tests/test_setup_models.py's
three cases); and convert -> parity -> acceptance run in a process where
importing jax, jaxlib, the JAX package, safetensors, ml_dtypes or
huggingface_hub fails."""

import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(4)
pytest.importorskip("safetensors.numpy")

from qwen3_tts_tpu_torch.config import (TalkerConfig,  # noqa: E402
                                        VocoderConfig)
from qwen3_tts_tpu_torch.io.gguf import GGUFReader  # noqa: E402
from qwen3_tts_tpu_torch.runtime import audio_io  # noqa: E402
from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS  # noqa: E402
from qwen3_tts_tpu_torch.tools import acceptance  # noqa: E402
from qwen3_tts_tpu_torch.tools import convert_checkpoints as tcc  # noqa: E402
from qwen3_tts_tpu_torch.tools import parity  # noqa: E402
from qwen3_tts_tpu_torch.tools import setup_models  # noqa: E402

from .test_converter import (make_codec_checkpoint,  # noqa: E402
                             make_tts_checkpoint)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

# the JAX package's tool, loaded under another name than the port's module
_spec = importlib.util.spec_from_file_location(
    "jax_parity_tool", REPO / "tools" / "parity.py")
jparity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jparity)

# the codec at tiny widths, its codebooks as wide as the code predictor's
# vocabulary (the talker's codes index them)
TINY_CODEC = dict(codebook_size=2048, codebook_dim=8, voc_hidden=16,
                  latent=32, voc_layers=2, voc_heads=4, decoder_dim=192,
                  rates=(2, 2, 2, 2))
# the talker and code predictor at the widths the kernels serve (the
# code predictor's are the 0.6B model's), one talker layer, the whole
# text vocabulary (the tokenizer's default BOS id, 151644, names a row)
# with a narrow embedding: the bf16 pass takes the kernels' twins
KERNEL_GEOMETRY = dict(layers=1, text_hidden=64, spk_hidden=16, **TINY_CODEC)
# a tiny model, whose code predictor no kernel serves
TINY_MODEL = dict(hidden=64, layers=2, heads=4, kv_heads=2, head_dim=32,
                  inter=192, text_hidden=16, cp_layers=1, cp_vocab=64,
                  codec_vocab=2304, spk_hidden=16, **TINY_CODEC)
JAX_STEPS = {"convert", "parity", "tokenizer_roundtrip", "load_models",
             "synthesize", "wav_roundtrip", "speaker_embd",
             "synthesize_cloned"}


def _fixtures(root: Path, seed: int) -> tuple[Path, Path]:
    rng = np.random.default_rng(seed)
    tts, codec = root / "hf_tts", root / "hf_codec"
    tts.mkdir()
    codec.mkdir()
    make_tts_checkpoint(tts, rng)
    make_codec_checkpoint(codec, rng)
    return tts, codec


def test_reference_dumps_bitwise_jax_tool(tmp_path):
    """run_parity's reference dumps (and its f32 pass) on the synthetic
    fixtures against tools/parity.py's TorchTalker / TorchVocoder fed the
    inputs that tool draws for the same seed."""
    tts, codec = _fixtures(tmp_path, 21)
    out = tmp_path / "parity.npz"
    failures, dumps = parity.run_parity(tts, codec, "cpu", seed=5, out=out)
    # the fixtures' unit-scale weights saturate the audio, which the bf16
    # pass cannot match (see test_run_parity_both_passes_through_twins)
    assert [f for f in failures if f.startswith("f32:")] == []
    hf = jparity._load_hf(tts)
    got_hf = parity._load_hf(tts)
    assert list(got_hf) == list(hf)
    for k in hf:
        assert np.array_equal(got_hf[k], hf[k]), k
    cfg_json = parity.json.loads((tts / "config.json").read_text())
    ref = jparity.TorchTalker(hf, cfg_json)
    tcc.convert_tts(tts, tmp_path / "t.gguf", "f32")
    with GGUFReader(str(tmp_path / "t.gguf")) as r:
        cfg = parity._clamp_ids(TalkerConfig.from_gguf(r))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.text_vocab_size, (16,))
    spk = rng.standard_normal(cfg.hidden_size).astype(np.float32) * 0.1
    lang = min(cfg.english_language_id, cfg.codec_vocab_size - 1)
    pf, _, _ = ref.prefill_embeds(
        torch.from_numpy(tokens), torch.from_numpy(spk),
        (cfg.tts_bos_token_id, cfg.tts_eos_token_id, cfg.tts_pad_token_id),
        (cfg.codec_think_id, cfg.codec_think_bos_id, cfg.codec_think_eos_id,
         cfg.codec_pad_id, cfg.codec_bos_id), lang)
    h, logits = ref.talker_forward(pf)
    rng.standard_normal(cfg.hidden_size)              # the step row
    cb0 = int(rng.integers(0, min(2048, cfg.codec_vocab_size)))
    codes, cp_logits = ref.code_predictor_greedy(h[-1], cb0)
    want = {"prefill_embd": pf.numpy(), "talker_hidden": h.numpy(),
            "talker_logits": logits.numpy(), "code_pred_codes": codes,
            "code_pred_logits": cp_logits}

    refv = jparity.TorchVocoder(jparity._load_hf(codec), parity.json.loads(
        (codec / "config.json").read_text()))
    tcc.convert_codec(codec, tmp_path / "c.gguf", "f32")
    with GGUFReader(str(tmp_path / "c.gguf")) as r:
        vcfg = VocoderConfig.from_gguf(r)
    want["vocoder_audio"] = refv.decode(rng.integers(
        0, vcfg.codebook_size, (12, vcfg.n_codebooks)))

    saved = np.load(out)
    assert sorted(saved.files) == sorted(want) == sorted(dumps)
    for k, v in want.items():
        for got in (dumps[k], saved[k]):
            assert got.dtype == v.dtype and np.array_equal(got, v), k


def test_reference_classes_bitwise(tmp_path):
    """The copied classes, stage by stage, on one set of inputs."""
    tts, codec = _fixtures(tmp_path, 22)
    rng = np.random.default_rng(23)
    hf = jparity._load_hf(tts)
    cfg_json = parity.json.loads((tts / "config.json").read_text())
    a, b = jparity.TorchTalker(hf, cfg_json), parity.TorchTalker(hf, cfg_json)
    tokens = torch.from_numpy(rng.integers(0, 96, (16,)))
    spk = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    args = (tokens, spk, (93, 94, 95), (120, 121, 122, 123, 124), 125)
    for x, y in zip(a.prefill_embeds(*args), b.prefill_embeds(*args)):
        assert torch.equal(x, y)
    rows = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    for x, y in zip(a.talker_forward(rows), b.talker_forward(rows)):
        assert torch.equal(x, y)
    ca, la = a.code_predictor_greedy(rows[-1], 7)
    cb, lb = b.code_predictor_greedy(rows[-1], 7)
    assert np.array_equal(ca, cb) and np.array_equal(la, lb)
    hv = jparity._load_hf(codec)
    vj = parity.json.loads((codec / "config.json").read_text())
    codes = rng.integers(0, 64, (5, 4))
    assert np.array_equal(jparity.TorchVocoder(hv, vj).decode(codes),
                          parity.TorchVocoder(hv, vj).decode(codes))


@pytest.fixture(scope="module")
def kernel_ckpt(tmp_path_factory):
    """HF checkpoints (TTS, codec) with the kernels' geometry."""
    root = tmp_path_factory.mktemp("kernel_ckpt")
    tts, codec = root / "t", root / "c"
    chip_smoke.write_hf_checkpoints(tts, codec, 31, **KERNEL_GEOMETRY)
    return tts, codec


def test_run_parity_both_passes_through_twins(kernel_ckpt):
    """A checkpoint with the kernels' geometry: the f32 pass and the bf16
    pass (the talker step, the code predictor and the vocoder through the
    kernels' torch twins, the step again under xla) report no failure."""
    tts, codec = kernel_ckpt
    report = []
    failures, _ = parity.run_parity(tts, codec, "cpu", seed=31,
                                    report=report)
    assert failures == []
    impls = {r["stage"]: r["impl"] for r in report}
    assert impls["bf16:step_hidden[fused]"].startswith("fused")
    assert impls["bf16:step_hidden[xla]"].startswith("xla")
    assert impls["bf16:code_pred_codes"].startswith("fused")
    assert impls["bf16:vocoder_audio"].startswith("fused")
    assert impls["f32:code_pred_codes"].startswith("xla")
    stages = {r["stage"].split(":")[1] for r in report}
    assert {"prefill_embd", "trailing_schedule", "talker_hidden",
            "talker_logits", "step_hidden[xla]", "step_logits[xla]",
            "code_pred_codes", "vocoder_audio"} <= stages
    assert all(r["ok"] for r in report)
    # the switches are back where they were
    assert all(s.impl is None for s in parity._switches())


def test_run_parity_reports_a_wrong_weight(tmp_path):
    """A stack that differs from the reference fails its stages: the
    checkpoint's final norm scaled after the reference read it."""
    tts, codec = _fixtures(tmp_path, 24)
    real = parity.TorchTalker.__init__

    def init(self, hf, cfg):
        real(self, hf, cfg)
        self.t["talker.model.norm.weight"] = \
            self.t["talker.model.norm.weight"] * 1.5

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parity.TorchTalker, "__init__", init)
        failures, _ = parity.run_parity(tts, None, "cpu")
    assert "f32:talker_hidden" in failures
    assert "f32:prefill_embd" not in failures


def test_run_parity_bf16_gate_is_relative(tmp_path):
    """A 2% error planted in the port's text projection fails the bf16
    trailing schedule on its relative error, which the absolute clause of
    the f32 pass's rule would have let through (the schedule's values are
    far below 1). The same checkpoint without the error passes the stage
    (test_run_parity_fails_an_unserved_geometry)."""
    tts, codec = tmp_path / "t", tmp_path / "c"
    chip_smoke.write_hf_checkpoints(tts, codec, 43, **TINY_MODEL)
    real = parity._talker_weights

    def planted(*args):
        w, cfg = real(*args)
        w["text_proj"]["fc2_w"] = w["text_proj"]["fc2_w"] * 1.02
        w["text_proj"]["fc2_b"] = w["text_proj"]["fc2_b"] * 1.02
        return w, cfg

    report = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parity, "_talker_weights", planted)
        failures, _ = parity.run_parity(tts, None, "cpu", seed=43,
                                        report=report)
    assert "bf16:trailing_schedule" in failures
    rec = {r["stage"]: r for r in report}["bf16:trailing_schedule"]
    assert rec["rel"] > rec["tol"] >= rec["max_abs"]


def test_run_parity_fails_an_unserved_geometry(tmp_path):
    """The bf16 pass runs the code predictor and the step under fused,
    which raises on a geometry its kernel does not serve: the stage fails,
    with the error on its record, instead of passing on the plain path
    (the code predictor of a tiny model; the step of the converter's
    fixture too, whose attention is not the reference's shape)."""
    tts, codec = tmp_path / "t", tmp_path / "c"
    chip_smoke.write_hf_checkpoints(tts, codec, 43, **TINY_MODEL)
    report = []
    failures, _ = parity.run_parity(tts, None, "cpu", seed=43,
                                    report=report)
    assert failures == ["bf16:code_pred_codes"]
    rec = {r["stage"]: r for r in report}["bf16:code_pred_codes"]
    assert rec["impl"].startswith("fused") and "does not serve" in \
        rec["error"]
    assert rec["pass"] == "bf16" and "launches" in rec
    (tmp_path / "fixture").mkdir()
    fixture, _ = _fixtures(tmp_path / "fixture", 44)
    report = []
    failures, _ = parity.run_parity(fixture, None, "cpu", report=report)
    for stage in ("step_hidden[fused]", "step_logits[fused]",
                  "code_pred_codes"):
        rec = {r["stage"]: r for r in report}[f"bf16:{stage}"]
        assert f"bf16:{stage}" in failures and rec["pass"] == "bf16"
        assert "does not" in rec["error"] and not rec["ok"]
    assert all(s.impl is None for s in parity._switches())
    assert parity.code_predictor._SWITCH.impl is None


def test_acceptance_synthetic(tools_run):
    """Every acceptance step passes on a synthetic checkpoint, under the
    JAX tool's step names (tests/test_acceptance.py), each timed; the
    parity step leaves its dumps. The run is tools_run's, in which the
    acceptance's main prints its JSON report."""
    r, work = tools_run
    out = "\n" + r.stdout          # the report: the last JSON list
    results = json.loads(out[out.rindex("\n[\n"):out.rindex("]") + 1])
    assert [x for x in results if not x["ok"]] == []
    assert {x["step"] for x in results} == JAX_STEPS
    assert all(x["seconds"] >= 0 for x in results)
    assert (work / "parity.npz").exists()


def test_acceptance_records_a_failed_load(tmp_path, monkeypatch):
    """A step that fails is recorded and the run goes on to its report:
    without a card, loading for the card fails."""
    tts, codec = tmp_path / "t", tmp_path / "c"
    chip_smoke.write_hf_checkpoints(tts, codec, 42, **TINY_MODEL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(parity, "run_parity", lambda *a, **k: ([], {}))
    results = acceptance.run_acceptance(tts, codec, tmp_path / "w",
                                        max_tokens=4, device="cuda")
    by = {r["step"]: r for r in results}
    assert by["parity"]["ok"] and by["convert"]["ok"]
    assert not by["load_models"]["ok"] and not by["synthesize"]["ok"]
    assert "no CUDA device" in by["load_models"]["detail"]


def _setup(monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["setup_models", *map(str, args)])
    return setup_models.main()


def test_setup_models_skip_download(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    base, codec = tmp_path / "hf_base", tmp_path / "hf_codec"
    base.mkdir()
    codec.mkdir()
    make_tts_checkpoint(base, rng)
    make_codec_checkpoint(codec, rng)
    models = tmp_path / "models"
    args = ("--skip-download", "--models-dir", models, "--base-dir", base,
            "--tokenizer-dir", codec, "--type", "f32")
    assert _setup(monkeypatch, *args) == 0
    assert (models / "qwen3-tts-0.6b-f16.gguf").exists()
    assert (models / "qwen3-tts-tokenizer-f16.gguf").exists()
    assert _setup(monkeypatch, *args) == 0       # idempotent
    engine = Qwen3TTS()
    assert engine.load_models(str(models), "cpu"), engine.error_msg
    assert len(engine.tokenizer.encode_for_tts("a b")) > 0


def test_setup_models_missing_checkpoint(tmp_path, monkeypatch):
    assert _setup(monkeypatch, "--skip-download", "--models-dir",
                  tmp_path / "models", "--base-dir", tmp_path / "nope",
                  "--tokenizer-dir", tmp_path / "nope2") == 1


def test_setup_models_warns_on_type_mismatch(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(9)
    base, codec = tmp_path / "hf_base", tmp_path / "hf_codec"
    base.mkdir()
    codec.mkdir()
    make_tts_checkpoint(base, rng, intermediate=256)
    make_codec_checkpoint(codec, rng)

    def run(out_type):
        return _setup(monkeypatch, "--skip-download", "--models-dir",
                      tmp_path / "models", "--base-dir", base,
                      "--tokenizer-dir", codec, "--type", out_type)

    assert run("f16") == 0
    capsys.readouterr()
    assert run("q8_0") == 0          # skipped, but must warn
    err = capsys.readouterr().err
    assert "WARNING" in err and "q8_0" in err
    assert run("f16") == 0           # matching type: plain skip line
    assert "WARNING" not in capsys.readouterr().err


def test_setup_models_download_without_hub(tmp_path, monkeypatch, capsys):
    """Without huggingface_hub the download step warns and returns False;
    the missing checkpoint then fails the run."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    assert not setup_models.snapshot_download_repo(
        setup_models.BASE_REPO_IDS, tmp_path / "x", None)
    assert "huggingface_hub not installed" in capsys.readouterr().err
    assert _setup(monkeypatch, "--models-dir", tmp_path / "m",
                  "--base-dir", tmp_path / "b", "--tokenizer-dir",
                  tmp_path / "c") == 1


BLOCKED = ("jax", "jaxlib", "qwen3_tts_tpu", "safetensors", "ml_dtypes",
           "huggingface_hub")


@pytest.fixture(scope="module")
def tools_run(kernel_ckpt, tmp_path_factory):
    """convert -> setup -> parity -> acceptance through their main()s, on
    the CPU, in a process whose meta-path finder refuses the JAX side,
    safetensors, ml_dtypes and huggingface_hub. Parity's main takes the
    codec alone: the acceptance run's parity step runs the talker's
    stages. Returns (the finished process, the acceptance's work dir)."""
    tmp_path = tmp_path_factory.mktemp("tools_run")
    tts, codec = map(str, kernel_ckpt)
    audio_io.save_wav(str(tmp_path / "ref.wav"),
                      chip_smoke._clip(1.0, 24000, 41), 24000)
    code = textwrap.dedent(f"""
        import importlib.abc, sys
        BLOCKED = {BLOCKED!r}

        def blocked(name):
            return name.split(".")[0] in BLOCKED

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if blocked(name):
                    raise ImportError("refused: " + name)
                return None

        for name in [m for m in sys.modules if blocked(m)]:
            del sys.modules[name]
        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(REPO)!r})
        import torch
        torch.set_num_threads(4)
        import chip_smoke  # noqa: F401  (it too imports nothing refused)
        from qwen3_tts_tpu_torch.tools import (acceptance,
                                               convert_checkpoints, parity,
                                               setup_models)
        root, tts, codec = {str(tmp_path)!r}, {tts!r}, {codec!r}
        sys.argv = ["convert", "codec", "-i", codec, "-o",
                    root + "/m/codec.gguf", "-t", "q8_0"]
        assert convert_checkpoints.main() == 0
        assert setup_models.main(["--skip-download", "--models-dir",
                                  root + "/m2", "--base-dir", tts,
                                  "--tokenizer-dir", codec]) == 0
        assert parity.main(["--codec", codec, "--device", "cpu"]) == 0
        assert acceptance.main(["--hf-tts", tts, "--hf-codec", codec,
                                "--work", root + "/w", "--ref-wav",
                                root + "/ref.wav", "--text",
                                "hello world.", "--max-tokens", "6",
                                "--device", "cpu"]) == 0
        loaded = sorted(m for m in sys.modules if blocked(m))
        assert not loaded, loaded
        print("TOOLS OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    return r, tmp_path / "w"


def test_tools_import_nothing_forbidden(tools_run):
    """tools_run's process ran every tool to its end and loaded nothing
    that it refuses."""
    r, _ = tools_run
    assert "TOOLS OK" in r.stdout
    assert "ACCEPTANCE OK" in r.stderr and "PARITY OK" in r.stderr
