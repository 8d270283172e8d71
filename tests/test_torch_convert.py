"""The port's converter (qwen3_tts_tpu_torch/tools/convert_checkpoints.py)
against tools/convert_checkpoints.py: for the same checkpoint and --type
the GGUF files are byte for byte the same, for the TTS model and the
codec at f32, f16, q8_0, q4_0 and q4_k, from the F32 fixtures of
tests/test_converter.py, from the same checkpoints stored as BF16 (the
JAX tool run with ml_dtypes imported, which it needs to read BF16), and
from the two-shard BF16 checkpoints that chip_smoke.write_hf_checkpoints
makes, at tiny widths."""

import filecmp
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("safetensors.numpy")
ml_dtypes = pytest.importorskip("ml_dtypes")

from qwen3_tts_tpu_torch.io import safetensors as sf  # noqa: E402
from qwen3_tts_tpu_torch.io.gguf import GGUFReader  # noqa: E402
from qwen3_tts_tpu_torch.tools import convert_checkpoints as tcc  # noqa: E402

from .test_converter import (make_codec_checkpoint,  # noqa: E402
                             make_tts_checkpoint)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import convert_checkpoints as jcc  # noqa: E402

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

TYPES = ["f32", "f16", "q8_0", "q4_0", "q4_k"]
# tiny widths for write_hf_checkpoints: every layer kind, one or two of
# each; rows of 256 so that every quantized type applies
TINY = dict(hidden=256, layers=2, heads=4, kv_heads=2, head_dim=64,
            inter=256, text_vocab=300, text_hidden=32, codec_vocab=160,
            groups=4, cp_layers=1, cp_vocab=64, spk_hidden=16,
            codebook_size=64, codebook_dim=8, voc_hidden=16, latent=32,
            voc_layers=1, voc_heads=4, decoder_dim=32, rates=(2, 2, 2, 2))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The F32 fixtures of tests/test_converter.py (intermediate 256, so
    that the quantized types apply) and the same tensors stored as BF16."""
    root = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(1010)
    out = {}
    for kind in ("tts", "codec"):
        f32 = root / f"{kind}_f32"
        f32.mkdir()
        arrays = (make_tts_checkpoint(f32, rng, intermediate=256)
                  if kind == "tts" else make_codec_checkpoint(f32, rng))
        bf16 = root / f"{kind}_bf16"
        bf16.mkdir()
        for p in f32.iterdir():
            if p.suffix != ".safetensors":
                (bf16 / p.name).write_bytes(p.read_bytes())
        sf.save_file(arrays, bf16 / "model.safetensors", bf16=True)
        out[kind] = {"f32": f32, "bf16": bf16}
    return out


def _convert_both(kind: str, src: Path, out_type: str, dst: Path):
    fn = "convert_tts" if kind == "tts" else "convert_codec"
    jax_out, port_out = dst / "jax.gguf", dst / "port.gguf"
    getattr(jcc, fn)(src, jax_out, out_type)
    getattr(tcc, fn)(src, port_out, out_type)
    return jax_out, port_out


def _assert_same_file(a: Path, b: Path) -> None:
    """Byte-identical; else the first differing metadata key or tensor."""
    if filecmp.cmp(a, b, shallow=False):
        return
    with GGUFReader(str(a)) as ra, GGUFReader(str(b)) as rb:
        for key in ra.metadata:
            assert ra.metadata[key] == rb.metadata.get(key), key
        assert list(ra.metadata) == list(rb.metadata)
        assert list(ra.tensors) == list(rb.tensors)
        for name in ra.tensors:
            assert bytes(ra.raw_tensor(name)) == bytes(rb.raw_tensor(name)), \
                name
    pytest.fail(f"{a} and {b} differ outside metadata and tensor data")


@pytest.mark.parametrize("kind", ["tts", "codec"])
@pytest.mark.parametrize("out_type", TYPES)
def test_byte_identical(checkpoints, tmp_path, kind, out_type):
    jax_out, port_out = _convert_both(kind, checkpoints[kind]["f32"],
                                      out_type, tmp_path)
    _assert_same_file(jax_out, port_out)


@pytest.mark.parametrize("kind", ["tts", "codec"])
@pytest.mark.parametrize("out_type", ["f32", "f16", "q8_0"])
def test_byte_identical_from_bf16(checkpoints, tmp_path, kind, out_type):
    """A BF16 checkpoint: the port widens the bits itself; the JAX tool
    reads it only with ml_dtypes imported (ROADMAP C.6)."""
    jax_out, port_out = _convert_both(kind, checkpoints[kind]["bf16"],
                                      out_type, tmp_path)
    _assert_same_file(jax_out, port_out)
    with GGUFReader(str(port_out)) as r:
        any_big = next(n for n, i in r.tensors.items() if len(i.shape) == 2)
        assert np.isfinite(r.tensor_data(any_big)).all()


@pytest.mark.parametrize("out_type", ["f16", "q4_k"])
def test_generator_checkpoints_through_both(tmp_path, out_type):
    """chip_smoke.write_hf_checkpoints (two BF16 TTS shards, the codec) at
    tiny widths through both converters."""
    tts, codec = tmp_path / "hf_tts", tmp_path / "hf_codec"
    n = chip_smoke.write_hf_checkpoints(tts, codec, 77, **TINY)
    assert n > 0
    assert len(sf.checkpoint_files(tts)) == 2
    for kind, src in (("tts", tts), ("codec", codec)):
        d = tmp_path / kind
        d.mkdir()
        _assert_same_file(*_convert_both(kind, src, out_type, d))


def test_codec_usage_division_and_skips(tmp_path, capsys):
    """The codec's codebooks are divided by their clamped usage on the way
    (the usage tensors dropped), and unmapped names are skipped with a
    note, as in the JAX tool."""
    rng = np.random.default_rng(12)
    d = tmp_path / "codec"
    d.mkdir()
    arrays = make_codec_checkpoint(d, rng)
    arrays["decoder.unmapped.weight"] = np.ones(3, np.float32)
    sf.save_file(arrays, d / "model.safetensors")
    out = tmp_path / "c.gguf"
    tcc.convert_codec(d, out, "f32")
    assert "skip decoder.unmapped.weight" in capsys.readouterr().err
    p = "decoder.quantizer.rvq_first.vq.layers.0._codebook"
    with GGUFReader(str(out)) as r:
        assert not any("usage" in n for n in r.tensors)
        got = r.tensor_data("tok_dec.vq_first.0.codebook")
    np.testing.assert_array_equal(
        got, arrays[f"{p}.embedding_sum"]
        / np.maximum(arrays[f"{p}.cluster_usage"], 1e-5)[:, None])


def test_main_and_missing_checkpoint(tmp_path, monkeypatch):
    rng = np.random.default_rng(13)
    d = tmp_path / "tts"
    d.mkdir()
    make_tts_checkpoint(d, rng)
    out = tmp_path / "sub" / "tts.gguf"
    monkeypatch.setattr(sys, "argv", ["convert_checkpoints", "tts", "-i",
                                      str(d), "-o", str(out), "-t", "f16"])
    assert tcc.main() == 0
    with GGUFReader(str(out)) as r:
        assert r.get("qwen3-tts.block_count") == 2
    with pytest.raises(FileNotFoundError):
        tcc.convert_tts(tmp_path, tmp_path / "x.gguf", "f16")
