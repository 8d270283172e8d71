"""io/safetensors.py, the port's own safetensors reader and writer,
against the ``safetensors`` package: the reader returns bitwise what
``safetensors.numpy.load_file`` returns, BF16 widened to the values that
``safe_open`` gives with ``ml_dtypes`` imported; the package reads the
writer's files back equal; checkpoints are found as the converter looks
for them (sharded files in sorted order, the ``speech_tokenizer/``
fallback)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
st_numpy = pytest.importorskip("safetensors.numpy")
safetensors = pytest.importorskip("safetensors")
ml_dtypes = pytest.importorskip("ml_dtypes")

from qwen3_tts_tpu_torch.io import safetensors as sf  # noqa: E402


def _arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "f64": rng.standard_normal((3, 5)),
        "f32": rng.standard_normal((4, 2, 3)).astype(np.float32),
        "f16": rng.standard_normal(7).astype(np.float16),
        "i64": rng.integers(-2**40, 2**40, (2, 3)),
        "i32": rng.integers(-2**30, 2**30, 9).astype(np.int32),
        "i16": rng.integers(-2**14, 2**14, 4).astype(np.int16),
        "i8": rng.integers(-100, 100, 6).astype(np.int8),
        "u8": rng.integers(0, 255, 5).astype(np.uint8),
        "bool": rng.random(8) > 0.5,
        "scalar": np.asarray(rng.standard_normal(), np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }


def _bitwise(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_reader_matches_load_file(tmp_path):
    arrays = _arrays(0)
    path = tmp_path / "a.safetensors"
    st_numpy.save_file(arrays, str(path), metadata={"format": "np"})
    want = st_numpy.load_file(str(path))
    with sf.SafeTensorsFile(path) as f:
        assert f.metadata() == {"format": "np"}
        assert f.keys() == sorted(arrays)
        with safetensors.safe_open(str(path), framework="np") as g:
            assert f.keys() == list(g.keys())
        for name in arrays:
            _bitwise(f.get_tensor(name), want[name])


def test_reader_widens_bf16_as_ml_dtypes(tmp_path):
    """BF16 (stored by torch, as the published checkpoints are) reads as
    f32 holding the values ml_dtypes gives."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((6, 10)).astype(np.float32) * 10.0
    vals[0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    t = torch.from_numpy(vals).to(torch.bfloat16)
    from safetensors.torch import save_file as save_pt
    path = tmp_path / "bf16.safetensors"
    save_pt({"w": t}, str(path))
    with safetensors.safe_open(str(path), framework="np") as g:
        ref = g.get_tensor("w")
    assert ref.dtype == ml_dtypes.bfloat16
    with sf.SafeTensorsFile(path) as f:
        got = f.get_tensor("w")
    _bitwise(got, ref.astype(np.float32))
    _bitwise(got, t.float().numpy())


def test_writer_read_back_by_safetensors(tmp_path):
    arrays = _arrays(2)
    path = tmp_path / "w.safetensors"
    sf.save_file(arrays, path, metadata={"format": "pt", "n": 3})
    got = st_numpy.load_file(str(path))
    for name, a in arrays.items():
        _bitwise(got[name], a)
    with safetensors.safe_open(str(path), framework="pt") as g:
        assert g.metadata() == {"format": "pt", "n": "3"}
        np.testing.assert_array_equal(g.get_tensor("f32").numpy(),
                                      arrays["f32"])


def test_writer_bf16(tmp_path):
    """bf16=True stores floats as BF16, rounded to nearest even, and takes
    uint16 arrays as bits; torch reads the same bf16 values back."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 4)).astype(np.float32)
    bits = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16)
    path = tmp_path / "b.safetensors"
    sf.save_file({"a": a, "bits": bits.numpy().view(np.uint16),
                  "ids": np.arange(4, dtype=np.int64)}, path, bf16=True)
    with safetensors.safe_open(str(path), framework="pt") as g:
        for name in ("a", "bits"):
            t = g.get_tensor(name)
            assert t.dtype == torch.bfloat16
            assert torch.equal(t.view(torch.int16), bits)
        assert g.get_tensor("ids").dtype == torch.int64
    with sf.SafeTensorsFile(path) as f:
        _bitwise(f.get_tensor("a"), torch.from_numpy(a).to(
            torch.bfloat16).float().numpy())


def test_checkpoint_files_shards_and_speech_tokenizer(tmp_path):
    """Shards are read in sorted file order, each file's names sorted;
    a directory without files of its own falls back to
    speech_tokenizer/; an empty one has none."""
    rng = np.random.default_rng(4)
    d = tmp_path / "ckpt"
    d.mkdir()
    shards = {"model-00002-of-00002.safetensors": {
                  "b.x": rng.standard_normal(3).astype(np.float32),
                  "a.y": rng.standard_normal(2).astype(np.float32)},
              "model-00001-of-00002.safetensors": {
                  "z.w": rng.standard_normal(4).astype(np.float32)}}
    for name, arrays in shards.items():
        sf.save_file(arrays, d / name)
    (d / "model.safetensors.index.json").write_text(json.dumps({}))
    files = sf.checkpoint_files(d)
    assert [p.name for p in files] == sorted(shards)
    names = [n for n, _ in sf.iter_tensors(files)]
    assert names == ["z.w", "a.y", "b.x"]

    codec = tmp_path / "codec"
    (codec / "speech_tokenizer").mkdir(parents=True)
    sf.save_file({"decoder.w": np.ones(2, np.float32)},
                 codec / "speech_tokenizer" / "model.safetensors")
    assert [p.parent.name for p in sf.checkpoint_files(codec)] == [
        "speech_tokenizer"]
    (tmp_path / "empty").mkdir()
    assert sf.checkpoint_files(tmp_path / "empty") == []


def test_reader_refuses_bad_files(tmp_path):
    path = tmp_path / "bad.safetensors"
    header = json.dumps({"w": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 8]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + b"\0" * 8)
    with pytest.raises(ValueError, match="bad offsets"):
        sf.SafeTensorsFile(path)
    header = json.dumps({"w": {"dtype": "F8_E4M3", "shape": [1],
                               "data_offsets": [0, 1]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + b"\0")
    with pytest.raises(ValueError, match="not read"):
        sf.SafeTensorsFile(path)
    path.write_bytes(b"\1\2")
    with pytest.raises(ValueError, match="not a safetensors"):
        sf.SafeTensorsFile(path)


def test_views_outlive_the_file(tmp_path):
    """A tensor read before close stays valid after it (the mapping is
    released when the last view goes)."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = tmp_path / "v.safetensors"
    sf.save_file({"a": a}, path)
    with sf.SafeTensorsFile(path) as f:
        view = f.get_tensor("a")
        assert not view.flags.writeable
    np.testing.assert_array_equal(view, a)
