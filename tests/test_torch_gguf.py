"""The port's io/gguf.py against the JAX package's: the same container,
metadata and dequantizers (q8_0 / q4_0 / q4_k bitwise on the same bytes),
files written by either package read by the other, and tensors loaded
straight to a device as the file's bytes."""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tts_tpu.io import gguf as jg  # noqa: E402
from qwen3_tts_tpu_torch.io import gguf as tg  # noqa: E402


def _roundtrip_file(tmp_path, rng, writer_mod):
    w = writer_mod.GGUFWriter("qwen3-tts")
    w.add("qwen3-tts.block_count", 28)
    w.add("qwen3-tts.rope.freq_base", 1e6)
    w.add("qwen3-tts.rope.mrope_section", [24, 20, 20])
    w.add("tokenizer.ggml.tokens", ["a", "b", "Ġhello"])
    w.add("general.name", "test-model")
    w.add("some.bool", True)
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((4, 32)).astype(np.float32)
    c = rng.standard_normal((4, 64)).astype(np.float32)
    w.add_tensor("talker.blk.0.attn_q.weight", a, writer_mod.GGML_F32)
    w.add_tensor("talker.blk.0.attn_k.weight", b, writer_mod.GGML_F16)
    w.add_tensor("talker.blk.0.attn_v.weight", c, writer_mod.GGML_Q8_0)
    path = str(tmp_path / f"{writer_mod.__name__}.gguf")
    w.write(path)
    return path, a, b, c


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_roundtrip_across_packages(tmp_path, writer, reader):
    """A file either package writes, either package reads: the same
    metadata and the same tensors."""
    rng = np.random.default_rng(701)
    path, a, b, c = _roundtrip_file(tmp_path, rng,
                                    {"port": tg, "jax": jg}[writer])
    with {"port": tg, "jax": jg}[reader].GGUFReader(path) as r:
        assert r.get("qwen3-tts.block_count") == 28
        assert r.get("qwen3-tts.rope.freq_base") == pytest.approx(1e6)
        assert r.get("qwen3-tts.rope.mrope_section") == [24, 20, 20]
        assert r.get("tokenizer.ggml.tokens") == ["a", "b", "Ġhello"]
        assert r.get("general.name") == "test-model"
        assert r.get("some.bool") is True
        np.testing.assert_array_equal(
            r.tensor_data("talker.blk.0.attn_q.weight"), a)
        np.testing.assert_array_equal(
            r.tensor_data("talker.blk.0.attn_k.weight"),
            b.astype(np.float16).astype(np.float32))
        np.testing.assert_array_equal(
            r.tensor_data("talker.blk.0.attn_v.weight"),
            jg.dequantize(jg.quantize_q8_0(c), jg.GGML_Q8_0,
                          c.size).reshape(c.shape))
        assert r.get_any(["missing", "qwen3-tts.block_count"], 0) == 28
        assert r.get_any(["missing.key"], 42) == 42


@pytest.mark.parametrize("qtype,block", [(jg.GGML_Q8_0, 32),
                                         (jg.GGML_Q4_0, 32),
                                         (jg.GGML_Q4_K, 256)],
                         ids=["q8_0", "q4_0", "q4_k"])
def test_quantizers_and_dequantizers_bitwise(qtype, block):
    """The same quantized bytes from both packages, and the same values
    decoded from them."""
    rng = np.random.default_rng(702)
    x = (rng.standard_normal(4 * block) * 2.0 + 0.3).astype(np.float32)
    quant = {jg.GGML_Q8_0: "quantize_q8_0", jg.GGML_Q4_0: "quantize_q4_0",
             jg.GGML_Q4_K: "quantize_q4_k"}[qtype]
    raw = getattr(tg, quant)(x)
    np.testing.assert_array_equal(raw, getattr(jg, quant)(x))
    got = tg.dequantize(raw, qtype, x.size)
    want = jg.dequantize(raw, qtype, x.size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_dequant_known_blocks():
    d = np.float16(0.5).tobytes()
    qs = bytes((i | (i << 4)) for i in range(16))
    y = tg.dequantize(np.frombuffer(d + qs, dtype=np.uint8), tg.GGML_Q4_0, 32)
    expected = (np.concatenate([np.arange(16), np.arange(16)]) - 8.0) * 0.5
    np.testing.assert_array_equal(y, expected.astype(np.float32))

    raw = np.zeros(144, dtype=np.uint8)
    raw[0:2] = np.frombuffer(np.float16(1.0).tobytes(), dtype=np.uint8)
    raw[4] = 2
    raw[5:8] = 1
    raw[12:16] = 1
    raw[16:144] = 0x33
    y = tg.dequantize(raw, tg.GGML_Q4_K, 256)
    np.testing.assert_array_equal(y[:32], 6.0)
    np.testing.assert_array_equal(y[32:64], 3.0)
    np.testing.assert_array_equal(y[128:], 3.0)


def test_reader_supports_v2(tmp_path):
    rng = np.random.default_rng(703)
    w = tg.GGUFWriter("qwen3-tts")
    w.add("qwen3-tts.block_count", 4)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    w.add_tensor("t", a, tg.GGML_F32)
    path = str(tmp_path / "v2.gguf")
    w.write(path)
    with open(path, "r+b") as f:
        f.seek(4)
        f.write(struct.pack("<I", 2))
    with tg.GGUFReader(path) as r:
        assert r.version == 2
        assert r.get("qwen3-tts.block_count") == 4
        np.testing.assert_array_equal(r.tensor_data("t"), a)


def test_reader_rejects_bad_magic(tmp_path):
    path = str(tmp_path / "bad.gguf")
    with open(path, "wb") as f:
        f.write(b"NOPE" + b"\x00" * 64)
    with pytest.raises(ValueError, match="not a GGUF"):
        tg.GGUFReader(path)


def test_writer_integer_tensors_roundtrip_as_i32(tmp_path):
    w = tg.GGUFWriter("t")
    ids = np.arange(100) + 2**25          # past f32's exact integers
    w.add_tensor("ids", ids)
    path = tmp_path / "ints.gguf"
    w.write(str(path))
    with tg.GGUFReader(str(path)) as r:
        arr = r.tensor_data("ids")
        t = r.tensor("ids", "cpu")
    assert arr.dtype == np.int32 and t.dtype == torch.int32
    np.testing.assert_array_equal(arr.reshape(-1), ids)
    np.testing.assert_array_equal(t.numpy().reshape(-1), ids)
    with pytest.raises(ValueError, match="int32 range"):
        tg.GGUFWriter("t").add_tensor("big", np.array([2**40]))


def test_bf16_tensors_roundtrip_exactly(tmp_path):
    """BF16 tensors keep their bits through the port's writer and reader,
    and the JAX reader widens them to the same f32 values."""
    rng = np.random.default_rng(704)
    x = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    xb = x.bfloat16()
    w = tg.GGUFWriter("t")
    w.add_tensor("bits", xb.view(torch.int16).numpy().view(np.uint16),
                 tg.GGML_BF16)
    w.add_tensor("rounded", x.numpy(), tg.GGML_BF16)
    path = str(tmp_path / "bf16.gguf")
    w.write(path)
    with tg.GGUFReader(path) as r:
        for name in ("bits", "rounded"):
            got = r.tensor(name, "cpu")
            assert got.dtype == torch.bfloat16 and got.shape == (6, 40)
            assert torch.equal(got.view(torch.int16), xb.view(torch.int16))
    with jg.GGUFReader(path) as r:
        np.testing.assert_array_equal(r.tensor_data("bits"), xb.float().numpy())


@pytest.mark.parametrize("ggml_type", [tg.GGML_F32, tg.GGML_F16,
                                       tg.GGML_Q8_0, tg.GGML_Q4_K],
                         ids=["f32", "f16", "q8_0", "q4_k"])
def test_tensor_to_device_matches_host_values(tmp_path, ggml_type):
    """GGUFReader.tensor: raw f32 / f16 bytes viewed and cast on the
    device, quantized types dequantized on the host; the values equal
    tensor_data's and the cast rounds as a host cast does."""
    rng = np.random.default_rng(705)
    a = rng.standard_normal((3, 256)).astype(np.float32)
    w = tg.GGUFWriter("t")
    w.add_tensor("a", a, ggml_type)
    path = str(tmp_path / "a.gguf")
    w.write(path)
    with tg.GGUFReader(path) as r:
        host = r.tensor_data("a")
        native = r.tensor("a", "cpu")
        bf = r.tensor("a", torch.device("cpu"), torch.bfloat16)
    assert native.dtype == (torch.float16 if ggml_type == tg.GGML_F16
                            else torch.float32)
    assert native.shape == (3, 256)
    np.testing.assert_array_equal(native.float().numpy(), host)
    assert torch.equal(bf.view(torch.int16),
                       torch.from_numpy(host).bfloat16().view(torch.int16))

