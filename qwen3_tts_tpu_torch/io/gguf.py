"""GGUF file reader and writer (the port's own copy of
qwen3_tts_tpu/io/gguf.py: the same container subset, dequantizers and
quantizers, so that a file either package writes the other reads).

The GGUF v2/v3 container: header, KV metadata, tensor table and an aligned
data section; dequantization of F32/F16/BF16/Q8_0/Q4_0/Q4_K in numpy.
Tensors come back in row-major (torch) convention: GGUF's `ne` dims are
fastest-first, so the shape is `reversed(ne)`.

Beyond the JAX package's module: ``GGUFReader.tensor`` puts a tensor
straight onto a device (raw bytes through pinned memory, cast there), and
the writer stores BF16 tensors.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Iterable

import numpy as np
import torch

GGUF_MAGIC = 0x46554747  # 'GGUF' little-endian
GGUF_VERSION = 3
DEFAULT_ALIGNMENT = 32

# GGUF metadata value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, T_U64, T_I64, T_F64 = range(13)

_SCALAR_FMT = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
    T_U32: "<I", T_I32: "<i", T_F32: "<f", T_BOOL: "<B",
    T_U64: "<Q", T_I64: "<q", T_F64: "<d",
}

# GGML tensor data types (subset)
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_I32 = 26
GGML_I64 = 27
GGML_BF16 = 30

GGML_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_Q4_0: "Q4_0",
    GGML_Q8_0: "Q8_0", GGML_Q4_K: "Q4_K", GGML_I32: "I32",
    GGML_I64: "I64", GGML_BF16: "BF16",
}

# (block_size_elems, block_bytes)
_BLOCK_LAYOUT = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_BF16: (1, 2),
    GGML_I32: (1, 4),
    GGML_I64: (1, 8),
    GGML_Q8_0: (32, 34),
    GGML_Q4_0: (32, 18),
    GGML_Q4_K: (256, 144),
}


def tensor_nbytes(ggml_type: int, n_elements: int) -> int:
    bs, bb = _BLOCK_LAYOUT[ggml_type]
    if n_elements % bs != 0:
        raise ValueError(f"element count {n_elements} not a multiple of block size {bs}")
    return (n_elements // bs) * bb


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]   # numpy/torch row-major shape (= reversed GGUF ne)
    ggml_type: int
    offset: int              # relative to data section start

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.ggml_type, self.n_elements)


# ---------------------------------------------------------------------------
# Dequantization (vectorized numpy)
# ---------------------------------------------------------------------------

def _dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)        # [nb,1]
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)                  # [nb,32]
    return (d * qs).reshape(-1)[:n]


def _dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 18)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)         # [nb,1]
    qs = blocks[:, 2:]                                                    # [nb,16]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d        # [nb,32]
    return out.reshape(-1)[:n]


def _dequant_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 144)
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(nb)      # super scale
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(nb)   # super min
    scales = blocks[:, 4:16].astype(np.uint8)                                       # [nb,12]
    qs = blocks[:, 16:144].astype(np.uint8)                                         # [nb,128]

    sc = np.empty((nb, 8), dtype=np.float32)
    mn = np.empty((nb, 8), dtype=np.float32)
    for j in range(8):
        if j < 4:
            sc[:, j] = (scales[:, j] & 63).astype(np.float32)
            mn[:, j] = (scales[:, j + 4] & 63).astype(np.float32)
        else:
            sc[:, j] = ((scales[:, j + 4] & 0x0F) | ((scales[:, j - 4] >> 6) << 4)).astype(np.float32)
            mn[:, j] = ((scales[:, j + 4] >> 4) | ((scales[:, j] >> 6) << 4)).astype(np.float32)

    # 4 chunks of 32 bytes, each yields 64 values: 32 low-nibble (sub-block 2c)
    # then 32 high-nibble (sub-block 2c+1)
    q = qs.reshape(nb, 4, 32)
    lo = (q & 0x0F).astype(np.float32)   # [nb,4,32]
    hi = (q >> 4).astype(np.float32)     # [nb,4,32]
    out = np.empty((nb, 8, 32), dtype=np.float32)
    for c in range(4):
        out[:, 2 * c, :] = lo[:, c, :]
        out[:, 2 * c + 1, :] = hi[:, c, :]
    vals = d[:, None, None] * sc[:, :, None] * out - dmin[:, None, None] * mn[:, :, None]
    return vals.reshape(-1)[:n]


def dequantize(raw: bytes | np.ndarray, ggml_type: int, n_elements: int) -> np.ndarray:
    """Decode a raw GGUF tensor payload to float32 (or native int) values."""
    buf = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    if ggml_type == GGML_F32:
        return buf.view(np.float32)[:n_elements].copy()
    if ggml_type == GGML_F16:
        return buf.view(np.float16)[:n_elements].astype(np.float32)
    if ggml_type == GGML_BF16:
        u16 = buf.view(np.uint16)[:n_elements].astype(np.uint32) << 16
        return u16.view(np.float32).copy()
    if ggml_type == GGML_I32:
        return buf.view(np.int32)[:n_elements].copy()
    if ggml_type == GGML_I64:
        return buf.view(np.int64)[:n_elements].copy()
    if ggml_type == GGML_Q8_0:
        return _dequant_q8_0(buf, n_elements)
    if ggml_type == GGML_Q4_0:
        return _dequant_q4_0(buf, n_elements)
    if ggml_type == GGML_Q4_K:
        return _dequant_q4_k(buf, n_elements)
    raise ValueError(f"unsupported GGML type {ggml_type}")


def bf16_bits(data: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) of `data`: a uint16 array is taken
    as bit patterns already; floats round to nearest, ties to even."""
    if data.dtype == np.uint16:
        return data
    u = np.ascontiguousarray(data, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def quantize_q8_0(data: np.ndarray) -> np.ndarray:
    """Q8_0-quantize float data (for writer/tests). Returns raw uint8 payload."""
    flat = data.astype(np.float32).reshape(-1)
    if flat.size % 32 != 0:
        raise ValueError("Q8_0 requires a multiple of 32 elements")
    groups = flat.reshape(-1, 32)
    amax = np.abs(groups).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.round(groups * inv[:, None]).clip(-127, 127).astype(np.int8)
    out = np.empty((groups.shape[0], 34), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def quantize_q4_0(data: np.ndarray) -> np.ndarray:
    """Q4_0-quantize float data (GGML block format: f16 scale + 16 bytes
    of nibbles per 32 values; low nibbles = elems 0..15, high = 16..31).
    Scale convention follows ggml's quantize_row_q4_0: d = signed_max/-8,
    q = clip(x/d + 8.5, 0, 15)."""
    flat = data.astype(np.float32).reshape(-1)
    if flat.size % 32 != 0:
        raise ValueError("Q4_0 requires a multiple of 32 elements")
    groups = flat.reshape(-1, 32)
    idx = np.abs(groups).argmax(axis=1)
    smax = groups[np.arange(len(groups)), idx]          # signed max-|.|
    d = (smax / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(groups * inv[:, None] + 8.5, 0.0, 15.0).astype(np.uint8)
    out = np.empty((groups.shape[0], 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_q4_k(data: np.ndarray) -> np.ndarray:
    """Q4_K-quantize float data (GGML super-block format: 256 values in 8
    sub-blocks of 32; f16 super scale d + super min dmin, 12 bytes of
    6-bit sub-block scales/mins, 128 bytes of nibbles).

    Simple min/max encoder (value = d*sc*q - dmin*mn); the format does
    not prescribe the optimizer, so any encoding decodable by
    _dequant_q4_k is valid."""
    flat = data.astype(np.float32).reshape(-1)
    if flat.size % 256 != 0:
        raise ValueError("Q4_K requires a multiple of 256 elements")
    sub = flat.reshape(-1, 8, 32)
    nb = sub.shape[0]
    smin = np.minimum(sub.min(axis=2), 0.0)             # [nb, 8], <= 0
    smax = sub.max(axis=2)
    scales = np.maximum((smax - smin) / 15.0, 0.0)      # per-sub scale
    mins = -smin                                        # >= 0
    d = np.max(scales, axis=1) / 63.0                   # [nb]
    dmin = np.max(mins, axis=1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1.0, dmin), 0.0)
    sc = np.clip(np.round(scales * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn = np.clip(np.round(mins * inv_m[:, None]), 0, 63).astype(np.uint8)

    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    eff_scale = d16[:, None, None] * sc[:, :, None].astype(np.float32)
    eff_min = dmin16[:, None, None] * mn[:, :, None].astype(np.float32)
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale == 0, 1.0,
                                                   eff_scale), 0.0)
    q = np.clip(np.round((sub + eff_min) * inv_s), 0, 15).astype(np.uint8)

    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    # 6-bit scale/min packing (inverse of _dequant_q4_k)
    packed = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(4):
        packed[:, j] = (sc[:, j] & 63) | ((sc[:, j + 4] >> 4) << 6)
        packed[:, j + 4] = (mn[:, j] & 63) | ((mn[:, j + 4] >> 4) << 6)
        packed[:, j + 8] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)
    out[:, 4:16] = packed
    qr = q.reshape(nb, 4, 2, 32)                        # [nb, chunk, lo/hi, 32]
    out[:, 16:] = (qr[:, :, 0, :] | (qr[:, :, 1, :] << 4)).reshape(nb, 128)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class GGUFReader:
    """mmap-backed GGUF reader.

    `metadata` maps key -> python value; `tensors` maps name -> GGUFTensorInfo.
    `tensor_data(name)` returns the dequantized numpy array in row-major shape.
    """

    def __init__(self, path: str):
        self.path = path
        self._file: BinaryIO = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self._parse()

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- parsing helpers ---------------------------------------------------
    def _parse(self) -> None:
        mm = self._mm
        self._pos = 0
        magic, version, n_tensors, n_kv = struct.unpack_from("<IIQQ", mm, 0)
        self._pos = 24
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        if version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {version}")
        self.version = version

        for _ in range(n_kv):
            key = self._read_str()
            vtype = self._read_fmt("<I")
            self.metadata[key] = self._read_value(vtype)

        infos = []
        for _ in range(n_tensors):
            name = self._read_str()
            n_dims = self._read_fmt("<I")
            ne = [self._read_fmt("<Q") for _ in range(n_dims)]
            ggml_type = self._read_fmt("<I")
            offset = self._read_fmt("<Q")
            infos.append(GGUFTensorInfo(name, tuple(reversed(ne)), ggml_type, offset))

        alignment = int(self.metadata.get("general.alignment", DEFAULT_ALIGNMENT))
        self.data_start = (self._pos + alignment - 1) // alignment * alignment
        for info in infos:
            self.tensors[info.name] = info

    def _read_fmt(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += struct.calcsize(fmt)
        return v

    def _read_str(self) -> str:
        n = self._read_fmt("<Q")
        s = self._mm[self._pos:self._pos + n].decode("utf-8", errors="replace")
        self._pos += n
        return s

    def _read_value(self, vtype: int):
        if vtype == T_STR:
            return self._read_str()
        if vtype == T_ARR:
            etype = self._read_fmt("<I")
            count = self._read_fmt("<Q")
            if etype == T_STR:
                return [self._read_str() for _ in range(count)]
            if etype == T_ARR:
                return [self._read_value(T_ARR) for _ in range(count)]
            fmt = _SCALAR_FMT[etype]
            size = struct.calcsize(fmt)
            arr = np.frombuffer(self._mm, dtype=np.dtype(fmt[1:]),
                                count=count, offset=self._pos).copy()
            self._pos += size * count
            if etype == T_BOOL:
                arr = arr.astype(bool)
            return arr.tolist()
        v = self._read_fmt(_SCALAR_FMT[vtype])
        return bool(v) if vtype == T_BOOL else v

    # -- public API ---------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self.metadata.get(key, default)

    def get_any(self, keys: Iterable[str], default: Any = None) -> Any:
        """Multi-key fallback chain, mirroring parse_config's get_u32_any
        (tts_transformer.cpp:289-307)."""
        for k in keys:
            if k in self.metadata:
                return self.metadata[k]
        return default

    def raw_tensor(self, name: str) -> memoryview:
        info = self.tensors[name]
        start = self.data_start + info.offset
        return memoryview(self._mm)[start:start + info.nbytes]

    def tensor(self, name: str, device, dtype: torch.dtype | None = None,
               stager: "HostStager | None" = None) -> torch.Tensor:
        """Tensor `name` on `device` in row-major shape, cast to `dtype`
        there (None keeps the file's type; quantized types give f32).

        F32, F16, BF16 and integer payloads cross as their raw bytes in one
        copy and are viewed and cast on the device; quantized payloads are
        dequantized on the host (the numpy code above), then cross. A CUDA
        copy goes through `stager`'s pinned buffers (pass one stager for
        many tensors; None makes one for this tensor)."""
        info = self.tensors[name]
        raw = np.frombuffer(self.raw_tensor(name), dtype=np.uint8)
        src_dtype = _TORCH_DTYPES.get(info.ggml_type)
        if src_dtype is None:
            raw = dequantize(raw, info.ggml_type, info.n_elements).view(
                np.uint8)
            src_dtype = torch.float32
        device = torch.device(device)
        if device.type == "cuda":
            stager = stager or HostStager(min(HostStager.CHUNK, raw.size))
            flat = stager.to_device(raw, device)
        else:
            flat = torch.from_numpy(raw.copy())
        out = flat.view(src_dtype).reshape(info.shape)
        return out if dtype is None else out.to(dtype)

    def tensor_data(self, name: str, dtype=None) -> np.ndarray:
        """Dequantized tensor in row-major (torch) shape, on the host."""
        info = self.tensors[name]
        raw = np.frombuffer(self.raw_tensor(name), dtype=np.uint8)
        out = dequantize(raw, info.ggml_type, info.n_elements).reshape(
            info.shape)
        if dtype is not None:
            out = out.astype(dtype)
        return out


_TORCH_DTYPES = {GGML_F32: torch.float32, GGML_F16: torch.float16,
                 GGML_BF16: torch.bfloat16, GGML_I32: torch.int32,
                 GGML_I64: torch.int64}


class HostStager:
    """Host -> card copies of raw bytes through two pinned buffers of
    `chunk` bytes: the host fills one while the card's copy engine drains
    the other, so a file's bytes cross in one pass without a pageable
    staging copy by the driver. Each buffer is reused only after the copy
    that read it has completed (its event)."""

    CHUNK = 64 << 20

    def __init__(self, chunk: int = CHUNK):
        self.chunk = max(chunk, 1)
        self._bufs: list[torch.Tensor] = []
        self._events: list[torch.cuda.Event | None] = []
        self._next = 0                  # the buffer the next chunk fills

    def to_device(self, raw: np.ndarray, device: torch.device
                  ) -> torch.Tensor:
        """A uint8 tensor on `device` holding `raw`'s bytes; the copy is
        ordered on the device's current stream."""
        out = torch.empty(raw.size, dtype=torch.uint8, device=device)
        if not self._bufs:
            self._bufs = [torch.empty(self.chunk, dtype=torch.uint8,
                                      pin_memory=True) for _ in range(2)]
            self._events = [None, None]
        stream = torch.cuda.current_stream(device)
        for off in range(0, raw.size, self.chunk):
            n = min(self.chunk, raw.size - off)
            slot = self._next
            self._next ^= 1
            if self._events[slot] is not None:
                self._events[slot].synchronize()
            buf = self._bufs[slot]
            buf.numpy()[:n] = raw[off:off + n]
            out[off:off + n].copy_(buf[:n], non_blocking=True)
            self._events[slot] = torch.cuda.Event()
            self._events[slot].record(stream)
        return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _encode_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _infer_vtype(v: Any) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, int):
        return T_U32 if 0 <= v < 2 ** 32 else T_I64
    if isinstance(v, float):
        return T_F32
    if isinstance(v, str):
        return T_STR
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


def _encode_value(v: Any, vtype: int) -> bytes:
    if vtype == T_STR:
        return _encode_str(v)
    if vtype == T_ARR:
        if len(v) == 0:
            return struct.pack("<IQ", T_U32, 0)
        etype = _infer_vtype(v[0])
        # join a chunk list: `out +=` in this loop was quadratic — a real
        # vocab-sized string array (151k entries) took ~30 s to encode
        chunks = [struct.pack("<IQ", etype, len(v))]
        chunks += [_encode_value(e, etype) for e in v]
        return b"".join(chunks)
    return struct.pack(_SCALAR_FMT[vtype], int(v) if vtype == T_BOOL else v)


class GGUFWriter:
    """Minimal GGUF v3 writer (f32/f16/bf16/q8_0/q4_0/q4_k/i32 tensors)."""

    def __init__(self, arch: str):
        self.arch = arch
        self._kv: list[tuple[str, int, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], int, bytes]] = []
        self.add("general.architecture", arch)

    def add(self, key: str, value: Any) -> None:
        if isinstance(value, (list, tuple)):
            self._kv.append((key, T_ARR, list(value)))
        elif isinstance(value, float):
            self._kv.append((key, T_F32, value))
        else:
            self._kv.append((key, _infer_vtype(value), value))

    def add_f32_scalar(self, key: str, value: float) -> None:
        self._kv.append((key, T_F32, float(value)))

    def add_tensor(self, name: str, data: np.ndarray, ggml_type: int | None = None) -> None:
        data = np.ascontiguousarray(data)
        if ggml_type is None:
            if data.dtype == np.float16:
                ggml_type = GGML_F16
            elif np.issubdtype(data.dtype, np.integer):
                # all integer inputs (incl. numpy's default int64) write
                # as I32 — silently casting them to F32 corrupted values
                # above 2^24
                if (data.size and (data.min() < np.iinfo(np.int32).min
                                   or data.max() > np.iinfo(np.int32).max)):
                    raise ValueError(
                        f"integer tensor {name} exceeds int32 range; "
                        f"pass an explicit ggml_type")
                ggml_type = GGML_I32
            else:
                ggml_type = GGML_F32
                data = data.astype(np.float32)
        if ggml_type == GGML_Q8_0:
            payload = quantize_q8_0(data).tobytes()
        elif ggml_type == GGML_Q4_0:
            payload = quantize_q4_0(data).tobytes()
        elif ggml_type == GGML_Q4_K:
            payload = quantize_q4_k(data).tobytes()
        elif ggml_type == GGML_F16:
            payload = data.astype(np.float16).tobytes()
        elif ggml_type == GGML_F32:
            payload = data.astype(np.float32).tobytes()
        elif ggml_type == GGML_BF16:
            payload = bf16_bits(data).tobytes()
        elif ggml_type == GGML_I32:
            payload = data.astype(np.int32).tobytes()
        else:
            raise ValueError(f"writer does not support GGML type {ggml_type}")
        self._tensors.append((name, data.shape, ggml_type, payload))

    def write(self, path: str) -> None:
        align = DEFAULT_ALIGNMENT
        header = struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                             len(self._tensors), len(self._kv))
        body_parts = []
        for key, vtype, value in self._kv:
            body_parts += [_encode_str(key), struct.pack("<I", vtype),
                           _encode_value(value, vtype)]
        body = b"".join(body_parts)

        offset = 0
        info_parts: list[bytes] = []
        payloads: list[tuple[int, bytes]] = []
        for name, shape, ggml_type, payload in self._tensors:
            ne = list(reversed(shape)) if shape else [1]
            info_parts.append(_encode_str(name))
            info_parts.append(struct.pack("<I", len(ne)))
            info_parts += [struct.pack("<Q", d) for d in ne]
            info_parts.append(struct.pack("<IQ", ggml_type, offset))
            payloads.append((offset, payload))
            offset += (len(payload) + align - 1) // align * align
        infos = b"".join(info_parts)

        head = header + body + infos
        data_start = (len(head) + align - 1) // align * align
        with open(path, "wb") as f:
            f.write(head)
            f.write(b"\x00" * (data_start - len(head)))
            pos = 0
            for off, payload in payloads:
                if off > pos:
                    f.write(b"\x00" * (off - pos))
                    pos = off
                f.write(payload)
                pos += len(payload)
