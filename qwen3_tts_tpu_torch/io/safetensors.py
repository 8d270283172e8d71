"""Safetensors checkpoints: the port's own reader and writer, so that the
offline tools need neither the ``safetensors`` package nor ``ml_dtypes``.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the data section that follows the header) plus an optional
``"__metadata__"`` map of strings, then the raw little-endian data.

``SafeTensorsFile`` (the counterpart of ``safe_open``) maps the file and
returns each tensor as a numpy view of the mapping, so a checkpoint is
never read whole into memory; BF16 is widened exactly to f32 (its bits
are the high half of an f32's), which is what ``safe_open(...,
framework="np")`` gives with ``ml_dtypes`` imported followed by
``astype(np.float32)``. ``keys()`` lists names in sorted order,
as ``safe_open`` does. ``checkpoint_files`` finds a checkpoint's files the
way the converter looks for them: the directory's ``*.safetensors`` in
sorted order (one file or shards), else those under ``speech_tokenizer/``.
``save_file`` writes a file that ``safetensors`` reads back.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Iterator

import numpy as np

from .gguf import bf16_bits

# safetensors dtype name -> numpy dtype of the stored values (BF16: bits)
DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"), "I64": np.dtype("<i8"), "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"), "I8": np.dtype("i1"), "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
_NAMES = {dt: name for name, dt in DTYPES.items() if name != "BF16"}


class SafeTensorsFile:
    """One mapped ``.safetensors`` file (a context manager)."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
            size = f.seek(0, 2)
            self._mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                        if size > 8 + n else None)
        self._metadata = header.pop("__metadata__", None)
        self._data_start = 8 + n
        self._entries = header
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{self.path}: tensor {name} has dtype "
                                 f"{e['dtype']}, which is not read")
            begin, end = e["data_offsets"]
            count = int(np.prod(e["shape"], dtype=np.int64))
            if end - begin != count * DTYPES[e["dtype"]].itemsize \
                    or self._data_start + end > size:
                raise ValueError(f"{self.path}: tensor {name} has bad "
                                 f"offsets {e['data_offsets']}")

    def keys(self) -> list[str]:
        return sorted(self._entries)

    def metadata(self) -> dict | None:
        return self._metadata

    def get_tensor(self, name: str) -> np.ndarray:
        """Tensor `name` as a read-only view of the mapping (BF16: a new
        f32 array holding the same values)."""
        e = self._entries[name]
        dt = DTYPES[e["dtype"]]
        shape = tuple(e["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if count == 0:
            a = np.empty(shape, dt)
        else:
            a = np.frombuffer(self._mm, dtype=dt, count=count,
                              offset=self._data_start + e["data_offsets"][0]
                              ).reshape(shape)
        if e["dtype"] == "BF16":      # the high half of an f32's bits
            return (a.astype(np.uint32) << 16).view(np.float32)
        return a

    def close(self) -> None:
        """Release the mapping; views still alive keep it until they go."""
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass
            self._mm = None

    def __enter__(self) -> "SafeTensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def checkpoint_files(input_dir) -> list[Path]:
    """The checkpoint's ``*.safetensors`` files in sorted order, else those
    under ``speech_tokenizer/``; [] when there are none."""
    input_dir = Path(input_dir)
    files = sorted(input_dir.glob("*.safetensors"))
    sub = input_dir / "speech_tokenizer"
    if not files and sub.exists():
        files = sorted(sub.glob("*.safetensors"))
    return files


def iter_tensors(files) -> Iterator[tuple[str, np.ndarray]]:
    """(name, array) over `files` in order, each file's names sorted."""
    for path in files:
        with SafeTensorsFile(path) as f:
            for name in f.keys():
                yield name, f.get_tensor(name)


def save_file(tensors: dict, path, metadata: dict | None = None, *,
              bf16: bool = False) -> None:
    """Write `tensors` (name -> numpy array) in insertion order. bf16=True
    stores every floating array as BF16, rounded to nearest even; a uint16
    array is taken as BF16 bits then too."""
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    payloads, offset = [], 0
    for name, a in tensors.items():
        a = np.asarray(a)
        if bf16 and (a.dtype.kind == "f" or a.dtype == np.uint16):
            dtype, raw = "BF16", bf16_bits(a)
        else:
            dtype = _NAMES.get(a.dtype.newbyteorder("<"))
            if dtype is None:
                raise ValueError(f"tensor {name}: dtype {a.dtype} is not "
                                 f"written")
            raw = a.astype(a.dtype.newbyteorder("<"), copy=False)
        raw = np.ascontiguousarray(raw)
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [offset, offset + raw.nbytes]}
        payloads.append(raw)
        offset += raw.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in payloads:
            f.write(memoryview(raw.reshape(-1)).cast("B"))
