"""Build and bind the port's CUDA kernels.

The sources in ``csrc/`` are compiled on first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
ctypes. The library lands in ``_build/`` under a name that hashes the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.
Nothing here runs at import time: the CPU tests import every module of the
port on machines without nvcc or a card.

Every C entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code, so a refused launch is never silent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (every function also takes the stream last, returns int)
_SIGNATURES = {
    "q3_codepred_frame": (_P,) * 27 + (_I,) * 5 + (_F,) * 2,
    "q3_snake_bf16": (_P, _P, _I, _I, _I, _P, _P, _I),
    "q3_res_conv7": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I),
    "q3_res_conv1": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I),
    "q3_snake_convt": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I),
    "q3_flash_decode": (_P,) * 9 + (_I,) * 9 + (_F, _I) + (_P,) * 4,
    "q3_talker_step": (_P,) * 22 + (_I,) * 7 + (_F,) * 3,
    "q3_moe_ffn": (_P,) * 19 + (_I,) * 8,
    "q3_moe_ffn_ep": (_P,) * 15 + (_I,) * 10 + (_F,),
    "q3_mla_decode": (_P,) * 7 + (_I,) * 5 + (_F,),
}
# C functions that take no stream: name -> (argument types, result type)
_HOST_SIGNATURES = {
    "q3_codepred_launches": ((), _I),
    "q3_codepred_add_launches": ((_I,), _I),
    "q3_talker_scratch": ((_I,) * 4 + (ctypes.POINTER(ctypes.c_longlong),),
                          _I),
}

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which("nvcc") or (
        CUDA_HOME and str(Path(CUDA_HOME) / "bin" / "nvcc"))
    if not nvcc or not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; wait for all, then raise on the
    first that failed. Returns their outputs."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return outs


def build_log() -> str:
    """What ptxas said of every kernel (registers, shared memory, spills)
    when the current library was built."""
    log = build().with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else "(no ptxas log)"


def build() -> Path:
    """Compile csrc/*.cu into _build/ (once per source hash), one nvcc per
    source in parallel, then link; return the library path."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib = BUILD_DIR / f"libq3tts_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        outs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", "-o",
                          str(o), str(s)] for s, o in zip(sources, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        lib.with_suffix(".ptxas.txt").write_text(
            "".join(f"== {s.name}\n{out}" for s, out in zip(sources, outs)))
        os.replace(tmp, lib)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = [*args, _P]
            fn.restype = ctypes.c_int
        for name, (args, res) in _HOST_SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = list(args), res
        _LIB = handle
    return _LIB


def codepred_launches() -> int:
    """Cooperative launches of the code-predictor kernel in this process,
    as the C side counts them (CUDA graph replays included:
    runtime/graphs.py adds what each replay launched)."""
    return lib().q3_codepred_launches()


def add_codepred_launches(n: int) -> None:
    """Add n (which may be negative) to the C side's launch count."""
    lib().q3_codepred_add_launches(n)


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
