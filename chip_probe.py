#!/usr/bin/env python3
"""Planted-fault probe of the talker megakernel on one NVIDIA GPU.

Run from the repository root: ``python3 chip_probe.py [name ...]`` (the
named mutants only; all by default). For the sound
kernel and for each one-line mutant of
qwen3_tts_tpu_torch/csrc/talker_fused.cu below, it copies the package and
chip_smoke.py into a temporary directory, applies the edit there, and runs
``chip_smoke.check_talker_fused`` (28 layers at the full widths; B 8 and
32, bf16 and int8, read_ctx 256 and 1,152, prefix and mask mode) in a
child process, which builds the kernels of that copy. It prints the
check's lines and, per mutant, the cases that failed. Exits non-zero
unless the sound kernel passes every case and every mutant fails one.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
SOURCE = "qwen3_tts_tpu_torch/csrc/talker_fused.cu"

# name -> (text of the sound kernel, its replacement)
MUTANTS = {
    "sound": None,
    "k_norm skipped": (
        "      if (roped) {\n        const float* nw",
        "      if (round == 0) {\n        const float* nw"),
    "RoPE sign flipped": (
        "v = d < TF_D / 2 ? v * cs - o * sn : v * cs + o * sn;",
        "v = d < TF_D / 2 ? v * cs + o * sn : v * cs - o * sn;"),
    "int8 V scale dropped": (
        "        pw[warp][lane] = p0 * v0;\n"
        "        pw[warp][lane + 32] = p1 * v1;",
        "        pw[warp][lane] = p0;\n        pw[warp][lane + 32] = p1;"),
    "current slot masked out": (
        "      const bool valid = s < ctx &&",
        "      const bool valid = s < ctx && s != __ldg(p.widx) &&"),
    "last layer skipped": (
        "  for (int l = 0; l < p.L; ++l) {\n    phase_norm(",
        "  for (int l = 0; l < p.L - 1; ++l) {\n    phase_norm("),
    "read past read_ctx": (
        "  const int ctx = p.read_ctx;",
        "  const int ctx = p.S;"),
}

CHILD = r"""
import sys, traceback
import torch
import chip_smoke as cs
from qwen3_tts_tpu_torch.config import TalkerConfig
from qwen3_tts_tpu_torch.models import weights as W
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
cfg = TalkerConfig(text_vocab_size=16)
w = W.init_talker_weights(cfg, gen, dev)
try:
    cs.check_talker_fused(w, cfg, dev, gen)
    print("PROBE passed every case", flush=True)
except AssertionError as e:
    print("PROBE failed cases", e, flush=True)
"""


def mutate(src: str, edit) -> str:
    """The kernel source with one edit applied (exactly one match)."""
    if edit is None:
        return src
    old, new = edit
    if src.count(old) != 1:
        raise SystemExit(f"mutant text found {src.count(old)} times: {old!r}")
    return src.replace(old, new)


def run(name, edit) -> tuple[bool, str]:
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        shutil.copytree(REPO / "qwen3_tts_tpu_torch",
                        root / "qwen3_tts_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", root / "chip_smoke.py")
        path = root / SOURCE
        path.write_text(mutate(path.read_text(), edit))
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                             capture_output=True, text=True, timeout=600)
    text = out.stdout + out.stderr
    for line in text.splitlines():
        if line.startswith(("talker_fused", "PROBE")):
            print(f"[{name}] {line}", flush=True)
    passed = "PROBE passed every case" in text
    if "PROBE" not in text:
        print(f"[{name}] no verdict (rc {out.returncode}):\n{text[-3000:]}",
              flush=True)
    return passed, text


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(MUTANTS)
    src = (REPO / SOURCE).read_text()
    for name in names:
        mutate(src, MUTANTS[name])      # every edit applies, before any run
    bad = [name for name in names
           if run(name, MUTANTS[name])[0] != (MUTANTS[name] is None)]
    print("probe: " + (f"unexpected: {bad}" if bad else
                       "every mutant failed, the sound kernel passed"),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
