#!/usr/bin/env python3
"""Planted-fault probe of five hand-written kernels on one NVIDIA GPU:
the talker megakernel, the code predictor, decode attention and the
vocoder's residual chain and Snake + convT head.

Run from the repository root: ``python3 chip_probe.py [name ...]`` (the
named mutants only; all by default). For each kernel's sound source and
for each one-line mutant below, it copies the package and chip_smoke.py
into a temporary directory, applies the edit there, and runs the
kernel's check from chip_smoke.py in a child process, which builds the
kernels of that copy:
- ``check_talker_fused``: 28 layers at the full widths; B 4, 8 and 32, bf16
  and int8, read_ctx 256 and 1,152, prefix and mask mode, and B 192 at
  read_ctx 256 (untimed);
- ``check_codepred``: B 8 and 64, greedy, sampled and forced (untimed);
- ``check_flash_decode``: B 8 and 32, read_ctx 512 / 1,024 / 1,152, bf16
  and int8, prefix, mask, window and wrapped window (untimed);
- ``check_res_chain``: the four decoder blocks' (C, T) of a 40-frame
  chunk at B 2 and 16, each against the twin and run twice (untimed);
- ``check_snake_convt``: the four heads' (C, T) of a 40-frame chunk at
  B 2, 16 and 48, each against the twin and run twice (untimed).
It prints the check's lines and, per mutant, the cases that failed.
Exits non-zero unless every sound kernel passes every case and every
mutant fails one.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = "qwen3_tts_tpu_torch/csrc/"
TALKER, CODEPRED, ATTN = "talker_fused", "codepred", "flash_decode"
CHAIN, HEAD = "vocoder", "vocoder_head"
# the prefix of the check's lines, by kernel
PREFIX = {TALKER: TALKER, CODEPRED: CODEPRED, ATTN: ATTN, CHAIN: "res_chain",
          HEAD: "snake_convt"}

# name -> (kernel, edit): the edit is None for the sound source, else
# (text of the sound source, its replacement) in csrc/<kernel>.cu, or
# (text, replacement, file) in another file of csrc/ (the shared header)
RING = "mma_ring.cuh"
MUTANTS = {
    "talker: sound": (TALKER, None),
    "talker: k_norm skipped": (TALKER, (
        "    if (roped) {\n      const float* nw",
        "    if (round == 0) {\n      const float* nw")),
    "talker: RoPE sign flipped": (TALKER, (
        "v = d < TF_D / 2 ? v * cs - o * sn : v * cs + o * sn;",
        "v = d < TF_D / 2 ? v * cs + o * sn : v * cs - o * sn;")),
    "talker: int8 V scale dropped": (TALKER, (
        "        pw[warp][lane] = p0 * v0;\n"
        "        pw[warp][lane + 32] = p1 * v1;",
        "        pw[warp][lane] = p0;\n        pw[warp][lane + 32] = p1;")),
    "talker: current slot masked out": (TALKER, (
        "      const bool valid = s < ctx &&",
        "      const bool valid = s < ctx && s != __ldg(p.widx) &&")),
    "talker: last layer skipped": (TALKER, (
        "  for (int l = 0; l < p.L; ++l) {\n    phase_norm(",
        "  for (int l = 0; l < p.L - 1; ++l) {\n    phase_norm(")),
    "talker: read past read_ctx": (TALKER, (
        "  const int ctx = p.read_ctx;",
        "  const int ctx = p.S;")),
    "talker: pre-barrier weight copy of the wrong item": (TALKER, (
        "    if (s < wk.total) issue_w(pr, wk.at(s), s, smem);",
        "    if (s < wk.total) {\n      Chunk ch = wk.at(s);\n"
        "      ch.tile ^= 1;\n      issue_w(pr, ch, s, smem);\n    }")),
    "talker: merge folded into the wrong K rows": (TALKER, (
        "const int hq = ch.ks, NH", "const int hq = ch.ks ^ 1, NH")),
    "talker: one gate/up K-split partial skipped": (TALKER, (
        "for (int ks = 0; ks < n_gu; ++ks) {",
        "for (int ks = 0; ks < n_gu - 1; ++ks) {")),
    "codepred: sound": (CODEPRED, None),
    "codepred: K/V row of slot p not written": (CODEPRED, (
        "      (half == 0 ? p.kc : p.vc)[slot0 + pos * D + d] = r;",
        "")),
    "codepred: RoPE sign flipped": (CODEPRED, (
        "if (roped) v = v * c + buf[", "if (roped) v = v * c - buf[")),
    "codepred: ring stage waited one group early": (CODEPRED, (
        "    cp_async_wait<NST - 1>();", "    cp_async_wait<NST>();", RING)),
    "codepred: top-k threshold at 4k": (CODEPRED, (
        ">= (float)p.top_k) t = cand;", ">= (float)(4 * p.top_k)) t = cand;")),
    "codepred: one K-split partial skipped": (CODEPRED, (
        "      for (int ks = 0; ks < KSPLIT; ++ks)\n"
        "        s += __ldcg(p.part",
        "      for (int ks = 0; ks < KSPLIT - 1; ++ks)\n"
        "        s += __ldcg(p.part")),
    "codepred: ragged row tile dropped": (CODEPRED, (
        "min(PROD_MG / 16, (B - ch.m0 + 15) / 16)",
        "min(PROD_MG / 16, (B - ch.m0) / 16)", RING)),
    "attention: sound": (ATTN, None),
    "attention: V read from the K tile": (ATTN, (
        "    const char* vt = kt + TILE;", "    const char* vt = kt;")),
    "attention: tile waited one group early": (ATTN, (
        "      issue(nx, stage ^ 1);\n      cp_async_wait<1>();",
        "      issue(nx, stage ^ 1);\n      cp_async_wait<2>();")),
    "attention: int8 V scale dropped": (ATTN, (
        "      pw[warp][lane] = p0 * v0;\n      pw[warp][lane + 32] = p1 * v1;",
        "      pw[warp][lane] = p0;\n      pw[warp][lane + 32] = p1;")),
    "attention: wrapped window's far end dropped": (ATTN, (
        "(wlo > whi ? (s0 < whi || e > wlo)",
        "(wlo > whi ? (s0 < whi)")),
    "attention: last tile of each split skipped": (ATTN, (
        "min(t0 + tiles_per_split, n_tiles)",
        "min(t0 + tiles_per_split - 1, n_tiles)")),
    "res_chain: sound": (CHAIN, None),
    "res_chain: tap offset off by one dilation": (CHAIN, (
        "kConv7 ? (6 - tap) * p.d : 0;", "kConv7 ? (7 - tap) * p.d : 0;")),
    "res_chain: snake2 skipped": (CHAIN, (
        "__floats2bfloat162_rn(\n"
        "                  snake<EXACT>(v0, p.sa[col], p.sib[col]),\n"
        "                  snake<EXACT>(v1, p.sa[col + 1], p.sib[col + 1]));",
        "__floats2bfloat162_rn(v0, v1);")),
    # for streams after the first, the rows before t = 0 are then the
    # previous stream's last rows (memory-safe; stream 0 still reads zeros)
    "res_chain: zero fill at negative time dropped": (CHAIN, (
        "if (src >= 0 && src < T)", "if ((src >= 0 || b > 0) && src < T)")),
    "res_chain: residual add dropped": (CHAIN, (
        "const float o0 = xv.x + v0, o1 = xv.y + v1;",
        "const float o0 = v0, o1 = v1;")),
    "res_chain: ring stage waited one group early": (CHAIN, (
        "    cp_async_wait<RST - 1>();", "    cp_async_wait<RST>();")),
    "head: sound": (HEAD, None),
    # the tap-1 row after a stream's last row is then the next stream's
    # first row (memory-safe; the last stream still reads zeros)
    "head: zero row after each stream dropped": (HEAD, (
        "if (t0 + r < T && !(tap && (last_row >> j & 1)))",
        "if (t0 + r + tap < T)")),
    "head: tap 1 reads row t": (HEAD, (
        "ab + (size_t)(t0 + r + tap) * C", "ab + (size_t)(t0 + r) * C")),
    "head: bias dropped": (HEAD, (
        "*reinterpret_cast<float2*>(p.out + o) = make_float2(v0, v1);",
        "*reinterpret_cast<float2*>(p.out + o) = make_float2("
        "acc[mt][j][2 * hf], acc[mt][j][2 * hf + 1]);")),
    "head: snake parameters swapped": (HEAD, (
        "x, s,\n                                     (size_t)B * T * C, C, a, "
        "ib, st);",
        "x, s,\n                                     (size_t)B * T * C, C, ib, "
        "a, st);")),
    "head: ring stage waited one group early": (HEAD, (
        "    cp_async_wait<RST - 1>();", "    cp_async_wait<RST>();")),
}

CHILD = r"""
import sys
import torch
import chip_smoke as cs
from qwen3_tts_tpu_torch.config import TalkerConfig
from qwen3_tts_tpu_torch.models import weights as W
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
kernel = sys.argv[1]
try:
    if kernel == "flash_decode":
        cs.check_flash_decode(dev, gen, timed=False)
    elif kernel in ("vocoder", "vocoder_head"):
        from qwen3_tts_tpu_torch.config import VocoderConfig
        check = (cs.check_res_chain if kernel == "vocoder"
                 else cs.check_snake_convt)
        check(cs.decoder_blocks(VocoderConfig(), dev, gen), dev, gen,
              timed=False)
    else:
        cfg = TalkerConfig(text_vocab_size=16,
                           n_layers=28 if kernel == "talker_fused" else 1)
        w = W.init_talker_weights(cfg, gen, dev)
        if kernel == "talker_fused":
            cs.check_talker_fused(w, cfg, dev, gen, timed=False)
        else:
            cs.check_codepred(w, cfg, dev, gen, timed=False)
    print("PROBE passed every case", flush=True)
except AssertionError as e:
    print("PROBE failed cases", e, flush=True)
"""


def target(kernel, edit) -> str:
    """The path under csrc/ that the edit changes."""
    if edit is not None and len(edit) > 2:
        return edit[2]
    return "vocoder.cu" if kernel == HEAD else f"{kernel}.cu"


def mutate(src: str, edit) -> str:
    """The source with one edit applied (exactly one match)."""
    if edit is None:
        return src
    old, new = edit[:2]
    if src.count(old) != 1:
        raise SystemExit(f"mutant text found {src.count(old)} times: {old!r}")
    return src.replace(old, new)


def run(name, kernel, edit) -> bool:
    """True when the check passed every case."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        shutil.copytree(REPO / "qwen3_tts_tpu_torch",
                        root / "qwen3_tts_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", root / "chip_smoke.py")
        path = root / CSRC / target(kernel, edit)
        path.write_text(mutate(path.read_text(), edit))
        try:
            out = subprocess.run([sys.executable, "-c", CHILD, kernel],
                                 cwd=root, capture_output=True, text=True,
                                 timeout=600)
            text = out.stdout + out.stderr
        except subprocess.TimeoutExpired as e:
            text = f"timed out after {e.timeout} s"
    for line in text.splitlines():
        if line.startswith((PREFIX[kernel], "PROBE")):
            print(f"[{name}] {line}", flush=True)
    if "PROBE" not in text:
        print(f"[{name}] no verdict:\n{text[-3000:]}", flush=True)
    return "PROBE passed every case" in text


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(MUTANTS)
    for name in names:                  # every edit applies, before any run
        kernel, edit = MUTANTS[name]
        mutate((REPO / CSRC / target(kernel, edit)).read_text(), edit)
    bad = [name for name in names
           if run(name, *MUTANTS[name]) != (MUTANTS[name][1] is None)]
    print("probe: " + (f"unexpected: {bad}" if bad else
                       "every mutant failed, every sound kernel passed"),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
