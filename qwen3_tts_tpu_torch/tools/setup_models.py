"""One-shot model setup on the port alone (the port of
tools/setup_models.py): download the HF checkpoints and emit the GGUF
model directory that ``Qwen3TTS().load_models`` reads.

Downloads the base TTS repo and the speech-codec repo (through
``huggingface_hub``, imported only for the download; without it the
download is skipped with a warning), converts both with
tools/convert_checkpoints.py, and verifies that the outputs open with the
port's GGUF reader.

Examples:
  python -m qwen3_tts_tpu_torch.tools.setup_models --models-dir models
  python -m qwen3_tts_tpu_torch.tools.setup_models --skip-download \\
      --base-dir <hf_tts_dir> --tokenizer-dir <hf_codec_dir>
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..io.gguf import GGML_F16, GGML_Q4_0, GGML_Q4_K, GGML_Q8_0, GGUFReader
from . import convert_checkpoints as cc

BASE_REPO_IDS = [
    "Qwen/Qwen3-TTS-12Hz-0.6B-Base",
    "Qwen/Qwen3-TTS-0.6B-Base",
]
TOKENIZER_REPO_IDS = [
    "Qwen/Qwen3-TTS-Tokenizer-12Hz",
]


def eprint(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def snapshot_download_repo(repo_ids, local_dir: Path,
                           token: str | None) -> bool:
    """Try each repo id in order. Returns False when download is
    unavailable (offline / no hub)."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        eprint("[warn] huggingface_hub not installed; cannot download "
               "(use --skip-download with local checkout dirs)")
        return False
    for repo_id in repo_ids:
        try:
            eprint(f"[download] {repo_id} -> {local_dir}")
            snapshot_download(repo_id=repo_id, local_dir=str(local_dir),
                              token=token)
            return True
        except Exception as err:  # noqa: BLE001 — try next mirror id
            eprint(f"[warn] failed to download {repo_id}: {err}")
    return False


def _has_checkpoint(d: Path) -> bool:
    return d.exists() and (any(d.glob("*.safetensors"))
                           or any(d.glob("**/*.safetensors")))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models-dir", type=Path, default=Path("models"),
                    help="output dir for the runtime GGUF files")
    ap.add_argument("--base-dir", type=Path, default=Path("models/hf_base"),
                    help="HF TTS checkpoint dir (downloaded or existing)")
    ap.add_argument("--tokenizer-dir", type=Path,
                    default=Path("models/hf_tokenizer"),
                    help="HF codec checkpoint dir")
    ap.add_argument("--skip-download", action="store_true")
    ap.add_argument("--hf-token", default=None)
    ap.add_argument("--type", choices=["f16", "f32", "q8_0", "q4_0", "q4_k"],
                    default="f16", help="quantization for the TTS GGUF")
    ap.add_argument("--force-convert", action="store_true")
    args = ap.parse_args(argv)

    args.models_dir.mkdir(parents=True, exist_ok=True)

    # 1. assets
    if not args.skip_download:
        if not _has_checkpoint(args.base_dir):
            snapshot_download_repo(BASE_REPO_IDS, args.base_dir,
                                   args.hf_token)
        if not _has_checkpoint(args.tokenizer_dir):
            snapshot_download_repo(TOKENIZER_REPO_IDS, args.tokenizer_dir,
                                   args.hf_token)
    for name, d in (("base", args.base_dir),
                    ("tokenizer", args.tokenizer_dir)):
        if not _has_checkpoint(d):
            eprint(f"[error] no {name} checkpoint at {d} "
                   "(download failed or wrong --*-dir)")
            return 1

    # 2. conversion
    out_tts = args.models_dir / "qwen3-tts-0.6b-f16.gguf"
    out_tok = args.models_dir / "qwen3-tts-tokenizer-f16.gguf"
    if args.force_convert or not out_tts.exists():
        eprint(f"[convert] {args.base_dir} -> {out_tts} ({args.type})")
        cc.convert_tts(args.base_dir, out_tts, args.type)
    else:
        # a stale artifact with a DIFFERENT quantization than requested
        # must not silently pass as ready
        want = {"f32": None, "f16": GGML_F16, "q8_0": GGML_Q8_0,
                "q4_0": GGML_Q4_0, "q4_k": GGML_Q4_K}.get(args.type)
        with GGUFReader(str(out_tts)) as r:
            types = {t.ggml_type for t in r.tensors.values()}
        if want is not None and want not in types:
            eprint(f"WARNING: {out_tts} exists but contains no "
                   f"{args.type}-quantized tensors — it was converted "
                   f"with a different --type. Re-run with "
                   f"--force-convert to apply --type {args.type}.")
        else:
            eprint(f"[skip] {out_tts} exists")
    if args.force_convert or not out_tok.exists():
        eprint(f"[convert] {args.tokenizer_dir} -> {out_tok} (f16)")
        cc.convert_codec(args.tokenizer_dir, out_tok, "f16")
    else:
        eprint(f"[skip] {out_tok} exists")

    # 3. verify outputs load
    for p in (out_tts, out_tok):
        with GGUFReader(str(p)) as r:
            eprint(f"[ok] {p}: {len(r.tensors)} tensors, "
                   f"arch={r.metadata.get('general.architecture')}")
    eprint(f"Model directory ready: {args.models_dir} (use with python -m "
           f"qwen3_tts_tpu_torch.cli -m {args.models_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
