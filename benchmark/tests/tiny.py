"""A scratch checkout with tiny cells, for the CPU tests: the
benchmark's folder copied, a tiny configuration (the program's test
widths), tiny mixes, limits, and a BENCHMARK.json naming them; and a
configuration's architecture and model."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark import spec

REPO = Path(__file__).resolve().parents[2]

TINY_SPECIAL = {
    "codec_pad_id": 2148, "codec_bos_id": 2149, "codec_eos_id": 2150,
    "codec_think_id": 2154, "codec_nothink_id": 2155,
    "codec_think_bos_id": 2156, "codec_think_eos_id": 2157,
    "english_language_id": 2050, "tts_bos_token_id": 500,
    "tts_eos_token_id": 501, "tts_pad_token_id": 499,
    "im_start_token_id": 400, "im_end_token_id": 401,
    "assistant_token_id": 402, "newline_token_id": 403}


def tiny_config(mtp: bool = False) -> dict:
    c = json.loads((REPO / "benchmark/configs/qwen3-tts-12hz-0.6b.json")
                   .read_text())
    c["name"] = "tiny-mtp" if mtp else "tiny"
    c["talker_config"].update(
        num_hidden_layers=2, hidden_size=96 if mtp else 64,
        intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, text_hidden_size=64, text_vocab_size=512)
    c["code_predictor_config"].update(
        num_hidden_layers=2, hidden_size=64, intermediate_size=128,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        vocab_size=256)
    c["vocoder_config"].update(
        codebook_size=2048, codebook_dim=8, latent_dim=32, hidden_size=16,
        num_hidden_layers=2, num_attention_heads=4, decoder_dim=32,
        upsample_rates=[2, 2, 2, 2])
    c["special_tokens"] = dict(TINY_SPECIAL)
    return c


OFFLINE = {"kind": "offline", "batch": 4, "prompt_tokens": [16, 24],
           "frame_cap": 60, "temperature": 0.9, "top_k": 50, "top_p": 1.0,
           "repetition_penalty": 1.05}
SERVE = {"kind": "serve", "slots": 4, "rate_per_s": 4.0,
         "lead_in_s": 0.5,
         "drain_max_s": 60.0, "prompt_tokens": [16, 24],
         "token_buckets": [16, 32], "frame_cap": 60, "temperature": 0.9,
         "top_k": 50, "top_p": 1.0, "repetition_penalty": 1.05,
         "trace_slice_steps": 2}
LIMITS = {"cb0_gap": 0.05, "code_gap": 0.05, "pcm_err": 0.05}


def make_root(tmp: Path, mtp: bool = False) -> Path:
    """A checkout at `tmp` holding the benchmark's folder and tiny cells
    "tiny-offline" and "tiny-serve"."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = tiny_config(mtp)
    name = cfg["name"]
    (tmp / f"benchmark/configs/{name}.json").write_text(json.dumps(cfg))
    (tmp / "benchmark/traffic/tiny-offline.json").write_text(
        json.dumps(OFFLINE))
    (tmp / "benchmark/traffic/tiny-serve.json").write_text(json.dumps(SERVE))
    (tmp / f"benchmark/limits/{name}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"] = [{"name": name, "source": "test",
                         "file": f"benchmark/configs/{name}.json",
                         "reduced": [], "why": "tiny"}]
    bench["workloads"] = [
        {"name": "tiny-offline", "config": name, "traffic": "tiny-offline",
         "chips": 1, "why": "tiny"},
        {"name": "tiny-serve", "config": name, "traffic": "tiny-serve",
         "chips": 1, "why": "tiny"}]
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = ["tiny-serve" if "serve" in w
                                  else "tiny-offline"
                                  for w in m["workloads"]][:1] + (
                    ["tiny-serve"] if any("serve" in w for w in
                                          m["workloads"]) else [])
                m["workloads"] = sorted(set(m["workloads"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def load_model(raw: dict | str):
    """(architecture module, model) of a configuration: a dict, or the
    name of a file of the repository's benchmark/configs/."""
    if isinstance(raw, str):
        raw = json.loads((REPO / f"benchmark/configs/{raw}.json").read_text())
    arch = spec.load_arch(REPO, raw["arch"])
    return arch, arch.load(raw)


def use_arch(root: Path, stem: str, source: str | None = None) -> None:
    """Point the tiny configuration of the scratch checkout `root` at the
    architecture `stem`, first writing its file benchmark/archs/<stem>.py
    from `source` where one is given."""
    if source is not None:
        (root / f"benchmark/archs/{stem}.py").write_text(source)
    path = root / "benchmark/configs/tiny.json"
    cfg = json.loads(path.read_text())
    cfg["arch"] = stem
    path.write_text(json.dumps(cfg))
