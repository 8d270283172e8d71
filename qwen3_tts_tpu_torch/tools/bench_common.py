"""What the measurement programs (``bench``, ``bench_serve``,
``bench_breakdown``) share: the device they run on, the card's name and
power limit, the kernels' launch counters, random full-width weights from
a seed.

A tool runs on the card unless ``--device cpu`` is given; asked for the
card where there is none, it stops with one line on stderr and a nonzero
exit code. It never carries on on the CPU. On the CPU the kernels'
wrappers run their plain twins, and the numbers measure PyTorch's CPU
kernels, not the card: the CPU run exists for the tests.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys

import torch

from ..config import TalkerConfig, VocoderConfig
from ..models import vocoder
from ..models import weights as W
from ..ops import codepred_fused, flash_decode, talker_fused, vocoder_fused

FRAME_BUDGET_MS = 80.0       # one 12.5 Hz frame of audio


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the first card; the default) or cpu (the "
                         "kernels' twins, for tests: no number taken on "
                         "the CPU describes the card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model dims (a CPU check of the program's "
                         "flow; its numbers mean nothing)")


class NoDevice(Exception):
    """The card was asked for and there is none."""


def resolve_device(name: str) -> torch.device:
    """The device a tool runs on; raises NoDevice for a card that is not
    there (no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device (pass --device cpu to run the "
                           "kernels' twins on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise NoDevice(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or what
    stood in the way."""
    if dev.type != "cuda":
        return "device: cpu (the kernels' twins; no card number)"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(dev)}, power limit unknown ({e})"
    if smi.returncode != 0:
        return (f"{torch.cuda.get_device_name(dev)}, power limit unknown "
                f"(nvidia-smi: {smi.stderr.strip()})")
    return smi.stdout.strip().splitlines()[0]


def _wrappers() -> dict:
    return {"codepred": codepred_fused.predict_codes_fused,
            "res_chain": vocoder_fused.fused_residual_chain,
            "snake_convt": vocoder_fused.fused_snake_convt,
            "flash_decode": flash_decode.flash_decode,
            "talker_fused": talker_fused.talker_step_fused}


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch counter now (graph replays included)."""
    return {k: fn.launches for k, fn in _wrappers().items()}


def launches_since(before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in launch_counts().items()}


def random_weights(device: torch.device, tiny: bool = False, seed: int = 0):
    """(talker cfg, talker + code-predictor weights, vocoder cfg, vocoder
    weights): random, from one torch.Generator seeded with `seed`, at the
    0.6B model's full widths (or the tiny test dims). The vocoder's
    matrices are bf16 on the card and f32 on the CPU, as the pipeline
    keeps them."""
    if tiny:
        cfg = W.tiny_talker_config()
        vcfg = dataclasses.replace(vocoder.tiny_vocoder_config(),
                                   codebook_size=2048)
    else:
        cfg, vcfg = TalkerConfig(), VocoderConfig()
    gen = torch.Generator(device=device).manual_seed(seed)
    talker_w = W.init_talker_weights(cfg, gen, device)
    voc_w = W.init_vocoder_weights(
        vcfg, gen, device,
        dtype=torch.bfloat16 if device.type == "cuda" else None)
    return cfg, talker_w, vcfg, voc_w


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def env(name: str, value: str | None):
    """Set (or, with None, leave) an environment variable for the block;
    the old value comes back after it."""
    old = os.environ.get(name)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
