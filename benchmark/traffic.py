"""The one traffic generator: every mix is a data file
(``benchmark/traffic/<mix>.json``) that this module reads.

A request is a templated prompt (the ids ``encode_for_tts`` gives: the
three ids of ``<|im_start|>assistant\\n``, the text, the five of
``<|im_end|>\\n<|im_start|>assistant\\n``) of ``prompt_tokens`` [lo, hi]
ids in all, and one of the configuration's voices. Lengths are not drawn
independently: every block of n requests takes the same multiset of n
lengths, evenly spread over [lo, hi], in an order drawn from the seed, so
that every seed asks for the same work. Open-loop arrivals (``rate_per_s``)
are one fixed Poisson trace of the mix: the gaps are the quantiles of the
exponential distribution in an order drawn from ``ARRIVAL_SEED``, not
from the run's seed, since the clumps of one
ordering set a tail that another ordering does not share; the run's seed
orders the requests' lengths over those arrivals, one of each length in
every block of hi - lo + 1 requests.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .seeds import rng

ARRIVAL_SEED = 1          # orders every mix's arrival gaps


@dataclass
class Request:
    rid: int
    tokens: list
    voice: int
    due: float = 0.0          # seconds after the schedule's start

    @property
    def text(self) -> str:
        """The key the benchmark's tokenizer maps back to `tokens`."""
        return f"req-{self.rid}"


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def spread_lengths(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths evenly spread over [lo, hi] (both ends reached)."""
    if n == 1:
        return np.array([(lo + hi) // 2])
    return np.round(lo + (hi - lo) * np.arange(n) / (n - 1)).astype(int)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """The n quantiles (i + 1/2) / n of the exponential gap at `rate`."""
    return -np.log1p(-(np.arange(n) + 0.5) / n) / rate


def make_requests(mix: dict, special: dict, text_vocab: int, n_voices: int,
                  seed: int, block: int, n: int, first_id: int = 0,
                  key: str = "requests") -> list[Request]:
    """`n` requests, ids from `first_id`, lengths spread per block of
    `block` requests (module docstring)."""
    lo, hi = mix["prompt_tokens"]
    head = [special["im_start_token_id"], special["assistant_token_id"],
            special["newline_token_id"]]
    tail = [special["im_end_token_id"], special["newline_token_id"],
            special["im_start_token_id"], special["assistant_token_id"],
            special["newline_token_id"]]
    g = rng(seed, "traffic", key)
    out: list[Request] = []
    while len(out) < n:
        lens = g.permutation(spread_lengths(lo, hi, block))
        for L in lens[:n - len(out)]:
            text = g.integers(0, min(text_vocab, min(head)),
                              int(L) - len(head) - len(tail))
            out.append(Request(first_id + len(out),
                               head + text.tolist() + tail,
                               int(g.integers(0, n_voices))))
    return out


def schedule(mix: dict, special: dict, text_vocab: int, n_voices: int,
             seed: int, horizon_s: float, first_id: int = 0) -> list[Request]:
    """Open-loop requests due over [0, horizon_s) at ``rate_per_s``
    (module docstring)."""
    n = max(1, math.ceil(mix["rate_per_s"] * horizon_s))
    lo, hi = mix["prompt_tokens"]
    reqs = make_requests(mix, special, text_vocab, n_voices, seed,
                         hi - lo + 1, n, first_id=first_id,
                         key=f"from-{first_id}")
    due = np.concatenate([[0.0], np.cumsum(
        rng(ARRIVAL_SEED, "traffic", "gaps").permutation(
            exp_gaps(mix["rate_per_s"], n)))[:-1]])
    for r, t in zip(reqs, due):
        r.due = float(t)
    return reqs
