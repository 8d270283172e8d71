"""Whether what the timed path served is correct: a sample of the
requests that the window finished, drawn from the seed with the longest
among them, held against the plain reference of the cell's architecture
(benchmark/archs/<arch>.py, on benchmark/reference/) in float32 with TF32
off, on weights the architecture makes again from the seed once the
program's state is freed.

Every mix samples its tokens (top-k with a temperature), so a served
token is held to what the sampler may draw: the program draws only among
the top_k best scores of its own logits (EOS aside), and a sound program
therefore serves a token whose reference score lies at most by rounding
below the reference's top_k-th best. For a greedy token (top_k 1) this is
the gap below the reference's best. The numbers compared, each the
widest over the sample:

- ``cb0_gap``: the talker, prefill then decode through the cache. The
  first codebook's score (codec-head logit after the sampler's
  suppression, repetition penalty and EOS ramp, all worked out again from
  the served history) below the reference's top_k-th best, in logits;
- ``code_gap``: the code predictor (with the small_to_mtp projection
  where the model has one), codebooks 1..15, the same measure over its
  logits. The reference feeds its code predictor its own talker state,
  so a talker that drifts moves this number too;
- ``pcm_err``: the vocoder. For every chunk the program delivered, the
  reference decodes the served codes (the chunk alone, its tail
  zero-padded, causal trim) and the error is |pcm - ref| / |ref| in L2
  over the chunk's delivered samples.

The control (``control=True``, used by benchmark/calibrate.py and never
by a run) is the reference put in the program's place in float8: at each
position of the same prompts and served tokens it draws its own token
from its own top_k with the mix's temperature, and that token's gap is
read against the float32 reference; its PCM is its float8 decode.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .reference.layers import Prec, no_tf32
from .seeds import rng, sub_seed

NAMES = ("cb0_gap", "code_gap", "pcm_err")
CHECK_REQUESTS = 8     # requests a run holds against the reference
FRAME_BLOCK = 256      # frames a code-predictor reference pass: fits at 1.7B
CHUNK_BLOCK = 8        # chunks a vocoder reference pass


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pick(streams, n: int, seed: int, spf: int) -> list:
    """n finished requests with their codes, the longest first, the rest
    drawn from the seed."""
    ok = [s for s in streams if s.ok and s.codes(spf) is not None]
    if not ok:
        return []
    longest = max(ok, key=lambda s: (s.codes(spf).shape[0], -s.req.rid))
    rest = [s for s in ok if s is not longest]
    g = rng(seed, "check")
    take = g.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(take)]


def _kth(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest along the last dim (k clipped to its size)."""
    k = min(k, x.shape[-1])
    return torch.topk(x, k, dim=-1).values[..., -1]


def _gap(scores: torch.Tensor, chosen: torch.Tensor, k: int) -> torch.Tensor:
    """How far the chosen entries lie below the k-th best (0 within)."""
    got = scores.gather(-1, chosen.long().unsqueeze(-1)).squeeze(-1)
    return (_kth(scores, k) - got).clamp_min(0)


def _draw(scores: torch.Tensor, k: int, temperature: float,
          gen: torch.Generator) -> torch.Tensor:
    """A token from the top k of scores / temperature (Gumbel-max)."""
    z = scores / max(temperature, 1e-6)
    z = z.masked_fill(z < _kth(z, k)[..., None], -math.inf)
    u = torch.rand(z.shape, generator=gen, device=z.device).clamp_min(1e-30)
    return torch.argmax(z - torch.log(-torch.log(u)), dim=-1)


def compare(arch, m, mix: dict, weights, sample: list, device, seed: int,
            control: bool = False) -> dict:
    """The numbers of `sample` (record.Stream list) against the reference
    of `arch` (model `m`); with `control`, also the control's ("control_"
    + name)."""
    k, T = int(mix["top_k"]), float(mix["temperature"])
    pen = float(mix["repetition_penalty"])
    spf = m.vocoder.samples_per_frame
    w, voices = weights.talker, weights.voices
    precs = [Prec("f32")] + ([Prec("fp8")] if control else [])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "ctrl"))
    out = {n: 0.0 for n in NAMES}
    if control:
        out.update({f"control_{n}": 0.0 for n in NAMES})
    n_tok = n_chunk = 0
    with torch.no_grad(), no_tf32():
        codes = [torch.as_tensor(s.codes(spf), device=device) for s in sample]
        hid = {}
        for p in precs:
            seqs = [arch.talker_sequence(p, w, m, s.req.tokens,
                                         voices[s.req.voice], c)
                    for s, c in zip(sample, codes)]
            P = seqs[0][1]
            hs = arch.talker_hidden(p, w, m, [x for x, _ in seqs])
            hid[p.mode] = [h[P - 1:P - 1 + c.shape[0]]
                           for h, c in zip(hs, codes)]
        for i, (s, c) in enumerate(zip(sample, codes)):
            n_tok += c.numel()
            h32 = hid["f32"][i]
            sc = arch.cb0_scores(precs[0], w, m, h32, c, len(s.req.tokens),
                                 pen)
            out["cb0_gap"] = max(out["cb0_gap"],
                                 float(_gap(sc, c[:, 0], k).max()))
            if control:
                hc = hid["fp8"][i]
                sc8 = arch.cb0_scores(precs[1], w, m, hc, c,
                                      len(s.req.tokens), pen)
                tok = _draw(sc8, k, T, gen)
                out["control_cb0_gap"] = max(out["control_cb0_gap"],
                                             float(_gap(sc, tok, k).max()))
            for f0 in range(0, c.shape[0], FRAME_BLOCK):
                cc = c[f0:f0 + FRAME_BLOCK]
                lg = arch.code_logits(precs[0], w, m,
                                      h32[f0:f0 + FRAME_BLOCK], cc)
                out["code_gap"] = max(out["code_gap"], float(
                    _gap(lg, cc[:, 1:], k).max()))
                if control:
                    lg8 = arch.code_logits(precs[1], w, m,
                                           hid["fp8"][i][f0:f0 + FRAME_BLOCK],
                                           cc)
                    tok = _draw(lg8, k, T, gen)
                    out["control_code_gap"] = max(
                        out["control_code_gap"],
                        float(_gap(lg, tok, k).max()))
        chunks = [(codes_row, pcm) for s in sample for codes_row, pcm
                  in s.chunks]
        for j in range(0, len(chunks), CHUNK_BLOCK):
            part = chunks[j:j + CHUNK_BLOCK]
            cb = torch.as_tensor(np.stack([c for c, _ in part]),
                                 device=device)
            pcms = {p.mode: arch.vocode(p, weights.vocoder, m.vocoder, cb)
                    for p in precs}
            for r, (_, pcm) in enumerate(part):
                n = len(pcm)
                want = pcms["f32"][r, :n].double()
                norm = float(want.norm()) or 1.0
                got = torch.as_tensor(pcm, device=device).double()
                out["pcm_err"] = max(out["pcm_err"],
                                     float((got - want).norm()) / norm)
                if control:
                    c8 = pcms["fp8"][r, :n].double()
                    out["control_pcm_err"] = max(
                        out["control_pcm_err"],
                        float((c8 - want).norm()) / norm)
                n_chunk += 1
    out["tokens"], out["chunks"] = n_tok, n_chunk
    return out


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers.get(n, math.inf) <= limits[n] for n in NAMES)


def report(numbers: dict | None, limits: dict) -> dict:
    """Each compared number beside its limit, as the last lines on stderr;
    returns the same for the result's last key."""
    lines = {}
    for n in NAMES:
        v = None if numbers is None else numbers.get(n)
        lines[n] = {"value": v, "limit": limits[n]}
    for n, d in lines.items():
        _log(f"check {n}: {d['value']} (limit {d['limit']})")
    return lines
