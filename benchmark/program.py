"""What the benchmark takes from the program under test
(``qwen3_tts_tpu_torch``) for every architecture: the tokenizer the engine
is given, the vocoder's configuration, and a tap on the codes that become
audio. Each architecture (benchmark/archs/) builds its own talker
configuration and engine; the traffic kinds import the program's entry
points themselves.

The served codes are what the check compares with the reference. The
program does not return them, so ``CodeTap`` wraps the engine's vocoder
entry ``Qwen3TTS._decode_chunk_batch(codes, pcm16=..., max_batch=...)``,
through which every decoded chunk passes (rows in the order in which the
streams' ``on_chunk`` / ``on_audio`` calls follow it), and records each
batch's codes. A program that stops decoding through that entry leaves
the tap empty, and the check then reads "not correct".
"""

from __future__ import annotations

import numpy as np

from .model import Vocoder


class TokenTable:
    """The tokenizer the engine is given: a request's text is its key,
    and ``encode_for_tts`` returns the templated ids the traffic generator
    made for it."""

    def __init__(self):
        self.ids: dict[str, list] = {}

    def add(self, requests) -> None:
        for r in requests:
            self.ids[r.text] = r.tokens

    def encode_for_tts(self, text: str) -> list:
        return self.ids[text]


def vocoder_config(v: Vocoder):
    from qwen3_tts_tpu_torch.config import VocoderConfig
    return VocoderConfig(
        sample_rate=v.sample_rate, n_codebooks=v.n_codebooks,
        codebook_size=v.codebook_size, codebook_dim=v.codebook_dim,
        latent_dim=v.latent_dim, hidden_dim=v.hidden,
        n_pre_tfm_layers=v.layers, n_heads=v.heads,
        decoder_dim=v.decoder_dim, upsample_rates=tuple(v.upsample_rates),
        rms_norm_eps=v.rms_norm_eps, rope_theta=v.rope_theta)


class CodeTap:
    """Records the codes of every vocoder batch the engine decodes (module
    docstring); ``take()`` hands out the rows of the latest batch in
    order, one per stream callback that carries samples."""

    def __init__(self, engine):
        self._inner = engine._decode_chunk_batch
        self._rows: np.ndarray | None = None
        self._next = 0
        self.batches = 0          # decodes so far: one a wave of audio
        engine._decode_chunk_batch = self._decode

    def _decode(self, codes, *args, **kwargs):
        self._rows, self._next = np.array(codes, copy=True), 0
        self.batches += 1
        return self._inner(codes, *args, **kwargs)

    def take(self) -> np.ndarray | None:
        """The next row [40, 16] of the latest batch, or None."""
        if self._rows is None or self._next >= len(self._rows):
            return None
        row = self._rows[self._next]
        self._next += 1
        return row
