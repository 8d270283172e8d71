"""Everything the benchmark takes from the program under test
(``qwen3_tts_tpu_torch``), in one place: its configuration classes, the
engine (``Qwen3TTS.from_components``), and a tap on the codes that become
audio. The traffic kinds and the layer timings import the program's entry points
themselves; nothing else here does.

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

from .model import Model


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


def talker_config(m: Model):
    from qwen3_tts_tpu_torch.config import TalkerConfig
    t, c, s = m.talker, m.code_pred, m.special
    return TalkerConfig(
        text_vocab_size=m.text_vocab, text_embd_dim=m.text_dim,
        hidden_size=t.hidden, n_layers=t.layers, n_attention_heads=t.heads,
        n_key_value_heads=t.kv_heads, intermediate_size=t.intermediate,
        head_dim=t.head_dim, rms_norm_eps=m.rms_norm_eps,
        rope_theta=m.rope_theta, codec_vocab_size=m.codec_vocab,
        n_codebooks=m.n_codebooks, code_pred_layers=c.layers,
        code_pred_vocab_size=m.cp_vocab, code_pred_hidden_size=c.hidden,
        code_pred_intermediate_size=c.intermediate,
        code_pred_n_attention_heads=c.heads, code_pred_n_kv_heads=c.kv_heads,
        code_pred_head_dim=c.head_dim,
        **{k: s[k] for k in (
            "codec_pad_id", "codec_bos_id", "codec_eos_id", "codec_think_id",
            "codec_nothink_id", "codec_think_bos_id", "codec_think_eos_id",
            "english_language_id", "tts_bos_token_id", "tts_eos_token_id",
            "tts_pad_token_id")})


def vocoder_config(m: Model):
    from qwen3_tts_tpu_torch.config import VocoderConfig
    v = m.vocoder
    return VocoderConfig(
        sample_rate=v.sample_rate, n_codebooks=v.n_codebooks,
        codebook_size=v.codebook_size, codebook_dim=v.codebook_dim,
        latent_dim=v.latent_dim, hidden_dim=v.hidden,
        n_pre_tfm_layers=v.layers, n_heads=v.heads,
        decoder_dim=v.decoder_dim, upsample_rates=tuple(v.upsample_rates),
        rms_norm_eps=v.rms_norm_eps, rope_theta=v.rope_theta)


def make_engine(m: Model, weights, tokenizer: TokenTable, device):
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS
    return Qwen3TTS.from_components(tokenizer, talker_config(m),
                                    weights.talker, vocoder_config(m),
                                    weights.vocoder, device)


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
