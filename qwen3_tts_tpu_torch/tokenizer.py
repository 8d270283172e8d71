"""Byte-level BPE text tokenizer (GPT-2 style, Qwen2 vocab): the port's
own copy of qwen3_tts_tpu/tokenizer.py, encoding identically.

Behavioral twin of the reference C++ tokenizer (text_tokenizer.cpp), including
its deliberately simplified whitespace-only pre-tokenization (no regex
splitting — text_tokenizer.cpp:244-265) and the TTS chat template
`<|im_start|>assistant\\n{text}<|im_end|>\\n<|im_start|>assistant\\n`
(text_tokenizer.cpp:293-330).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterable

from .config import TokenizerSpecialTokens


@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """Byte->unicode table matching the reference's static BYTE_TO_UNICODE
    (text_tokenizer.cpp:12-29).

    Note: the reference table deviates from the canonical GPT-2 mapping for
    bytes >= 173 — it maps byte b to chr(b+1) for 173..254 and byte 255 to
    chr(323) ("Ń"), i.e. the soft-hyphen slot is shifted instead of escaped.
    We replicate that behavior exactly for parity.
    """
    table: dict[int, str] = {}
    for b in range(256):
        if 33 <= b <= 126 or 161 <= b <= 172:
            table[b] = chr(b)               # printable: identity
        elif b <= 32:
            table[b] = chr(256 + b)         # control + space
        elif b == 127:
            table[b] = chr(256 + 33)        # DEL
        elif 128 <= b <= 160:
            table[b] = chr(256 + 34 + (b - 128))
        elif 173 <= b <= 254:
            table[b] = chr(b + 1)           # reference's shifted tail
        else:  # b == 255
            table[b] = chr(256 + 67)        # "Ń"
    return table


@lru_cache(maxsize=1)
def _unicode_to_byte() -> dict[str, int]:
    return {v: k for k, v in _byte_to_unicode().items()}


class TextTokenizer:
    """BPE tokenizer over a vocab + merges list (loaded from GGUF metadata)."""

    def __init__(self, tokens: list[str], merges: list[str],
                 special: TokenizerSpecialTokens | None = None):
        self.id_to_token = list(tokens)
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.bpe_ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(merges):
            space = merge.find(" ")
            if space > 0:
                self.bpe_ranks[(merge[:space], merge[space + 1:])] = rank

        sp = special or TokenizerSpecialTokens()
        self.special = TokenizerSpecialTokens(
            vocab_size=len(tokens),
            pad_token_id=sp.pad_token_id,
            eos_token_id=sp.eos_token_id,
            bos_token_id=sp.bos_token_id,
            # `assistant` / newline resolved from vocab when present
            # (text_tokenizer.cpp:146-162)
            assistant_token_id=self.vocab.get(
                "assistant", self.vocab.get("Ġassistant", sp.assistant_token_id)),
            newline_token_id=self.vocab.get(
                "Ċ", self.vocab.get("\n", sp.newline_token_id)),
        )
        self._bpe_cache: dict[str, tuple[str, ...]] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_gguf(cls, reader) -> "TextTokenizer":
        tokens = reader.get("tokenizer.ggml.tokens")
        if tokens is None:
            raise ValueError("tokenizer.ggml.tokens not found in GGUF")
        merges = reader.get("tokenizer.ggml.merges", [])
        defaults = TokenizerSpecialTokens()
        special = TokenizerSpecialTokens(
            bos_token_id=int(reader.get("tokenizer.ggml.bos_token_id",
                                        defaults.bos_token_id)),
            eos_token_id=int(reader.get("tokenizer.ggml.eos_token_id",
                                        defaults.eos_token_id)),
            pad_token_id=int(reader.get("tokenizer.ggml.padding_token_id",
                                        defaults.pad_token_id)),
        )
        return cls(tokens, merges, special)

    # ------------------------------------------------------------------
    def _bpe(self, token: str) -> tuple[str, ...]:
        """Greedy lowest-rank pair merging (text_tokenizer.cpp:185-232)."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        while len(word) > 1:
            pairs = ((self.bpe_ranks.get((word[i], word[i + 1]), 1 << 60), i)
                     for i in range(len(word) - 1))
            best_rank, _ = min(pairs)
            if best_rank >= 1 << 60:
                break
            first, second = None, None
            for i in range(len(word) - 1):
                if self.bpe_ranks.get((word[i], word[i + 1]), 1 << 60) == best_rank:
                    first, second = word[i], word[i + 1]
                    break
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if (i + 1 < len(word) and word[i] == first and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        if len(self._bpe_cache) < 65536:
            self._bpe_cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        b2u = _byte_to_unicode()
        unicode_text = "".join(b2u[b] for b in text.encode("utf-8"))

        # Whitespace-only word split keeping the space glyph with the
        # following word (text_tokenizer.cpp:244-265).
        words: list[str] = []
        current = ""
        for ch in unicode_text:
            if ch == "Ġ":
                if current:
                    words.append(current)
                current = ch
            else:
                current += ch
        if current:
            words.append(current)

        out: list[int] = []
        for word in words:
            for tok in self._bpe(word):
                tid = self.vocab.get(tok)
                if tid is not None:
                    out.append(tid)
                else:
                    # Unknown merge result: fall back to per-byte tokens
                    # (text_tokenizer.cpp:277-287)
                    for byte in tok.encode("utf-8"):
                        bid = self.vocab.get(b2u.get(byte, ""))
                        if bid is not None:
                            out.append(bid)
        return out

    def encode_for_tts(self, text: str) -> list[int]:
        """<|im_start|>assistant\\n{text}<|im_end|>\\n<|im_start|>assistant\\n"""
        sp = self.special
        return ([sp.bos_token_id, sp.assistant_token_id, sp.newline_token_id]
                + self.encode(text)
                + [sp.eos_token_id, sp.newline_token_id,
                   sp.bos_token_id, sp.assistant_token_id, sp.newline_token_id])

    def decode(self, tokens: Iterable[int]) -> str:
        """Concatenate every token's RAW bytes, then interpret the whole
        stream as UTF-8 once — the reference accumulates a std::string of
        bytes the same way (text_tokenizer.cpp:332-338). Per-token
        decoding would corrupt multi-byte characters whose bytes are
        split across BPE tokens."""
        out = bytearray()
        for t in tokens:
            out.extend(self._token_bytes(t))
        return out.decode("utf-8", errors="replace")

    def _token_bytes(self, token_id: int) -> bytes:
        if token_id < 0 or token_id >= len(self.id_to_token):
            return b""
        u2b = _unicode_to_byte()
        out = bytearray()
        for ch in self.id_to_token[token_id]:
            b = u2b.get(ch)
            if b is not None:
                out.append(b)
            else:
                out.extend(ch.encode("utf-8"))
        return bytes(out)

    def decode_token(self, token_id: int) -> str:
        """Single-token text (may contain U+FFFD when the token holds a
        partial multi-byte character — use decode() for sequences)."""
        return self._token_bytes(token_id).decode("utf-8", errors="replace")
