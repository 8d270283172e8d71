"""The port's own config.py and tokenizer.py against the JAX package's:
the same dataclass fields and defaults, the same GGUF-metadata fallback
chains, the same token ids. Also the helpers that turn a JAX test's
config or tokenizer into the port's (the port takes only its own)."""

import dataclasses

import pytest

from qwen3_tts_tpu import config as jconfig
from qwen3_tts_tpu import tokenizer as jtokenizer
from qwen3_tts_tpu_torch import config as tconfig
from qwen3_tts_tpu_torch import tokenizer as ttokenizer

from .test_tokenizer import make_tiny_tokenizer

CLASSES = ("TalkerConfig", "VocoderConfig", "SpeakerEncoderConfig",
           "TokenizerSpecialTokens")


def port_cfg(cfg):
    """The port's dataclass of the same name and field values as a JAX
    package config."""
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def port_tokenizer(tok):
    """The port's TextTokenizer over a JAX tokenizer's vocab, merges (in
    rank order) and special ids."""
    merges = [f"{a} {b}" for (a, b), _ in sorted(tok.bpe_ranks.items(),
                                                 key=lambda kv: kv[1])]
    return ttokenizer.TextTokenizer(tok.id_to_token, merges,
                                    port_cfg(tok.special))


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults(name):
    jf = dataclasses.fields(getattr(jconfig, name))
    tf = dataclasses.fields(getattr(tconfig, name))
    assert [(f.name, f.default) for f in tf] == [(f.name, f.default)
                                                 for f in jf]
    assert dataclasses.asdict(getattr(tconfig, name)()) == \
        dataclasses.asdict(getattr(jconfig, name)())
    assert port_cfg(getattr(jconfig, name)()) == getattr(tconfig, name)()


class _Reader:
    """A GGUF reader's metadata lookups over a dict."""

    def __init__(self, meta):
        self.meta = meta

    def get(self, key, default=None):
        return self.meta.get(key, default)

    def get_any(self, keys, default=None):
        return next((self.meta[k] for k in keys if k in self.meta), default)


@pytest.mark.parametrize("meta", [
    {},
    {"qwen3-tts.embedding_length": 2048, "qwen3-tts.block_count": 20,
     "qwen3-tts.talker.attention.head_count": 32,
     "qwen3-tts.code_predictor.embedding_length": 1024,
     "qwen3-tts.codec.eos_token_id": 7, "qwen3-tts.tts.pad_id": 9,
     "qwen3-tts-tokenizer.upsample_rates": [4, 4, 2],
     "qwen3-tts.tokenizer.sample_rate": 16000,
     "qwen3-tts.speaker_encoder.embedding_length": 192},
], ids=["defaults", "fallback-keys"])
@pytest.mark.parametrize("name", ["TalkerConfig", "VocoderConfig",
                                  "SpeakerEncoderConfig"])
def test_from_gguf_matches(name, meta):
    r = _Reader(meta)
    want = getattr(jconfig, name).from_gguf(r)
    got = getattr(tconfig, name).from_gguf(r)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("text", ["hello", "hell", "hello wo", "x",
                                  "hello world.", "héllo 你好 wow"])
def test_tokenizer_encodes_identically(text):
    jtok = make_tiny_tokenizer()
    ttok = port_tokenizer(jtok)
    assert ttok.special == port_cfg(jtok.special)
    assert ttok.encode(text) == jtok.encode(text)
    assert ttok.encode_for_tts(text) == jtok.encode_for_tts(text)
    assert ttok.decode(ttok.encode(text)) == jtok.decode(jtok.encode(text))


def test_tokenizer_byte_fallback_and_table():
    assert ttokenizer._byte_to_unicode() == jtokenizer._byte_to_unicode()
    b2u = jtokenizer._byte_to_unicode()
    tokens = [b2u[i] for i in range(256)]   # one token per raw byte
    sp = dict(bos_token_id=0, eos_token_id=1, pad_token_id=1)
    jtok = jtokenizer.TextTokenizer(tokens, [],
                                    jconfig.TokenizerSpecialTokens(**sp))
    ttok = ttokenizer.TextTokenizer(tokens, [],
                                    tconfig.TokenizerSpecialTokens(**sp))
    text = "héllo 你好"
    assert ttok.encode(text) == jtok.encode(text)
    assert ttok.decode(ttok.encode(text)) == text
