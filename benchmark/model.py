"""A configuration file (``benchmark/configs/<name>.json``) read into plain
shapes: the widths that the weight maker, the reference, the traffic
generator and the roofline counts share. Nothing here imports the
program."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Stack:
    """A Qwen2-style decoder stack's widths."""
    layers: int
    hidden: int
    intermediate: int
    heads: int
    kv_heads: int
    head_dim: int


@dataclass(frozen=True)
class Vocoder:
    sample_rate: int
    n_codebooks: int
    codebook_size: int
    codebook_dim: int
    latent_dim: int
    hidden: int
    layers: int
    heads: int
    decoder_dim: int
    upsample_rates: tuple
    rms_norm_eps: float
    rope_theta: float

    @property
    def samples_per_frame(self) -> int:
        n = 4                       # the two 2x ConvNeXt upsample blocks
        for r in self.upsample_rates:
            n *= r
        return n


@dataclass(frozen=True)
class Model:
    name: str
    source: str
    talker: Stack
    code_pred: Stack
    codec_vocab: int
    n_codebooks: int
    cp_vocab: int
    text_vocab: int
    text_dim: int
    rms_norm_eps: float
    rope_theta: float
    vocoder: Vocoder
    special: dict
    random: dict

    @property
    def prefill_len(self) -> int:
        """Rows of a request's prefill: three template ids, the think
        prefix (think, think_bos, language, think_eos), the speaker row,
        pad, and bos carrying the text's first id; the rest of the text
        arrives a row a frame."""
        return 3 + 4 + 1 + 2

    @property
    def has_mtp(self) -> bool:
        """The 2048 -> 1024 small_to_mtp_projection of the larger models."""
        return self.code_pred.hidden != self.talker.hidden


def _stack(c: dict) -> Stack:
    return Stack(layers=c["num_hidden_layers"], hidden=c["hidden_size"],
                 intermediate=c["intermediate_size"],
                 heads=c["num_attention_heads"],
                 kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"])


def from_dict(raw: dict) -> Model:
    t, v = raw["talker_config"], raw["vocoder_config"]
    return Model(
        name=raw["name"], source=raw["source"], talker=_stack(t),
        code_pred=_stack(raw["code_predictor_config"]),
        codec_vocab=t["vocab_size"], n_codebooks=t["num_code_groups"],
        cp_vocab=raw["code_predictor_config"]["vocab_size"],
        text_vocab=t["text_vocab_size"], text_dim=t["text_hidden_size"],
        rms_norm_eps=t["rms_norm_eps"], rope_theta=t["rope_theta"],
        vocoder=Vocoder(
            sample_rate=v["sample_rate"], n_codebooks=v["num_quantizers"],
            codebook_size=v["codebook_size"],
            codebook_dim=v["codebook_dim"], latent_dim=v["latent_dim"],
            hidden=v["hidden_size"], layers=v["num_hidden_layers"],
            heads=v["num_attention_heads"], decoder_dim=v["decoder_dim"],
            upsample_rates=tuple(v["upsample_rates"]),
            rms_norm_eps=v["rms_norm_eps"], rope_theta=v["rope_theta"]),
        special=dict(raw["special_tokens"]),
        random=dict(raw["random_weights"]))


def load(path: Path) -> Model:
    return from_dict(json.loads(Path(path).read_text()))
