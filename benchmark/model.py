"""Plain shapes that more than one architecture's configuration holds:
the widths of a dense decoder stack and of the 12 Hz tokenizer's decoder
(the vocoder), read from a configuration file's groups. An architecture
(benchmark/archs/<arch>.py) reads the rest of its file into a model of
its own. Nothing here imports the program."""

from __future__ import annotations

from dataclasses import dataclass


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


def stack(c: dict) -> Stack:
    """A decoder stack's group (``talker_config`` and the like)."""
    return Stack(layers=c["num_hidden_layers"], hidden=c["hidden_size"],
                 intermediate=c["intermediate_size"],
                 heads=c["num_attention_heads"],
                 kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"])


def vocoder(v: dict) -> Vocoder:
    """A configuration's ``vocoder_config`` group."""
    return Vocoder(
        sample_rate=v["sample_rate"], n_codebooks=v["num_quantizers"],
        codebook_size=v["codebook_size"], codebook_dim=v["codebook_dim"],
        latent_dim=v["latent_dim"], hidden=v["hidden_size"],
        layers=v["num_hidden_layers"], heads=v["num_attention_heads"],
        decoder_dim=v["decoder_dim"],
        upsample_rates=tuple(v["upsample_rates"]),
        rms_norm_eps=v["rms_norm_eps"], rope_theta=v["rope_theta"])
