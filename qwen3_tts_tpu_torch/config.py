"""Model configuration dataclasses (the port's own copy of
qwen3_tts_tpu/config.py: the same fields, defaults and GGUF-metadata
fallback chains, so that a configuration read by either package is the
same).

Mirrors the reference's GGUF-metadata parsing with multi-key fallback
chains and hard-coded defaults:
  - talker + code predictor: tts_transformer.cpp:288-442 (tts_transformer.h:21-69)
  - vocoder:                 audio_tokenizer_decoder.cpp:84-86 (audio_tokenizer_decoder.h:14-28)
  - speaker encoder:         audio_tokenizer_encoder.cpp:146-147 (audio_tokenizer_encoder.h:15-27)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TalkerConfig:
    # Text embedding
    text_vocab_size: int = 151936
    text_embd_dim: int = 2048

    # Talker transformer (Qwen2-style, 0.6B)
    hidden_size: int = 1024
    n_layers: int = 28
    n_attention_heads: int = 16
    n_key_value_heads: int = 8
    intermediate_size: int = 3072
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0

    # Codec vocabulary
    codec_vocab_size: int = 3072
    n_codebooks: int = 16

    # Code predictor (5-layer stack; falls back to talker dims for 0.6B)
    code_pred_layers: int = 5
    code_pred_vocab_size: int = 2048
    code_pred_hidden_size: int = 1024
    code_pred_intermediate_size: int = 3072
    code_pred_n_attention_heads: int = 16
    code_pred_n_kv_heads: int = 8
    code_pred_head_dim: int = 128

    # Special codec tokens
    codec_pad_id: int = 2148
    codec_bos_id: int = 2149
    codec_eos_id: int = 2150
    codec_think_id: int = 2154
    codec_nothink_id: int = 2155
    codec_think_bos_id: int = 2156
    codec_think_eos_id: int = 2157
    english_language_id: int = 2050

    # TTS special text tokens
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673
    tts_pad_token_id: int = 151671

    @staticmethod
    def from_gguf(r) -> "TalkerConfig":
        """Parse with the exact fallback chains of tts_transformer.cpp:288-441."""
        g = r.get_any
        hidden_size = int(g(["qwen3-tts.talker.embedding_length",
                             "qwen3-tts.embedding_length"], 1024))
        n_heads = int(g(["qwen3-tts.talker.attention.head_count",
                         "qwen3-tts.attention.head_count"], 16))
        n_kv = int(g(["qwen3-tts.talker.attention.head_count_kv",
                      "qwen3-tts.attention.head_count_kv"], 8))
        inter = int(g(["qwen3-tts.talker.feed_forward_length",
                       "qwen3-tts.feed_forward_length"], 3072))
        head_dim = int(g(["qwen3-tts.talker.attention.key_length",
                          "qwen3-tts.attention.key_length"], 128))
        return TalkerConfig(
            text_vocab_size=int(g(["qwen3-tts.text.vocab_size",
                                   "qwen3-tts.text_vocab_size"], 151936)),
            text_embd_dim=int(g(["qwen3-tts.text.embedding_dim",
                                 "qwen3-tts.text_hidden_size"], 2048)),
            hidden_size=hidden_size,
            n_layers=int(g(["qwen3-tts.talker.block_count",
                            "qwen3-tts.block_count"], 28)),
            n_attention_heads=n_heads,
            n_key_value_heads=n_kv,
            intermediate_size=inter,
            head_dim=head_dim,
            rms_norm_eps=float(g(["qwen3-tts.talker.attention.layer_norm_rms_epsilon",
                                  "qwen3-tts.attention.layer_norm_rms_epsilon"], 1e-6)),
            rope_theta=float(g(["qwen3-tts.talker.rope.freq_base",
                                "qwen3-tts.rope.freq_base"], 1_000_000.0)),
            codec_vocab_size=int(g(["qwen3-tts.talker.codec_vocab_size",
                                    "qwen3-tts.vocab_size"], 3072)),
            n_codebooks=int(g(["qwen3-tts.talker.num_codebooks",
                               "qwen3-tts.num_code_groups"], 16)),
            code_pred_layers=int(g(["qwen3-tts.code_pred.layer_count",
                                    "qwen3-tts.code_predictor.layer_count"], 5)),
            code_pred_vocab_size=int(g(["qwen3-tts.code_pred.vocab_size",
                                        "qwen3-tts.code_predictor.vocab_size"], 2048)),
            code_pred_hidden_size=int(g(["qwen3-tts.code_predictor.embedding_length"], hidden_size)),
            code_pred_intermediate_size=int(g(["qwen3-tts.code_predictor.feed_forward_length"], inter)),
            code_pred_n_attention_heads=int(g(["qwen3-tts.code_predictor.attention.head_count"], n_heads)),
            code_pred_n_kv_heads=int(g(["qwen3-tts.code_predictor.attention.head_count_kv"], n_kv)),
            code_pred_head_dim=int(g(["qwen3-tts.code_predictor.attention.key_length"], head_dim)),
            codec_pad_id=int(g(["qwen3-tts.codec.pad_id"], 2148)),
            codec_bos_id=int(g(["qwen3-tts.codec.bos_id"], 2149)),
            codec_eos_id=int(g(["qwen3-tts.codec.eos_id",
                                "qwen3-tts.codec.eos_token_id"], 2150)),
            codec_think_id=int(g(["qwen3-tts.codec.think_id",
                                  "qwen3-tts.codec_think_id"], 2154)),
            codec_nothink_id=int(g(["qwen3-tts.codec.nothink_id",
                                    "qwen3-tts.codec_nothink_id"], 2155)),
            codec_think_bos_id=int(g(["qwen3-tts.codec.think_bos_id",
                                      "qwen3-tts.codec_think_bos_id"], 2156)),
            codec_think_eos_id=int(g(["qwen3-tts.codec.think_eos_id",
                                      "qwen3-tts.codec_think_eos_id"], 2157)),
            english_language_id=int(g(["qwen3-tts.language.english_id",
                                       "qwen3-tts.codec.language.english_id",
                                       "qwen3-tts.language_id"], 2050)),
            tts_bos_token_id=int(g(["qwen3-tts.tts_bos_token_id",
                                    "qwen3-tts.tts.bos_token_id",
                                    "qwen3-tts.tts.bos_id"], 151672)),
            tts_eos_token_id=int(g(["qwen3-tts.tts_eos_token_id",
                                    "qwen3-tts.tts.eos_token_id",
                                    "qwen3-tts.tts.eos_id"], 151673)),
            tts_pad_token_id=int(g(["qwen3-tts.tts_pad_token_id",
                                    "qwen3-tts.tts.pad_token_id",
                                    "qwen3-tts.tts.pad_id"], 151671)),
        )


@dataclass(frozen=True)
class MoEConfig:
    """A talker whose every layer has a sparse mixture-of-experts FFN in
    place of the dense SwiGLU: Qwen3-Omni's talker
    (``Qwen3OmniMoeTalkerTextSparseMoeBlock``). A port-only setting, not a
    ``TalkerConfig`` field: the JAX package has no such talker. The
    defaults are Qwen3-Omni-30B-A3B's talker (models/weights.py lays out
    its leaves; ops/moe.py computes the block)."""
    n_experts: int = 128
    top_k: int = 6
    expert_intermediate: int = 384
    shared_intermediate: int = 768
    norm_topk_prob: bool = True
    # LongCat-Flash's router (``LongcatFlashTopkRouter`` / ``LongcatFlashMoE``;
    # a zero shared width means no shared expert, and then these apply):
    # the router's outputs past the n_experts real ones are identity
    # ("zero-compute") experts; the layer's leaf ``e_bias``, where it holds
    # one, enters the choice only; the chosen probabilities are scaled by
    # ``routed_scaling`` and, unlike Omni's, not rounded to bf16. This chip
    # holds the real experts [expert_offset, expert_offset + n_held) of a
    # wide expert-parallel deployment (n_held 0: all of them).
    n_zero_experts: int = 0
    routed_scaling: float = 1.0
    expert_offset: int = 0
    n_held: int = 0

    @property
    def router_width(self) -> int:
        return self.n_experts + self.n_zero_experts

    @property
    def held(self) -> int:
        return self.n_held or self.n_experts


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V3's, as LongCat-Flash runs it:
    transformers' ``LongcatFlashMLA``) in a talker of LongCat-Flash double
    layers (``LongcatFlashDecoderLayer``): two attention sublayers, two
    dense SwiGLU FFNs of ``TalkerConfig.intermediate_size`` and one
    shortcut MoE (a ``MoEConfig``) a layer. A port-only setting, not a
    ``TalkerConfig`` field: the JAX package has no such talker. It rides in
    the layers tree as its entry "mla" (models/weights.mla_layers); the
    heads are ``TalkerConfig.n_attention_heads``. The defaults are
    LongCat-Flash-Omni's. The query parts are scaled by sqrt(hidden /
    q_lora_rank) and the latent by sqrt(hidden / kv_lora_rank)
    (``mla_scale_q_lora``, ``mla_scale_kv_lora``)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def latent_width(self) -> int:
        """Values a cached position holds a sublayer: the latent and the
        one roped key shared by every head."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5


@dataclass(frozen=True)
class Code2WavConfig:
    """Qwen3-Omni's Code2Wav in place of the 12 Hz tokenizer's decoder
    front (transformers' ``Qwen3OmniMoeCode2Wav``): the codes enter as
    the mean of their rows of one embedding table, an 8-layer
    pre-transformer runs at the decoder's hidden width with sliding-window
    attention and no projections around it, the ConvNeXt upsample takes
    the exact GELU, and the waveform is clamped to [-1, 1] instead of
    tanh. A port-only setting, not a ``VocoderConfig`` field: the JAX
    package has no such decoder. It rides in the vocoder's weights tree as
    the entry "code2wav" (models/weights.init_code2wav_weights); widths
    come from the tree's shapes and the ``VocoderConfig`` (whose
    ``hidden_dim`` and ``latent_dim`` are both the hidden width, 1024 in
    Qwen3-Omni-30B-A3B's ``code2wav_config``)."""
    sliding_window: int = 72
    intermediate_size: int = 3072     # the pre-transformer's SwiGLU width


@dataclass(frozen=True)
class VocoderConfig:
    """WavTokenizer-style decoder (audio_tokenizer_decoder.h:14-28)."""
    sample_rate: int = 24000
    n_codebooks: int = 16
    codebook_size: int = 2048
    codebook_dim: int = 256      # embedding dim per codebook
    latent_dim: int = 1024       # pre-transformer width
    hidden_dim: int = 512        # VQ output width
    n_pre_tfm_layers: int = 8
    n_heads: int = 16
    decoder_dim: int = 1536
    upsample_rates: tuple[int, ...] = (8, 5, 4, 3)
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10_000.0

    @property
    def samples_per_frame(self) -> int:
        # 4 (2x ConvNeXt upsample) * prod(upsample_rates)=480 -> 1920 at 24 kHz
        n = 4
        for r in self.upsample_rates:
            n *= r
        return n

    @staticmethod
    def from_gguf(r) -> "VocoderConfig":
        return VocoderConfig(
            sample_rate=int(r.get("qwen3-tts-tokenizer.sample_rate",
                                  r.get("qwen3-tts.tokenizer.sample_rate", 24000))),
            n_codebooks=int(r.get("qwen3-tts-tokenizer.num_codebooks",
                                  r.get("qwen3-tts.tokenizer.num_codebooks", 16))),
            codebook_size=int(r.get("qwen3-tts-tokenizer.codebook_size",
                                    r.get("qwen3-tts.tokenizer.codebook_size", 2048))),
            latent_dim=int(r.get("qwen3-tts-tokenizer.decoder.latent_dim", 1024)),
            hidden_dim=int(r.get("qwen3-tts-tokenizer.decoder.hidden_size", 512)),
            n_pre_tfm_layers=int(r.get("qwen3-tts-tokenizer.decoder.num_layers", 8)),
            n_heads=int(r.get("qwen3-tts-tokenizer.decoder.num_heads", 16)),
            upsample_rates=tuple(int(x) for x in
                                 r.get("qwen3-tts-tokenizer.upsample_rates", (8, 5, 4, 3))),
        )


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """ECAPA-TDNN speaker encoder + mel frontend (audio_tokenizer_encoder.h:15-27)."""
    sample_rate: int = 24000
    n_mels: int = 128
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    embedding_dim: int = 1024
    hidden_dim: int = 512
    n_res2net_blocks: int = 3
    res2net_scale: int = 8
    f_min: float = 0.0
    f_max: float = 12000.0

    @staticmethod
    def from_gguf(r) -> "SpeakerEncoderConfig":
        return SpeakerEncoderConfig(
            sample_rate=int(r.get("qwen3-tts.speaker_encoder.sample_rate", 24000)),
            embedding_dim=int(r.get("qwen3-tts.speaker_encoder.embedding_length", 1024)),
        )


@dataclass(frozen=True)
class TokenizerSpecialTokens:
    """Text-tokenizer special ids (text_tokenizer.h:13-18, :70-71)."""
    vocab_size: int = 151936
    pad_token_id: int = 151643
    eos_token_id: int = 151645   # <|im_end|>
    bos_token_id: int = 151644   # <|im_start|>
    assistant_token_id: int = 77091
    newline_token_id: int = 198
