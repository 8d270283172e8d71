"""Weights as nested dicts of tensors, in the JAX package's layouts
(port of qwen3_tts_tpu/models/weights.py and the random init of
qwen3_tts_tpu/models/vocoder.py).

Layouts: linear weights [in, out]; stacked per-layer tensors [L, ...];
fused ``wqkv`` ([q | k | v] columns) and ``w_gu`` ([gate | up]);
``code_pred.embd`` [15, V, H] and ``code_pred.heads`` [15, H, V]; vocoder
convolutions in torch order ([C_out, C_in, K], convT [C_in, C_out, K]).

``load_talker_weights`` reads the TTS GGUF straight onto a device
(io/gguf.GGUFReader.tensor): each tensor crosses once in its file type and
is transposed, fused, stacked and cast there. The tree is bitwise the JAX
loader's. The random inits draw on the device from a ``torch.Generator``
at the JAX package's scales, so that activations stay in range at full
width.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import (Code2WavConfig, MLAConfig, MoEConfig, TalkerConfig,
                      VocoderConfig)

MATMUL_DTYPE = torch.bfloat16
NORM_DTYPE = torch.float32


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes, which torch rejects
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tree_from_numpy(tree, device):
    """Map a nested dict/list of numpy arrays (e.g. a JAX parameter pytree
    passed through np.asarray) to tensors of the same dtype and layout on
    `device`."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    return _from_numpy(tree, device)


# the talker (+ code predictor) and vocoder pytrees convert alike
talker_weights_from_numpy = vocoder_weights_from_numpy = tree_from_numpy


def _linear(r, name: str, device, stager) -> torch.Tensor:
    """A [out, in] GGUF linear weight as [in, out] bf16 (a view: callers
    stack or copy it)."""
    return r.tensor(name, device, MATMUL_DTYPE, stager).t()


def _vec(r, name: str, device, stager) -> torch.Tensor:
    return r.tensor(name, device, NORM_DTYPE, stager)


def _embd(r, name: str, device, stager) -> torch.Tensor:
    """An embedding table stays [vocab, dim] (row gather)."""
    return r.tensor(name, device, MATMUL_DTYPE, stager)


def load_decoder_stack(r, prefix: str, n_layers: int, device,
                       stager=None) -> dict[str, Any]:
    """A Qwen2-style decoder stack (talker or code predictor) from tensors
    {prefix}.blk.{i}.{attn_norm, attn_q, attn_k, attn_v, attn_output,
    attn_q_norm, attn_k_norm, ffn_norm, ffn_gate, ffn_up, ffn_down}, with
    Q/K/V and gate/up fused along the output dimension."""
    def lw(name):
        return torch.stack([
            _linear(r, f"{prefix}.blk.{i}.{name}.weight", device, stager)
            for i in range(n_layers)])

    def lv(name):
        return torch.stack([
            _vec(r, f"{prefix}.blk.{i}.{name}.weight", device, stager)
            for i in range(n_layers)])

    return {
        "attn_norm": lv("attn_norm"),
        "wqkv": torch.cat([lw("attn_q"), lw("attn_k"), lw("attn_v")], dim=-1),
        "wo": lw("attn_output"),
        "q_norm": lv("attn_q_norm"),
        "k_norm": lv("attn_k_norm"),
        "ffn_norm": lv("ffn_norm"),
        "w_gu": torch.cat([lw("ffn_gate"), lw("ffn_up")], dim=-1),
        "w_down": lw("ffn_down"),
    }


def load_talker_weights(r, cfg: TalkerConfig, device,
                        stager=None) -> dict[str, Any]:
    """Talker + code-predictor weights from the TTS GGUF (`r`, an
    io.gguf.GGUFReader) on `device`. ``code_pred.mtp_w`` / ``mtp_b`` are
    None unless the file has ``code_pred.mtp_proj`` (the 1.7B shape)."""
    def lin(name):
        return _linear(r, name, device, stager).contiguous()

    def vec(name):
        return _vec(r, name, device, stager)

    n_rest = cfg.n_codebooks - 1
    w: dict[str, Any] = {
        "text_embd": _embd(r, "talker.text_embd.weight", device, stager),
        "text_proj": {
            "fc1_w": lin("talker.text_proj.fc1.weight"),
            "fc1_b": vec("talker.text_proj.fc1.bias"),
            "fc2_w": lin("talker.text_proj.fc2.weight"),
            "fc2_b": vec("talker.text_proj.fc2.bias"),
        },
        "codec_embd": _embd(r, "talker.codec_embd.weight", device, stager),
        "codec_head": lin("talker.codec_head.weight"),
        "output_norm": vec("talker.output_norm.weight"),
        "layers": load_decoder_stack(r, "talker", cfg.n_layers, device,
                                     stager),
    }
    cp: dict[str, Any] = {
        "layers": load_decoder_stack(r, "code_pred", cfg.code_pred_layers,
                                     device, stager),
        "output_norm": vec("code_pred.output_norm.weight"),
        "embd": torch.stack([
            _embd(r, f"code_pred.codec_embd.{i}.weight", device, stager)
            for i in range(n_rest)]),
        "heads": torch.stack([
            _linear(r, f"code_pred.lm_head.{i}.weight", device, stager)
            for i in range(n_rest)]),
        "mtp_w": None,
        "mtp_b": None,
    }
    if "code_pred.mtp_proj.weight" in r.tensors:
        cp["mtp_w"] = lin("code_pred.mtp_proj.weight")
        if "code_pred.mtp_proj.bias" in r.tensors:
            cp["mtp_b"] = vec("code_pred.mtp_proj.bias")
    w["code_pred"] = cp
    return w


def _decoder_stack(rn, norm, n_layers, hidden, n_heads, n_kv, head_dim,
                   inter):
    return {
        "attn_norm": norm(n_layers, hidden),
        "wqkv": rn(n_layers, hidden, (n_heads + 2 * n_kv) * head_dim),
        "wo": rn(n_layers, n_heads * head_dim, hidden),
        "q_norm": norm(n_layers, head_dim),
        "k_norm": norm(n_layers, head_dim),
        "ffn_norm": norm(n_layers, hidden),
        "w_gu": rn(n_layers, hidden, 2 * inter),
        "w_down": rn(n_layers, inter, hidden),
    }


def moe_layers(rn, n_layers: int, hidden: int, moe: MoEConfig
               ) -> dict[str, Any]:
    """The sparse-MoE FFN leaves of a talker stack, in place of ``w_gu`` /
    ``w_down``: router ``w_router`` [L, H, E]; routed experts ``w_gu_e``
    [L, E, H, 2 Ie] ([gate | up] columns) and ``w_down_e`` [L, E, Ie, H];
    shared expert ``w_gu_s`` [L, H, 2 Is], ``w_down_s`` [L, Is, H] and its
    gate ``w_sgate`` [L, H]; all bf16 (ops/moe.py). ``moe`` rides along as
    the layers tree's non-tensor entry "moe"."""
    E, Ie, Is = (moe.n_experts, moe.expert_intermediate,
                 moe.shared_intermediate)
    return {
        "w_router": rn(n_layers, hidden, E),
        "w_gu_e": rn(n_layers, E, hidden, 2 * Ie),
        "w_down_e": rn(n_layers, E, Ie, hidden),
        "w_gu_s": rn(n_layers, hidden, 2 * Is),
        "w_down_s": rn(n_layers, Is, hidden),
        "w_sgate": rn(n_layers, hidden),
        "moe": moe,
    }


def mla_layers(rn, norm, zeros, cfg: TalkerConfig, mla: MLAConfig,
               moe: MoEConfig) -> dict[str, Any]:
    """The leaves of a talker of LongCat-Flash double layers (ops/mla.py,
    models/stack.py), stacked over the L double layers and, where a leaf
    has one a sublayer, over its two sublayers: norms ``attn_norm`` /
    ``ffn_norm`` [L, 2, H]; latent attention ``wq_a`` [L, 2, H, Rq],
    ``q_a_norm`` [L, 2, Rq], ``wq_b`` [L, 2, Rq, n (dn + dr)], ``wkv_a``
    [L, 2, H, R + dr], ``kv_a_norm`` [L, 2, R], ``wkv_b`` [L, 2, R,
    n (dn + dv)], ``wo`` [L, 2, n dv, H]; the dense SwiGLUs ``w_gu`` [L, 2,
    H, 2 I] / ``w_down`` [L, 2, I, H]; the shortcut MoE's router
    ``w_router`` [L, H, E + Z], correction bias ``e_bias`` [L, E + Z] f32
    and the held experts ``w_gu_e`` [L, held, H, 2 Ie] / ``w_down_e`` [L,
    held, Ie, H]. ``mla`` and ``moe`` ride along as non-tensor entries."""
    L, H, n = cfg.n_layers, cfg.hidden_size, cfg.n_attention_heads
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    Rq, R, I = mla.q_lora_rank, mla.kv_lora_rank, cfg.intermediate_size
    Ie = moe.expert_intermediate
    return {
        "attn_norm": norm(L, 2, H), "ffn_norm": norm(L, 2, H),
        "wq_a": rn(L, 2, H, Rq), "q_a_norm": norm(L, 2, Rq),
        "wq_b": rn(L, 2, Rq, n * (dn + dr)),
        "wkv_a": rn(L, 2, H, R + dr), "kv_a_norm": norm(L, 2, R),
        "wkv_b": rn(L, 2, R, n * (dn + dv)), "wo": rn(L, 2, n * dv, H),
        "w_gu": rn(L, 2, H, 2 * I), "w_down": rn(L, 2, I, H),
        "w_router": rn(L, H, moe.router_width),
        "e_bias": zeros(L, moe.router_width),
        "w_gu_e": rn(L, moe.held, H, 2 * Ie),
        "w_down_e": rn(L, moe.held, Ie, H),
        "mla": mla, "moe": moe,
    }


def init_talker_weights(cfg: TalkerConfig, generator: torch.Generator,
                        device, scale: float = 0.02,
                        moe: MoEConfig | None = None,
                        mla: MLAConfig | None = None) -> dict[str, Any]:
    """Random talker + code-predictor weights: normal(0, scale) matmul
    weights in bf16 and zero biases, as the JAX package draws them
    (weights.py:119-170). Norm weights are 1 + normal(0, 0.1) where the JAX
    init has ones, so that a kernel that skips one is seen. With `moe`,
    every talker layer holds ``moe_layers``' leaves in place of the dense
    FFN (``cfg.intermediate_size`` then unused); with `mla` too, the
    talker is of LongCat-Flash double layers (``mla_layers``; the
    correction bias zero)."""
    def rn(*shape):
        t = torch.randn(shape, generator=generator, device=device)
        return (t * scale).to(MATMUL_DTYPE)

    def norm(*shape):
        return 1.0 + 0.1 * torch.randn(shape, generator=generator,
                                       device=device, dtype=NORM_DTYPE)

    def zeros(*shape):
        return torch.zeros(shape, dtype=NORM_DTYPE, device=device)

    n_rest = cfg.n_codebooks - 1
    has_mtp = cfg.code_pred_hidden_size != cfg.hidden_size

    def talker_layers():
        if mla is not None:
            return mla_layers(rn, norm, zeros, cfg, mla, moe)
        layers = _decoder_stack(
            rn, norm, cfg.n_layers, cfg.hidden_size, cfg.n_attention_heads,
            cfg.n_key_value_heads, cfg.head_dim,
            0 if moe is not None else cfg.intermediate_size)
        if moe is not None:
            del layers["w_gu"], layers["w_down"]
            layers.update(moe_layers(rn, cfg.n_layers, cfg.hidden_size, moe))
        return layers

    return {
        "text_embd": rn(cfg.text_vocab_size, cfg.text_embd_dim),
        "text_proj": {
            "fc1_w": rn(cfg.text_embd_dim, cfg.text_embd_dim),
            "fc1_b": zeros(cfg.text_embd_dim),
            "fc2_w": rn(cfg.text_embd_dim, cfg.hidden_size),
            "fc2_b": zeros(cfg.hidden_size),
        },
        "codec_embd": rn(cfg.codec_vocab_size, cfg.hidden_size),
        "codec_head": rn(cfg.hidden_size, cfg.codec_vocab_size),
        "output_norm": norm(cfg.hidden_size),
        "layers": talker_layers(),
        "code_pred": {
            "layers": _decoder_stack(
                rn, norm, cfg.code_pred_layers, cfg.code_pred_hidden_size,
                cfg.code_pred_n_attention_heads, cfg.code_pred_n_kv_heads,
                cfg.code_pred_head_dim, cfg.code_pred_intermediate_size),
            "output_norm": norm(cfg.code_pred_hidden_size),
            "embd": rn(n_rest, cfg.code_pred_vocab_size, cfg.hidden_size),
            "heads": rn(n_rest, cfg.code_pred_hidden_size,
                        cfg.code_pred_vocab_size),
            "mtp_w": (rn(cfg.hidden_size, cfg.code_pred_hidden_size)
                      if has_mtp else None),
            "mtp_b": zeros(cfg.code_pred_hidden_size) if has_mtp else None,
        },
    }


def init_decoder_block(c: int, rate: int, generator: torch.Generator,
                       device, scale: float | None = 0.1) -> dict[str, Any]:
    """One f32 vocoder decoder block: Snake + convT (c -> c/2, K = 2*rate)
    and three residual blocks. Conv kernels are normal(0, scale), or
    normal(0, 1/sqrt(fan_in)) when `scale` is None, which keeps the
    residual chain's activations O(1). Snake parameters are normal(0, 0.3)
    and biases normal(0, 0.1) where the JAX init has zeros, so that a
    kernel that skips one is seen."""
    def rn(*shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def conv(*shape, fan_in):
        return rn(*shape, std=fan_in ** -0.5 if scale is None else scale)

    def res_block(ch):
        return {"a1": rn(ch, std=0.3), "b1": rn(ch, std=0.3),
                "c1_w": conv(ch, ch, 7, fan_in=7 * ch),
                "c1_b": rn(ch, std=0.1),
                "a2": rn(ch, std=0.3), "b2": rn(ch, std=0.3),
                "c2_w": conv(ch, ch, 1, fan_in=ch), "c2_b": rn(ch, std=0.1)}

    return {"snake_a": rn(c, std=0.3), "snake_b": rn(c, std=0.3),
            "conv_t_w": conv(c, c // 2, 2 * rate, fan_in=2 * c),
            "conv_t_b": rn(c // 2, std=0.1),
            "res": [res_block(c // 2) for _ in range(3)]}


def init_vocoder_weights(cfg: VocoderConfig, generator: torch.Generator,
                         device, dtype: torch.dtype | None = torch.bfloat16
                         ) -> dict[str, Any]:
    """Random vocoder weights at the JAX package's scales (vocoder.py:
    645-722): normal(0, 0.1) kernels, normal(0, 1) codebooks, unit norms,
    0.5 layer scales, zero biases outside the decoder blocks; the decoder
    blocks as init_decoder_block draws them. Matrices are then cast to
    `dtype` (cast_weights; None keeps f32)."""
    from .vocoder import cast_weights

    def rn(*shape, scale=0.1):
        return torch.randn(shape, generator=generator, device=device) * scale

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    width, qkv = cfg.hidden_dim, cfg.latent_dim

    def tfm_layer():
        return {"attn_norm": full(width, 1.0), "wq": rn(width, qkv),
                "wk": rn(width, qkv), "wv": rn(width, qkv),
                "wo": rn(qkv, width), "attn_scale": full(width, 0.5),
                "ffn_norm": full(width, 1.0), "w_gate": rn(width, 2 * width),
                "w_up": rn(width, 2 * width), "w_down": rn(2 * width, width),
                "ffn_scale": full(width, 0.5)}

    def upsample_block(c):
        return {"conv_t_w": rn(c, c, 2), "conv_t_b": full(c, 0.0),
                "dw_w": rn(c, 1, 7), "dw_b": full(c, 0.0),
                "ln_w": full(c, 1.0), "ln_b": full(c, 0.0),
                "pw1_w": rn(c, 2 * c), "pw1_b": full(2 * c, 0.0),
                "pw2_w": rn(2 * c, c), "pw2_b": full(c, 0.0),
                "gamma": full(c, 0.5)}

    c = cfg.decoder_dim
    dec_blocks = []
    for rate in cfg.upsample_rates:
        dec_blocks.append(init_decoder_block(c, rate, generator, device))
        c //= 2
    layers = [tfm_layer() for _ in range(cfg.n_pre_tfm_layers)]
    w = {
        "vq_first_codebook": rn(cfg.codebook_size, cfg.codebook_dim,
                                scale=1.0),
        "vq_first_out_proj": rn(cfg.codebook_dim, cfg.hidden_dim),
        "vq_rest_codebooks": rn(cfg.n_codebooks - 1, cfg.codebook_size,
                                cfg.codebook_dim, scale=1.0),
        "vq_rest_out_proj": rn(cfg.codebook_dim, cfg.hidden_dim),
        "pre_conv_w": rn(cfg.latent_dim, cfg.hidden_dim, 3),
        "pre_conv_b": full(cfg.latent_dim, 0.0),
        "pre_tfm": {
            "in_w": rn(cfg.latent_dim, width), "in_b": full(width, 0.0),
            "out_w": rn(width, cfg.latent_dim),
            "out_b": full(cfg.latent_dim, 0.0), "norm": full(width, 1.0),
            "layers": {k: torch.stack([lay[k] for lay in layers])
                       for k in layers[0]},
        },
        "upsample": [upsample_block(cfg.latent_dim) for _ in range(2)],
        "dec0_w": rn(cfg.decoder_dim, cfg.latent_dim, 7),
        "dec0_b": full(cfg.decoder_dim, 0.0),
        "dec_blocks": dec_blocks,
        "dec5_a": rn(c, scale=0.3), "dec5_b": rn(c, scale=0.3),
        "dec6_w": rn(1, c, 7), "dec6_b": full(1, 0.0),
    }
    return w if dtype is None else cast_weights(w, dtype)


def init_code2wav_weights(cfg: VocoderConfig, generator: torch.Generator,
                          device, c2w: Code2WavConfig = Code2WavConfig(),
                          dtype: torch.dtype | None = torch.bfloat16
                          ) -> dict[str, Any]:
    """Random weights of Qwen3-Omni's Code2Wav (config.Code2WavConfig,
    models/vocoder.py), the entry "code2wav" = c2w among them:
    ``code_embedding`` [n_codebooks * codebook_size, hidden_dim]
    normal(0, sqrt(n_codebooks)) (a frame's mean of n rows has unit
    variance), the pre-transformer at hidden_dim (q / k / v / o
    hidden_dim wide, SwiGLU c2w.intermediate_size) with unit norms and
    0.5 layer scales, ConvNeXt upsample blocks of 4 x hidden_dim, dec0,
    the decoder blocks (init_decoder_block) and the last convolution;
    every matrix and convolution normal(0, 1/sqrt(fan_in)), the decoder
    blocks' convT x0.7 and their residual k7 convolutions x0.3, the last
    convolution x0.12, so that activations stay O(1) block to block at any
    width and the audio off the clamp. Matrices are then cast to `dtype`
    (cast_weights; None keeps f32)."""
    from .vocoder import cast_weights

    def rn(*shape, fan_in=None, std=None):
        std = fan_in ** -0.5 if std is None else std
        return torch.randn(shape, generator=generator, device=device) * std

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    H, inter = cfg.hidden_dim, c2w.intermediate_size

    def tfm_layer():
        return {"attn_norm": full(H, 1.0), "wq": rn(H, H, fan_in=H),
                "wk": rn(H, H, fan_in=H), "wv": rn(H, H, fan_in=H),
                "wo": rn(H, H, fan_in=H), "attn_scale": full(H, 0.5),
                "ffn_norm": full(H, 1.0), "w_gate": rn(H, inter, fan_in=H),
                "w_up": rn(H, inter, fan_in=H),
                "w_down": rn(inter, H, fan_in=inter),
                "ffn_scale": full(H, 0.5)}

    def upsample_block():
        return {"conv_t_w": rn(H, H, 2, fan_in=H), "conv_t_b": full(H, 0.0),
                "dw_w": rn(H, 1, 7, fan_in=7), "dw_b": full(H, 0.0),
                "ln_w": full(H, 1.0), "ln_b": full(H, 0.0),
                "pw1_w": rn(H, 4 * H, fan_in=H), "pw1_b": full(4 * H, 0.0),
                "pw2_w": rn(4 * H, H, fan_in=4 * H), "pw2_b": full(H, 0.0),
                "gamma": full(H, 0.5)}

    c = cfg.decoder_dim
    dec_blocks = []
    for rate in cfg.upsample_rates:
        blk = init_decoder_block(c, rate, generator, device, scale=None)
        blk["conv_t_w"] *= 0.7
        for res in blk["res"]:
            res["c1_w"] *= 0.3
        dec_blocks.append(blk)
        c //= 2
    layers = [tfm_layer() for _ in range(cfg.n_pre_tfm_layers)]
    w = {
        "code_embedding": rn(cfg.n_codebooks * cfg.codebook_size, H,
                             std=cfg.n_codebooks ** 0.5),
        "pre_tfm": {
            "norm": full(H, 1.0),
            "layers": {k: torch.stack([lay[k] for lay in layers])
                       for k in layers[0]},
        },
        "upsample": [upsample_block() for _ in range(2)],
        "dec0_w": rn(cfg.decoder_dim, H, 7, fan_in=7 * H),
        "dec0_b": full(cfg.decoder_dim, 0.0),
        "dec_blocks": dec_blocks,
        "dec5_a": rn(c, std=0.3), "dec5_b": rn(c, std=0.3),
        "dec6_w": rn(1, c, 7, std=0.12 * (7 * c) ** -0.5),
        "dec6_b": full(1, 0.0),
        "code2wav": c2w,
    }
    return w if dtype is None else cast_weights(w, dtype)


def tiny_talker_config() -> TalkerConfig:
    """Small config for fast tests (same structure, tiny dims)."""
    return TalkerConfig(
        text_vocab_size=512, text_embd_dim=64,
        hidden_size=64, n_layers=2, n_attention_heads=4,
        n_key_value_heads=2, intermediate_size=128, head_dim=16,
        codec_vocab_size=3072, n_codebooks=16,
        code_pred_layers=2, code_pred_vocab_size=256,
        code_pred_hidden_size=64, code_pred_intermediate_size=128,
        code_pred_n_attention_heads=4, code_pred_n_kv_heads=2,
        code_pred_head_dim=16,
        tts_bos_token_id=500, tts_eos_token_id=501, tts_pad_token_id=499,
    )
