"""Vocoder: codes [B, F, 16] -> 24 kHz waveform (port of
qwen3_tts_tpu/models/vocoder.py; layout [B, T, C] throughout).

Pipeline: RVQ dequant -> causal pre_conv -> 8-layer causal
pre-transformer -> 2 ConvNeXt upsample blocks -> dec0 conv -> 4 decoder
blocks (snake + convT, then the residual Snake chain) -> snake -> conv ->
tanh. 1920 samples per 12.5 Hz frame.

Convolutions round their input to the weight dtype and accumulate in f32
(the JAX ``preferred_element_type=f32`` convention). On a CUDA tensor the
decoder blocks run the hand-written kernels of ops/vocoder_fused.py: the
residual chain always, the Snake + convT head with trim="causal"; their
parameters are packed once by ``pack_kernel_weights``. The JAX package's
switches are ported (no environment variable, as in the JAX package):
- ``set_res_chain_impl`` (models/impl_switch.py): ``auto`` (the default)
  takes the kernels on a CUDA tensor (they raise where a shape is not
  served) and the plain torch path on a CPU tensor; ``fused`` the
  kernels' wrappers on any tensor (on a CPU tensor they run their twins,
  which are the plain path); ``xla`` the plain path;
- ``set_snake_sin2_impl`` (ops/vocoder_fused.py): Snake's sin^2, ``fast``
  (the fast_sin2 polynomial, the default) or ``exact`` (the accurate
  sine), honoured by the plain path, the twins and the kernels;
- ``res_chain_impl_traced`` / ``reset_res_chain_traced``: which residual
  chain ``_res_chain`` took since the reset, "fused" (the kernels'
  wrappers), "xla" (the plain path), "mixed", or "untraced". It is
  recorded where Python picks the implementation, at an eager call and at
  a graph's capture; a replay runs no Python, as a JAX cache hit runs no
  trace, so a reset followed by replays only reads "untraced".
The engine's vocoder graphs are keyed by the first two
(runtime/graphs.voc_key), so a change takes a new graph.
``load_vocoder_weights`` reads the codec GGUF onto a device in f32, as the
JAX loader does; the pipeline casts (``cast_weights``) and packs.

A weights tree holding the entry "code2wav" (a config.Code2WavConfig;
models/weights.init_code2wav_weights) is Qwen3-Omni's Code2Wav: the
codes' rows of ``code_embedding`` averaged over the codebooks, then the
pre-transformer at the hidden width with sliding-window attention and its
final norm (no pre_conv, no projections around it), the ConvNeXt
upsample with the exact GELU, the same decoder blocks and kernels, and
the waveform clamped to [-1, 1] where the 12 Hz decoder takes tanh.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import VocoderConfig
from ..ops.layers import NEG_INF, dot, rms_norm, rope_neox
# set_snake_sin2_impl / snake_sin2_impl: the switch lives beside the
# kernels that honour it and is re-exported here, where the JAX package has it
from ..ops.vocoder_fused import (fused_residual_chain, fused_snake_convt,
                                 pack_block, residual_chain_twin,
                                 set_snake_sin2_impl, sin2, snake_sin2_impl)
from .impl_switch import ImplSwitch

_SWITCH = ImplSwitch(None, "set_res_chain_impl")
set_res_chain_impl = _SWITCH.set
_resolve_impl = _SWITCH.resolve
_RES_TRACED: set = set()     # "fused" / "xla": what _res_chain took


def reset_res_chain_traced() -> None:
    _RES_TRACED.clear()


def res_chain_impl_traced() -> str:
    """"fused" / "xla" / "mixed" over every residual chain that Python
    dispatched since the last reset; "untraced" if none (graph replays
    only; module docstring)."""
    if not _RES_TRACED:
        return "untraced"
    return next(iter(_RES_TRACED)) if len(_RES_TRACED) == 1 else "mixed"


def _kernels(x: torch.Tensor) -> bool:
    """Whether the decoder blocks take the kernels' wrappers for `x`."""
    impl = _SWITCH.resolve()
    return impl == "fused" or (impl == "auto" and x.is_cuda)


def _ncw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, C, T] f32 holding values of w's dtype."""
    return x.to(w.dtype).float().transpose(1, 2)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  dilation: int = 1, left_pad: int | None = None,
                  groups: int = 1) -> torch.Tensor:
    """Conv1d with left (causal) zero padding. x: [B, T, C_in];
    w: [C_out, C_in/groups, K] (torch order); left_pad defaults to
    dilation*(K-1). Returns [B, T', C_out] f32."""
    if left_pad is None:
        left_pad = dilation * (w.shape[-1] - 1)
    y = F.conv1d(F.pad(_ncw(x, w), (left_pad, 0)), w.float(),
                 dilation=dilation, groups=groups)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.float()
    return y.contiguous()


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """ConvTranspose1d, out length (T-1)*stride + K. x: [B, T, C_in];
    w: [C_in, C_out, K] (torch order). Returns [B, T', C_out] f32."""
    y = F.conv_transpose1d(_ncw(x, w), w.float(), stride=stride)
    return y.transpose(1, 2).contiguous()


def snake(x: torch.Tensor, alpha_log: torch.Tensor,
          beta_log: torch.Tensor) -> torch.Tensor:
    """x + exp(-beta) * sin^2(exp(alpha) * x), per channel; sin^2 as
    ``set_snake_sin2_impl`` says (the fast_sin2 polynomial by default)."""
    a = torch.exp(alpha_log.float())
    inv_b = torch.exp(-beta_log.float())
    return x + inv_b * sin2(x.float() * a)


def _pre_tfm_layer(wl, x: torch.Tensor, positions: torch.Tensor,
                   n_heads: int, eps: float, theta: float,
                   window: int | None = None) -> torch.Tensor:
    """Causal pre-transformer layer with layer-scale; a query sees the
    `window` latest positions, itself included, where `window` is given."""
    B, T, _ = x.shape
    h = rms_norm(x, wl["attn_norm"], eps)
    q, k, v = dot(h, wl["wq"]), dot(h, wl["wk"]), dot(h, wl["wv"])
    head_dim = q.shape[-1] // n_heads
    q = rope_neox(q.reshape(B, T, n_heads, head_dim), positions, theta)
    k = rope_neox(k.reshape(B, T, n_heads, head_dim), positions, theta)
    v = v.reshape(B, T, n_heads, head_dim)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / head_dim ** 0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    if window is not None:
        causal = causal.triu(1 - window)
    scores = scores.masked_fill(~causal, NEG_INF)
    attn = torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), v)
    x = x + dot(attn.reshape(B, T, n_heads * head_dim), wl["wo"]) \
        * wl["attn_scale"]
    h = rms_norm(x, wl["ffn_norm"], eps)
    act = F.silu(dot(h, wl["w_gate"])) * dot(h, wl["w_up"])
    return x + dot(act, wl["w_down"]) * wl["ffn_scale"]


def _upsample_block(w, x: torch.Tensor, gelu: str = "tanh") -> torch.Tensor:
    """ConvNeXt 2x upsample: convT stride 2 (no trim) -> [causal dwconv k=7
    + LayerNorm + pointwise MLP (GELU, `gelu` its approximation) + gamma]
    residual."""
    c = x.shape[-1]
    x = conv_transpose1d(x, w["conv_t_w"], 2) + w["conv_t_b"].float()
    residual = x
    k = w["dw_w"].shape[-1]
    x = causal_conv1d(x, w["dw_w"], w["dw_b"], left_pad=k - 1, groups=c)
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + 1e-6) * w["ln_w"].float()
         + w["ln_b"].float())
    x = F.gelu(dot(x, w["pw1_w"]) + w["pw1_b"], approximate=gelu)
    x = dot(x, w["pw2_w"]) + w["pw2_b"]
    return residual + x * w["gamma"].float()


def _residual_block(w, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """Snake + dilated causal conv k=7 + Snake + conv k=1, residual."""
    y = causal_conv1d(snake(x, w["a1"], w["b1"]), w["c1_w"], w["c1_b"],
                      dilation=dilation)
    y = causal_conv1d(snake(y, w["a2"], w["b2"]), w["c2_w"], w["c2_b"])
    return x + y


def _res_chain(blk_w, x: torch.Tensor) -> torch.Tensor:
    """The 3-block dilated residual chain (the kernel on a CUDA tensor
    unless the switch says xla), recorded for ``res_chain_impl_traced``."""
    if _kernels(x):
        _RES_TRACED.add("fused")
        return fused_residual_chain(x, blk_w)
    _RES_TRACED.add("xla")
    return residual_chain_twin(x, blk_w)


def _decoder_block(w, x: torch.Tensor, rate: int,
                   trim: str = "both") -> torch.Tensor:
    """Snake + convT(stride=rate) + 3 residual blocks.

    trim="both": (K-rate) cut from both sides, output (T+1)*rate - K.
    trim="causal": (K-rate) cut from the left only, output exactly T*rate
    (the streaming path's fixed-chunk sample arithmetic)."""
    if trim == "causal" and _kernels(x):
        return _res_chain(w, fused_snake_convt(x, w, rate))
    k = w["conv_t_w"].shape[-1]
    x = conv_transpose1d(snake(x, w["snake_a"], w["snake_b"]),
                         w["conv_t_w"], rate)
    cut = k - rate
    if cut > 0:
        x = x[:, cut:x.shape[1] - cut] if trim == "both" else x[:, cut:]
    return _res_chain(w, (x + w["conv_t_b"].float()).contiguous())


def vq_dequantize(w, cfg: VocoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """RVQ lookup + shared projections, summed. codes: [B, F, 16] ->
    [B, F, hidden]. The 15 rest codebooks share one projection, so their
    embeddings are summed before it."""
    codes = codes.long()
    first = dot(w["vq_first_codebook"][codes[..., 0]], w["vq_first_out_proj"])
    tables = w["vq_rest_codebooks"]
    rest_emb = tables[torch.arange(tables.shape[0], device=codes.device),
                      codes[..., 1:]]                         # [B, F, 15, D]
    return first + dot(rest_emb.sum(dim=-2), w["vq_rest_out_proj"])


def code2wav_embed(w, codes: torch.Tensor) -> torch.Tensor:
    """Code2Wav's input: each code's row of ``code_embedding`` [n *
    codebook_size, H] (codebook j's codes offset by j * codebook_size),
    averaged over the n codebooks. codes [B, F, n] -> [B, F, H] f32."""
    codes = codes.long()
    n = codes.shape[-1]
    offset = (w["code_embedding"].shape[0] // n) * torch.arange(
        n, device=codes.device)
    return w["code_embedding"][codes + offset].float().mean(dim=-2)


def vocoder_output_length(w, cfg: VocoderConfig, n_frames: int,
                          trim: str = "both") -> int:
    """Exact output sample count for n_frames (trim="causal":
    n_frames * samples_per_frame)."""
    t = n_frames
    for up_w in w["upsample"]:
        t = (t - 1) * 2 + up_w["conv_t_w"].shape[-1]
    for blk_w, rate in zip(w["dec_blocks"], cfg.upsample_rates):
        if trim == "both":
            k = blk_w["conv_t_w"].shape[-1]
            t = (t - 1) * rate + k - 2 * (k - rate)
        else:
            t = t * rate
    return t


def _code2wav_front(w, cfg: VocoderConfig, codes: torch.Tensor
                    ) -> torch.Tensor:
    """Code2Wav's front (module docstring): codes [B, F, 16] -> latent
    [B, 4F, decoder_dim]."""
    B, F_, _ = codes.shape
    x = code2wav_embed(w, codes)
    t = w["pre_tfm"]
    positions = torch.arange(F_, dtype=torch.int32,
                             device=codes.device).expand(B, F_)
    window = w["code2wav"].sliding_window
    for l in range(t["layers"]["wq"].shape[0]):
        wl = {name: a[l] for name, a in t["layers"].items()}
        x = _pre_tfm_layer(wl, x, positions, cfg.n_heads, cfg.rms_norm_eps,
                           cfg.rope_theta, window)
    x = rms_norm(x, t["norm"], cfg.rms_norm_eps)
    for up_w in w["upsample"]:
        x = _upsample_block(up_w, x, gelu="none")
    return causal_conv1d(x, w["dec0_w"], w["dec0_b"])


def _front_impl(w, cfg: VocoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """vq dequant + pre-transformer + ConvNeXt upsample + dec0:
    codes [B, F, 16] -> latent [B, 4F(+pad), decoder_dim]; Code2Wav's
    front where the tree holds "code2wav"."""
    if "code2wav" in w:
        return _code2wav_front(w, cfg, codes)
    B, F_, _ = codes.shape
    x = vq_dequantize(w, cfg, codes)
    x = causal_conv1d(x, w["pre_conv_w"], w["pre_conv_b"])
    t = w["pre_tfm"]
    x = dot(x, t["in_w"]) + t["in_b"]
    positions = torch.arange(F_, dtype=torch.int32,
                             device=codes.device).expand(B, F_)
    for l in range(t["layers"]["wq"].shape[0]):
        wl = {name: a[l] for name, a in t["layers"].items()}
        x = _pre_tfm_layer(wl, x, positions, cfg.n_heads, cfg.rms_norm_eps,
                           cfg.rope_theta)
    x = dot(rms_norm(x, t["norm"], cfg.rms_norm_eps), t["out_w"]) + t["out_b"]
    for up_w in w["upsample"]:
        x = _upsample_block(up_w, x)
    return causal_conv1d(x, w["dec0_w"], w["dec0_b"])


def _tail_impl(w, cfg: VocoderConfig, x: torch.Tensor, trim: str,
               pcm16: bool) -> torch.Tensor:
    """Decoder blocks + final snake/conv/tanh (Code2Wav: clamp to
    [-1, 1]): [B, T, decoder_dim] -> audio [B, T*480] f32, or int16 PCM
    when `pcm16`."""
    for blk_w, rate in zip(w["dec_blocks"], cfg.upsample_rates):
        x = _decoder_block(blk_w, x, rate, trim)
    x = causal_conv1d(snake(x, w["dec5_a"], w["dec5_b"]), w["dec6_w"],
                      w["dec6_b"])
    audio = (x[..., 0].clamp(-1.0, 1.0) if "code2wav" in w
             else torch.tanh(x[..., 0]))
    if pcm16:
        return torch.round(audio * 32767.0).clamp(-32768, 32767).to(
            torch.int16)
    return audio


def vocoder_decode(w, cfg: VocoderConfig, codes: torch.Tensor,
                   trim: str = "both", pcm16: bool = False) -> torch.Tensor:
    """Decode codes [B, F, 16] -> audio [B, samples] (see _tail_impl)."""
    return _tail_impl(w, cfg, _front_impl(w, cfg, codes), trim, pcm16)


def vocoder_decode_subbatched(w, cfg: VocoderConfig, codes: torch.Tensor,
                              trim: str = "causal", pcm16: bool = False,
                              sub: int = 16) -> torch.Tensor:
    """Whole-batch decode with bounded activation memory: the front runs
    once over the batch, the tail (whose buffers grow to 76,800 samples
    per 40-frame chunk) per `sub`-wide sub-batch. B must be a multiple of
    `sub`."""
    B = codes.shape[0]
    if B <= sub:
        return vocoder_decode(w, cfg, codes, trim, pcm16)
    if B % sub:
        raise ValueError(f"batch {B} is not a multiple of sub {sub}")
    x = _front_impl(w, cfg, codes)
    return torch.cat([_tail_impl(w, cfg, x[i:i + sub], trim, pcm16)
                      for i in range(0, B, sub)])


def _maybe_normalize_codebook(r, cb_name: str, usage_name: str, device,
                              stager) -> torch.Tensor:
    """codebook = embedding_sum / clamp(usage, 1e-5) when the file has a
    usage tensor (the converter pre-divides and drops them; both layouts
    load). Divided on the host in f32, as the JAX loader does."""
    if usage_name not in r.tensors:
        return r.tensor(cb_name, device, torch.float32, stager)
    cb = r.tensor_data(cb_name).astype(np.float32)
    usage = r.tensor_data(usage_name).astype(np.float32)
    return torch.from_numpy(cb / np.maximum(usage, 1e-5)[:, None]).to(device)


def load_vocoder_weights(r, cfg: VocoderConfig, device,
                         stager=None) -> dict[str, Any]:
    """The vocoder from the codec GGUF (`r`, an io.gguf.GGUFReader) on
    `device`, every tensor f32 as the JAX loader gives it: linear weights
    [in, out], convolutions in torch order. Callers cast (cast_weights)
    and pack (pack_kernel_weights)."""
    def t(name):
        return r.tensor(name, device, torch.float32, stager)

    def lin(name):
        return t(name).t().contiguous()

    def proj(name):              # a k=1 conv [out, in, 1] used as [in, out]
        w = t(name)
        return w.reshape(w.shape[0], w.shape[1]).t().contiguous()

    def tfm_layer(i):
        p = f"tok_dec.pre_tfm.blk.{i}"
        return {
            "attn_norm": t(f"{p}.attn_norm.weight"),
            "wq": lin(f"{p}.attn_q.weight"), "wk": lin(f"{p}.attn_k.weight"),
            "wv": lin(f"{p}.attn_v.weight"),
            "wo": lin(f"{p}.attn_output.weight"),
            "attn_scale": t(f"{p}.attn_scale"),
            "ffn_norm": t(f"{p}.ffn_norm.weight"),
            "w_gate": lin(f"{p}.ffn_gate.weight"),
            "w_up": lin(f"{p}.ffn_up.weight"),
            "w_down": lin(f"{p}.ffn_down.weight"),
            "ffn_scale": t(f"{p}.ffn_scale"),
        }

    def upsample_block(i):
        p = f"tok_dec.upsample.{i}"
        return {
            "conv_t_w": t(f"{p}.conv.weight"), "conv_t_b": t(f"{p}.conv.bias"),
            "dw_w": t(f"{p}.dwconv.weight"), "dw_b": t(f"{p}.dwconv.bias"),
            "ln_w": t(f"{p}.norm.weight"), "ln_b": t(f"{p}.norm.bias"),
            "pw1_w": lin(f"{p}.pwconv1.weight"),
            "pw1_b": t(f"{p}.pwconv1.bias"),
            "pw2_w": lin(f"{p}.pwconv2.weight"),
            "pw2_b": t(f"{p}.pwconv2.bias"),
            "gamma": t(f"{p}.gamma"),
        }

    def res_block(blk, res):
        p = f"tok_dec.dec.{blk}.res.{res}"
        return {
            "a1": t(f"{p}.act1.alpha"), "b1": t(f"{p}.act1.beta"),
            "c1_w": t(f"{p}.conv1.weight"), "c1_b": t(f"{p}.conv1.bias"),
            "a2": t(f"{p}.act2.alpha"), "b2": t(f"{p}.act2.beta"),
            "c2_w": t(f"{p}.conv2.weight"), "c2_b": t(f"{p}.conv2.bias"),
        }

    def dec_block(blk):
        p = f"tok_dec.dec.{blk}"
        return {
            "snake_a": t(f"{p}.snake.alpha"), "snake_b": t(f"{p}.snake.beta"),
            "conv_t_w": t(f"{p}.conv_t.weight"),
            "conv_t_b": t(f"{p}.conv_t.bias"),
            # the file numbers the residual blocks 2..4 (after snake, convT)
            "res": [res_block(blk, j) for j in (2, 3, 4)],
        }

    layers = [tfm_layer(i) for i in range(cfg.n_pre_tfm_layers)]
    return {
        "vq_first_codebook": _maybe_normalize_codebook(
            r, "tok_dec.vq_first.0.codebook", "tok_dec.vq_first.0.usage",
            device, stager),
        "vq_first_out_proj": proj("tok_dec.vq_first.output_proj.weight"),
        "vq_rest_codebooks": torch.stack([
            _maybe_normalize_codebook(
                r, f"tok_dec.vq_rest.{i}.codebook",
                f"tok_dec.vq_rest.{i}.usage", device, stager)
            for i in range(cfg.n_codebooks - 1)]),
        "vq_rest_out_proj": proj("tok_dec.vq_rest.output_proj.weight"),
        "pre_conv_w": t("tok_dec.pre_conv.weight"),
        "pre_conv_b": t("tok_dec.pre_conv.bias"),
        "pre_tfm": {
            "in_w": lin("tok_dec.pre_tfm.input_proj.weight"),
            "in_b": t("tok_dec.pre_tfm.input_proj.bias"),
            "out_w": lin("tok_dec.pre_tfm.output_proj.weight"),
            "out_b": t("tok_dec.pre_tfm.output_proj.bias"),
            "norm": t("tok_dec.pre_tfm.norm.weight"),
            "layers": {k: torch.stack([lay[k] for lay in layers])
                       for k in layers[0]},
        },
        "upsample": [upsample_block(i) for i in range(2)],
        "dec0_w": t("tok_dec.dec.0.conv.weight"),
        "dec0_b": t("tok_dec.dec.0.conv.bias"),
        "dec_blocks": [dec_block(i) for i in (1, 2, 3, 4)],
        "dec5_a": t("tok_dec.dec.5.snake.alpha"),
        "dec5_b": t("tok_dec.dec.5.snake.beta"),
        "dec6_w": t("tok_dec.dec.6.conv.weight"),
        "dec6_b": t("tok_dec.dec.6.conv.bias"),
    }


def cast_weights(w, dtype=torch.bfloat16):
    """Cast f32 conv/matmul weights (ndim >= 2) to `dtype`, keeping 1-D
    params (norms, biases, snake alphas) in f32."""
    if isinstance(w, dict):
        return {k: cast_weights(v, dtype) for k, v in w.items()}
    if isinstance(w, list):
        return [cast_weights(v, dtype) for v in w]
    if (isinstance(w, torch.Tensor) and w.ndim >= 2
            and w.dtype == torch.float32):
        return w.to(dtype)
    return w


def pack_kernel_weights(w):
    """`w` with each decoder block's kernel-ready parameters added under
    "kernel" (ops/vocoder_fused.pack_block). Done once at load time; the
    CUDA path needs it, the CPU path ignores it."""
    return {**w, "dec_blocks": [{**blk, "kernel": pack_block(blk)}
                                for blk in w["dec_blocks"]]}


def tiny_vocoder_config() -> VocoderConfig:
    return VocoderConfig(
        sample_rate=24000, n_codebooks=16, codebook_size=64,
        codebook_dim=8, latent_dim=32, hidden_dim=16,
        n_pre_tfm_layers=2, n_heads=4, decoder_dim=32,
        upsample_rates=(2, 2, 2, 2))
