"""Per-stage activation parity on the port alone: an independent PyTorch
reference, written from the HF tensor layout, against the port's stack
(the port of tools/parity.py).

  1. loads an HF-layout checkpoint directory (config.json + safetensors,
     through io/safetensors.py),
  2. runs the reference of each stage (``TorchTalker``, ``TorchVocoder``:
     a copy of tools/parity.py's classes, sharing no code with the port's
     models) on the CPU in f32,
  3. converts the same checkpoint to GGUF (tools/convert_checkpoints.py),
     loads it into the port on --device and runs the port's stack on the
     same inputs, reporting per stage max|diff|, its ratio to the
     reference's max|.| and the cosine.

Stages: prefill-embedding recipe and trailing schedule, talker prefill
(last hidden state and logits), talker decode step (against a reference
FULL forward over prefill + 1 rows, which cross-checks the KV-cache path),
greedy code predictor, vocoder decode.

The port's stack runs two passes:
  - f32: GGUF converted at f32, weights loaded in f32
    (``weights.MATMUL_DTYPE = torch.float32``), every switch at ``xla``,
    decode attention's included (``set_decode_attention_impl``), and TF32
    off: the plain path end to end, no kernel launched, gated at --tol as
    the JAX tool gates it (the residual is the bf16 KV cache's rounding);
  - bf16: the production weights (GGUF f16 loaded as bf16; the vocoder's
    matrices cast to bf16, as ``load_models`` does on the card). The
    talker step, the code predictor and the vocoder take their kernels
    (``fused``: on a CUDA tensor the kernel, on a CPU tensor its torch
    twin); a geometry a kernel does not serve (``fused`` raises; the 0.6B
    model's is served by every kernel) fails its stage, never falls back
    to the plain path. The step then runs once more under ``xla`` with
    decode attention at ``flash``, so that the decode-attention kernel
    runs in the per-layer step (its twin on the CPU). The
    vocoder decodes with the streaming (causal) trim there, which the
    Snake + convT head kernel serves; every layer is causal, so the
    reference's both-sides-trimmed audio is a prefix of it, and the stage
    compares that prefix. Gated at BF16_TOL on the relative error alone
    (the f32 pass keeps the JAX tool's rule, relative or absolute error
    within --tol); greedy codes must be equal
    or differ first at a bf16 near-tie (the reference's logit of its own
    code at most NEAR_TIE above its logit of the port's).
Each stage's line names the pass and the implementation that ran it.

Usage:
  python -m qwen3_tts_tpu_torch.tools.parity --tts <hf_dir> \\
      [--codec <hf_dir>] [--out parity.npz] [--tol 1e-2] [--seed 0] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..config import TalkerConfig, VocoderConfig
from ..io.gguf import GGUFReader
from ..io.safetensors import checkpoint_files, iter_tensors
from ..models import code_predictor, talker, vocoder
from ..models import weights as W
from ..models.stack import init_kv_cache
from ..ops import (attention, codepred_fused, flash_decode, talker_fused,
                   vocoder_fused)
from . import convert_checkpoints as cc

PASSES = ("f32", "bf16")
# The bf16 pass's gates on max|diff| / max|reference|, per stage: twice the
# largest such ratio that this pass showed through the kernels' twins on
# the CPU at the full 0.6B widths, over 3 seeds of a synthetic BF16
# checkpoint (`python3 chip_smoke.py --parity-cpu` on an 8-core host, torch
# 2.11; the step's largest over its fused and xla runs): prefill_embd 1.782e-4,
# trailing_schedule 2.120e-3, talker_hidden 1.028e-2, talker_logits
# 7.741e-3, step_hidden 8.588e-3, step_logits 6.333e-3, vocoder_audio
# 6.715e-2 (the f32 pass: at most 4.390e-3, within --tol).
BF16_TOL = {"prefill_embd": 3.6e-4, "trailing_schedule": 4.3e-3,
            "talker_hidden": 2.1e-2, "talker_logits": 1.6e-2,
            "step_hidden": 1.8e-2, "step_logits": 1.3e-2,
            "vocoder_audio": 1.4e-1}
NEAR_TIE = 5e-2     # a code flip within this reference logit margin


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Torch reference (HF tensor layout, independent of the port's models)
# ---------------------------------------------------------------------------

def _load_hf(d: Path) -> dict:
    """Every tensor of the checkpoint at `d` (or its speech_tokenizer/), as
    writable numpy arrays."""
    return {name: a if a.flags.writeable else a.copy()
            for name, a in iter_tensors(checkpoint_files(d))}


class TorchTalker:
    """Reference talker forward in torch (tts_transformer.cpp:1233-1512)."""

    def __init__(self, hf: dict, cfg: dict):
        self.t = {k: torch.from_numpy(np.asarray(v, np.float32))
                  for k, v in hf.items()}
        tk = cfg["talker_config"]
        self.H = tk["hidden_size"]
        self.L = tk["num_hidden_layers"]
        self.NH = tk["num_attention_heads"]
        self.NKV = tk["num_key_value_heads"]
        self.HD = tk["head_dim"]
        self.eps = tk.get("rms_norm_eps", 1e-6)
        self.theta = tk.get("rope_theta", 1e6)
        cp = tk.get("code_predictor_config", {})
        self.cp_L = cp.get("num_hidden_layers", 5)
        # the code predictor's head geometry is its own (the converter
        # and TalkerConfig plumb separate code_pred head counts); using
        # the talker's here reported false parity failures for variants
        self.cp_NH = cp.get("num_attention_heads", self.NH)
        self.cp_NKV = cp.get("num_key_value_heads", self.NKV)
        self.cp_HD = cp.get("head_dim", self.HD)
        self.n_groups = tk.get("num_code_groups", 16)

    # -- primitives --------------------------------------------------------
    def rms(self, x, w):
        var = (x.float() ** 2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * w

    def rope(self, x, positions):
        """NEOX pairs (i, i+D/2) — ggml_rope_ext(GGML_ROPE_TYPE_NEOX),
        tts_transformer.cpp:1290-1296. x: [B,T,nh,D]."""
        D = x.shape[-1]
        half = D // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32)
                          * (-2.0 / D) * math.log(self.theta))
        ang = positions.float()[..., None] * freqs          # [B,T,half]
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _layer(self, p, x, positions, nh, nkv, hd):
        B, T, H = x.shape
        h = self.rms(x, self.t[f"{p}.input_layernorm.weight"])
        q = h @ self.t[f"{p}.self_attn.q_proj.weight"].T
        k = h @ self.t[f"{p}.self_attn.k_proj.weight"].T
        v = h @ self.t[f"{p}.self_attn.v_proj.weight"].T
        q = q.view(B, T, nh, hd)
        k = k.view(B, T, nkv, hd)
        v = v.view(B, T, nkv, hd)
        q = self.rms(q, self.t[f"{p}.self_attn.q_norm.weight"])
        k = self.rms(k, self.t[f"{p}.self_attn.k_norm.weight"])
        q = self.rope(q, positions)
        k = self.rope(k, positions)
        G = nh // nkv
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool))
        scores = scores.masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, -1)
        x = x + attn @ self.t[f"{p}.self_attn.o_proj.weight"].T
        h = self.rms(x, self.t[f"{p}.post_attention_layernorm.weight"])
        gate = h @ self.t[f"{p}.mlp.gate_proj.weight"].T
        up = h @ self.t[f"{p}.mlp.up_proj.weight"].T
        x = x + (torch.nn.functional.silu(gate) * up) \
            @ self.t[f"{p}.mlp.down_proj.weight"].T
        return x

    # -- stages ------------------------------------------------------------
    def text_project(self, tokens):
        """text_embd -> fc1 -> SiLU -> fc2 (tts_transformer.cpp:1026-1091).

        Indices clamp to the table (matches jnp.take's clip mode, relevant
        only for tiny synthetic vocabs where real special ids overflow)."""
        table = self.t["talker.model.text_embedding.weight"]
        tokens = torch.clamp(tokens, max=table.shape[0] - 1)
        x = table[tokens]
        x = x @ self.t["talker.text_projection.linear_fc1.weight"].T \
            + self.t["talker.text_projection.linear_fc1.bias"]
        x = torch.nn.functional.silu(x)
        return x @ self.t["talker.text_projection.linear_fc2.weight"].T \
            + self.t["talker.text_projection.linear_fc2.bias"]

    def prefill_embeds(self, tokens, spk, special, codec_ids, language_id):
        """build_prefill_graph recipe (tts_transformer.cpp:1093-1231).

        codec_ids: (think, think_bos, think_eos, pad, bos)."""
        tts_bos, tts_eos, tts_pad = [
            self.text_project(torch.tensor([i]))[0] for i in special]
        proj = self.text_project(tokens)                 # [T, H]
        ce = self.t["talker.model.codec_embedding.weight"]

        def crow(i):
            return ce[min(i, ce.shape[0] - 1)]

        think, think_bos, think_eos, pad_id, bos_id = codec_ids
        codec_rows = torch.stack([
            crow(think), crow(think_bos), crow(language_id),
            crow(think_eos), spk, crow(pad_id), crow(bos_id)])
        n = codec_rows.shape[0]
        overlaid = codec_rows[:n - 1] + tts_pad
        overlaid[-1] = codec_rows[n - 2] + tts_bos       # codec_pad row
        last = proj[3] + codec_rows[n - 1]
        prefill = torch.cat([proj[:3], overlaid, last[None]], dim=0)
        trailing = torch.cat([proj[4:len(tokens) - 5], tts_eos[None]], dim=0)
        return prefill, trailing, tts_pad

    def talker_forward(self, embeds):
        """Full causal forward; returns (hidden [T,H], logits [T,V])."""
        x = embeds[None].float()
        T = x.shape[1]
        positions = torch.arange(T)[None]
        for i in range(self.L):
            x = self._layer(f"talker.model.layers.{i}", x, positions,
                            self.NH, self.NKV, self.HD)
        h = self.rms(x, self.t["talker.model.norm.weight"])[0]
        logits = h @ self.t["talker.codec_head.weight"].T
        return h, logits

    def code_predictor_greedy(self, hidden, cb0):
        """predict_codes_autoregressive, greedy
        (tts_transformer.cpp:2153-2340): seq = [hidden, codec_embd[cb0],
        cp.codec_embd[s-1][code_s]...]; head[s] picks code_{s+1}.
        Implemented as a growing full forward (no cache) — equivalent."""
        mtp_w = self.t.get("talker.code_predictor."
                           "small_to_mtp_projection.weight")
        mtp_b = self.t.get("talker.code_predictor."
                           "small_to_mtp_projection.bias")

        def mtp(x):
            if mtp_w is None:
                return x
            return x @ mtp_w.T + (mtp_b if mtp_b is not None else 0.0)

        rows = [mtp(hidden),
                mtp(self.t["talker.model.codec_embedding.weight"][cb0])]
        codes, logits_all = [], []
        n_steps = self.n_groups - 1
        for s in range(n_steps):
            x = torch.stack(rows)[None]
            T = x.shape[1]
            positions = torch.arange(T)[None]
            for i in range(self.cp_L):
                x = self._layer(f"talker.code_predictor.model.layers.{i}",
                                x, positions, self.cp_NH, self.cp_NKV,
                                self.cp_HD)
            h = self.rms(x[0, -1],
                         self.t["talker.code_predictor.model.norm.weight"])
            head = self.t[f"talker.code_predictor.lm_head.{s}.weight"]
            logits = h @ head.T
            code = int(torch.argmax(logits))
            codes.append(code)
            logits_all.append(logits)
            if s < n_steps - 1:
                emb = self.t[f"talker.code_predictor.model."
                             f"codec_embedding.{s}.weight"][code]
                rows.append(mtp(emb))
        return np.asarray(codes, np.int32), torch.stack(logits_all).numpy()


class TorchVocoder:
    """Reference vocoder decode in torch
    (audio_tokenizer_decoder.cpp:622-802)."""

    def __init__(self, hf: dict, cfg: dict):
        self.t = {k: torch.from_numpy(np.asarray(v, np.float32))
                  for k, v in hf.items()}
        dec = cfg.get("decoder_config", {})
        self.L = dec.get("num_hidden_layers", 8)
        # defaults must MATCH the stack under test (config.py:142-165 /
        # convert_checkpoints.py), else the comparison runs a different
        # model: heads default 16, rms eps 1e-5
        self.NH = dec.get("num_attention_heads", 16)
        self.n_q = dec.get("num_quantizers", 16)
        self.rates = dec.get("upsample_rates", [8, 5, 4, 3])
        self.eps = 1e-5
        self.theta = 1e4

    def rms(self, x, w):
        var = (x.float() ** 2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * w

    def _codebook(self, prefix):
        emb = self.t[f"{prefix}.embedding_sum"]
        usage = self.t.get(f"{prefix}.cluster_usage")
        if usage is not None:
            emb = emb / usage.clamp(min=1e-5)[:, None]
        return emb

    def _causal_conv(self, x, w, b, dilation=1, groups=1):
        """x: [C,T]; w: [out,in/groups,K]; left pad dilation*(K-1)."""
        k = w.shape[-1]
        x = torch.nn.functional.pad(x[None], (dilation * (k - 1), 0))
        y = torch.nn.functional.conv1d(x, w, b, dilation=dilation,
                                       groups=groups)
        return y[0]

    def decode(self, codes):
        """codes: [F, n_q] int -> audio [T] (both-sides convT trim — the
        GGML-path behavior, audio_tokenizer_decoder.cpp:581-620)."""
        codes = torch.from_numpy(np.asarray(codes, np.int64))
        first_cb = self._codebook(
            "decoder.quantizer.rvq_first.vq.layers.0._codebook")
        first = first_cb[codes[:, 0]]
        first = torch.nn.functional.conv1d(
            first.T[None],
            self.t["decoder.quantizer.rvq_first.output_proj.weight"])[0].T
        rest = 0
        for i in range(self.n_q - 1):
            cb = self._codebook(
                f"decoder.quantizer.rvq_rest.vq.layers.{i}._codebook")
            rest = rest + cb[codes[:, i + 1]]
        rest = torch.nn.functional.conv1d(
            rest.T[None],
            self.t["decoder.quantizer.rvq_rest.output_proj.weight"])[0].T
        x = (first + rest).T                               # [C, F]

        x = self._causal_conv(x, self.t["decoder.pre_conv.conv.weight"],
                              self.t["decoder.pre_conv.conv.bias"])

        # pre-transformer (RoPE theta 1e4, causal, layer-scale)
        h = x.T @ self.t["decoder.pre_transformer.input_proj.weight"].T \
            + self.t["decoder.pre_transformer.input_proj.bias"]
        T = h.shape[0]
        positions = torch.arange(T)
        for i in range(self.L):
            p = f"decoder.pre_transformer.layers.{i}"
            hn = self.rms(h, self.t[f"{p}.input_layernorm.weight"])
            q = hn @ self.t[f"{p}.self_attn.q_proj.weight"].T
            k = hn @ self.t[f"{p}.self_attn.k_proj.weight"].T
            v = hn @ self.t[f"{p}.self_attn.v_proj.weight"].T
            hd = q.shape[-1] // self.NH
            half = hd // 2
            freqs = torch.exp(torch.arange(half, dtype=torch.float32)
                              * (-2.0 / hd) * math.log(self.theta))
            ang = positions.float()[:, None] * freqs
            cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
            def rope(z):
                z = z.view(T, self.NH, hd)
                z1, z2 = z[..., :half], z[..., half:]
                return torch.cat([z1 * cos - z2 * sin,
                                  z1 * sin + z2 * cos], dim=-1)
            q, k = rope(q), rope(k)
            v = v.view(T, self.NH, hd)
            scores = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
            causal = torch.tril(torch.ones(T, T, dtype=torch.bool))
            scores = scores.masked_fill(~causal, float("-inf"))
            attn = torch.einsum("hts,shd->thd",
                                torch.softmax(scores, -1), v).reshape(T, -1)
            attn = attn @ self.t[f"{p}.self_attn.o_proj.weight"].T
            h = h + attn * self.t[f"{p}.self_attn_layer_scale.scale"]
            hn = self.rms(h, self.t[f"{p}.post_attention_layernorm.weight"])
            gate = hn @ self.t[f"{p}.mlp.gate_proj.weight"].T
            up = hn @ self.t[f"{p}.mlp.up_proj.weight"].T
            ffn = (torch.nn.functional.silu(gate) * up) \
                @ self.t[f"{p}.mlp.down_proj.weight"].T
            h = h + ffn * self.t[f"{p}.mlp_layer_scale.scale"]
        h = self.rms(h, self.t["decoder.pre_transformer.norm.weight"])
        x = (h @ self.t["decoder.pre_transformer.output_proj.weight"].T
             + self.t["decoder.pre_transformer.output_proj.bias"]).T

        # 2 ConvNeXt upsample blocks (convT stride 2, no trim)
        for i in range(2):
            p = f"decoder.upsample.{i}"
            x = torch.nn.functional.conv_transpose1d(
                x[None], self.t[f"{p}.0.conv.weight"],
                self.t[f"{p}.0.conv.bias"], stride=2)[0]
            res = x
            c = x.shape[0]
            x = self._causal_conv(x, self.t[f"{p}.1.dwconv.conv.weight"],
                                  self.t[f"{p}.1.dwconv.conv.bias"],
                                  groups=c)
            xt = x.T
            mu = xt.mean(-1, keepdim=True)
            var = xt.var(-1, unbiased=False, keepdim=True)
            xt = (xt - mu) / torch.sqrt(var + 1e-6) \
                * self.t[f"{p}.1.norm.weight"] + self.t[f"{p}.1.norm.bias"]
            xt = xt @ self.t[f"{p}.1.pwconv1.weight"].T \
                + self.t[f"{p}.1.pwconv1.bias"]
            xt = torch.nn.functional.gelu(xt, approximate="tanh")
            xt = xt @ self.t[f"{p}.1.pwconv2.weight"].T \
                + self.t[f"{p}.1.pwconv2.bias"]
            x = res + (xt * self.t[f"{p}.1.gamma"]).T

        x = self._causal_conv(x, self.t["decoder.decoder.0.conv.weight"],
                              self.t["decoder.decoder.0.conv.bias"])

        def snake(z, a, b):
            return z + torch.exp(-b)[:, None] \
                * torch.sin(torch.exp(a)[:, None] * z) ** 2

        for blk, rate in zip(range(1, 5), self.rates):
            p = f"decoder.decoder.{blk}.block"
            x = snake(x, self.t[f"{p}.0.alpha"], self.t[f"{p}.0.beta"])
            w = self.t[f"{p}.1.conv.weight"]
            k = w.shape[-1]
            x = torch.nn.functional.conv_transpose1d(
                x[None], w, stride=rate)[0]
            trim = k - rate
            if trim > 0:
                x = x[:, trim:x.shape[1] - trim]
            x = x + self.t[f"{p}.1.conv.bias"][:, None]
            for res_i, dil in zip((2, 3, 4), (1, 3, 9)):
                rp = f"{p}.{res_i}"
                r = x
                x = snake(x, self.t[f"{rp}.act1.alpha"],
                          self.t[f"{rp}.act1.beta"])
                x = self._causal_conv(x, self.t[f"{rp}.conv1.conv.weight"],
                                      self.t[f"{rp}.conv1.conv.bias"],
                                      dilation=dil)
                x = snake(x, self.t[f"{rp}.act2.alpha"],
                          self.t[f"{rp}.act2.beta"])
                x = self._causal_conv(x, self.t[f"{rp}.conv2.conv.weight"],
                                      self.t[f"{rp}.conv2.conv.bias"])
                x = r + x
        x = snake(x, self.t["decoder.decoder.5.alpha"],
                  self.t["decoder.decoder.5.beta"])
        x = self._causal_conv(x, self.t["decoder.decoder.6.conv.weight"],
                              self.t["decoder.decoder.6.conv.bias"])
        return torch.tanh(x[0]).numpy()




# ---------------------------------------------------------------------------
# Diff driver
# ---------------------------------------------------------------------------

def _stats(name, a, b, tol, failures, impl="torch", report=None,
           abs_ok=True):
    """Log one stage's max|diff|, its ratio to the reference's max|.| and
    cosine (a diagnostic only); `name` joins `failures` when it fails.
    The gate: the ratio within `tol`, or, with `abs_ok` (the JAX tool's
    rule), max|diff| within `tol`. Returns ok."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    rec = {"stage": name, "impl": impl, "tol": tol}
    if a.shape != b.shape:
        log(f"  {name:<28} SHAPE MISMATCH {a.shape} vs {b.shape}")
        failures.append(name)
        if report is not None:
            report.append({**rec, "ok": False})
        return False
    mad = np.abs(a - b).max() if a.size else 0.0
    amax = np.abs(a).max() if a.size else 0.0
    rel = mad / max(amax, 1e-12)
    denom = (np.linalg.norm(a) * np.linalg.norm(b)) or 1.0
    cos = float(np.dot(a, b) / denom)
    ok = bool(rel <= tol or (abs_ok and mad <= tol))
    log(f"  {name:<28} max|diff|={mad:.3e}  rel={rel:.3e}  "
        f"cos={cos:.6f}  tol={tol:.1e}  {'OK' if ok else 'FAIL'}  [{impl}]")
    if not ok:
        failures.append(name)
    if report is not None:
        report.append({**rec, "max_abs": float(mad), "rel": float(rel),
                       "cos": cos, "ok": ok})
    return ok


def _launch_counts() -> dict:
    """The kernel wrappers' launch counters."""
    return {"talker_fused": talker_fused.talker_step_fused.launches,
            "codepred": codepred_fused.predict_codes_fused.launches,
            "flash_decode": flash_decode.flash_decode.launches,
            "res_chain": vocoder_fused.fused_residual_chain.launches,
            "snake_convt": vocoder_fused.fused_snake_convt.launches}


def _switches():
    return (talker._SWITCH, code_predictor._SWITCH, vocoder._SWITCH,
            attention._SWITCH)


@contextlib.contextmanager
def _pass_settings(name: str):
    """The weight dtype and TF32 of one pass (module docstring); the
    switches and settings are restored after it."""
    saved = (W.MATMUL_DTYPE, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             [s.impl for s in _switches()])
    try:
        if name == "f32":
            attention.set_decode_attention_impl("xla")
            W.MATMUL_DTYPE = torch.float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            W.MATMUL_DTYPE = torch.bfloat16
        yield
    finally:
        (W.MATMUL_DTYPE, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, impls) = saved
        for s, impl in zip(_switches(), impls):
            s.impl = impl


def _label(what: str, impl: str, dev: torch.device) -> str:
    """Which implementation ran a stage."""
    card = dev.type == "cuda"
    if impl == "fused":
        src = {"talker": "csrc/talker_fused.cu",
               "codepred": "csrc/codepred.cu",
               "vocoder": "csrc/vocoder.cu chain + head"}[what]
        return f"fused: {src}" if card else "fused: torch twin (CPU)"
    attn = attention.get_decode_attention_impl()
    if what == "vocoder" or attn == "xla" or (attn == "auto" and not card):
        return "xla: plain torch"
    return ("xla: plain torch, " + ("csrc/flash_decode.cu" if card else
                                    "decode attention's torch twin (CPU)"))


def _clamp_ids(cfg: TalkerConfig) -> TalkerConfig:
    """Special ids clamped into the checkpoint's vocabs: a no-op for real
    checkpoints; synthetic ones may use tiny vocabs with the real
    (out-of-range) default ids."""
    tv, cv = cfg.text_vocab_size, cfg.codec_vocab_size
    return dataclasses.replace(
        cfg,
        tts_bos_token_id=min(cfg.tts_bos_token_id, tv - 1),
        tts_eos_token_id=min(cfg.tts_eos_token_id, tv - 2),
        tts_pad_token_id=min(cfg.tts_pad_token_id, tv - 3),
        codec_think_id=min(cfg.codec_think_id, cv - 1),
        codec_think_bos_id=min(cfg.codec_think_bos_id, cv - 2),
        codec_think_eos_id=min(cfg.codec_think_eos_id, cv - 3),
        codec_pad_id=min(cfg.codec_pad_id, cv - 4),
        codec_bos_id=min(cfg.codec_bos_id, cv - 5))


def _free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def run_parity(tts_dir: Path | None = None, codec_dir: Path | None = None,
               device="cuda", *, tol: float = 1e-2, seed: int = 0,
               out: Path | None = None,
               report: list | None = None) -> tuple[list[str], dict]:
    """Every stage of both passes (module docstring) on the checkpoints
    given. Returns (failures: "pass:stage" names, dumps: the
    reference's stage outputs); `report`, when given, receives one dict
    per stage (pass, stage, impl, max_abs, rel, tol, ok; the codes' stage
    has codes and the near-tie gap instead). `out` saves the dumps as an
    .npz."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (run with --device cpu for the "
                           "CPU)")
    rng = np.random.default_rng(seed)
    failures: list[str] = []
    dumps: dict[str, np.ndarray] = {}

    last = _launch_counts()

    def tag(pname):
        """The pass and the kernel launches since the last stage, on the
        stage's report record."""
        nonlocal last
        now = _launch_counts()
        if report is not None:
            report[-1].update({"pass": pname, "launches": {
                k: now[k] - last[k] for k in now if now[k] != last[k]}})
        last = now

    def stat(pname, stage, ref, got, impl):
        gate = tol if pname == "f32" else BF16_TOL[stage.split("[")[0]]
        ok = _stats(f"{pname}:{stage}", ref, got, gate, failures, impl,
                    report, abs_ok=pname == "f32")
        tag(pname)
        return ok

    def unserved(pname, stages, impl, err):
        for stage in stages:
            _unserved(f"{pname}:{stage}", impl, err, failures, report)
            tag(pname)

    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        if tts_dir:
            _talker_stages(Path(tts_dir), td, dev, rng, stat, unserved, tag,
                           failures, dumps, report)
        if codec_dir:
            _vocoder_stages(Path(codec_dir), td, dev, rng, stat, unserved,
                            dumps)

    if out:
        np.savez(out, **dumps)
        log(f"dumps saved to {out}")
    log(f"PARITY FAIL: {failures}" if failures else "PARITY OK")
    return failures, dumps


def _talker_weights(tts_dir: Path, td: Path, pname: str, dev):
    path = td / f"tts-{pname}.gguf"
    cc.convert_tts(tts_dir, path, "f32" if pname == "f32" else "f16")
    with GGUFReader(str(path)) as r:
        cfg = TalkerConfig.from_gguf(r)
        w = W.load_talker_weights(r, cfg, dev)
    path.unlink()
    return w, _clamp_ids(cfg)


def _talker_stages(tts_dir, td, dev, rng, stat, unserved, tag, failures,
                   dumps, report):
    hf = _load_hf(tts_dir)
    ref = TorchTalker(hf, json.loads((tts_dir / "config.json").read_text()))
    del hf
    ref_out = None
    for pname in PASSES:
        with _pass_settings(pname):
            w, cfg = _talker_weights(tts_dir, td, pname, dev)
            if ref_out is None:
                ref_out = _talker_reference(ref, cfg, rng, dumps)
            (tokens, spk, lang, step_row, cb0, t_prefill, t_trailing, t_h,
             t_logits, t_h2, t_logits2, t_codes, t_cp_logits) = ref_out
            log(f"== talker stages, {pname} pass on {dev} ==")
            n_tok = len(tokens)

            def i32(v):
                return torch.as_tensor(np.asarray(v), dtype=torch.int32,
                                       device=dev)

            pf = talker.build_prefill_inputs(
                w, cfg, i32(tokens[None]), i32([n_tok]),
                torch.as_tensor(spk[None], device=dev),
                language_id=i32([lang]))
            stat(pname, "prefill_embd", t_prefill, pf.prefill_embd[0].cpu(),
                 "torch")
            t_len = int(pf.trailing_len[0])
            stat(pname, "trailing_schedule", t_trailing,
                 pf.trailing_hidden[0, :t_len].cpu(), "torch")

            P = pf.prefill_embd.shape[1]
            ctx = ((P + 2 + 127) // 128) * 128
            cache = init_kv_cache(cfg.n_layers, 1, ctx, cfg.n_key_value_heads,
                                  cfg.head_dim, dev)
            h, logits, cache = talker.talker_prefill(w, cfg, pf.prefill_embd,
                                                     cache)
            stat(pname, "talker_hidden", t_h[-1], h[0].cpu(), "torch")
            stat(pname, "talker_logits", t_logits[-1], logits[0].cpu(),
                 "torch")

            # the decode step == a full forward over prefill + 1 rows
            x = torch.as_tensor(step_row[None], device=dev)
            n_past, widx = i32([P]), i32(P)
            for impl in ("xla",) if pname == "f32" else ("fused", "xla"):
                talker.set_talker_step_impl(impl)
                if pname != "f32":      # the per-layer step's kernel
                    attention.set_decode_attention_impl(
                        "flash" if impl == "xla" else None)
                label = _label("talker", impl, dev)
                try:
                    h2, logits2, _ = talker.talker_step(
                        w, cfg, x, cache.clone(), n_past, widx)
                except ValueError as e:      # fused: a geometry not served
                    unserved(pname, [f"step_hidden[{impl}]",
                                     f"step_logits[{impl}]"], label, e)
                    continue
                stat(pname, f"step_hidden[{impl}]", t_h2[-1], h2[0].cpu(),
                     label)
                stat(pname, f"step_logits[{impl}]", t_logits2[-1],
                     logits2[0].cpu(), label)

            impl = "xla" if pname == "f32" else "fused"
            code_predictor.set_codepred_impl(impl)
            label = _label("codepred", impl, dev)
            try:
                got = code_predictor.predict_codes(
                    w, cfg, h, i32([cb0]), 0.0, 1, None,
                    greedy=True)[0].cpu().numpy()
            except ValueError as e:
                unserved(pname, ["code_pred_codes"], label, e)
            else:
                _codes_stage(pname, t_codes, t_cp_logits, got, label,
                             failures, report)
                tag(pname)
            del w, cache
            _free(dev)


def _talker_reference(ref, cfg, rng, dumps):
    """The inputs (drawn in the JAX tool's order) and the reference's
    outputs of every talker stage."""
    n_tok = 16
    tokens = rng.integers(0, cfg.text_vocab_size, (n_tok,))
    spk = rng.standard_normal(cfg.hidden_size).astype(np.float32) * 0.1
    lang = min(cfg.english_language_id, cfg.codec_vocab_size - 1)
    t_prefill, t_trailing, _ = ref.prefill_embeds(
        torch.from_numpy(tokens), torch.from_numpy(spk),
        (cfg.tts_bos_token_id, cfg.tts_eos_token_id, cfg.tts_pad_token_id),
        (cfg.codec_think_id, cfg.codec_think_bos_id, cfg.codec_think_eos_id,
         cfg.codec_pad_id, cfg.codec_bos_id), lang)
    t_h, t_logits = ref.talker_forward(t_prefill)
    step_row = rng.standard_normal(cfg.hidden_size).astype(np.float32) * 0.1
    t_h2, t_logits2 = ref.talker_forward(
        torch.cat([t_prefill, torch.from_numpy(step_row)[None]], dim=0))
    cb0 = int(rng.integers(0, min(2048, cfg.codec_vocab_size)))
    t_codes, t_cp_logits = ref.code_predictor_greedy(t_h[-1], cb0)
    dumps.update(prefill_embd=t_prefill.numpy(), talker_hidden=t_h.numpy(),
                 talker_logits=t_logits.numpy(), code_pred_codes=t_codes,
                 code_pred_logits=t_cp_logits)
    return (tokens, spk, lang, step_row, cb0, t_prefill.numpy(),
            t_trailing.numpy(), t_h.numpy(), t_logits.numpy(), t_h2.numpy(),
            t_logits2.numpy(), t_codes, t_cp_logits)


def _codes_stage(pname, t_codes, t_logits, got, impl, failures, report):
    """Greedy codes: equal in the f32 pass; in the bf16 pass equal, or
    first different where the reference's logit of its own code is at
    most NEAR_TIE above its logit of the port's (a bf16 near-tie)."""
    name = f"{pname}:code_pred_codes"
    got = np.asarray(got, np.int32)
    same = np.array_equal(t_codes, got)
    gap = None
    if not same and pname != "f32" and got.shape == t_codes.shape:
        s = int(np.flatnonzero(t_codes != got)[0])
        gap = float(t_logits[s, t_codes[s]] - t_logits[s, got[s]])
    ok = same or (gap is not None and gap <= NEAR_TIE)
    verdict = ("OK" if same else f"near-tie (margin {gap:.3e} <= "
               f"{NEAR_TIE})" if ok else "FAIL")
    log(f"  {name:<28} torch {t_codes.tolist()} port {got.tolist()}  "
        f"{verdict}  [{impl}]")
    if not ok:
        failures.append(name)
    if report is not None:
        report.append({"stage": name, "impl": impl,
                       "codes_equal": bool(same), "gap": gap,
                       "tol": NEAR_TIE, "ok": bool(ok)})


def _unserved(name, impl, err, failures, report):
    """A stage whose kernel does not serve the checkpoint's geometry
    (``fused`` raised): it fails, with the error on its record."""
    log(f"  {name:<28} NOT SERVED: {err}  FAIL  [{impl}]")
    failures.append(name)
    if report is not None:
        report.append({"stage": name, "impl": impl, "error": str(err),
                       "ok": False})


def _vocoder_stages(codec_dir, td, dev, rng, stat, unserved, dumps):
    hf = _load_hf(codec_dir)
    refv = TorchVocoder(hf, json.loads((codec_dir / "config.json")
                                       .read_text()))
    del hf
    codes = t_audio = None
    for pname in PASSES:
        with _pass_settings(pname):
            path = td / f"codec-{pname}.gguf"
            cc.convert_codec(codec_dir, path, "f32" if pname == "f32"
                             else "f16")
            with GGUFReader(str(path)) as r:
                vcfg = VocoderConfig.from_gguf(r)
                vw = vocoder.load_vocoder_weights(r, vcfg, dev)
            path.unlink()
            if codes is None:
                F = 12
                codes = rng.integers(0, vcfg.codebook_size,
                                     (F, vcfg.n_codebooks))
                t_audio = refv.decode(codes)
                dumps["vocoder_audio"] = t_audio
            log(f"== vocoder, {pname} pass on {dev} ==")
            if pname == "f32":
                impl, trim = "xla", "both"
            else:
                impl, trim = "fused", "causal"
                vw = vocoder.pack_kernel_weights(vocoder.cast_weights(vw))
            vocoder.set_res_chain_impl(impl)
            label = _label("vocoder", impl, dev) + f", trim={trim}"
            try:
                audio = vocoder.vocoder_decode(
                    vw, vcfg, torch.as_tensor(codes[None], dtype=torch.int32,
                                              device=dev), trim=trim)
            except ValueError as e:
                unserved(pname, ["vocoder_audio"], label, e)
            else:
                stat(pname, "vocoder_audio", t_audio,
                     audio[0, :len(t_audio)].cpu(), label)
            del vw
            _free(dev)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tts", type=Path, help="HF TTS checkpoint dir")
    ap.add_argument("--codec", type=Path, help="HF codec checkpoint dir")
    ap.add_argument("--out", type=Path, help="save stage dumps to .npz")
    # the f32 pass's gate; the bf16 pass's is BF16_TOL
    ap.add_argument("--tol", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the stack under test (default cuda)")
    args = ap.parse_args(argv)
    if not args.tts and not args.codec:
        ap.error("need --tts and/or --codec")
    failures, _ = run_parity(args.tts, args.codec, args.device,
                             tol=args.tol, seed=args.seed, out=args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
