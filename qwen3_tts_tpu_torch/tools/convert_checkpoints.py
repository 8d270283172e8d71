"""Offline model pipeline: HuggingFace checkpoints -> GGUF, on the port
alone (the port of tools/convert_checkpoints.py).

  - TTS model (talker + code predictor + speaker encoder + text
    tokenizer): ``tts``
  - Speech codec (decoder used as the vocoder): ``codec``

The checkpoint is read through io/safetensors.py, tensor by tensor from
the mapped files (BF16 widened exactly to f32), and written with
io/gguf.GGUFWriter, so neither the ``safetensors`` package nor
``ml_dtypes`` is needed. For the same checkpoint and --type the GGUF file
is byte for byte the one tools/convert_checkpoints.py writes: the same
tensor names, metadata keys and value types, in the same order.

Usage:
  python -m qwen3_tts_tpu_torch.tools.convert_checkpoints tts \\
      --input /path/Qwen3-TTS-12Hz-0.6B-Base \\
      --output models/qwen3-tts-0.6b-f16.gguf [--type f16|f32|q8_0|q4_0|q4_k]
  python -m qwen3_tts_tpu_torch.tools.convert_checkpoints codec \\
      --input /path/Qwen3-TTS-Tokenizer-12Hz \\
      --output models/qwen3-tts-tokenizer-f16.gguf [--type ...]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

from ..io.gguf import (GGML_F16, GGML_F32, GGML_Q4_0, GGML_Q4_K, GGML_Q8_0,
                       GGUFWriter)
from ..io.safetensors import SafeTensorsFile, checkpoint_files, iter_tensors


def _checkpoint_files(input_dir: Path) -> list[Path]:
    files = checkpoint_files(input_dir)
    if not files:
        raise FileNotFoundError(f"no .safetensors under {input_dir}")
    return files


def _iter_safetensors(input_dir: Path):
    """(HF name, array) over the checkpoint: files in sorted order, each
    file's names sorted."""
    return iter_tensors(_checkpoint_files(input_dir))


def _to_numpy(t) -> np.ndarray:
    a = np.asarray(t)
    # F64 and the other non-f32/f16/int dtypes widen to f32 here (BF16
    # arrives widened already)
    if a.dtype not in (np.float32, np.float16, np.int32, np.int64):
        a = a.astype(np.float32)
    return a


def _pick_type(name: str, data: np.ndarray, out_type: str,
               keep_hi_fidelity) -> int:
    """Quantized types apply only to >=2-D weight matrices that pass the
    exclusion rules; everything else falls back to F16/F32."""
    if data.ndim <= 1:
        return GGML_F32
    if out_type == "f32":
        return GGML_F32
    quant = {"q8_0": (GGML_Q8_0, 32), "q4_0": (GGML_Q4_0, 32),
             "q4_k": (GGML_Q4_K, 256)}.get(out_type)
    if quant is not None and not keep_hi_fidelity(name) \
            and data.shape[-1] % quant[1] == 0:
        # GGML quant blocks must not straddle rows: divisibility is on
        # the innermost dim (ne[0]), not the flattened size
        return quant[0]
    return GGML_F16


# ---------------------------------------------------------------------------
# TTS model (talker + code predictor + speaker encoder + tokenizer)
# ---------------------------------------------------------------------------

# HF name -> GGUF name. Static names first; layered tensors via regex.
TTS_STATIC = {
    "talker.model.codec_embedding.weight": "talker.codec_embd.weight",
    "talker.model.text_embedding.weight": "talker.text_embd.weight",
    "talker.codec_head.weight": "talker.codec_head.weight",
    "talker.model.norm.weight": "talker.output_norm.weight",
    "talker.text_projection.linear_fc1.weight": "talker.text_proj.fc1.weight",
    "talker.text_projection.linear_fc1.bias": "talker.text_proj.fc1.bias",
    "talker.text_projection.linear_fc2.weight": "talker.text_proj.fc2.weight",
    "talker.text_projection.linear_fc2.bias": "talker.text_proj.fc2.bias",
    "talker.code_predictor.model.norm.weight": "code_pred.output_norm.weight",
    "talker.code_predictor.small_to_mtp_projection.weight": "code_pred.mtp_proj.weight",
    "talker.code_predictor.small_to_mtp_projection.bias": "code_pred.mtp_proj.bias",
    "speaker_encoder.blocks.0.conv.weight": "spk_enc.conv0.weight",
    "speaker_encoder.blocks.0.conv.bias": "spk_enc.conv0.bias",
    "speaker_encoder.asp.conv.weight": "spk_enc.asp.conv.weight",
    "speaker_encoder.asp.conv.bias": "spk_enc.asp.conv.bias",
    "speaker_encoder.asp.tdnn.conv.weight": "spk_enc.asp.tdnn.weight",
    "speaker_encoder.asp.tdnn.conv.bias": "spk_enc.asp.tdnn.bias",
    "speaker_encoder.mfa.conv.weight": "spk_enc.mfa.weight",
    "speaker_encoder.mfa.conv.bias": "spk_enc.mfa.bias",
    "speaker_encoder.fc.weight": "spk_enc.fc.weight",
    "speaker_encoder.fc.bias": "spk_enc.fc.bias",
}

# (regex with one or two numeric groups, target template)
_QWEN_LAYER = ("input_layernorm.weight:attn_norm.weight|"
               "self_attn.q_proj.weight:attn_q.weight|"
               "self_attn.k_proj.weight:attn_k.weight|"
               "self_attn.v_proj.weight:attn_v.weight|"
               "self_attn.o_proj.weight:attn_output.weight|"
               "self_attn.q_norm.weight:attn_q_norm.weight|"
               "self_attn.k_norm.weight:attn_k_norm.weight|"
               "post_attention_layernorm.weight:ffn_norm.weight|"
               "mlp.gate_proj.weight:ffn_gate.weight|"
               "mlp.up_proj.weight:ffn_up.weight|"
               "mlp.down_proj.weight:ffn_down.weight")


def _layer_rules(hf_prefix: str, gg_prefix: str):
    rules = []
    for pair in _QWEN_LAYER.split("|"):
        hf_suffix, gg_suffix = pair.split(":")
        rules.append((
            re.compile(rf"{re.escape(hf_prefix)}\.(\d+)\.{re.escape(hf_suffix)}$"),
            f"{gg_prefix}.blk.{{0}}.{gg_suffix}"))
    return rules


TTS_RULES = (
    _layer_rules("talker.model.layers", "talker")
    + _layer_rules("talker.code_predictor.model.layers", "code_pred")
    + [
        (re.compile(r"talker\.code_predictor\.model\.codec_embedding\.(\d+)\.weight$"),
         "code_pred.codec_embd.{0}.weight"),
        (re.compile(r"talker\.code_predictor\.lm_head\.(\d+)\.weight$"),
         "code_pred.lm_head.{0}.weight"),
        (re.compile(r"speaker_encoder\.blocks\.(\d+)\.res2net_block\.blocks\.(\d+)\.conv\.(weight|bias)$"),
         "spk_enc.blk.{0}.res2net.{1}.{2}"),
        (re.compile(r"speaker_encoder\.blocks\.(\d+)\.se_block\.conv(\d)\.(weight|bias)$"),
         "spk_enc.blk.{0}.se.conv{1}.{2}"),
        (re.compile(r"speaker_encoder\.blocks\.(\d+)\.tdnn(\d)\.conv\.(weight|bias)$"),
         "spk_enc.blk.{0}.tdnn{1}.{2}"),
    ])


def map_tts_name(hf_name: str) -> str | None:
    if hf_name in TTS_STATIC:
        return TTS_STATIC[hf_name]
    for rx, template in TTS_RULES:
        m = rx.match(hf_name)
        if m:
            return template.format(*m.groups())
    return None


def convert_tts(input_dir: Path, output: Path, out_type: str) -> None:
    cfg = json.loads((input_dir / "config.json").read_text())
    talker = cfg.get("talker_config", {})
    code_pred = talker.get("code_predictor_config", {})
    spk = cfg.get("speaker_encoder_config", {})

    w = GGUFWriter("qwen3-tts")
    w.add("general.name", input_dir.name or "Qwen3-TTS")
    w.add("qwen3-tts.block_count", int(talker.get("num_hidden_layers", 28)))
    w.add("qwen3-tts.embedding_length", int(talker.get("hidden_size", 1024)))
    w.add("qwen3-tts.feed_forward_length",
          int(talker.get("intermediate_size", 3072)))
    w.add("qwen3-tts.attention.head_count",
          int(talker.get("num_attention_heads", 16)))
    w.add("qwen3-tts.attention.head_count_kv",
          int(talker.get("num_key_value_heads", 8)))
    w.add("qwen3-tts.attention.key_length", int(talker.get("head_dim", 128)))
    w.add("qwen3-tts.attention.value_length", int(talker.get("head_dim", 128)))
    w.add_f32_scalar("qwen3-tts.rope.freq_base",
                     float(talker.get("rope_theta", 1e6)))
    w.add_f32_scalar("qwen3-tts.attention.layer_norm_rms_epsilon",
                     float(talker.get("rms_norm_eps", 1e-6)))
    w.add("qwen3-tts.vocab_size", int(talker.get("vocab_size", 3072)))
    w.add("qwen3-tts.text_vocab_size",
          int(talker.get("text_vocab_size", 151936)))
    w.add("qwen3-tts.text_hidden_size",
          int(talker.get("text_hidden_size", 2048)))
    w.add("qwen3-tts.num_code_groups", int(talker.get("num_code_groups", 16)))
    mrope = talker.get("rope_scaling", {}).get("mrope_section", [24, 20, 20])
    w.add("qwen3-tts.rope.mrope_section", [int(x) for x in mrope])
    w.add("qwen3-tts.code_predictor.layer_count",
          int(code_pred.get("num_hidden_layers", 5)))
    w.add("qwen3-tts.code_predictor.vocab_size",
          int(code_pred.get("vocab_size", 2048)))
    w.add("qwen3-tts.code_predictor.embedding_length",
          int(code_pred.get("hidden_size", talker.get("hidden_size", 1024))))
    w.add("qwen3-tts.code_predictor.feed_forward_length",
          int(code_pred.get("intermediate_size",
                            talker.get("intermediate_size", 3072))))
    w.add("qwen3-tts.code_predictor.attention.head_count",
          int(code_pred.get("num_attention_heads",
                            talker.get("num_attention_heads", 16))))
    w.add("qwen3-tts.code_predictor.attention.head_count_kv",
          int(code_pred.get("num_key_value_heads",
                            talker.get("num_key_value_heads", 8))))
    w.add("qwen3-tts.code_predictor.attention.key_length",
          int(code_pred.get("head_dim", talker.get("head_dim", 128))))
    w.add("qwen3-tts.speaker_encoder.embedding_length",
          int(spk.get("enc_dim", 1024)))
    w.add("qwen3-tts.speaker_encoder.sample_rate",
          int(spk.get("sample_rate", 24000)))
    w.add("qwen3-tts.codec.pad_id", int(talker.get("codec_pad_id", 2148)))
    w.add("qwen3-tts.codec.bos_id", int(talker.get("codec_bos_id", 2149)))
    w.add("qwen3-tts.codec.eos_id",
          int(talker.get("codec_eos_token_id", 2150)))
    # think/language/tts special ids (config.py:106-126 reads these; the
    # reference converter never writes them and both stacks then fall
    # back to the same hardcoded defaults — emitting them makes variant
    # checkpoints with different ids load correctly instead of silently
    # using the wrong prompt recipe)
    w.add("qwen3-tts.codec.think_id",
          int(talker.get("codec_think_id", 2154)))
    w.add("qwen3-tts.codec.nothink_id",
          int(talker.get("codec_nothink_id", 2155)))
    w.add("qwen3-tts.codec.think_bos_id",
          int(talker.get("codec_think_bos_id", 2156)))
    w.add("qwen3-tts.codec.think_eos_id",
          int(talker.get("codec_think_eos_id", 2157)))
    w.add("qwen3-tts.language.english_id",
          int(talker.get("english_language_id",
                         talker.get("language_id", 2050))))
    w.add("qwen3-tts.tts_bos_token_id",
          int(talker.get("tts_bos_token_id", 151672)))
    w.add("qwen3-tts.tts_eos_token_id",
          int(talker.get("tts_eos_token_id", 151673)))
    w.add("qwen3-tts.tts_pad_token_id",
          int(talker.get("tts_pad_token_id", 151671)))

    _add_text_tokenizer(w, input_dir,
                        int(talker.get("text_vocab_size", 151936)))

    def keep_hi_fidelity(name: str) -> bool:
        # match the reference's quantization exclusions
        # (convert_tts_to_gguf.py:248-274)
        return any(x in name for x in
                   ("_embd", "codebook", "_norm", ".bias", "lm_head",
                    "codec_head"))

    n = 0
    for hf_name, tensor in _iter_safetensors(input_dir):
        gg = map_tts_name(hf_name)
        if gg is None:
            print(f"  skip {hf_name}", file=sys.stderr)
            continue
        data = _to_numpy(tensor)
        gtype = _pick_type(gg, data, out_type, keep_hi_fidelity)
        w.add_tensor(gg, data.astype(
            np.float16 if gtype == GGML_F16 else np.float32), gtype)
        n += 1
    w.write(str(output))
    print(f"wrote {output} ({n} tensors)", file=sys.stderr)


def _add_text_tokenizer(w: GGUFWriter, input_dir: Path,
                        text_vocab_size: int) -> None:
    """Embed the BPE tokenizer into the GGUF
    (the reference does the same: convert_tts_to_gguf.py:498-547)."""
    vocab_path = input_dir / "vocab.json"
    merges_path = input_dir / "merges.txt"
    if not vocab_path.exists():
        print("  (no vocab.json — tokenizer not embedded)", file=sys.stderr)
        return
    vocab = json.loads(vocab_path.read_text(encoding="utf-8"))
    tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    while len(tokens) < text_vocab_size:
        tokens.append(f"[PAD{len(tokens)}]")
    merges = []
    if merges_path.exists():
        for line in merges_path.read_text(encoding="utf-8").splitlines():
            line = line.rstrip("\n")
            # Skip only the '#version:' header. The reference converter
            # drops EVERY '#'-initial line (convert_tts_to_gguf.py:374),
            # deleting real byte-level merge rules like '# #' and making
            # hash-containing text tokenize differently from HF; keeping
            # them is a strict interop improvement (its C++ loader is
            # happy with the complete table).
            if line and not line.startswith("#version"):
                merges.append(line)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.pre", "qwen2")
    w.add("tokenizer.ggml.tokens", tokens)
    w.add("tokenizer.ggml.merges", merges)
    tc_path = input_dir / "tokenizer_config.json"
    if tc_path.exists():
        tc = json.loads(tc_path.read_text(encoding="utf-8"))
        for key, gguf_key in (("eos_token", "tokenizer.ggml.eos_token_id"),
                              ("pad_token", "tokenizer.ggml.padding_token_id")):
            tok = tc.get(key)
            if isinstance(tok, dict):
                tok = tok.get("content")
            if tok and tok in vocab:
                w.add(gguf_key, int(vocab[tok]))


# ---------------------------------------------------------------------------
# Speech codec (vocoder decoder)
# ---------------------------------------------------------------------------

CODEC_STATIC = {
    "decoder.pre_conv.conv.weight": "tok_dec.pre_conv.weight",
    "decoder.pre_conv.conv.bias": "tok_dec.pre_conv.bias",
    "decoder.pre_transformer.input_proj.weight": "tok_dec.pre_tfm.input_proj.weight",
    "decoder.pre_transformer.input_proj.bias": "tok_dec.pre_tfm.input_proj.bias",
    "decoder.pre_transformer.output_proj.weight": "tok_dec.pre_tfm.output_proj.weight",
    "decoder.pre_transformer.output_proj.bias": "tok_dec.pre_tfm.output_proj.bias",
    "decoder.pre_transformer.norm.weight": "tok_dec.pre_tfm.norm.weight",
    "decoder.quantizer.rvq_first.input_proj.weight": "tok_dec.vq_first.input_proj.weight",
    "decoder.quantizer.rvq_first.output_proj.weight": "tok_dec.vq_first.output_proj.weight",
    "decoder.quantizer.rvq_rest.input_proj.weight": "tok_dec.vq_rest.input_proj.weight",
    "decoder.quantizer.rvq_rest.output_proj.weight": "tok_dec.vq_rest.output_proj.weight",
    "decoder.decoder.0.conv.weight": "tok_dec.dec.0.conv.weight",
    "decoder.decoder.0.conv.bias": "tok_dec.dec.0.conv.bias",
    "decoder.decoder.5.alpha": "tok_dec.dec.5.snake.alpha",
    "decoder.decoder.5.beta": "tok_dec.dec.5.snake.beta",
    "decoder.decoder.6.conv.weight": "tok_dec.dec.6.conv.weight",
    "decoder.decoder.6.conv.bias": "tok_dec.dec.6.conv.bias",
}

CODEC_RULES = (
    _layer_rules("decoder.pre_transformer.layers", "tok_dec.pre_tfm")
    + [
        (re.compile(r"decoder\.pre_transformer\.layers\.(\d+)\.self_attn_layer_scale\.scale$"),
         "tok_dec.pre_tfm.blk.{0}.attn_scale"),
        (re.compile(r"decoder\.pre_transformer\.layers\.(\d+)\.mlp_layer_scale\.scale$"),
         "tok_dec.pre_tfm.blk.{0}.ffn_scale"),
        (re.compile(r"decoder\.decoder\.(\d+)\.block\.0\.(alpha|beta)$"),
         "tok_dec.dec.{0}.snake.{1}"),
        (re.compile(r"decoder\.decoder\.(\d+)\.block\.1\.conv\.(weight|bias)$"),
         "tok_dec.dec.{0}.conv_t.{1}"),
        (re.compile(r"decoder\.decoder\.(\d+)\.block\.(\d+)\.act(\d)\.(alpha|beta)$"),
         "tok_dec.dec.{0}.res.{1}.act{2}.{3}"),
        (re.compile(r"decoder\.decoder\.(\d+)\.block\.(\d+)\.conv(\d)\.conv\.(weight|bias)$"),
         "tok_dec.dec.{0}.res.{1}.conv{2}.{3}"),
        (re.compile(r"decoder\.quantizer\.rvq_first\.vq\.layers\.(\d+)\._codebook\.embedding_sum$"),
         "tok_dec.vq_first.{0}.codebook"),
        (re.compile(r"decoder\.quantizer\.rvq_rest\.vq\.layers\.(\d+)\._codebook\.embedding_sum$"),
         "tok_dec.vq_rest.{0}.codebook"),
        (re.compile(r"decoder\.upsample\.(\d+)\.0\.conv\.(weight|bias)$"),
         "tok_dec.upsample.{0}.conv.{1}"),
        (re.compile(r"decoder\.upsample\.(\d+)\.1\.dwconv\.conv\.(weight|bias)$"),
         "tok_dec.upsample.{0}.dwconv.{1}"),
        (re.compile(r"decoder\.upsample\.(\d+)\.1\.gamma$"),
         "tok_dec.upsample.{0}.gamma"),
        (re.compile(r"decoder\.upsample\.(\d+)\.1\.norm\.(weight|bias)$"),
         "tok_dec.upsample.{0}.norm.{1}"),
        (re.compile(r"decoder\.upsample\.(\d+)\.1\.pwconv(\d)\.(weight|bias)$"),
         "tok_dec.upsample.{0}.pwconv{1}.{2}"),
    ])


def map_codec_name(hf_name: str) -> str | None:
    if hf_name in CODEC_STATIC:
        return CODEC_STATIC[hf_name]
    for rx, template in CODEC_RULES:
        m = rx.match(hf_name)
        if m:
            return template.format(*m.groups())
    return None


def convert_codec(input_dir: Path, output: Path, out_type: str) -> None:
    cfg = json.loads((input_dir / "config.json").read_text())
    enc = cfg.get("encoder_config", {})
    dec = cfg.get("decoder_config", {})

    w = GGUFWriter("qwen3-tts-tokenizer")
    w.add("general.name", "Qwen3-TTS-Tokenizer-12Hz")
    w.add("qwen3-tts-tokenizer.num_codebooks",
          int(dec.get("num_quantizers", 16)))
    w.add("qwen3-tts-tokenizer.codebook_size",
          int(enc.get("codebook_size", 2048)))
    w.add("qwen3-tts-tokenizer.sample_rate",
          int(cfg.get("input_sample_rate", 24000)))
    w.add_f32_scalar("qwen3-tts-tokenizer.frame_rate",
                     float(enc.get("_frame_rate", 12.5)))
    w.add("qwen3-tts-tokenizer.decoder.hidden_size",
          int(dec.get("hidden_size", 512)))
    w.add("qwen3-tts-tokenizer.decoder.num_layers",
          int(dec.get("num_hidden_layers", 8)))
    w.add("qwen3-tts-tokenizer.decoder.num_heads",
          int(dec.get("num_attention_heads", 16)))
    w.add("qwen3-tts-tokenizer.decoder.latent_dim",
          int(dec.get("latent_dim", 1024)))
    w.add("qwen3-tts-tokenizer.upsample_rates",
          [int(x) for x in dec.get("upsample_rates", [8, 5, 4, 3])])

    # pre-normalize codebooks: embedding_sum / clamp(cluster_usage, 1e-5)
    # and drop usage tensors (same as convert_tokenizer_to_gguf.py:347-359).
    # The decoder.* names are indexed first (in iteration order) and each
    # tensor read when it is written, so the checkpoint is never held whole.
    files = [SafeTensorsFile(p) for p in _checkpoint_files(input_dir)]
    try:
        where = {name: f for f in files for name in f.keys()
                 if name.startswith("decoder.")}

        def load(name):
            return _to_numpy(where[name].get_tensor(name))

        n = 0
        for hf_name in where:
            if "cluster_usage" in hf_name:
                continue
            data = load(hf_name)
            if "embedding_sum" in hf_name:
                usage_name = hf_name.replace("embedding_sum", "cluster_usage")
                if usage_name in where:
                    data = data / np.maximum(load(usage_name), 1e-5)[:, None]
            gg = map_codec_name(hf_name)
            if gg is None:
                print(f"  skip {hf_name}", file=sys.stderr)
                continue
            gtype = _pick_type(gg, data, out_type, lambda name: any(
                x in name for x in
                ("codebook", "norm", "scale", "alpha", "beta")))
            w.add_tensor(gg, data.astype(
                np.float16 if gtype == GGML_F16 else np.float32), gtype)
            n += 1
    finally:
        for f in files:
            f.close()
    w.write(str(output))
    print(f"wrote {output} ({n} tensors)", file=sys.stderr)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model", choices=["tts", "codec"])
    ap.add_argument("--input", "-i", type=Path, required=True)
    ap.add_argument("--output", "-o", type=Path, required=True)
    ap.add_argument("--type", "-t",
                    choices=["f16", "f32", "q8_0", "q4_0", "q4_k"],
                    default="f16")
    args = ap.parse_args()
    args.output.parent.mkdir(parents=True, exist_ok=True)
    if args.model == "tts":
        convert_tts(args.input, args.output, args.type)
    else:
        convert_codec(args.input, args.output, args.type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
