"""Synthesis pipeline: load models, synthesize, clone voices (port of
qwen3_tts_tpu/runtime/pipeline.py). Text -> 24 kHz waveform for a batch
of streams in lock-step, with the streaming 40-frame vocoder decode;
runtime/serve.py builds continuous batching on this engine.

``Qwen3TTS().load_models(dir)`` reads a model directory
(qwen3-tts-0.6b-f16.gguf, qwen3-tts-tokenizer-f16.gguf) straight onto the
card: each tensor crosses once as its file's bytes and is cast there. The
speaker encoder loads on first use. ``from_components`` assembles an
engine from tensors already in memory.

Devices: an engine lives on one device, ``cuda`` (the first card) unless
the caller asks for ``cpu``; without a card, loading for ``cuda`` fails,
it never falls back to the CPU. On the card the vocoder's matrices are
bf16, the dtype the vocoder kernels were written and checked for (the
JAX package casts them on its accelerator too); on the CPU they stay f32,
as the JAX package keeps them there. ``QWEN3_TTS_LOW_MEM=1`` keeps the
vocoder's weights, its kernels' packed copies included, in pinned host
memory and stages them to the card for each decode.

The chunk loop runs on the core that the serving batcher shares
(runtime/stream.py: ``enqueue_chunk``, ``StreamCodes``, ``decode_wave``),
its read window counted on the host from the frames dispatched, so that
no readback lands between two dispatches. A sparse-MoE talker
(Qwen3-Omni's, ``from_components(..., moe=)``) runs the same loop, its FFN
ops/moe.py inside the same frame graphs: each chunk zeroes the talker's
counters, which come home with its codes (``ChunkCopies``).

Without a vocoder (``from_components(..., voc_w=None)``) the engine still
generates codes; each stream then reports "Vocoder not loaded", as in the
JAX package.

Compiled executables (runtime/graphs.py): on the card each frame of a
chunk replays its bucket's CUDA graph (``_gen_fn``) over static state
buffers, prefilled in place and kept for the last batch shape, and each
vocoder decode its (n, frames, sub, pcm16) bucket's (``_voc_fn``), both
captured on first use into ``Qwen3TTS.graphs``; ``QWEN3_TTS_AOT=0`` runs
them eagerly, as the CPU does.

A mesh (``Qwen3TTS.shard``, parallel/mesh.py): one process per device,
each calling the same entry points with the same arguments. The talker is
split over tp; ``synthesize_batch`` tokenizes every text on every rank,
pads the batch with inactive streams to a multiple of dp (saying so on
stderr), and builds the prefill and the state of this rank's dp rows
only. After each chunk one ``all_gather`` over dp of (codes, valid, done)
gives every rank the whole batch, and the loop ends on the global done.
Every rank decodes the audio of its own dp rows (the tp ranks of a dp
group alike: they hold the same codes, and would otherwise wait), then
the audio is exchanged over dp, so that every rank returns the whole
list of results; ``on_chunk`` fires on the ranks that decode the stream.
Frame graphs are captured on a dp-only NCCL mesh (no collective sits in a
frame); at tp > 1 and on a gloo mesh generation runs eagerly. A generator
that the engine seeds itself is seeded apart on each dp rank and alike on
the tp ranks of a dp group (``mesh.rank_seed``): greedy output equals the
unsharded engine's, sampled output matches it in distribution.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..config import (MLAConfig, MoEConfig, SpeakerEncoderConfig,
                      TalkerConfig, VocoderConfig)
from ..io.gguf import GGUFReader, HostStager
from ..models import code_predictor
from ..models import speaker_encoder as spk
from ..models import talker, vocoder
from ..models import weights as W
from ..models.stack import QuantKV
from ..ops import codepred_fused, mla as mla_op, moe as moe_op
from ..ops.attention import get_decode_attention_impl
from ..parallel.mesh import (dp_rows, gather_chunk, gather_objects,
                             graphs_allowed, mesh_dims, rank_seed,
                             shard_talker_weights)
from ..tokenizer import TextTokenizer
from ..utils import trace
from ..utils.trace import memory_snapshot, print_report, profile_trace
from . import audio_io
from .generate import (ctx_bucket, generate_frame, init_state,
                       kv_quant_enabled, make_consts, required_ctx)
from .graphs import GraphCache, aot_enabled, gen_key, new_buffer_id, voc_key
from .stream import CHUNK_FRAMES, ChunkCopies, StreamCodes, decode_wave

TTS_FILE = "qwen3-tts-0.6b-f16.gguf"
CODEC_FILE = "qwen3-tts-tokenizer-f16.gguf"


@dataclass
class TTSParams:
    """Generation parameters."""
    max_audio_tokens: int = 4096
    temperature: float = 0.9
    top_p: float = 1.0          # nucleus filter after top-k when < 1
    top_k: int = 50
    repetition_penalty: float = 1.05
    language_id: int = 2050     # English
    seed: int | None = None
    print_timing: bool = True   # a stage report on stderr per batch


@dataclass
class TTSResult:
    audio: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    sample_rate: int = 24000
    success: bool = False
    error_msg: str = ""
    n_frames: int = 0
    t_tokenize_ms: float = 0.0
    t_encode_ms: float = 0.0    # synthesize_with_voice: the speaker encode
    t_total_ms: float = 0.0
    # serving only (ContinuousBatcher): wall time from submit to admission;
    # t_total_ms counts from admission, so a client waits the sum
    t_queue_ms: float = 0.0
    mem_rss_peak_bytes: int = 0
    device_mem_bytes: int = 0


def _now_ms() -> float:
    return time.monotonic() * 1e3


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _tree_map(fn, tree):
    """fn over the tensors of a weights tree; other leaves (None, a
    settings entry such as "moe" or "code2wav") as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _first_leaf(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return next((x for x in map(_first_leaf, tree) if x is not None),
                    None)
    return tree if isinstance(tree, torch.Tensor) else None


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Qwen3TTS:
    """End-to-end engine: text -> waveform, batched over streams, with
    voice cloning. ``Qwen3TTS().load_models(dir)`` or
    ``Qwen3TTS.from_components(...)`` make a usable engine."""

    # Vocoder activations at the 76,800-sample tail stages are large: cap
    # the decode batch and split bigger waves.
    VOC_MAX_BATCH = 48
    # Decode-batch buckets: a wave of n ready streams decodes at the
    # smallest bucket covering n.
    VOC_BUCKETS = (1, 4, 8, 16, 32, 64, 128)

    def __init__(self, tokenizer: TextTokenizer | None = None,
                 talker_cfg: TalkerConfig | None = None, talker_w=None,
                 voc_cfg: VocoderConfig | None = None, voc_w=None,
                 device=None, spk_cfg: SpeakerEncoderConfig | None = None,
                 spk_w=None) -> None:
        self.tokenizer = tokenizer
        self.talker_cfg = talker_cfg
        self.device = None if device is None else torch.device(device)
        if talker_w is not None and self.device is not None \
                and self.device.type == "cuda":
            # behind an mtp projection, the code predictor kernel's input
            # rows; the CPU runs the XLA path and needs none
            talker_w = codepred_fused.fold_mtp(talker_w, talker_cfg)
        self.talker_w = talker_w
        self.voc_cfg = voc_cfg
        self.voc_w = voc_w
        self.spk_cfg = spk_cfg
        self.spk_w = spk_w
        self.low_mem = False
        self.error_msg = ""
        self._tts_model_path: str | None = None
        self.mesh = None
        self._drop_graphs()

    def _drop_graphs(self) -> None:
        """Forget the compiled executables and the static buffers they
        read and write (module docstring)."""
        self._graph_cache = None
        self._model_tag = None
        self._graph_gen = None
        self._lockstep = None     # (shape, state, consts, buffers id)
        self._voc_bufs: dict = {}
        self._chunk_bufs: dict = {}   # (buffers id, key) -> outputs

    @classmethod
    def from_components(cls, tokenizer, talker_cfg, talker_w, voc_cfg, voc_w,
                        device, spk_cfg=None, spk_w=None,
                        moe: MoEConfig | None = None,
                        mla: MLAConfig | None = None) -> "Qwen3TTS":
        """Assemble an engine from in-memory components whose tensors
        already live on `device`; the vocoder kernels' parameters are
        packed here, once. voc_w=None: an engine without a vocoder
        (module docstring). moe: the sparse-MoE talker's settings, when
        its layers hold the MoE leaves (models/weights.moe_layers); they
        ride in the layers tree as its entry "moe", which a tree from
        ``init_talker_weights(..., moe=)`` carries already, beside the
        engine's counters ``moe_counts`` [L, 3] int32 ([L, 5] on the
        expert-parallel path, ops/moe.py; module docstring). mla: the
        settings of a talker of LongCat-Flash double layers, whose layers
        hold ``wkv_b`` (models/weights.mla_layers), ridden in as the entry
        "mla" the same way; the engine adds each sublayer's absorbed
        ``w_uk`` / ``w_uv`` (ops/mla.absorbed_weights) for decoding."""
        if talker_w is not None:
            talker_w = cls._with_mla(talker_w, talker_cfg, mla)
        if talker_w is not None and "w_router" in talker_w["layers"]:
            layers = talker_w["layers"]
            have = layers.get("moe")
            if moe is None and have is None:
                raise ValueError("a sparse-MoE talker needs its MoEConfig "
                                 "(from_components(..., moe=))")
            if moe is not None and have not in (None, moe):
                raise ValueError(f"moe={moe} differs from the talker "
                                 f"tree's {have}")
            counts = torch.zeros(layers["w_router"].shape[0],
                                 moe_op.n_counts(moe or have),
                                 dtype=torch.int32, device=device)
            talker_w = {**talker_w, "layers": {
                **layers, "moe": moe or have, "moe_counts": counts}}
        elif moe is not None:
            raise ValueError("moe given, but the talker's layers hold no "
                             "w_router")
        if voc_w is not None:
            voc_w = vocoder.pack_kernel_weights(voc_w)
        return cls(tokenizer, talker_cfg, talker_w, voc_cfg, voc_w, device,
                   spk_cfg, spk_w)

    @staticmethod
    def _with_mla(talker_w, talker_cfg, mla):
        """The talker tree with its "mla" entry and absorbed leaves, where
        its layers hold ``wkv_b`` (from_components)."""
        layers = talker_w["layers"]
        if "wkv_b" not in layers:
            if mla is not None:
                raise ValueError("mla given, but the talker's layers hold "
                                 "no wkv_b")
            return talker_w
        have = layers.get("mla")
        if mla is None and have is None:
            raise ValueError("a latent-attention talker needs its MLAConfig "
                             "(from_components(..., mla=))")
        if mla is not None and have not in (None, mla):
            raise ValueError(f"mla={mla} differs from the talker tree's "
                             f"{have}")
        mla = mla or have
        w_uk, w_uv = mla_op.absorbed_weights(
            layers["wkv_b"], talker_cfg.n_attention_heads, mla)
        return {**talker_w, "layers": {**layers, "mla": mla, "w_uk": w_uk,
                                       "w_uv": w_uv}}

    def shard(self, mesh) -> "Qwen3TTS":
        """Shard the engine over a dp x tp mesh (``parallel.make_mesh``;
        every rank calls this with its own mesh handle): the talker
        weights are split over tp (``shard_talker_weights``), the batches
        of later calls over dp (module docstring), and the captured
        graphs, which hold the old weights' addresses, are dropped.
        Returns self."""
        if self.mesh is not None:
            raise ValueError("the engine is sharded already")
        if torch.device(mesh.device_type).type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot shard an "
                             f"engine on {self.device}")
        if "mla" in self.talker_w["layers"] and mesh_dims(mesh)[1] > 1:
            raise ValueError("tp > 1 on a latent-attention talker: its "
                             "heads and its experts are not split; shard it "
                             "over dp only")
        if self._moe_counts() is not None and mesh_dims(mesh)[1] > 1:
            raise ValueError("tp > 1 on a sparse-MoE talker: its experts "
                             "are not split (no expert parallelism); shard "
                             "it over dp only")
        self.talker_w = shard_talker_weights(self.talker_w, mesh,
                                             self.talker_cfg)
        self.mesh = mesh
        self._drop_graphs()
        if (self.device.type == "cuda" and not graphs_allowed(mesh)
                and torch.distributed.get_rank() == 0):
            dp, tp = mesh_dims(mesh)
            _log(f"[shard] mesh dp={dp} tp={tp}: generation runs eagerly "
                 f"(no CUDA graphs at tp > 1 or over gloo)")
        return self

    def _mesh_key(self) -> tuple | None:
        """(dp, tp, rank) of the engine's mesh for graph keys."""
        if self.mesh is None:
            return None
        return (*mesh_dims(self.mesh), torch.distributed.get_rank())

    # -- loading -------------------------------------------------------------
    def load_models(self, model_dir: str, device="cuda") -> bool:
        """Load the tokenizer, talker and vocoder from `model_dir` onto
        `device` (the speaker encoder loads on first use). Returns False
        with error_msg set when a file is missing or malformed, or when
        `device` is a card and there is none."""
        try:
            dev = torch.device(device)
        except RuntimeError as e:
            self.error_msg = f"Failed to load models: {e}"
            return False
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                self.error_msg = ("Failed to load models: no CUDA device "
                                  "(load with device='cpu' to run on the "
                                  "CPU)")
                return False
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        low_mem = os.environ.get("QWEN3_TTS_LOW_MEM", "")
        low_mem = bool(low_mem) and low_mem != "0"
        if low_mem:
            _log("  Low-memory mode enabled (host-resident vocoder weights)")
        t0 = _now_ms()
        stager = HostStager() if dev.type == "cuda" else None
        tts_path = os.path.join(model_dir, TTS_FILE)
        try:
            with GGUFReader(tts_path) as r:
                t1 = _now_ms()
                tokenizer = TextTokenizer.from_gguf(r)
                _log(f"  Text tokenizer loaded: vocab_size="
                     f"{len(tokenizer.id_to_token)} ({_now_ms() - t1:.0f} ms)")
                t1 = _now_ms()
                talker_cfg = TalkerConfig.from_gguf(r)
                talker_w = W.load_talker_weights(r, talker_cfg, dev, stager)
                _log(f"  Talker loaded: hidden_size={talker_cfg.hidden_size}"
                     f", n_layers={talker_cfg.n_layers} on {dev} "
                     f"({_now_ms() - t1:.0f} ms)")
            _log("  Speaker encoder: deferred (lazy load)")
            t1 = _now_ms()
            with GGUFReader(os.path.join(model_dir, CODEC_FILE)) as r:
                voc_cfg = VocoderConfig.from_gguf(r)
                voc_w = vocoder.load_vocoder_weights(r, voc_cfg, dev, stager)
            if dev.type == "cuda":
                voc_w = vocoder.cast_weights(voc_w)
            voc_w = vocoder.pack_kernel_weights(voc_w)
            if low_mem and dev.type == "cuda":
                voc_w = _tree_map(_pinned, voc_w)
            _log(f"  Vocoder loaded: sample_rate={voc_cfg.sample_rate}, "
                 f"n_codebooks={voc_cfg.n_codebooks} "
                 f"({_now_ms() - t1:.0f} ms)")
        except (OSError, ValueError, KeyError) as e:
            self.error_msg = f"Failed to load models: {e}"
            return False
        # a fresh engine over the loaded models (the old graphs hold the
        # old weights' addresses)
        self.__init__(tokenizer, talker_cfg, talker_w, voc_cfg, voc_w, dev)
        self.low_mem = low_mem
        self._tts_model_path = tts_path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _log(f"All models loaded in {_now_ms() - t0:.0f} ms")
        return True

    def _ensure_speaker_encoder(self) -> bool:
        if self.spk_w is not None:
            return True
        if not self._tts_model_path:
            self.error_msg = "speaker encoder unavailable (no model path)"
            return False
        try:
            with GGUFReader(self._tts_model_path) as r:
                cfg = SpeakerEncoderConfig.from_gguf(r)
                self.spk_w = spk.load_speaker_encoder_weights(
                    r, cfg, self.device,
                    HostStager() if self.device.type == "cuda" else None)
                self.spk_cfg = cfg
            return True
        except (OSError, ValueError, KeyError) as e:
            self.error_msg = f"Failed to load speaker encoder: {e}"
            return False

    # -- speaker encoding ----------------------------------------------------
    def encode_speaker(self, reference_audio: str) -> np.ndarray | None:
        """Reference WAV -> voice embedding [embedding_dim] (host f32), or
        None with error_msg set."""
        if not self._ensure_speaker_encoder():
            return None
        try:
            samples, sr = audio_io.load_wav(reference_audio)
        except (OSError, ValueError) as e:
            self.error_msg = f"Failed to load reference audio: {e}"
            return None
        return self.encode_speaker_samples(samples, sr)

    def encode_speaker_samples(self, samples: np.ndarray,
                               sample_rate: int) -> np.ndarray | None:
        """One clip: the host mel, padded to a 128-frame bucket, then the
        encoder on the engine's device."""
        if not self._ensure_speaker_encoder():
            return None
        cfg = self.spk_cfg
        if sample_rate != cfg.sample_rate:
            samples = audio_io.resample_linear(samples, sample_rate,
                                               cfg.sample_rate)
        mel = spk.mel_spectrogram(np.asarray(samples, np.float32), cfg)
        t = mel.shape[0]
        mel_pad = np.zeros((1, spk.bucket_frames(t), cfg.n_mels), np.float32)
        mel_pad[0, :t] = mel
        with torch.inference_mode():
            emb = spk.encode(self.spk_w, cfg,
                             torch.as_tensor(mel_pad, device=self.device),
                             torch.tensor([t], device=self.device))
        return emb[0].cpu().numpy()

    def encode_speaker_batch(self, clips: list[np.ndarray],
                             sample_rate: int) -> np.ndarray | None:
        """Bulk enrolment: N clips -> [N, embedding_dim] in one encode,
        the mel computed on the device (spk.mel_spectrogram_batch) over
        clips padded to one 1 s sample bucket."""
        if not self._ensure_speaker_encoder():
            return None
        cfg = self.spk_cfg
        if not clips:
            return np.zeros((0, cfg.embedding_dim), np.float32)
        res = [audio_io.resample_linear(np.asarray(c, np.float32),
                                        sample_rate, cfg.sample_rate)
               if sample_rate != cfg.sample_rate else
               np.asarray(c, np.float32) for c in clips]
        n = np.array([len(c) for c in res], np.int32)
        if (n <= 0).any():
            self.error_msg = "empty reference clip in batch"
            return None
        batch = np.zeros((len(res), spk.bucket_samples(int(n.max()), cfg)),
                         np.float32)
        for i, c in enumerate(res):
            batch[i, :len(c)] = c
        with torch.inference_mode():
            mel, n_frames = spk.mel_spectrogram_batch(
                torch.as_tensor(batch, device=self.device),
                torch.as_tensor(n, device=self.device), cfg)
            emb = spk.encode(self.spk_w, cfg, mel, n_frames)
        return emb.cpu().numpy()

    # -- synthesis -----------------------------------------------------------
    def synthesize(self, text: str, params: TTSParams | None = None,
                   generator: torch.Generator | None = None) -> TTSResult:
        """One stream, default voice (zero speaker embedding)."""
        return self.synthesize_batch([text], None, params, generator)[0]

    def synthesize_with_embedding(self, text: str, embedding: np.ndarray,
                                  params: TTSParams | None = None,
                                  generator: torch.Generator | None = None
                                  ) -> TTSResult:
        return self.synthesize_batch([text], [embedding], params,
                                     generator)[0]

    def synthesize_with_voice(self, text: str, reference_audio: str,
                              params: TTSParams | None = None,
                              generator: torch.Generator | None = None
                              ) -> TTSResult:
        """Clone the voice of a reference WAV: encode it, then synthesize
        with its embedding; t_encode_ms is the time outside synthesis."""
        t0 = _now_ms()
        emb = self.encode_speaker(reference_audio)
        if emb is None:
            return TTSResult(error_msg=self.error_msg)
        res = self.synthesize_batch([text], [emb], params, generator)[0]
        res.t_encode_ms = _now_ms() - t0 - res.t_total_ms
        return res

    def synthesize_batch(self, texts: Sequence[str],
                         embeddings: Sequence[np.ndarray] | None = None,
                         params: TTSParams | None = None,
                         generator: torch.Generator | None = None,
                         on_chunk: Callable[[int, np.ndarray], None] | None
                         = None) -> list[TTSResult]:
        """Synthesize independent streams in lock-step.

        generator: the sampling noise source, on self.device; when None, one
        is seeded from params.seed (or at random). on_chunk(stream, samples)
        fires per decoded 40-frame chunk. QWEN3_TTS_PROFILE=<dir> writes a
        torch.profiler trace of the call (utils/trace.py). The call is a
        ``call`` span holding ``call.tokenize``, ``call.prefill``, a
        ``call.dispatch`` a chunk, a ``call.decode`` a vocoder wave
        (``rows``, ``bucket``) and ``call.tail_flush`` (the tails' wave)."""
        with profile_trace("synthesize_batch"), \
                trace.span("call", streams=len(texts)):
            return self._synthesize_batch_impl(texts, embeddings, params,
                                               generator, on_chunk)

    def _synthesize_batch_impl(self, texts, embeddings, params, generator,
                               on_chunk) -> list[TTSResult]:
        p = params or TTSParams()
        results = [TTSResult() for _ in texts]
        if self.talker_w is None or self.tokenizer is None:
            for r in results:
                r.error_msg = "Models not loaded"
            return results
        cfg = self.talker_cfg
        dev = self.device
        t_total0 = time.monotonic_ns()

        with trace.span("call.tokenize"):
            token_lists = [self.tokenizer.encode_for_tts(t) for t in texts]
        t_tok = (time.monotonic_ns() - t_total0) / 1e6
        bad = set()
        for i, (r, toks) in enumerate(zip(results, token_lists)):
            if len(toks) < 4:
                r.error_msg = "Need at least 4 text tokens for generation"
                bad.add(i)
        if len(bad) == len(texts):
            return results
        B = len(texts)
        # on a mesh: the batch padded to a multiple of dp, this rank's rows
        rows_pad, lo, hi = self._dp_split(B)
        rows = range(lo, min(hi, B))
        t_max = max(-(-max(len(t) for t in token_lists) // 16) * 16, 16)
        tokens = np.zeros((rows_pad, t_max), np.int32)
        lens = np.zeros((rows_pad,), np.int32)
        for i, toks in enumerate(token_lists):
            tokens[i, :len(toks)] = toks
            lens[i] = len(toks)
        spk_emb = np.zeros((rows_pad, cfg.hidden_size), np.float32)
        if embeddings is not None:
            spk_emb[:B] = np.stack([np.asarray(e, np.float32)
                                    for e in embeddings])
        if generator is None:
            seed = (p.seed if p.seed is not None
                    else int(np.random.randint(0, 2**31)))
            generator = torch.Generator(device=dev).manual_seed(
                rank_seed(self.mesh, seed))
        active = (None if rows_pad == B else
                  torch.arange(lo, hi, device=dev) < B)

        with torch.inference_mode():
            with trace.span("call.prefill"):
                prefill = talker.build_prefill_inputs(
                    self.talker_w, cfg,
                    torch.as_tensor(tokens[lo:hi], device=dev),
                    torch.as_tensor(lens[lo:hi], device=dev),
                    torch.as_tensor(spk_emb[lo:hi], device=dev),
                    language_id=torch.full((hi - lo,), p.language_id,
                                           dtype=torch.int32, device=dev))
                prefill_len = prefill.prefill_embd.shape[1]
                max_ctx = required_ctx(prefill_len, p.max_audio_tokens,
                                       CHUNK_FRAMES)
                state, consts, bufs = self._lockstep_state(
                    prefill, max_ctx, p, generator, active)

            streams = StreamCodes.alloc(B, p.max_audio_tokens, cfg.n_codebooks)
            n_chunks = -(-p.max_audio_tokens // CHUNK_FRAMES)

            def dispatch(k: int) -> ChunkCopies:
                with trace.span("call.dispatch"):
                    # every stream's n_past is at most prefill + k chunks
                    return self.enqueue_chunk(state, consts, bufs, ctx_bucket(
                        prefill_len + k * CHUNK_FRAMES, CHUNK_FRAMES,
                        max_ctx), p)

            def deliver(i: int, ref) -> None:
                b = ready[i][0]      # the stream of the wave's row i
                streams[b].audio.append(ref)
                if on_chunk:
                    on_chunk(b, ref.to_f32())

            # runtime/stream.py: chunk k+1 is enqueued as soon as chunk k's
            # `done` is home, before chunk k's codes are read and decoded
            inflight, k = dispatch(0), 1
            while inflight is not None:
                chunk, inflight = inflight, None
                if k < n_chunks and not chunk.done.result().all():
                    inflight, k = dispatch(k), k + 1
                codes_h, valid_h, _ = chunk.take()
                for b, s in enumerate(streams):
                    s.take(codes_h, valid_h, b)
                while self.voc_w is not None and (ready := [
                        (b, c) for b in rows
                        if (c := streams[b].next_chunk())]):
                    decode_wave(self, [c for _, c in ready], len(rows),
                                "call.decode", deliver=deliver)
            if state.generator is not generator:
                generator.set_state(state.generator.get_state())
            with trace.span("call.tail_flush"):
                for b in range(B):
                    if b in bad:
                        continue
                    n = streams[b].n_frames
                    results[b].n_frames = n
                    if n == 0:
                        results[b].error_msg = "No speech codes generated"
                        continue
                    if self.voc_w is None:
                        results[b].error_msg = "Vocoder not loaded"
                        continue
                    results[b].sample_rate = self.voc_cfg.sample_rate
                    results[b].success = True
                # this rank's streams with audio to make
                self._flush_tails(streams, [b for b in rows
                                            if results[b].success],
                                  on_chunk, len(rows), results)
                if self.mesh is not None:
                    for part in gather_objects(self.mesh, {
                            b: results[b].audio for b in rows}):
                        for b, audio in part.items():
                            results[b].audio = audio
                _sync(dev)

        rss = memory_snapshot()["rss_peak_bytes"]
        dev_mem = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
        t_total = (time.monotonic_ns() - t_total0) / 1e6
        for r in results:
            r.t_tokenize_ms = t_tok
            r.t_total_ms = t_total
            r.mem_rss_peak_bytes = rss
            r.device_mem_bytes = dev_mem
        if p.print_timing and results[0].success:
            print_report(self._call_stages(trace.spans(t_total0)), t_total,
                         audio_seconds=sum(len(x.audio) for x in results)
                         / results[0].sample_rate)
            _log(f"  Streams:         {len(results)}")
            _log(f"  RSS peak:        {rss / 2**20:.0f} MB; "
                 f"device mem peak: {dev_mem / 2**20:.0f} MB")
        return results

    @staticmethod
    def _call_stages(spans) -> dict[str, float]:
        """The ``Timing:`` report's stages, ms, from one call's spans
        (nested: the host waits lie inside the decodes and the flush, the
        tail wave inside the flush)."""
        names = (("Tokenization", "call.tokenize"), ("Prefill", "call.prefill"),
                 ("Host waits", "host.wait"), ("Vocoder decode", "call.decode"),
                 ("Tail flush", "call.tail_flush"))
        return {label: sum(s.ms for s in spans if s.name == name)
                for label, name in names
                if any(s.name == name for s in spans)}

    # -- vocoder paths -------------------------------------------------------
    def decode_codes_chunked(self, frames: np.ndarray,
                             chunk: int = CHUNK_FRAMES) -> np.ndarray:
        """Independent fixed-size chunk decode: each chunk zero-padded to
        `chunk` frames, decoded with no history, k*samples_per_frame
        samples kept per k-frame chunk."""
        out = []
        for off in range(0, len(frames), chunk):
            part = frames[off:off + chunk]
            padded = np.zeros((chunk, frames.shape[1]), np.int32)
            padded[:len(part)] = part
            audio = self._decode_chunk_batch(padded[None])[0]
            out.append(audio[:vocoder.vocoder_output_length(
                self.voc_w, self.voc_cfg, len(part), trim="causal")])
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def voc_bucket(self, n_ready: int, cap: int) -> int:
        """Smallest decode-batch bucket covering n_ready, capped at the
        serving batch size."""
        for b in self.VOC_BUCKETS:
            if n_ready <= b < cap:
                return b
        return cap

    def voc_sub(self, n: int, max_batch: int | None = None) -> int | None:
        """The tail's sub-batch width for a decode of n streams: None (the
        whole batch at once) up to max_batch (default VOC_MAX_BATCH), else
        the largest of max_batch, 32, 16, 8, 4, 2, 1 that is not above
        max_batch and divides n."""
        cap = self.VOC_MAX_BATCH if max_batch is None else max_batch
        return None if n <= cap else next(
            d for d in (cap, 32, 16, 8, 4, 2, 1) if d <= cap and n % d == 0)

    def _decode_chunk_batch(self, codes: np.ndarray, pcm16: bool = False,
                            max_batch: int | None = None):
        """[n, CHUNK, 16] -> [n, CHUNK*1920] audio (causal trim), the tail
        in sub-batches of at most max_batch (default VOC_MAX_BATCH; the
        continuous batcher passes its own cap per call). pcm16: return
        int16 PCM as a tensor on the engine's device, for a ``Readback``
        (runtime/stream.py); otherwise host f32."""
        n = len(codes)
        sub = self.voc_sub(n, max_batch)
        with torch.inference_mode():
            buf, decode = self._voc_fn(n, codes.shape[1], sub, pcm16)
            host = torch.from_numpy(np.ascontiguousarray(codes, np.int32))
            if buf.is_cuda:
                # from pageable memory the copy would wait for every chunk
                # queued ahead (runtime/stream.py); a pinned block from the
                # caching host allocator stays alive until the copy is done
                buf.copy_(host.pin_memory(), non_blocking=True)
            else:
                buf.copy_(host)
            audio = decode()
            return audio if pcm16 else audio.cpu().numpy()

    def _flush_tails(self, streams: list[StreamCodes], mine: list[int],
                     on_chunk, n_rows: int, results) -> None:
        """Decode the ragged tails (< 40 frames) of the streams `mine` as
        one vocoder wave, in the bucket of a batch of `n_rows` streams
        that covers them (never above n_rows, so one wave holds every
        tail). While the card decodes it, the host writes each stream's
        ``results[b].audio`` up to its tail; then, stream by stream (so in
        row order), the tail's samples go to on_chunk and end the
        waveform."""
        tails = [(b, c) for b in mine
                 if (c := streams[b].next_chunk(final=True))]
        refs = {}
        if tails:
            refs = dict(zip((b for b, _ in tails), decode_wave(
                self, [c for _, c in tails], n_rows, "call.decode")))
        # A stream's tail samples get their array just before its
        # waveform: allocated after all the waveforms, they would leave
        # the waveforms together at the top of the heap, which malloc
        # gives back to the system once the caller frees them, and the
        # next call's chunk samples would fault fresh pages in (~0.5 s a
        # call of 192 streams, measured on an H100 host).
        samples = {}
        for b in mine:
            n = refs[b].valid if b in refs else 0
            if n and on_chunk:
                samples[b] = np.empty(n, np.float32)
            results[b].audio = streams[b].waveform(n)
        for b, ref in refs.items():
            tail = results[b].audio[len(results[b].audio) - ref.valid:]
            ref.to_f32(tail)
            if b in samples:
                samples[b][:] = tail
                on_chunk(b, samples[b])

    # -- compiled executables (runtime/graphs.py) --------------------------
    @property
    def graphs(self) -> GraphCache:
        """The engine's CUDA graphs: the generation chunk per bucket and
        switch, the vocoder decode per bucket (module docstring)."""
        if self._graph_cache is None:
            self._graph_cache = GraphCache()
        return self._graph_cache

    def model_tag(self) -> str:
        """Short stable tag of the model dims and weight dtypes: part of
        every graph key."""
        if self._model_tag is None:
            dt = [str(_first_leaf(w).dtype) if w else "na"
                  for w in (self.voc_w, self.talker_w)]
            src = repr((self.talker_cfg, self.voc_cfg, dt))
            if self.voc_w is not None and "code2wav" in self.voc_w:
                src += repr(self.voc_w["code2wav"])
            self._model_tag = hashlib.md5(src.encode()).hexdigest()[:8]
        return self._model_tag

    def _gen_fn(self, state, consts, buffers: int, read_ctx: int,
                top_k: int, greedy: bool, top_p: float, ring: bool = False):
        """The generation chunk over `state` and `consts` (static
        buffers, owner id `buffers`) at one read_ctx bucket: a callable
        returning (codes [chunk, B, 16], valid [chunk, B]), buffers that
        the next chunk overwrites (``enqueue_chunk`` copies them home
        first). A chunk is CHUNK_FRAMES calls of the frame's graph on the card
        (captured on the first), which writes its codes at a frame index
        kept on the card: a 40-frame graph replays no faster, and
        instantiating one takes longer than the eager chunk under
        QWEN3_TTS_TALKER=xla (PERF.md).
        The key reads the impl switches now, as the JAX package bakes
        them in at trace time."""
        cache = state.kv_cache
        key = gen_key(
            model_tag=self.model_tag(), buffers=buffers,
            B=state.n_past.shape[0], ctx=state.valid_mask.shape[1],
            kv_quant=isinstance(cache, QuantKV),
            talker_impl=talker._resolve_impl(),
            codepred_impl=code_predictor._resolve_impl(),
            attn_impl=get_decode_attention_impl(), read_ctx=read_ctx,
            top_k=top_k, greedy=greedy, ring=ring,
            trailing=consts.trailing_hidden.shape[1], top_p=top_p,
            temperature=consts.temperature,
            repetition_penalty=consts.repetition_penalty, device=self.device,
            mesh=self._mesh_key())
        if (buffers, key) not in self._chunk_bufs:
            B, dev = state.n_past.shape[0], self.device
            self._chunk_bufs[buffers, key] = (
                torch.empty(CHUNK_FRAMES, B, self.talker_cfg.n_codebooks,
                            dtype=torch.int32, device=dev),
                torch.empty(CHUNK_FRAMES, B, dtype=torch.bool, device=dev),
                torch.zeros(1, dtype=torch.long, device=dev))
        codes, valid, f = self._chunk_bufs[buffers, key]

        def frame():
            c, v = generate_frame(self.talker_w, self.talker_cfg, state,
                                  consts, top_k, greedy=greedy,
                                  read_ctx=read_ctx, top_p=top_p, ring=ring)
            codes.index_copy_(0, f, c[None])
            valid.index_copy_(0, f, v[None])
            f.add_(1)

        frame_fn = (self.graphs.get_or_capture(key, frame, self.device,
                                               state.generator, buffers)
                    if graphs_allowed(self.mesh) else frame)

        counts = self._moe_counts()

        def chunk():
            f.zero_()
            if counts is not None:
                counts.zero_()
            for _ in range(CHUNK_FRAMES):
                frame_fn()
            return codes, valid

        return chunk

    def enqueue_chunk(self, state, consts, buffers: int, read_ctx: int,
                      p: TTSParams, ring: bool = False) -> ChunkCopies:
        """Enqueue one generation chunk (``_gen_fn`` at read_ctx, sampling
        as `p` says) and, before any later chunk, the copies home of its
        (codes, valid, done), on a mesh gathered over dp so that every
        rank holds the whole batch, and of an MoE talker's counters."""
        t0 = time.monotonic_ns()
        codes, valid = self._gen_fn(state, consts, buffers, read_ctx,
                                    p.top_k, p.temperature <= 0.0, p.top_p,
                                    ring)()
        done = state.done
        if self.mesh is not None:
            codes, valid, done = gather_chunk(self.mesh, codes, valid, done)
        return ChunkCopies(codes, valid, done, self._moe_counts(), t0)

    def _moe_counts(self) -> torch.Tensor | None:
        """The sparse-MoE talker's counters [L, 3] (``from_components``),
        else None."""
        if self.talker_w is None:
            return None
        return self.talker_w["layers"].get("moe_counts")

    def _dp_split(self, B: int) -> tuple[int, int, int]:
        """(rows, lo, hi): a batch of B streams padded to a multiple of dp
        and this rank's rows [lo, hi) of it; (B, 0, B) unsharded. Rank 0
        says so on stderr where it pads."""
        if self.mesh is None:
            return B, 0, B
        dp = mesh_dims(self.mesh)[0]
        rows = -(-B // dp) * dp
        if rows != B and torch.distributed.get_rank() == 0:
            _log(f"[shard] batch {B} not divisible by dp={dp}: padded with "
                 f"{rows - B} inactive stream(s) to {rows}")
        return (rows, *dp_rows(self.mesh, rows))

    def _lockstep_state(self, prefill, max_ctx: int, p: TTSParams,
                        generator, active=None):
        """(state, consts, buffers id) of one lock-step call. With
        QWEN3_TTS_AOT on (the default), static buffers refilled in place,
        so that the graphs over them replay and no second KV cache is
        made: the last call's, when its shape (B, max_ctx, trailing rows,
        KV dtype) is this one's, else new ones, and the old buffers and
        their graphs are dropped (one KV cache is held between calls, not
        one per batch shape). Their draws come from the engine's own
        generator, which takes `generator`'s state here and gives it back
        after the call. With QWEN3_TTS_AOT=0, new ones each call. active:
        [B] bool, the streams that hold a text (None: all)."""
        cfg, kv_quant = self.talker_cfg, kv_quant_enabled()
        if not aot_enabled():
            return (init_state(self.talker_w, cfg, prefill, max_ctx,
                               generator, active=active, kv_quant=kv_quant),
                    make_consts(prefill, p.temperature,
                                p.repetition_penalty), 0)
        if self._graph_gen is None:
            self._graph_gen = torch.Generator(device=self.device)
        gen = self._graph_gen
        gen.set_state(generator.get_state())
        shape = (prefill.prefill_embd.shape[0], max_ctx,
                 prefill.trailing_hidden.shape[1], kv_quant)
        old = self._lockstep
        if old is not None and old[0] != shape:
            self.graphs.release(old[3])
            self._chunk_bufs = {k: v for k, v in self._chunk_bufs.items()
                                if k[0] != old[3]}
            old = self._lockstep = None
        state = init_state(self.talker_w, cfg, prefill, max_ctx, gen,
                           active=active, kv_quant=kv_quant,
                           into=old and old[1])
        consts = make_consts(prefill, p.temperature, p.repetition_penalty,
                             into=old and old[2])
        bufs = old[3] if old else new_buffer_id()
        self._lockstep = (shape, state, consts, bufs)
        return state, consts, bufs

    def _voc_fn(self, n: int, frames: int, sub: int | None, pcm16: bool):
        """(codes buffer [n, frames, n_codebooks] int32 on the device, a
        callable decoding it with the causal trim): the graph of the
        bucket on the card. Low-memory mode stages the weights per decode
        and stays eager."""
        mkey = (n, frames, sub, pcm16)
        if mkey not in self._voc_bufs:
            codes = torch.zeros(n, frames, self.voc_cfg.n_codebooks,
                                dtype=torch.int32, device=self.device)

            def decode():
                return vocoder.vocoder_decode_subbatched(
                    self._vocoder_weights(), self.voc_cfg, codes,
                    trim="causal", pcm16=pcm16, sub=sub or n)

            self._voc_bufs[mkey] = (codes, decode)
        codes, decode = self._voc_bufs[mkey]
        if self.low_mem:
            return codes, decode
        key = voc_key(model_tag=self.model_tag(), n=n, frames=frames,
                      sub=sub, pcm16=pcm16,
                      res_impl=vocoder._resolve_impl(), device=self.device,
                      sin2=vocoder.snake_sin2_impl(), mesh=self._mesh_key())
        return codes, self.graphs.get_or_capture(key, decode, self.device)

    def _vocoder_weights(self):
        """The vocoder's weights on the engine's device. In low-memory
        mode, copies of the pinned host tensors for this decode: copied on
        the current stream ahead of the decode's kernels, and freed to the
        caching allocator, stream-ordered, once the caller drops them. The
        host tensors belong to the engine, so they outlive every copy."""
        if not self.low_mem:
            return self.voc_w
        return _tree_map(lambda t: t.to(self.device, non_blocking=True),
                         self.voc_w)
