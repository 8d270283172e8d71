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

Dispatch is pipelined, as in the JAX loop: chunk k+1 is enqueued before
the host reads chunk k's codes and runs its vocoder decode, so the card's
queue holds the next chunk while the host does its per-stream
bookkeeping. The read window comes from the frames dispatched so far,
counted on the host, so no readback lands between two dispatches; a
chunk's codes, valid mask and ``done`` leave the card through ``Readback``
(a non-blocking copy into pinned host memory whose end a CUDA event
marks), taken in stream order right after the chunk, before the next
chunk overwrites them, and the host waits only for chunk k's copies. The
vocoder's codes go up from pinned memory without blocking, so that its
decode queues behind chunk k+1 instead of waiting for it.

Audio leaves the card as int16 PCM through ``readback_submit``, another
``Readback``. ``PCMRef`` names one stream's row of such a copy and
resolves it lazily.

Without a vocoder (``from_components(..., voc_w=None)``) the engine still
generates codes; each stream then reports "Vocoder not loaded", as in the
JAX package.

Compiled executables (runtime/graphs.py, the port of the JAX package's
AOT cache): on the card each frame of a 40-frame lock-step chunk replays
the CUDA graph of its bucket (``_gen_fn``) over static state buffers,
prefilled in place and kept for the last batch shape, and each vocoder
decode replays the graph of its (n, frames, sub, pcm16) bucket
(``_voc_fn``); both are captured on first use into ``Qwen3TTS.graphs``.
A replay overwrites the buffers the last one wrote, which is why the
chunk's copies are taken in stream order before the next replay.
``QWEN3_TTS_AOT=0`` runs them eagerly, as the CPU does.

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

from ..config import SpeakerEncoderConfig, TalkerConfig, VocoderConfig
from ..io.gguf import GGUFReader, HostStager
from ..models import code_predictor
from ..models import speaker_encoder as spk
from ..models import talker, vocoder
from ..models import weights as W
from ..models.stack import QuantKV
from ..ops.attention import get_decode_attention_impl
from ..parallel.mesh import (dp_rows, gather_chunk, gather_objects,
                             graphs_allowed, mesh_dims, rank_seed,
                             shard_talker_weights)
from ..tokenizer import TextTokenizer
from ..utils.trace import StageTimer, memory_snapshot, profile_trace
from . import audio_io
from .generate import (ctx_bucket, generate_frame, init_state,
                       kv_quant_enabled, make_consts, required_ctx)
from .graphs import GraphCache, aot_enabled, gen_key, new_buffer_id, voc_key

TTS_FILE = "qwen3-tts-0.6b-f16.gguf"
CODEC_FILE = "qwen3-tts-tokenizer-f16.gguf"
CHUNK_FRAMES = 40  # streaming vocoder interval


class Readback:
    """A device -> host copy in flight. A CUDA tensor is copied
    non-blocking into pinned host memory and an event marks the copy's
    end: done() polls the event, result() waits on it. A CPU tensor is
    copied at once."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()
            self.event = None

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class PCMRef:
    """One stream's row of a batch audio readback still in flight: the
    whole [nb, T] int16 copy, this stream's row and its valid sample
    count. One copy serves every stream of the batch."""

    __slots__ = ("fut", "row", "valid")

    def __init__(self, fut: Readback, row: int, valid: int | None = None):
        self.fut = fut
        self.row = row
        self.valid = valid

    def resolve(self) -> np.ndarray:
        arr = self.fut.result()[self.row]
        return arr[:self.valid] if self.valid is not None else arr


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
    streaming_vocoder: bool = True   # 40-frame chunked decode


@dataclass
class TTSResult:
    audio: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    sample_rate: int = 24000
    success: bool = False
    error_msg: str = ""
    n_frames: int = 0
    t_tokenize_ms: float = 0.0
    t_encode_ms: float = 0.0    # synthesize_with_voice: the speaker encode
    t_generate_ms: float = 0.0
    t_decode_ms: float = 0.0
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
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _first_leaf(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return next((x for x in map(_first_leaf, tree) if x is not None),
                    None)
    return tree


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
        self.talker_w = talker_w
        self.voc_cfg = voc_cfg
        self.voc_w = voc_w
        self.device = None if device is None else torch.device(device)
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
                        device, spk_cfg=None, spk_w=None) -> "Qwen3TTS":
        """Assemble an engine from in-memory components whose tensors
        already live on `device`; the vocoder kernels' parameters are
        packed here, once. voc_w=None: an engine without a vocoder
        (module docstring)."""
        if voc_w is not None:
            voc_w = vocoder.pack_kernel_weights(voc_w)
        return cls(tokenizer, talker_cfg, talker_w, voc_cfg, voc_w, device,
                   spk_cfg, spk_w)

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
        self.tokenizer, self.talker_cfg, self.talker_w = (
            tokenizer, talker_cfg, talker_w)
        self.voc_cfg, self.voc_w = voc_cfg, voc_w
        self.spk_cfg = self.spk_w = None
        self.device, self.low_mem = dev, low_mem
        self.mesh = None
        self._drop_graphs()    # they hold the old weights' addresses
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
        torch.profiler trace of the call (utils/trace.py)."""
        with profile_trace("synthesize_batch"):
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
        t_total0 = _now_ms()
        timer = StageTimer()

        with timer.stage("Tokenization"):
            token_lists = [self.tokenizer.encode_for_tts(t) for t in texts]
        t_tok = timer.stages["Tokenization"]
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

        t0 = _now_ms()
        with torch.inference_mode():
            prefill = talker.build_prefill_inputs(
                self.talker_w, cfg, torch.as_tensor(tokens[lo:hi], device=dev),
                torch.as_tensor(lens[lo:hi], device=dev),
                torch.as_tensor(spk_emb[lo:hi], device=dev),
                language_id=torch.full((hi - lo,), p.language_id,
                                       dtype=torch.int32, device=dev))
            prefill_len = prefill.prefill_embd.shape[1]
            max_ctx = required_ctx(prefill_len, p.max_audio_tokens,
                                   CHUNK_FRAMES)
            state, consts, bufs = self._lockstep_state(prefill, max_ctx, p,
                                                       generator, active)

            frames: list[list[np.ndarray]] = [[] for _ in range(B)]
            audio_parts: list[list[np.ndarray]] = [[] for _ in range(B)]
            t_decode = 0.0
            n_chunks = -(-p.max_audio_tokens // CHUNK_FRAMES)
            greedy = p.temperature <= 0.0
            steps_dispatched = 0

            def dispatch():
                """Enqueue one chunk and the copies of its (codes, valid,
                done), in stream order, before any later chunk."""
                nonlocal steps_dispatched
                # every stream's n_past is at most prefill + frames so far
                read_ctx = ctx_bucket(prefill_len + steps_dispatched,
                                      CHUNK_FRAMES, max_ctx)
                steps_dispatched += CHUNK_FRAMES
                codes, valid = self._gen_fn(state, consts, bufs, read_ctx,
                                            p.top_k, greedy, p.top_p)()
                done = state.done
                if self.mesh is not None:   # the whole batch, every rank
                    codes, valid, done = gather_chunk(self.mesh, codes,
                                                      valid, done)
                return tuple(Readback(t) for t in (codes, valid, done))

            # module docstring: chunk k+1 is enqueued as soon as chunk k's
            # `done` is home, before chunk k's codes are read and decoded
            inflight, n_dispatched = dispatch(), 1
            while inflight is not None:
                codes_r, valid_r, done_r = inflight
                inflight = None
                if n_dispatched < n_chunks and not done_r.result().all():
                    inflight, n_dispatched = dispatch(), n_dispatched + 1
                codes_h = codes_r.result()               # [chunk, B, 16]
                valid_h = valid_r.result()               # [chunk, B]
                for b in range(B):
                    got = codes_h[valid_h[:, b], b]
                    have = sum(len(f) for f in frames[b])
                    got = got[:p.max_audio_tokens - have]
                    if len(got):
                        frames[b].append(got)
                if p.streaming_vocoder and self.voc_w is not None:
                    td0 = _now_ms()
                    self._decode_streaming(frames, audio_parts, on_chunk,
                                           rows)
                    t_decode += _now_ms() - td0
            if state.generator is not generator:
                generator.set_state(state.generator.get_state())
            t_gen = _now_ms() - t0 - t_decode

            td0 = _now_ms()
            for b in range(B):
                if b in bad:
                    continue
                fr = (np.concatenate(frames[b]) if frames[b]
                      else np.zeros((0, cfg.n_codebooks), np.int32))
                results[b].n_frames = len(fr)
                if len(fr) == 0:
                    results[b].error_msg = "No speech codes generated"
                    continue
                if self.voc_w is None:
                    results[b].error_msg = "Vocoder not loaded"
                    continue
                results[b].sample_rate = self.voc_cfg.sample_rate
                results[b].success = True
                if b not in rows:
                    continue          # another dp rank's stream
                if p.streaming_vocoder:
                    self._flush_streaming(b, frames, audio_parts, on_chunk,
                                          len(rows))
                    results[b].audio = self._pcm_parts_to_f32(audio_parts[b])
                else:
                    results[b].audio = self.decode_codes(fr)
            if self.mesh is not None:
                for part in gather_objects(self.mesh, {
                        b: results[b].audio for b in rows}):
                    for b, audio in part.items():
                        results[b].audio = audio
            _sync(dev)
            t_decode += _now_ms() - td0

        timer.add("Code generation", t_gen)
        timer.add("Vocoder decode", t_decode)
        rss = memory_snapshot()["rss_peak_bytes"]
        dev_mem = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
        for r in results:
            r.t_tokenize_ms = t_tok
            r.t_generate_ms = t_gen
            r.t_decode_ms = t_decode
            r.t_total_ms = _now_ms() - t_total0
            r.mem_rss_peak_bytes = rss
            r.device_mem_bytes = dev_mem
        if p.print_timing and results[0].success:
            timer.report(audio_seconds=sum(len(x.audio) for x in results)
                         / results[0].sample_rate)
            _log(f"  Streams:         {len(results)}")
            _log(f"  RSS peak:        {rss / 2**20:.0f} MB; "
                 f"device mem peak: {dev_mem / 2**20:.0f} MB")
        return results

    # -- vocoder paths -------------------------------------------------------
    def decode_codes(self, frames: np.ndarray,
                     trim: str = "both") -> np.ndarray:
        """Full-sequence decode of [F, 16] codes."""
        codes = torch.as_tensor(frames[None], dtype=torch.int32,
                                device=self.device)
        with torch.inference_mode():
            audio = vocoder.vocoder_decode(self._vocoder_weights(),
                                           self.voc_cfg, codes, trim)
        return audio[0].cpu().numpy()

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
        int16 PCM as a tensor on the engine's device, for readback_submit;
        otherwise host f32."""
        n = len(codes)
        sub = self.voc_sub(n, max_batch)
        with torch.inference_mode():
            buf, decode = self._voc_fn(n, codes.shape[1], sub, pcm16)
            host = torch.from_numpy(np.ascontiguousarray(codes, np.int32))
            if buf.is_cuda:
                # from pageable memory the copy would wait for every chunk
                # queued ahead (module docstring); a pinned block from the
                # caching host allocator stays alive until the copy is done
                buf.copy_(host.pin_memory(), non_blocking=True)
            else:
                buf.copy_(host)
            audio = decode()
            return audio if pcm16 else audio.cpu().numpy()

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
            self._model_tag = hashlib.md5(src.encode()).hexdigest()[:8]
        return self._model_tag

    def _gen_fn(self, state, consts, buffers: int, read_ctx: int,
                top_k: int, greedy: bool, top_p: float, ring: bool = False):
        """The generation chunk over `state` and `consts` (static
        buffers, owner id `buffers`) at one read_ctx bucket: a callable
        returning (codes [chunk, B, 16], valid [chunk, B]), buffers of
        this key that the next chunk overwrites, so a caller takes their
        copies (``Readback``) in stream order before it enqueues another.
        A chunk is CHUNK_FRAMES calls of the frame's graph on the card
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

        def chunk():
            f.zero_()
            for _ in range(CHUNK_FRAMES):
                frame_fn()
            return codes, valid

        return chunk

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

    def readback_submit(self, dev_audio: torch.Tensor) -> Readback:
        """Start ONE whole-batch [nb, T] copy to the host; returns it."""
        return Readback(dev_audio)

    @staticmethod
    def _pcm_parts_to_f32(parts) -> np.ndarray:
        """Resolve deferred chunk readbacks -> one host f32 waveform
        (value = i / 32767, inverting the vocoder's pcm16)."""
        if not parts:
            return np.zeros(0, np.float32)
        rows = [p.resolve() if isinstance(p, PCMRef) else np.asarray(p)
                for p in parts]
        return np.concatenate(rows).astype(np.float32) / 32767.0

    @staticmethod
    def _pcm_to_f32(part) -> np.ndarray:
        part = part.resolve() if isinstance(part, PCMRef) else np.asarray(part)
        return part.astype(np.float32) / 32767.0

    @staticmethod
    def _slice_pieces(pieces, start: int, count: int) -> np.ndarray:
        """Rows [start, start + count) of the concatenation of `pieces`,
        without concatenating a stream's whole history every wave."""
        out, seen, end = [], 0, start + count
        for arr in pieces:
            a0, a1 = seen, seen + len(arr)
            seen = a1
            if a1 <= start:
                continue
            if a0 >= end:
                break
            out.append(arr[max(0, start - a0):end - a0])
        return out[0] if len(out) == 1 else np.concatenate(out)

    def _decode_streaming(self, frames, audio_parts, on_chunk,
                          rows: range) -> None:
        """Decode every stream of `rows` holding a full undecoded 40-frame
        chunk, as one [n, 40] vocoder batch per wave; the audio stays on
        the device until a consumer resolves it."""
        n_cb = self.talker_cfg.n_codebooks
        while True:
            ready = []
            for b in rows:
                total = sum(len(f) for f in frames[b])
                done = len(audio_parts[b]) * CHUNK_FRAMES
                if total - done >= CHUNK_FRAMES:
                    ready.append((b, self._slice_pieces(frames[b], done,
                                                        CHUNK_FRAMES)))
            if not ready:
                return
            nb = self.voc_bucket(len(ready), len(rows))
            batch = np.zeros((nb, CHUNK_FRAMES, n_cb), np.int32)
            for i, (_, part) in enumerate(ready):
                batch[i] = part
            fut = self.readback_submit(
                self._decode_chunk_batch(batch, pcm16=True))
            for i, (b, _) in enumerate(ready):
                ref = PCMRef(fut, i)
                audio_parts[b].append(ref)
                if on_chunk:
                    on_chunk(b, self._pcm_to_f32(ref))

    def _flush_streaming(self, b, frames, audio_parts, on_chunk,
                         n_rows: int) -> None:
        """Decode the ragged tail (< 40 frames) of stream b, zero-padded
        to the fixed chunk, in the smallest bucket of a batch of
        `n_rows` streams."""
        if not frames[b]:
            return
        full = np.concatenate(frames[b])
        done = len(audio_parts[b]) * CHUNK_FRAMES
        if done >= len(full):
            return
        part = full[done:]
        nb = self.voc_bucket(1, n_rows)
        batch = np.zeros((nb, CHUNK_FRAMES, full.shape[1]), np.int32)
        batch[0, :len(part)] = part
        valid = vocoder.vocoder_output_length(self.voc_w, self.voc_cfg,
                                              len(part), trim="causal")
        ref = PCMRef(self.readback_submit(
            self._decode_chunk_batch(batch, pcm16=True)), 0, valid)
        audio_parts[b].append(ref)
        if on_chunk:
            on_chunk(b, self._pcm_to_f32(ref))
