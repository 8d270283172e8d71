"""The chunk loop's core, shared by the lock-step call
(``Qwen3TTS.synthesize_batch``) and the serving batcher
(``ContinuousBatcher.step``): each chunk's copies home (``ChunkCopies``)
are taken before the next chunk overwrites its buffers, chunk k+1 is
enqueued (``Qwen3TTS.enqueue_chunk``) before chunk k's audio is decoded,
each stream's codes are kept in a ``StreamCodes``, and ready chunks decode
in vocoder waves (``decode_wave``) whose codes go up from pinned memory
without blocking, so that a wave queues behind chunk k+1. Callers deliver
a wave's audio in row order before the next wave's decode.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..models import vocoder
from ..utils import trace

CHUNK_FRAMES = 40  # streaming vocoder interval


class Readback:
    """A device -> host copy in flight: non-blocking into pinned memory
    with an event at its end (a CPU tensor is copied at once). done()
    polls; result() waits, in a ``host.wait`` span (``what``: codes, done
    or audio) if the copy has not landed."""

    __slots__ = ("host", "event", "what")

    def __init__(self, t: torch.Tensor, what: str = "codes"):
        self.what = what
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
        if self.event is not None and not self.event.query():
            with trace.span("host.wait", what=self.what):
                self.event.synchronize()
        return self.host.numpy()


class ChunkCopies:
    """One chunk's (codes [chunk, B, n_cb], valid [chunk, B], done [B])
    and a sparse-MoE talker's counters [L, 3] (ops/moe.py) on their way
    home, from the chunk's dispatch at ``t0`` (ns)."""

    __slots__ = ("codes", "valid", "done", "moe", "t0")

    def __init__(self, codes: torch.Tensor, valid: torch.Tensor,
                 done: torch.Tensor, moe_counts: torch.Tensor | None, t0: int):
        self.codes = Readback(codes, "codes")
        self.valid = Readback(valid, "codes")
        self.done = Readback(done, "done")
        self.moe = None if moe_counts is None else Readback(moe_counts)
        self.t0 = t0

    def take(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host (codes, valid, done), waited for; MoE counters become the
        span ``talker.moe`` (pairs and rows summed over the layers,
        max_rows their max; on the expert-parallel path also ``zero``, the
        pairs routed to identity experts, and ``remote``, those routed to
        experts held elsewhere) and the counters ``moe.pairs`` /
        ``moe.rows`` (and ``moe.zero_pairs`` / ``moe.remote_pairs``)."""
        out = tuple(r.result() for r in (self.codes, self.valid, self.done))
        if self.moe is not None:
            c = self.moe.result()
            sums = dict(pairs=int(c[:, 0].sum()), rows=int(c[:, 1].sum()))
            if c.shape[1] > 3:
                sums.update(zero=int(c[:, 3].sum()),
                            remote=int(c[:, 4].sum()))
            trace.add("talker.moe", self.t0, time.monotonic_ns(),
                      max_rows=int(c[:, 2].max()), **sums)
            for name, counter in (("pairs", "moe.pairs"), ("rows", "moe.rows"),
                                  ("zero", "moe.zero_pairs"),
                                  ("remote", "moe.remote_pairs")):
                if name in sums:
                    trace.count(counter, sums[name])
        return out


class PCMRef:
    """One stream's row of a wave's [nb, T] int16 audio readback, and its
    valid sample count (None: all T)."""

    __slots__ = ("fut", "row", "valid")

    def __init__(self, fut: Readback, row: int, valid: int | None = None):
        self.fut = fut
        self.row = row
        self.valid = valid

    def __len__(self) -> int:
        return self.fut.host.shape[1] if self.valid is None else self.valid

    def to_f32(self, out: np.ndarray | None = None) -> np.ndarray:
        """The samples as f32, i / 32767 (inverting the vocoder's pcm16),
        waited for; written into `out` when given."""
        return np.divide(self.fut.result()[self.row][:len(self)], 32767.0,
                         out=out, dtype=np.float32)


class StreamCodes:
    """One stream's codes on the host and its audio: ``buf`` [rows,
    n_codebooks] (``cap`` frames rounded up to whole chunks, zeros past
    ``n_frames``), ``n_decoded`` frames handed to the vocoder, ``audio`` a
    PCMRef a decoded chunk."""

    __slots__ = ("buf", "cap", "n_frames", "n_decoded", "audio")

    def __init__(self, buf: np.ndarray, cap: int):
        self.buf, self.cap = buf, cap
        self.n_frames = self.n_decoded = 0
        self.audio: list[PCMRef] = []

    @classmethod
    def alloc(cls, n: int, cap: int, n_codebooks: int) -> list[StreamCodes]:
        """n streams of `cap` frames, views of one zeroed array."""
        rows = -(-cap // CHUNK_FRAMES) * CHUNK_FRAMES
        return [cls(buf, cap)
                for buf in np.zeros((n, rows, n_codebooks), np.int32)]

    def take(self, codes: np.ndarray, valid: np.ndarray, b: int) -> int:
        """Append stream b's valid frames of a chunk's host codes and valid
        mask, cut at the cap; returns how many."""
        got = codes[valid[:, b], b][:self.cap - self.n_frames]
        self.buf[self.n_frames:self.n_frames + len(got)] = got
        self.n_frames += len(got)
        return len(got)

    def next_chunk(self, final: bool = False
                   ) -> tuple[np.ndarray, int] | None:
        """(the next CHUNK_FRAMES undecoded frames, their count), now
        counted as decoded; with `final`, a shorter tail too, zero-padded
        to the chunk. None when none is ready."""
        k = min(self.n_frames - self.n_decoded, CHUNK_FRAMES)
        if k < CHUNK_FRAMES and not (final and k > 0):
            return None
        at, self.n_decoded = self.n_decoded, self.n_decoded + k
        return self.buf[at:at + CHUNK_FRAMES], k

    def waveform(self, room: int = 0) -> np.ndarray:
        """The decoded audio as one host f32 waveform, followed by `room`
        samples left for the caller to write."""
        out = np.empty(sum(map(len, self.audio)) + room, np.float32)
        at = 0
        for r in self.audio:
            r.to_f32(out[at:at + len(r)])
            at += len(r)
        return out


def decode_wave(engine, parts: list[tuple[np.ndarray, int]], n_rows: int,
                span: str, max_batch: int | None = None,
                deliver: Callable[[int, PCMRef], None] | None = None
                ) -> list[PCMRef]:
    """One vocoder wave of `parts` ((codes [CHUNK_FRAMES, n_cb], frames)
    a chunk, ``StreamCodes.next_chunk``'s) on `engine`: one batch of
    ``voc_bucket(len(parts), n_rows)`` rows, one ``_decode_chunk_batch``
    call (int16 PCM, sub-batches of at most max_batch) and one readback,
    inside the span `span` (``rows``, ``bucket``). Returns a PCMRef a
    chunk in row order, a tail's trimmed to its frames; resolves none, but
    runs deliver(i, ref), when given, for each in row order in the span."""
    nb = engine.voc_bucket(len(parts), n_rows)
    with trace.span(span, rows=len(parts), bucket=nb):
        batch = np.zeros((nb, CHUNK_FRAMES, engine.talker_cfg.n_codebooks),
                         np.int32)
        for i, (codes, _) in enumerate(parts):
            batch[i] = codes
        fut = Readback(engine._decode_chunk_batch(
            batch, pcm16=True, max_batch=max_batch), "audio")
        refs = [PCMRef(fut, i, None if k == CHUNK_FRAMES else
                       vocoder.vocoder_output_length(
                           engine.voc_w, engine.voc_cfg, k, trim="causal"))
                for i, (_, k) in enumerate(parts)]
        if deliver:
            for i, ref in enumerate(refs):
                deliver(i, ref)
    return refs
