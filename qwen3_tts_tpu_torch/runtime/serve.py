"""Continuous-batching serving engine (port of
qwen3_tts_tpu/runtime/serve.py, ring-slot cache).

A fixed pool of B stream slots generates in 40-frame chunks; finished
slots take new requests at chunk boundaries (admission waits at most one
chunk) while the other streams keep producing audio. All streams write the
shared ring slot of the KV cache (runtime/generate.py, ring mode), and
decode attention reads each stream's bitmask inside its lifetime window
(ops/flash_decode.py on the card).

The chunk loop runs on the core that the lock-step call shares
(runtime/stream.py): the next chunk is enqueued before this chunk's codes
are decoded, so the host waits on the card only where it needs a value.
On an engine without a vocoder the slots generate codes and return no
audio.

Failure isolation covers host-side failures: a poisoned text or
embedding, or a raising on_audio callback, fails its request only; any
other exception inside a step fails the in-flight requests, rebuilds the
device state and keeps serving the queue. A CUDA device-side fault (an
illegal address, a trapped kernel) poisons the CUDA context of the
process: the rebuild then fails too, and only a new process recovers.

Compiled executables (runtime/graphs.py): on the card each chunk replays
its read_ctx bucket's CUDA graph over the batcher's state, which
``_reset_state`` and ``_fail_inflight`` rebuild in place; ``warmup()``
captures every bucket before traffic arrives. Admission and park run once
per request and stay eager.

On a sharded engine (``Qwen3TTS.shard``) n_slots must be a multiple of dp
(ValueError otherwise; the JAX package's fallback to GSPMD propagation
has no counterpart). Each rank holds the device state of its n_slots / dp
slots; the host scheduler (queue, free slots, admissions, park, retire,
finalize) runs the same on every rank over the global slot table, fed by
each chunk's copies gathered over dp (``Qwen3TTS.enqueue_chunk``). A slot
is admitted, parked and decoded by the rank that owns it; at each step
with retirements the ranks exchange the finished results over dp (the
retired slots' audio copies are waited for there), so that ``run_all``
returns the same results on every rank, and ``on_audio`` fires on the
owning ranks. A failure inside a step on some ranks only is not
coordinated: the isolation above holds where every rank sees the failure
alike (a bad request).

Spans (utils/trace.py): a ``serve.step`` a step (``busy`` slots at its
dispatch, ``slots``), inside it ``serve.admit`` (``admitted``),
``serve.dispatch``, a ``serve.decode`` a vocoder wave (``rows``,
``bucket``) and ``serve.finalize`` (``finalized``); per request, under
its id, ``req.queue`` (submit to admission; ``t_queue_ms`` is its
length), ``req.first_codes`` (admission to its first chunk's codes on the
host) and ``req.first_audio`` (admission to its first ``on_audio`` call
with samples); ``serve.warmup``.

Not ported: the per-step timing print and the per-stream scatter mode
(``QWEN3_TTS_RING=0``, which raises NotImplementedError here).
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models import talker
from ..parallel.mesh import dp_rows, gather_objects, mesh_dims, rank_seed
from ..utils import trace
from .generate import (RING_PREFILL_SLOTS, admit_slots, ctx_bucket,
                       init_state, kv_quant_enabled, make_consts, park_slot,
                       required_ctx_ring)
from .graphs import new_buffer_id
from .pipeline import Qwen3TTS, TTSParams, TTSResult
from .stream import CHUNK_FRAMES, PCMRef, StreamCodes, decode_wave


@dataclass
class _Slot:
    busy: bool = False
    request_id: int = -1
    codes: StreamCodes | None = None   # its codes and the audio made of them
    t_start: int = 0           # admission, ns (time.monotonic_ns)
    t_queue_ms: float = 0.0    # submit -> admission wall time
    on_audio: Callable[[np.ndarray, bool], None] | None = None
    final_sent: bool = False   # a final=True on_audio callback fired
    first_audio_sent: bool = False   # an on_audio call carried samples
    error: str = ""


class ContinuousBatcher:
    """Slot-based continuous batching over the ring-mode generation chunk.

    Usage:
        cb = ContinuousBatcher(engine, n_slots=16, params=TTSParams(...))
        rid = cb.submit("hello world.", embedding=None)
        while cb.pending():
            done = cb.step()          # one 40-frame chunk for all slots
            for rid, result in done.items(): ...
    """

    def __init__(self, engine: Qwen3TTS, n_slots: int = 16,
                 params: TTSParams | None = None,
                 max_frames: int = 1024, trailing_buf: int = 256):
        if os.environ.get("QWEN3_TTS_RING", "1") == "0":
            raise NotImplementedError(
                "QWEN3_TTS_RING=0 (per-stream scatter KV writes) is not "
                "ported; the port serves with the ring-slot cache only")
        self.engine = engine
        self.params = params or TTSParams()
        self.n_slots = n_slots
        self.mesh = engine.mesh
        dp = mesh_dims(self.mesh)[0]
        if n_slots % dp:
            raise ValueError(f"n_slots={n_slots} is not a multiple of dp={dp}"
                             f" of the engine's mesh")
        # this rank's slots [lo, lo + n_local) of the global slot table
        self.lo = dp_rows(self.mesh, n_slots)[0]
        # the per-request cap (params.max_audio_tokens) binds as well
        self.max_frames = min(max_frames, self.params.max_audio_tokens)
        self.trailing_buf = trailing_buf
        self.cfg = engine.talker_cfg
        self.device = engine.device
        self.slots = [_Slot() for _ in range(n_slots)]
        # (id, text, embedding, on_audio, submit time in ns)
        self._queue: list[tuple[int, str, np.ndarray | None,
                                Callable | None, int]] = []
        self._next_id = 0
        self._failed: dict[int, TTSResult] = {}
        self._retiring: list[_Slot] = []
        # retired slots whose audio copies are still in flight: a later
        # step() emits their results once the copies have landed
        self._finalizing: list[_Slot] = []
        self._busy_at_dispatch = 0   # busy slots at this step's dispatch
        self.ctx = required_ctx_ring(max_frames, CHUNK_FRAMES)
        # vocoder decode cap, local to this batcher (passed per call): the
        # talker cache and an in-flight chunk share the card with it
        n = self.n_local
        self.voc_max_batch = (48 if n <= 96 else 32 if n <= 128 else
                              16 if n <= 192 else 8)
        self._buffers = new_buffer_id()   # names this state in graph keys
        self.state = self.consts = None
        self._reset_state()

    def _reset_state(self) -> None:
        """(Re)build the device state of this rank's slots: dummy prefill,
        every slot parked. After the first build, into the same buffers
        (and the same generator, reseeded), which the captured graphs
        read and write."""
        cfg, n = self.cfg, self.n_local
        dev = self.device
        with torch.inference_mode():
            prefill = talker.build_prefill_inputs(
                self.engine.talker_w, cfg,
                torch.zeros(n, 16, dtype=torch.int32, device=dev),
                torch.full((n,), 16, dtype=torch.int32, device=dev),
                torch.zeros(n, cfg.hidden_size, device=dev))
            prefill = prefill._replace(
                trailing_hidden=self._pad_trailing(prefill.trailing_hidden))
            self._steps_done = 0
            self._inflight = None   # a dispatched chunk's ChunkCopies
            # a prefill past the reserved region would put write_slot past
            # RING_PREFILL_SLOTS and the ring wrap would overwrite live
            # prefill rows
            P = prefill.prefill_embd.shape[1]
            if P > RING_PREFILL_SLOTS:
                raise ValueError(f"prefill length {P} exceeds "
                                 f"RING_PREFILL_SLOTS {RING_PREFILL_SLOTS}")
            seed = self.params.seed if self.params.seed is not None else 0
            gen = (torch.Generator(device=dev) if self.state is None
                   else self.state.generator)
            self.state = init_state(
                self.engine.talker_w, cfg, prefill, self.ctx,
                gen.manual_seed(rank_seed(self.mesh, seed)),
                active=torch.zeros(n, dtype=torch.bool, device=dev),
                kv_quant=kv_quant_enabled(), into=self.state)
            self.consts = make_consts(prefill, self.params.temperature,
                                      self.params.repetition_penalty,
                                      into=self.consts)

    def warmup(self, token_buckets: tuple[int, ...] = (16,)) -> None:
        """Build everything the serving loop can hit before traffic, so
        that no request pays a first-use cost (the kernels' nvcc build
        included): admission at each of `token_buckets` (text-token
        counts round up to 16-multiples), through the trailing-buffer
        growth of the live path; park; the generation chunk at every
        read_ctx bucket the ring can reach; the vocoder at every decode
        bucket, int16 PCM as ``decode_wave`` calls it. On the card the
        chunks and the decodes are captured as CUDA graphs
        (runtime/graphs.py); admission and park stay eager. Then the
        state is rebuilt pristine, in place."""
        t0 = time.monotonic()
        cfg, dev, K = self.cfg, self.device, self.n_local
        gen_buckets, voc_sizes = self.warmup_buckets()
        with torch.inference_mode(), trace.span("serve.warmup"):
            for tb in token_buckets:
                tb = max(-(-tb // 16) * 16, 16)
                pf = talker.build_prefill_inputs(
                    self.engine.talker_w, cfg,
                    torch.zeros(K, tb, dtype=torch.int32, device=dev),
                    torch.full((K,), tb, dtype=torch.int32, device=dev),
                    torch.zeros(K, cfg.hidden_size, device=dev),
                    language_id=torch.full((K,), self.params.language_id,
                                           dtype=torch.int32, device=dev))
                self._ensure_trailing_capacity(pf.trailing_hidden.shape[1])
                pf = pf._replace(trailing_hidden=self._pad_trailing(
                    pf.trailing_hidden))
                admit_slots(self.engine.talker_w, cfg, self.state,
                            self.consts,
                            torch.zeros(K, dtype=torch.long, device=dev), pf)
            park_slot(self.state, 0)
            for rc in gen_buckets:
                self._gen_fn(rc)()
            if self.engine.voc_w is None:   # an engine without a vocoder
                voc_sizes = []
            # largest first: the smaller buckets' graphs then reuse its
            # blocks of the shared pool, which a larger one cannot
            for nb in reversed(voc_sizes):
                self.engine._decode_chunk_batch(
                    np.zeros((nb, CHUNK_FRAMES, cfg.n_codebooks), np.int32),
                    pcm16=True, max_batch=self.voc_max_batch)
            # the warm chunks advanced the ring: rebuild a pristine state
            self._reset_state()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.warmup_s = time.monotonic() - t0
        print(f"  Serving warmup: {len(gen_buckets)} gen bucket(s) + "
              f"{len(voc_sizes)} vocoder bucket(s) built in "
              f"{self.warmup_s:.1f} s", file=sys.stderr, flush=True)

    def warmup_buckets(self) -> tuple[list[int], list[int]]:
        """(read_ctx buckets the ring can reach, in the order the serving
        loop meets them; vocoder decode-batch sizes), as the JAX
        package's warmup walks them."""
        buckets: list[int] = []
        steps = 0
        while True:
            covered = RING_PREFILL_SLOTS + steps + CHUNK_FRAMES
            rc = ctx_bucket(min(covered, self.ctx), 0, self.ctx)
            if not buckets or rc != buckets[-1]:
                buckets.append(rc)
            if rc >= self.ctx:
                break
            steps += CHUNK_FRAMES
        sizes = sorted({self.engine.voc_bucket(n, self.n_local)
                        for n in range(1, self.n_local + 1)})
        return buckets, sizes

    def _gen_fn(self, read_ctx: int):
        """The ring-mode generation chunk at one read_ctx bucket
        (``Qwen3TTS._gen_fn``): returns (codes, valid) of the chunk."""
        p = self.params
        return self.engine._gen_fn(self.state, self.consts, self._buffers,
                                   read_ctx, p.top_k, p.temperature <= 0.0,
                                   p.top_p, ring=True)

    # ------------------------------------------------------------------
    def _ensure_trailing_capacity(self, n_rows: int) -> None:
        """Grow the shared trailing-text buffer to a power-of-two bucket
        covering n_rows, so that long texts are never cut. Rows past
        max_frames are never read (the frame cap retires the stream
        first), so capacity stops there."""
        n_rows = min(n_rows, self.max_frames)
        if n_rows <= self.trailing_buf:
            return
        new = self.trailing_buf
        while new < n_rows:
            new *= 2
        grow = new - self.trailing_buf
        self.trailing_buf = new
        self.consts.trailing_hidden = torch.nn.functional.pad(
            self.consts.trailing_hidden, (0, 0, 0, grow))

    def _pad_trailing(self, trailing: torch.Tensor) -> torch.Tensor:
        t = trailing.shape[1]
        if t < self.trailing_buf:
            return torch.nn.functional.pad(
                trailing, (0, 0, 0, self.trailing_buf - t))
        if t > self.trailing_buf and self.trailing_buf < self.max_frames:
            # only rows the frame cap makes unreachable may be dropped
            raise RuntimeError(
                f"trailing schedule ({t} rows) exceeds the buffer "
                f"({self.trailing_buf}) below max_frames ({self.max_frames})")
        return trailing[:, :self.trailing_buf]

    def submit(self, text: str, embedding: np.ndarray | None = None,
               on_audio: Callable[[np.ndarray, bool], None] | None = None,
               ) -> int:
        """Queue a request; returns its id. on_audio(samples, final) fires
        per decoded chunk. Submission only enqueues: every device action
        happens inside step(), under its failure isolation."""
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, text, embedding, on_audio,
                            time.monotonic_ns()))
        return rid

    def pending(self) -> bool:
        return (bool(self._queue) or any(s.busy for s in self.slots)
                or bool(self._finalizing))

    @property
    def n_local(self) -> int:
        """Slots whose device state this rank holds (n_slots / dp)."""
        return self.n_slots // mesh_dims(self.engine.mesh)[0]

    def _owns(self, b: int) -> bool:
        """Whether global slot b lives on this rank."""
        return self.lo <= b < self.lo + self.n_local

    def _admit_pending(self) -> None:
        """Admit every queued request that has a free slot, in ONE batched
        admit_slots call of K = n_local rows of this rank's admissions (pad
        rows repeat the last real one; a rank with none makes no call).
        Token arrays pad to 16-token buckets of the longest admitted
        text, as the trailing buffer grows, alike on every rank."""
        with trace.span("serve.admit") as sp:
            sp.set(admitted=self._admit())

    def _admit(self) -> int:
        """``_admit_pending``'s body; returns how many it admitted."""
        cfg, dev = self.cfg, self.device
        free = [i for i, s in enumerate(self.slots) if not s.busy]
        take = min(len(free), len(self._queue))
        if take == 0:
            return 0
        batch, token_lists = [], []
        while len(batch) < take and self._queue:
            item = self._queue.pop(0)
            try:  # a poisoned text or embedding fails its request only
                toks = self.engine.tokenizer.encode_for_tts(item[1])
                if item[2] is not None:
                    emb = np.asarray(item[2], np.float32).reshape(-1)
                    if emb.shape != (cfg.hidden_size,):
                        raise ValueError(
                            f"speaker embedding shape {emb.shape} != "
                            f"({cfg.hidden_size},)")
                    item = (item[0], item[1], emb, item[3], item[4])
                token_lists.append(toks)
                batch.append(item)
            except Exception as e:
                self._failed[item[0]] = self._error_result(
                    f"bad request: {type(e).__name__}: {e}")
        take = len(batch)
        if take == 0:
            return 0
        slot_ids = free[:take]

        t_max = max(-(-max(len(t) for t in token_lists) // 16) * 16, 16)
        # build_prefill_inputs's trailing rows for t_max tokens
        self._ensure_trailing_capacity(max(t_max - 8, 1))
        mine = [j for j in range(take) if self._owns(slot_ids[j])]
        if mine:
            K = self.n_local
            tokens = np.zeros((K, t_max), np.int32)
            lens = np.zeros((K,), np.int32)
            spk = np.zeros((K, cfg.hidden_size), np.float32)
            slots_arr = np.zeros((K,), np.int64)
            for j in range(K):
                src = mine[min(j, len(mine) - 1)]  # pads repeat the last
                toks = token_lists[src]
                tokens[j, :len(toks)] = toks
                lens[j] = len(toks)
                if batch[src][2] is not None:
                    spk[j] = batch[src][2]
                slots_arr[j] = slot_ids[src] - self.lo

            prefill = talker.build_prefill_inputs(
                self.engine.talker_w, cfg,
                torch.as_tensor(tokens, device=dev),
                torch.as_tensor(lens, device=dev),
                torch.as_tensor(spk, device=dev),
                language_id=torch.full((K,), self.params.language_id,
                                       dtype=torch.int32, device=dev))
            prefill = prefill._replace(
                trailing_hidden=self._pad_trailing(prefill.trailing_hidden))
            admit_slots(self.engine.talker_w, cfg, self.state, self.consts,
                        torch.as_tensor(slots_arr, device=dev), prefill)
        t_admit = time.monotonic_ns()
        for j in range(take):
            rid, _, _, on_audio, t_submit = batch[j]
            self.slots[slot_ids[j]] = _Slot(
                busy=True, request_id=rid, codes=StreamCodes.alloc(
                    1, self.max_frames, cfg.n_codebooks)[0],
                t_start=t_admit, on_audio=on_audio,
                t_queue_ms=(t_admit - t_submit) / 1e6)
            trace.add("req.queue", t_submit, t_admit, rid=rid)
        return take

    # ------------------------------------------------------------------
    def _dispatch_chunk(self) -> None:
        """Enqueue one 40-frame generation chunk and its copies home
        (``Qwen3TTS.enqueue_chunk``)."""
        self._busy_at_dispatch = sum(s.busy for s in self.slots)
        with trace.span("serve.dispatch"):
            # attention reads the prefill region + every ring slot written
            # so far (bucketed; the whole cache once the ring has wrapped),
            # known on the host without reading the device
            covered = RING_PREFILL_SLOTS + self._steps_done + CHUNK_FRAMES
            read_ctx = ctx_bucket(min(covered, self.ctx), 0, self.ctx)
            self._inflight = self.engine.enqueue_chunk(
                self.state, self.consts, self._buffers, read_ctx,
                self.params, ring=True)
            self._steps_done += CHUNK_FRAMES

    def step(self) -> dict[int, TTSResult]:
        """Process one 40-frame chunk across all slots; admit queued
        requests into freed slots, which join the next chunk; return
        results of finished requests. Failure isolation as in the module
        docstring."""
        self._busy_at_dispatch = 0
        with torch.inference_mode(), trace.span(
                "serve.step", slots=self.n_slots) as sp:
            try:
                out = self._step_impl()
            except Exception as e:
                out = self._fail_inflight(e)
            sp.set(busy=self._busy_at_dispatch)
        if self._failed:
            out = {**self._failed, **out}
            self._failed = {}
        return out

    def _error_result(self, msg: str, t_start: int | None = None
                      ) -> TTSResult:
        r = TTSResult(success=False, error_msg=msg)
        if t_start:
            r.t_total_ms = (time.monotonic_ns() - t_start) / 1e6
        return r

    def _fail_inflight(self, exc: Exception) -> dict[int, TTSResult]:
        """Fail every in-flight request and rebuild the device state in
        place, which cannot be trusted after a failure mid-step. Queued
        requests stay queued and admit on the next step."""
        traceback.print_exc(file=sys.stderr)
        msg = f"serving step failed: {type(exc).__name__}: {exc}"
        out: dict[int, TTSResult] = {}
        for slot in self._retiring:  # freed mid-step, not yet finalized
            out[slot.request_id] = self._error_result(msg, slot.t_start)
        self._retiring = []
        for b, slot in enumerate(self.slots):
            if slot.busy:
                out[slot.request_id] = self._error_result(msg, slot.t_start)
                self.slots[b] = _Slot()
        try:
            self._reset_state()
        except Exception:
            traceback.print_exc(file=sys.stderr)
        return out

    def _step_impl(self) -> dict[int, TTSResult]:
        if self._inflight is None:
            self._admit_pending()
            if not any(s.busy for s in self.slots):
                # nothing generating: only in-flight readbacks remain
                return self._drain_finalizing(block=True)
            self._dispatch_chunk()
        codes_h, valid_h, done_h = self._inflight.take()
        self._inflight = None

        live, retired = [], []
        self._retiring = retired  # visible to _fail_inflight: slots freed
        #                           below must still fail loudly if the
        #                           decode or finalize raises
        n_retired = 0
        for b, slot in enumerate(self.slots):
            if not slot.busy:
                continue
            sc = slot.codes
            got = sc.take(codes_h, valid_h, b)
            if got and sc.n_frames == got:
                trace.add("req.first_codes", slot.t_start,
                          time.monotonic_ns(), rid=slot.request_id)
            mine = self._owns(b)    # another rank's slot: bookkeeping only
            if bool(done_h[b]) or sc.n_frames >= sc.cap:
                if not bool(done_h[b]) and mine:
                    # retired by the frame cap, not EOS: stop the device
                    # stream so its cache position freezes
                    park_slot(self.state, b - self.lo)
                if mine:
                    retired.append(slot)
                n_retired += 1
                self.slots[b] = _Slot()  # free before admissions
            elif mine:
                live.append(slot)

        # admissions first so that freed slots join the very next chunk,
        # then enqueue that chunk BEFORE this chunk's vocoder decode
        self._admit_pending()
        if any(s.busy for s in self.slots):
            self._dispatch_chunk()
        self._decode_ready(live, retired)
        # retired slots wait for their audio copies; emit those (earlier
        # or current) whose copies have landed. Block only when no device
        # work is left to overlap with.
        self._finalizing.extend(retired)
        self._retiring = []
        if self.mesh is None:
            return self._drain_finalizing(
                block=not (any(s.busy for s in self.slots) or self._queue))
        if not n_retired:
            return {}
        # every rank retired the same slots: finalize this rank's, then
        # exchange them, so that every rank returns every result
        out: dict[int, TTSResult] = {}
        for part in gather_objects(self.mesh,
                                   self._drain_finalizing(block=True)):
            out.update(part)
        return out

    def _drain_finalizing(self, block: bool) -> dict[int, TTSResult]:
        """Finalize retired slots whose audio copies have landed (polled,
        never waited on); with block=True, finalize all of them."""
        out: dict[int, TTSResult] = {}
        still: list[_Slot] = []
        with trace.span("serve.finalize") as sp:
            for slot in self._finalizing:
                if block or all(r.fut.done() for r in slot.codes.audio):
                    out[slot.request_id] = self._finalize(slot)
                else:
                    still.append(slot)
            sp.set(finalized=len(out))
        self._finalizing = still
        return out

    def _decode_ready(self, live: list[_Slot], retired: list[_Slot]) -> None:
        """Waves (``decode_wave``) of every slot's ready 40-frame chunks
        and of retired slots' ragged tails. Nothing without a vocoder."""
        if self.engine.voc_w is None:
            return
        targets = [(s, False) for s in live] + [(s, True) for s in retired]
        while work := [(s, ret, c) for s, ret in targets
                       if (c := s.codes.next_chunk(final=ret))]:
            decode_wave(self.engine, [c for _, _, c in work], self.n_local,
                        "serve.decode", self.voc_max_batch,
                        lambda i, ref: self._send(*work[i][:2], ref))

    @staticmethod
    def _send(slot: _Slot, retired: bool, ref: PCMRef | None) -> None:
        """One decoded chunk to the slot's on_audio, final on a retired
        stream's last chunk, a full one too (streaming consumers close on
        final=True); ref None: an empty final one. A raising sink fails
        ITS request, not the batch."""
        if ref is not None:
            slot.codes.audio.append(ref)
        if not slot.on_audio:
            return
        final = ref is None or (retired and
                                slot.codes.n_decoded == slot.codes.n_frames)
        try:
            pcm = np.zeros(0, np.float32) if ref is None else ref.to_f32()
            if len(pcm) and not slot.first_audio_sent:
                trace.add("req.first_audio", slot.t_start,
                          time.monotonic_ns(), rid=slot.request_id)
                slot.first_audio_sent = True
            slot.on_audio(pcm, final)
        except Exception as e:
            slot.error = f"on_audio callback failed: {type(e).__name__}: {e}"
            slot.on_audio = None
        slot.final_sent = slot.final_sent or final

    def _finalize(self, slot: _Slot) -> TTSResult:
        if not slot.final_sent and not slot.error:
            # the stream's audio all went out while it was live (it retired
            # at a decoded chunk boundary): close it with an empty chunk
            self._send(slot, True, None)
        voc_cfg = self.engine.voc_cfg
        r = TTSResult(n_frames=slot.codes.n_frames,
                      sample_rate=voc_cfg.sample_rate if voc_cfg else 24000)
        try:
            r.audio = slot.codes.waveform()
        except Exception as e:  # a readback failure is per request too
            slot.error = slot.error or (f"audio readback failed: "
                                        f"{type(e).__name__}: {e}")
        r.success = r.n_frames > 0 and not slot.error
        if slot.error:
            r.error_msg = slot.error
        elif not r.success:
            r.error_msg = "No speech codes generated"
        r.t_total_ms = (time.monotonic_ns() - slot.t_start) / 1e6
        r.t_queue_ms = slot.t_queue_ms
        return r

    def run_all(self) -> dict[int, TTSResult]:
        """Drive step() until every queued and running request is done."""
        out: dict[int, TTSResult] = {}
        while self.pending():
            out.update(self.step())
        return out
