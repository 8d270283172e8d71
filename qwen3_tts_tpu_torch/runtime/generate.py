"""Batched generation (port of qwen3_tts_tpu/runtime/generate.py): the
lock-step frame loop and the ring-slot mode of continuous batching.

One frame: sample CB0 (suppression / penalty / EOS ramp / top-k) -> code
predictor -> next-step embedding -> talker decode step. All streams share
one cache write slot per frame, kept on the device, so no host sync
happens per frame: in lock-step mode it is max(n_past); in ring mode it
is ``GenState.write_slot``, which walks the ring past the prefill region
and wraps back to its start.

On a mesh (parallel/mesh.py) a state holds one rank's rows, and the
lock-step slot is the max over those rows only, with no collective: every
live stream of a lock-step batch sits at the same position (one prefill
length, one frame a step), so the local max is the global one wherever a
stream is live, and a rank whose streams are all done writes only rows
that no live stream reads (each stream attends its own cache row).

Every ``GenState`` tensor is updated in place, never rebound: by
``generate_chunk`` (the torch counterpart of JAX's
``donate_argnames=("state",)``), ``admit_slots``, ``park_slot`` and
``init_state(into=...)``, which prefills into a given state's buffers;
``make_consts(into=...)`` does the same for ``GenConsts``. A captured CUDA
graph (runtime/graphs.py) reads and writes fixed addresses, so this is
what lets one graph serve every chunk of a bucket; rebuilding into the
same buffers also keeps one KV cache where a fresh state would need a
second.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..config import TalkerConfig
from ..models import code_predictor, talker
from ..models.stack import (LatentKV, QuantKV, init_kv_cache,
                            quantize_kv_rows, stack_prefill)
from ..ops.sampling import sample_cb0
from ..parallel.mesh import tp_size

# Ring-slot cache: rows [0, RING_PREFILL_SLOTS) of each stream are its
# prefill region (admissions write there); rows beyond are the shared ring
# written at GenState.write_slot. Must be >= any prefill length.
RING_PREFILL_SLOTS = 16


def kv_quant_enabled() -> bool:
    """QWEN3_TTS_KV=int8 selects the int8 talker KV cache (stack.QuantKV).
    Default bf16."""
    return os.environ.get("QWEN3_TTS_KV", "bf16").lower() == "int8"


@dataclass
class GenState:
    kv_cache: object              # [L, 2, B, kv, S, D] bf16, QuantKV or
    #                               LatentKV (a latent-attention talker)
    n_past: torch.Tensor          # [B] int32 per-stream position
    frame_idx: torch.Tensor       # [B] int32 frames generated
    last_hidden: torch.Tensor     # [B, H] f32
    logits: torch.Tensor          # [B, codec_vocab] f32
    seen_mask: torch.Tensor       # [B, codec_vocab] bool emitted CB0 ids
    done: torch.Tensor            # [B] bool hit EOS (or inactive)
    generator: torch.Generator | None
    # ring-slot cache (continuous batching; unused in lock-step):
    valid_mask: torch.Tensor      # [B, S] bool slots each stream may attend
    write_slot: torch.Tensor      # 0-d int32 next ring slot to write
    ring_lo: torch.Tensor         # [B] int32 ring slot at admission: a
    #                               stream's ring slots lie in the modular
    #                               window [ring_lo, write_slot]


@dataclass
class GenConsts:
    """Per-utterance constants of the frame loop."""
    trailing_hidden: torch.Tensor   # [B, T_trail, H]
    trailing_len: torch.Tensor      # [B]
    tts_pad_embed: torch.Tensor     # [B, H]
    expected_frames: torch.Tensor   # [B] EOS-ramp threshold
    temperature: float
    repetition_penalty: float


def init_state(w, cfg: TalkerConfig, prefill: talker.PrefillInputs,
               max_ctx: int, generator: torch.Generator | None,
               active: torch.Tensor | None = None,
               kv_quant: bool = False,
               into: GenState | None = None) -> GenState:
    """Run the talker prefill into a cleared cache of max_ctx slots.
    active: [B] bool streams that hold a request (partly filled serving
    batches); the others start done. into: a state of the same shapes
    whose buffers are cleared and refilled in place (and returned), the
    generator included; None allocates a new one. A tp-split `w` holds
    n_kv / tp KV heads, and so does its cache. A latent-attention talker
    (its layers' entry "mla") gets a LatentKV; kv_quant then raises."""
    B, P, _ = prefill.prefill_embd.shape
    dev = prefill.prefill_embd.device
    mla = w["layers"].get("mla")
    if into is None:
        into = GenState(
            kv_cache=init_kv_cache(cfg.n_layers, B, max_ctx,
                                   cfg.n_key_value_heads
                                   // tp_size(w["layers"]), cfg.head_dim,
                                   quant=kv_quant, device=dev,
                                   latent=mla.latent_width if mla else 0),
            n_past=torch.empty(B, dtype=torch.int32, device=dev),
            frame_idx=torch.empty(B, dtype=torch.int32, device=dev),
            last_hidden=torch.empty(B, cfg.hidden_size, device=dev),
            logits=torch.empty(B, cfg.codec_vocab_size, device=dev),
            seen_mask=torch.empty(B, cfg.codec_vocab_size, dtype=torch.bool,
                                  device=dev),
            done=torch.empty(B, dtype=torch.bool, device=dev),
            generator=generator,
            valid_mask=torch.empty(B, max_ctx, dtype=torch.bool, device=dev),
            write_slot=torch.empty((), dtype=torch.int32, device=dev),
            ring_lo=torch.empty(B, dtype=torch.int32, device=dev))
    else:
        cache = into.kv_cache
        have = (cache.values if isinstance(cache, QuantKV) else
                cache.rows if isinstance(cache, LatentKV) else cache).shape
        if (isinstance(cache, QuantKV) != kv_quant
                or tuple(into.valid_mask.shape) != (B, max_ctx)
                or have[0] != cfg.n_layers):
            raise ValueError(f"init_state(into=...): a state of {have} "
                             f"(int8 {isinstance(cache, QuantKV)}) cannot "
                             f"hold B={B}, max_ctx={max_ctx}, int8 "
                             f"{kv_quant}")
        if isinstance(cache, QuantKV):
            cache.values.zero_()
            cache.scales.fill_(1e-8 / 127.0)     # init_kv_cache's
        elif isinstance(cache, LatentKV):
            cache.rows.zero_()
        else:
            cache.zero_()
        into.generator = generator
    hidden, logits, _ = talker.talker_prefill(w, cfg, prefill.prefill_embd,
                                              into.kv_cache)
    ring0 = max(P, RING_PREFILL_SLOTS)
    into.n_past.fill_(P)
    into.frame_idx.zero_()
    into.last_hidden.copy_(hidden)
    into.logits.copy_(logits)
    into.seen_mask.zero_()
    if active is None:
        into.done.zero_()
    else:
        into.done.copy_(~active.to(dev))
    into.valid_mask.copy_(torch.arange(max_ctx, device=dev) < P)
    into.write_slot.fill_(ring0)
    into.ring_lo.fill_(ring0)
    return into


def expected_frames(n_text_tokens: torch.Tensor) -> torch.Tensor:
    """EOS-ramp threshold: max(20, 4 * n_text_tokens) frames."""
    return (n_text_tokens * 4).clamp_min(20).to(torch.int32)


def make_consts(prefill: talker.PrefillInputs, temperature: float,
                repetition_penalty: float,
                into: GenConsts | None = None) -> GenConsts:
    """The frame loop's constants; into: consts of the same shapes that
    are refilled in place (and returned) instead of new ones."""
    fresh = GenConsts(
        trailing_hidden=prefill.trailing_hidden,
        trailing_len=prefill.trailing_len,
        tts_pad_embed=prefill.tts_pad_embed,
        expected_frames=expected_frames(prefill.n_text_tokens),
        temperature=float(temperature),
        repetition_penalty=float(repetition_penalty))
    if into is None:
        return fresh
    for name in ("trailing_hidden", "trailing_len", "tts_pad_embed",
                 "expected_frames"):
        getattr(into, name).copy_(getattr(fresh, name))
    into.temperature = fresh.temperature
    into.repetition_penalty = fresh.repetition_penalty
    return into


def generate_frame(w, cfg: TalkerConfig, state: GenState,
                   consts: GenConsts, top_k: int, greedy: bool = False,
                   read_ctx: int | None = None, top_p: float = 1.0,
                   cb0_gumbel: torch.Tensor | None = None,
                   codes_gumbel: torch.Tensor | None = None,
                   ring: bool = False):
    """One frame for every stream, updating `state` in place: the body of
    ``generate_chunk`` (arguments as there, the noise for this frame
    only: cb0_gumbel [B, codec_vocab], codes_gumbel [15, B, V]). A CUDA
    graph of this function is what the card replays (runtime/graphs.py).
    Returns (codes [B, 16] int32, valid [B] bool)."""
    B = state.n_past.shape[0]
    rows = torch.arange(B, device=state.n_past.device)
    t_trail = consts.trailing_hidden.shape[1]
    cb0 = sample_cb0(
        state.logits, state.seen_mask, state.frame_idx,
        consts.expected_frames, consts.repetition_penalty,
        consts.temperature, top_k, state.generator,
        eos_id=cfg.codec_eos_id,
        suppress_start=cfg.codec_vocab_size - 1024, greedy=greedy,
        top_p=top_p, gumbel=cb0_gumbel)
    is_eos = cb0 == cfg.codec_eos_id
    valid = ~state.done & ~is_eos
    done = state.done | is_eos
    cb0_safe = torch.where(valid, cb0, 0)
    state.seen_mask[rows, cb0_safe.long()] |= valid

    rest = code_predictor.predict_codes(
        w, cfg, state.last_hidden, cb0_safe, consts.temperature, top_k,
        state.generator, greedy=greedy, top_p=top_p, gumbel=codes_gumbel)
    frame_codes = torch.cat([cb0_safe[:, None], rest], dim=1)

    # trailing text row, or tts_pad once the text schedule is exhausted
    row_idx = state.frame_idx.clamp(0, t_trail - 1).long()
    trail_row = torch.where(
        (state.frame_idx < consts.trailing_len)[:, None],
        consts.trailing_hidden[rows, row_idx], consts.tts_pad_embed)
    step_embd = code_predictor.frame_step_embedding(w, cfg, frame_codes,
                                                    trail_row)
    if ring:
        # dead lanes write a garbage row whose bit is cleared
        slot = state.write_slot
        state.valid_mask.index_copy_(1, slot.long().reshape(1),
                                     (~done)[:, None])
        hidden, logits, _ = talker.talker_step(
            w, cfg, step_embd, state.kv_cache, state.n_past, slot,
            read_ctx=read_ctx, valid_mask=state.valid_mask,
            window_lo=state.ring_lo, window_hi=slot + 1,
            prefill_len=RING_PREFILL_SLOTS)
        state.write_slot.copy_(torch.where(
            slot + 1 >= state.valid_mask.shape[1],
            torch.full_like(slot, RING_PREFILL_SLOTS), slot + 1))
    else:
        # this state's rows only, on a mesh too (module docstring)
        hidden, logits, _ = talker.talker_step(
            w, cfg, step_embd, state.kv_cache, state.n_past,
            state.n_past.max(), read_ctx=read_ctx)

    # done streams freeze their position
    advance = (~done).to(torch.int32)
    state.n_past += advance
    state.frame_idx += advance
    state.last_hidden.copy_(hidden)
    state.logits.copy_(logits)
    state.done.copy_(done)
    return frame_codes, valid


def generate_chunk(w, cfg: TalkerConfig, state: GenState, consts: GenConsts,
                   top_k: int, chunk_frames: int = 40, greedy: bool = False,
                   read_ctx: int | None = None, top_p: float = 1.0,
                   cb0_gumbel: torch.Tensor | None = None,
                   codes_gumbel: torch.Tensor | None = None,
                   ring: bool = False):
    """Generate `chunk_frames` frames for every stream, updating `state`
    in place. read_ctx: attention reads only that many cache rows (the
    caller guarantees max(n_past) + chunk_frames <= read_ctx; in ring mode
    write_slot + chunk_frames <= read_ctx instead).

    ring: ring-slot cache mode for continuous batching. Every stream
    writes the shared write_slot; the slot's bit in valid_mask is set to
    the stream's liveness before the step, and attention reads the
    bitmask inside each stream's lifetime window [ring_lo, slot + 1) plus
    the prefill region. Cache slots are then not position-ordered; RoPE
    keeps each stream's logical position.

    cb0_gumbel [chunk, B, codec_vocab] / codes_gumbel [chunk, 15, B, V]:
    optional explicit noise for the sampled mode (tests); otherwise drawn
    from state.generator.

    Returns (state, codes [chunk, B, 16] int32, valid [chunk, B] bool). A
    frame is valid iff its stream was live and did not sample EOS."""
    all_codes, all_valid = [], []
    for f in range(chunk_frames):
        codes, valid = generate_frame(
            w, cfg, state, consts, top_k, greedy=greedy, read_ctx=read_ctx,
            top_p=top_p, ring=ring,
            cb0_gumbel=None if cb0_gumbel is None else cb0_gumbel[f],
            codes_gumbel=None if codes_gumbel is None else codes_gumbel[f])
        all_codes.append(codes)
        all_valid.append(valid)
    return state, torch.stack(all_codes), torch.stack(all_valid)


def admit_slots(w, cfg: TalkerConfig, state: GenState, consts: GenConsts,
                slots: torch.Tensor, prefill: talker.PrefillInputs) -> None:
    """Splice K new requests into slots `slots` of a live serving batch,
    in place: one batched K-row prefill, then every request's K/V rows
    [0, P) and per-slot state and consts rows.

    slots: [K] int (duplicates allowed: the later entry wins, so callers
    may pad K to a fixed size by repeating the last real admission).
    prefill: PrefillInputs with leading dim K, trailing_hidden already
    padded or cut to consts.trailing_hidden.shape[1]."""
    K, P = prefill.prefill_embd.shape[:2]
    # admissions write rows [0, P): a longer prefill would overwrite the
    # shared ring, whose slots >= RING_PREFILL_SLOTS are rewritten each step
    if P > RING_PREFILL_SLOTS:
        raise ValueError(f"prefill length {P} exceeds RING_PREFILL_SLOTS "
                         f"{RING_PREFILL_SLOTS}")
    dev = state.n_past.device
    slots = torch.as_tensor(slots, device=dev).long()
    positions = torch.arange(P, dtype=torch.int32, device=dev).expand(K, P)
    y, ks, vs = stack_prefill(
        w["layers"], prefill.prefill_embd, positions,
        n_heads=cfg.n_attention_heads, n_kv=cfg.n_key_value_heads,
        head_dim=cfg.head_dim, eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    h, logits = talker._head(w, cfg, y[:, -1])

    # Duplicate indices make index_put_ order unspecified (on the card as
    # under XLA), so every entry carries its slot's LAST payload: colliding
    # writes are then identical and any order gives last-wins.
    k_idx = torch.arange(K, device=dev)
    last = torch.where(slots[:, None] == slots[None, :], k_idx[None, :],
                       -1).amax(dim=1)
    cache = state.kv_cache
    if isinstance(cache, LatentKV):              # ks: [L, 2, K, P, W]
        cache.rows[:, :, slots, :P] = ks[:, :, last]
    else:                                        # kv: [L, 2, K, kv, P, D]
        kv = torch.stack([ks, vs], dim=1).transpose(3, 4)[:, :, last]
        if isinstance(cache, QuantKV):
            qv, qs = quantize_kv_rows(kv)
            cache.values[:, :, slots, :, :P] = qv
            cache.scales[:, :, slots, :, :P] = qs
        else:
            cache[:, :, slots, :, :P] = kv.to(cache.dtype)

    S = state.valid_mask.shape[1]
    state.n_past[slots] = P
    state.frame_idx[slots] = 0
    state.last_hidden[slots] = h[last]
    state.logits[slots] = logits[last]
    state.seen_mask[slots] = False
    state.done[slots] = False
    state.valid_mask[slots] = torch.arange(S, device=dev) < P
    state.ring_lo[slots] = state.write_slot
    consts.trailing_hidden[slots] = prefill.trailing_hidden[last]
    consts.trailing_len[slots] = prefill.trailing_len[last]
    consts.tts_pad_embed[slots] = prefill.tts_pad_embed[last]
    consts.expected_frames[slots] = expected_frames(
        prefill.n_text_tokens)[last]


def admit_slot(w, cfg: TalkerConfig, state: GenState, consts: GenConsts,
               slot: int, prefill: talker.PrefillInputs) -> None:
    """Single-request admission (K = 1 admit_slots)."""
    admit_slots(w, cfg, state, consts, torch.tensor([slot]), prefill)


def park_slot(state: GenState, slot: int) -> None:
    """Mark a slot done on the device (a request retired by its frame cap
    rather than by sampling EOS), so that the stream stops advancing until
    a new request is admitted."""
    state.done[slot] = True


def required_ctx(prefill_len: int, max_frames: int, chunk: int = 40,
                 align: int = 128) -> int:
    """Talker cache size: prefill + frames rounded up to whole chunks +
    slack, aligned."""
    n_chunks = -(-max_frames // chunk)
    need = prefill_len + n_chunks * chunk + 8
    return -(-need // align) * align


def required_ctx_ring(max_frames: int, chunk: int = 40,
                      align: int = 128) -> int:
    """Cache size for ring mode: prefill region + ring capacity. A stream
    may take up to max_frames + chunk - 1 ring slots before its frame cap
    retires it at a chunk boundary, and must never wrap into its own
    rows."""
    need = RING_PREFILL_SLOTS + max_frames + chunk + 8
    return -(-need // align) * align


def ctx_bucket(max_n_past: int, chunk: int, total_ctx: int,
               bucket: int = 512) -> int:
    """Attention read window for the next chunk: every stream's position
    plus the chunk, rounded up to `bucket`, capped at the cache size."""
    need = max_n_past + chunk + 1
    return min(-(-need // bucket) * bucket, total_ctx)
