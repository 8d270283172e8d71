"""Compiled-executable layer (port of qwen3_tts_tpu/runtime/aot.py): one
captured CUDA graph per bucket.

The JAX package compiles a generation chunk once per static bucket
(read_ctx, top_k, greedy, ring, top_p, ...) and the vocoder decode once
per (n, frames, sub, pcm16) bucket, and keeps the executables. Here each
such bucket becomes one CUDA graph, captured on first use and replayed on
every later call. The generation graph is one frame, replayed 40 times a
chunk (``Qwen3TTS._gen_fn``): a frame's ~155 launches (~1,300 under
QWEN3_TTS_TALKER=xla) go to the card as one graph launch, and a frame
graph captures in milliseconds where a 40-frame one takes seconds under
xla, longer than the eager chunk, and replays no faster.

``GraphCache.get_or_capture(key, fn, device, generator)`` returns a
callable with no arguments. On a CUDA device its first call runs ``fn`` on
the cache's side stream (the warm-up that capture needs; its outputs are
that call's result), then captures a second run of ``fn`` into a graph
whose memory comes from one pool that every graph of the cache shares, so
that the buckets do not each hold their own intermediates. Every later
call replays the graph and returns the captured outputs: static buffers
that the next replay overwrites, so a caller copies them out (``.cpu()``,
``stream.Readback``) before it enqueues the next replay on the stream.
A failed capture raises; nothing gives way to the eager path.

What a graph keeps from its capture:
- addresses: ``fn`` closes over tensors that later calls update in place
  (``GenState``/``GenConsts`` through runtime/generate.py, a vocoder
  bucket's code buffer); the key names the buffers' owner, and the graph
  holds the kernels' cached scratch tensors it saw, so that a later
  reallocation cannot free memory it writes;
- Python scalars (temperature, top_k, read_ctx): keys name them all;
- the mesh: on a sharded engine (parallel/mesh.py) the keys end with the
  JAX package's mesh tag and the rank, ``-m{dp}x{tp}-rk{rank}``; only a
  dp-only NCCL mesh captures generation graphs (no collective sits in a
  frame), at tp > 1 and over gloo the frame runs eagerly;
- random draws: ``generator``, when given, is registered with the graph,
  so a replay draws from the generator's state at the time of the replay
  and advances it as the eager calls do (the process's default CUDA
  generator is registered by torch);
- the kernels' launch counters: the wrappers count at capture, where
  nothing launches, so the capture takes its counts back and every replay
  adds them (``kernels.add_codepred_launches`` for the C side's count).

Eager, with ``fn`` itself returned: CPU tensors (there is nothing to
capture; that is the device the caller asked for), ``QWEN3_TTS_AOT=0``
(the switch the JAX package reads, with the same meaning) and a kernel's
phase clock set (``predict_codes_fused.phase_ns``,
``talker_step_fused.phase_ns``, whose pointers a graph would keep). A
``QWEN3_TTS_PROFILE`` trace replays the graphs an untraced run replays;
the program's own ranges there are the recorder's (utils/trace.py).
Graphs live as long as their cache, which the engine owns; CUDA graphs
have no serialized form, so nothing is written to disk (the kernels'
build cache in ``_build/`` is the port's on-disk artifact).

Each capture is a ``graphs.capture`` span (``kind`` gen or voc,
``warm_us``, ``capture_us``); ``pool_bytes()`` reads the pool's memory
when asked.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable

import torch

from .. import kernels
from ..ops import (codepred_fused, flash_decode, mla, moe, talker_fused,
                   vocoder_fused)
from ..utils import trace

_BUFFER_IDS = itertools.count(1)


def new_buffer_id() -> int:
    """A process-unique id for a set of static buffers that graphs close
    over (one serving state, one lock-step state): part of their keys."""
    return next(_BUFFER_IDS)


def aot_enabled() -> bool:
    """QWEN3_TTS_AOT=0 turns the cache off (every call eager)."""
    return os.environ.get("QWEN3_TTS_AOT", "1") != "0"


def _phase_clocks_on() -> bool:
    return (codepred_fused.predict_codes_fused.phase_ns is not None
            or talker_fused.talker_step_fused.phase_ns is not None)


def _fmt(x) -> str:
    return str(int(x)) if isinstance(x, bool) else str(x)


def _mesh_tag(mesh: tuple | None) -> str:
    """``-m{dp}x{tp}`` (the JAX package's mesh tag) and ``-rk{rank}`` of
    a (dp, tp, rank) mesh position; nothing without a mesh."""
    if mesh is None:
        return ""
    dp, tp, rank = mesh
    return f"-m{dp}x{tp}-rk{rank}"


def gen_key(*, model_tag: str, buffers: int, B: int, ctx: int,
            kv_quant: bool, talker_impl: str, codepred_impl: str,
            read_ctx: int, top_k: int, greedy: bool, ring: bool,
            trailing: int, top_p: float, temperature: float,
            repetition_penalty: float, device, attn_impl: str,
            mesh: tuple | None = None) -> str:
    """Name of one generation graph: the JAX package's ``_key_base``
    (model tag, slots, ctx, KV quantisation, mesh shape, impl switches)
    and ``_gen_fn`` name (read_ctx, top_k, greedy, ring, trailing buffer,
    top_p), plus what the port bakes in besides: B, the device, the
    sampling scalars, the decode-attention switch (ops/attention.py), the
    buffers' owner and, on a mesh ((dp, tp, rank)), the rank."""
    parts = dict(b=B, c=ctx, q=kv_quant, tk=talker_impl, cp=codepred_impl,
                 at=attn_impl, rc=read_ctx, k=top_k, g=greedy, r=ring,
                 t=trailing, p=float(top_p), T=float(temperature),
                 rp=float(repetition_penalty), s=buffers,
                 d=torch.device(device))
    return (f"gen-{model_tag}-" + "-".join(f"{k}{_fmt(v)}"
                                           for k, v in parts.items())
            + _mesh_tag(mesh))


def voc_key(*, model_tag: str, n: int, frames: int, sub: int | None,
            pcm16: bool, res_impl: str, sin2: str, device,
            mesh: tuple | None = None) -> str:
    """Name of one vocoder-decode graph (the JAX package's ``_voc_fn``
    name, plus the residual-chain and Snake sin^2 switches, as
    ``gen_key`` carries the talker's and the code predictor's, the device
    and the mesh position)."""
    return (f"voc-{model_tag}-n{n}-f{frames}-s{sub or 0}-p{int(pcm16)}"
            f"-v{res_impl}-z{sin2}-d{torch.device(device)}"
            f"{_mesh_tag(mesh)}")


# -- launch counters ----------------------------------------------------------
_COUNTED = (codepred_fused.predict_codes_fused,
            talker_fused.talker_step_fused, flash_decode.flash_decode,
            vocoder_fused.fused_residual_chain,
            vocoder_fused.fused_snake_convt, moe.moe_ffn, mla.mla_decode)


def _counts() -> tuple:
    return (tuple(f.launches for f in _COUNTED),
            tuple(flash_decode.flash_decode.launches_by_mode.values()),
            kernels.codepred_launches())


def _add_counts(delta: tuple, sign: int = 1) -> None:
    wrappers, modes, coop = delta
    for f, n in zip(_COUNTED, wrappers):
        f.launches += sign * n
    by_mode = flash_decode.flash_decode.launches_by_mode
    for mode, n in zip(list(by_mode), modes):
        by_mode[mode] += sign * n
    if coop:
        kernels.add_codepred_launches(sign * coop)


def _diff(after: tuple, before: tuple) -> tuple:
    return (tuple(a - b for a, b in zip(after[0], before[0])),
            tuple(a - b for a, b in zip(after[1], before[1])),
            after[2] - before[2])


def _scratch_refs() -> list:
    """Every kernel scratch tensor cached right now."""
    return [*codepred_fused._SCRATCH.values(),
            *talker_fused._SCRATCH.values(), *flash_decode._SCRATCH.values(),
            *vocoder_fused._CHAIN_SCRATCH.values(),
            *vocoder_fused._HEAD_SCRATCH.values()]


class _Graph:
    """One bucket: captured on the first call, replayed on the others."""

    def __init__(self, cache: "GraphCache", key: str, fn: Callable,
                 device: torch.device, generator, owner):
        self.cache, self.key, self.fn = cache, key, fn
        self.device, self.generator, self.owner = device, generator, owner
        self.graph = None
        self.outputs = None
        self.delta = None
        self.keep: list = []

    def __call__(self):
        if self.graph is None:
            with trace.span("graphs.capture",
                            kind=self.key.split("-", 1)[0]) as sp:
                return self._capture(sp)
        self.graph.replay()
        _add_counts(self.delta)
        return self.outputs

    def _capture(self, sp):
        main = torch.cuda.current_stream(self.device)
        side = self.cache.side_stream(self.device)
        side.wait_stream(main)
        t0 = time.perf_counter_ns()
        with torch.cuda.stream(side):
            warm = self.fn()
        side.synchronize()
        t1 = time.perf_counter_ns()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _counts()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self.cache.pool(self.device),
                                    capture_error_mode="thread_local")
                try:
                    outputs = self.fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass          # the capture was invalidated
                    raise
                graph.capture_end()
        finally:
            delta = _diff(_counts(), before)
            _add_counts(delta, -1)    # the capture launched nothing
        main.wait_stream(side)
        self.graph, self.outputs, self.delta = graph, outputs, delta
        self.keep = _scratch_refs()
        if flash_decode.flash_decode.wrapped is not None:
            self.keep.append(flash_decode.flash_decode.wrapped)
        sp.set(warm_us=(t1 - t0) // 1000,
               capture_us=(time.perf_counter_ns() - t1) // 1000)
        return warm


class GraphCache:
    """The engine's graphs: one memory pool and one side stream per
    device, graphs by key (module docstring)."""

    def __init__(self):
        self.graphs: dict = {}
        self._pools: dict = {}
        self._streams: dict = {}

    @staticmethod
    def capturing(device) -> bool:
        """Whether calls on `device` run as graphs (module docstring)."""
        return (torch.device(device).type == "cuda" and aot_enabled()
                and not _phase_clocks_on())

    def pool(self, device):
        if device not in self._pools:
            self._pools[device] = torch.cuda.graph_pool_handle()
        return self._pools[device]

    def side_stream(self, device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def get_or_capture(self, key: str, fn: Callable, device,
                       generator: torch.Generator | None = None,
                       owner: int | None = None) -> Callable:
        """A callable running `fn`: the graph of `key` (captured on its
        first call) where ``capturing(device)``, else `fn` itself. A
        graph draws from `generator`, when given, and from the default
        CUDA generator. The wrapped-window counter of decode attention
        is a pointer a graph keeps, so it is part of the key. `owner`
        names the static buffers `fn` closes over (``release``)."""
        device = torch.device(device)
        if not self.capturing(device):
            return fn
        wrapped = flash_decode.flash_decode.wrapped
        full = (key, None if wrapped is None else wrapped.data_ptr())
        g = self.graphs.get(full)
        if g is None:
            g = self.graphs[full] = _Graph(self, key, fn, device, generator,
                                           owner)
        return g

    def release(self, owner: int) -> None:
        """Drop the graphs over the buffers of `owner`, which are about to
        be freed."""
        self.graphs = {k: g for k, g in self.graphs.items()
                       if g.owner != owner}

    def pool_bytes(self, device) -> int:
        """Card memory the graphs' pool holds (reserved segments): a walk
        over the allocator's snapshot, made only when asked."""
        if device not in self._pools:
            return 0
        pool = tuple(self._pools[device])
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
