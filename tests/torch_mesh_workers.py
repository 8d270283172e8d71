"""The port's multi-process runs for tests/test_torch_sharding.py.

Each job runs the same way unsharded (``mesh=None``, in the test process)
and sharded (in a gloo worker spawned by ``spawn``), and returns numpy
results, which the test compares. This module imports only torch, numpy
and the port: the workers are fresh processes, and neither JAX nor the
JAX package is imported there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import faulthandler
import io
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

CHUNK = 6               # frames of the lock-step chunk
RING_CHUNK = 4          # frames of a serving chunk
B = 8                   # streams of the lock-step and serving batches
COLLECTIVE_S = 120      # gloo's collective timeout, and the exit wait's


@dataclasses.dataclass
class Inputs:
    """What every job reads: port configs, weight trees (CPU tensors), a
    port tokenizer, token ids, texts and sampling draws."""
    cfg: object
    talker_w: dict
    voc_cfg: object
    voc_w: dict
    tokenizer: object
    tokens: np.ndarray        # [B, 16] int32, lock-step
    serve_tokens: np.ndarray  # [B, 16] int32, admitted to the serving slots
    cb0_gumbel: np.ndarray    # [CHUNK, B, codec_vocab] f32
    codes_gumbel: np.ndarray  # [CHUNK, 15, B, code_pred_vocab] f32
    texts: list
    ragged_texts: list
    slot_texts: list          # write-slot case: rank 0 short, rank 1 long
    batcher_texts: list


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return None if tree is None else tree.clone()


def _weights(inp: Inputs):
    return _clone(inp.talker_w)


def _engine(inp: Inputs, mesh):
    from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS
    eng = Qwen3TTS.from_components(
        inp.tokenizer, inp.cfg, _weights(inp), inp.voc_cfg,
        _clone(inp.voc_w), "cpu")
    return eng if mesh is None else eng.shard(mesh)


def _prefill(w, cfg, tokens):
    from qwen3_tts_tpu_torch.models import talker
    n = tokens.shape[0]
    return talker.build_prefill_inputs(
        w, cfg, torch.from_numpy(tokens), torch.full((n,), 16,
                                                     dtype=torch.int32),
        torch.zeros(n, cfg.hidden_size))


def _rows(mesh, n):
    from qwen3_tts_tpu_torch.parallel.mesh import dp_rows
    return (0, n) if mesh is None else dp_rows(mesh, n)


def _gather(mesh, codes, valid, done):
    from qwen3_tts_tpu_torch.parallel.mesh import gather_chunk
    if mesh is not None:
        codes, valid, done = gather_chunk(mesh, codes, valid, done)
    # copies: done is the live state's until gathered
    return tuple(t.numpy().copy() for t in (codes, valid, done))


def _shard_state(mesh, state, consts):
    from qwen3_tts_tpu_torch.parallel.mesh import shard_consts, shard_gen_state
    if mesh is None:
        return state, consts
    return shard_gen_state(state, mesh), shard_consts(consts, mesh)


def _sharded_weights(inp, mesh):
    from qwen3_tts_tpu_torch.parallel.mesh import shard_talker_weights
    w = _weights(inp)
    return w, (w if mesh is None else shard_talker_weights(w, mesh, inp.cfg))


def job_chunk(inp: Inputs, mesh, sampled: bool = False) -> dict:
    """One lock-step chunk of CHUNK frames over a state built for the
    whole batch with the unsharded weights, then sliced (greedy, or
    sampled with the draws passed in, sliced to this rank's rows)."""
    from qwen3_tts_tpu_torch.runtime import generate as G
    cfg = inp.cfg
    w, ws = _sharded_weights(inp, mesh)
    pf = _prefill(w, cfg, inp.tokens)
    ctx = G.required_ctx(pf.prefill_embd.shape[1], CHUNK, CHUNK)
    temperature = 0.9 if sampled else 0.0
    state, consts = _shard_state(
        mesh, G.init_state(w, cfg, pf, ctx, None),
        G.make_consts(pf, temperature, 1.05))
    lo, hi = _rows(mesh, B)
    draws = {}
    if sampled:
        draws = dict(
            cb0_gumbel=torch.from_numpy(inp.cb0_gumbel[:, lo:hi]),
            codes_gumbel=torch.from_numpy(inp.codes_gumbel[:, :, lo:hi]))
    state, codes, valid = G.generate_chunk(
        ws, cfg, state, consts, 50, CHUNK, greedy=not sampled,
        read_ctx=ctx, **draws)
    codes, valid, done = _gather(mesh, codes, valid, state.done)
    return dict(codes=codes, valid=valid, done=done)


def job_serving(inp: Inputs, mesh) -> dict:
    """The serving primitives: every slot parked, one batched admission
    (each rank admits its own slots), 2 ring chunks, park global slot 0,
    one more chunk."""
    from qwen3_tts_tpu_torch.runtime import generate as G
    cfg = inp.cfg
    w, ws = _sharded_weights(inp, mesh)
    ctx = G.required_ctx_ring(3 * RING_CHUNK, RING_CHUNK)
    dummy = _prefill(w, cfg, np.zeros_like(inp.tokens))
    state, consts = _shard_state(
        mesh, G.init_state(w, cfg, dummy, ctx, None,
                           active=torch.zeros(B, dtype=torch.bool)),
        G.make_consts(dummy, 0.0, 1.05))
    lo, hi = _rows(mesh, B)
    G.admit_slots(ws, cfg, state, consts, torch.arange(hi - lo),
                  _prefill(ws, cfg, inp.serve_tokens[lo:hi]))
    out = []
    for step in range(3):
        if step == 2 and lo == 0:
            G.park_slot(state, 0)
        _, codes, valid = G.generate_chunk(ws, cfg, state, consts, 50,
                                           RING_CHUNK, greedy=True,
                                           ring=True, read_ctx=ctx)
        out.append(_gather(mesh, codes, valid, state.done))
    return dict(chunks=out)


def _audio(results) -> list:
    return [(r.success, r.n_frames, np.asarray(r.audio)) for r in results]


def job_synth(inp: Inputs, mesh, texts, max_tokens: int = 8) -> dict:
    """synthesize_batch, greedy; this rank's stderr with it and the
    streams its on_chunk calls named."""
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    eng = _engine(inp, mesh)
    err, chunked = io.StringIO(), set()
    with contextlib.redirect_stderr(err):
        res = eng.synthesize_batch(texts, params=TTSParams(
            max_audio_tokens=max_tokens, temperature=0.0, seed=0,
            print_timing=False), on_chunk=lambda b, pcm: chunked.add(b))
    return dict(results=_audio(res), stderr=err.getvalue(),
                chunked=sorted(chunked))


def job_batcher(inp: Inputs, mesh, n_slots: int = 4) -> dict:
    """ContinuousBatcher, greedy, after warmup()."""
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    cb = ContinuousBatcher(_engine(inp, mesh), n_slots=n_slots,
                           params=TTSParams(temperature=0.0, seed=0),
                           max_frames=8)
    with contextlib.redirect_stderr(io.StringIO()):
        cb.warmup()
    finals = []
    rids = [cb.submit(t, on_audio=lambda pcm, final, i=i: final
                      and finals.append(i))
            for i, t in enumerate(inp.batcher_texts)]
    res = cb.run_all()
    return dict(results=_audio([res[r] for r in rids]), finals=finals)


def _raises(fn) -> str:
    """The ValueError message `fn` raises ('' if it returns)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def job_mesh_facts(inp: Inputs, mesh) -> dict:
    """The mesh and the split weights as plain facts, and the errors a
    sharded run must raise."""
    from qwen3_tts_tpu_torch.models import code_predictor, talker
    from qwen3_tts_tpu_torch.parallel import mesh as M
    from qwen3_tts_tpu_torch.runtime.pipeline import TTSParams
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    dp, tp = M.mesh_dims(mesh)
    w, ws = _sharded_weights(inp, mesh)
    facts = dict(
        dims=(dp, tp), names=tuple(mesh.mesh_dim_names),
        coords=M.mesh_coords(mesh), seed=M.rank_seed(mesh, 7),
        bigger=_raises(lambda: M.make_mesh(dp * 2, tp, "cpu")),
        cuda=_raises(lambda: M.make_mesh(dp, tp, "cuda")),
        no_cfg=_raises(lambda: M.shard_talker_weights(w, mesh)) if tp > 1
        else "",
        odd_slots=_raises(lambda: ContinuousBatcher(
            _engine(inp, mesh), n_slots=dp * 2 + 1,
            params=TTSParams(temperature=0.0))) if dp > 1 else "",
        stacks={name: {k: tuple(v.shape) for k, v in stack.items()
                       if isinstance(v, torch.Tensor)}
                for name, stack in (("talker", ws["layers"]),
                                    ("code_pred", ws["code_pred"]["layers"]))},
        heads=(tuple(ws["codec_head"].shape),
               tuple(ws["code_pred"]["heads"].shape)))
    if tp > 1:
        for name, switch in (("talker", talker.set_talker_step_impl),
                             ("codepred", code_predictor.set_codepred_impl)):
            switch("fused")
            try:
                facts[f"fused_{name}"] = _raises(
                    lambda: job_chunk(inp, mesh))
            finally:
                switch(None)
    return facts


JOBS = {
    "chunk": job_chunk,
    "sampled": lambda inp, mesh: job_chunk(inp, mesh, sampled=True),
    "serving": job_serving,
    "synth": lambda inp, mesh: job_synth(inp, mesh, inp.texts),
    "ragged": lambda inp, mesh: job_synth(inp, mesh, inp.ragged_texts),
    "write_slot": lambda inp, mesh: job_synth(inp, mesh, inp.slot_texts,
                                              max_tokens=80),
    "batcher": job_batcher,
    "facts": job_mesh_facts,
}


def run_jobs(inp: Inputs, mesh, names) -> dict:
    return {name: JOBS[name](inp, mesh) for name in names}


def _stderr_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"rank{rank}.stderr")


def _result_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"rank{rank}.pkl")


def _write_result(out_dir: str, rank: int, out: dict) -> None:
    """Write a rank's results whole, or not at all (rename into place)."""
    tmp = _result_path(out_dir, rank) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, _result_path(out_dir, rank))


def _wait_for_results(out_dir: str, world: int, timeout_s: float) -> None:
    """Until every rank has written its results (or `timeout_s`)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not all(
            os.path.exists(_result_path(out_dir, r)) for r in range(world)):
        time.sleep(0.05)


def _entry(rank: int, world: int, n_tp: int, store: str, out_dir: str,
           inp: Inputs, names) -> None:
    # this rank's stderr, the C++ side's included, goes to a file that
    # spawn() puts into its error; a fatal signal dumps the Python stack
    err = open(_stderr_path(out_dir, rank), "w", buffering=1)
    os.dup2(err.fileno(), 2)
    sys.stderr = err
    faulthandler.enable(err)
    torch.set_num_threads(1)
    # a rank that fails ends the others' collectives in seconds, not in
    # gloo's 30-minute default
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    try:
        from qwen3_tts_tpu_torch.parallel.mesh import make_mesh
        out = run_jobs(inp, make_mesh(world // n_tp, n_tp, "cpu"), names)
    except Exception:
        _write_result(out_dir, rank, {"error": traceback.format_exc()})
        raise
    _write_result(out_dir, rank, out)
    # No rank tears its gloo groups down: gloo's TCP transport can abort
    # the process there ("terminate called without an active exception").
    # Its event loop's destructor calls shutdown(), which returns at once
    # when the loop's done flag is already set, joined or not, and then
    # destroys the loop's std::thread, which terminates if still joinable.
    # Once every rank has written its results no collective is left
    # anywhere, and each rank leaves without running a destructor.
    _wait_for_results(out_dir, world, COLLECTIVE_S)
    err.flush()
    os._exit(0)


def spawn(inp: Inputs, world: int, n_tp: int, names, tmp) -> list[dict]:
    """Run `names` on a (world / n_tp) x n_tp gloo mesh of `world` spawned
    processes; returns each rank's results. If a rank fails, the error
    raised here holds every rank's stderr."""
    tmp = str(tmp)
    try:
        torch.multiprocessing.spawn(
            _entry, args=(world, n_tp, os.path.join(tmp, "store"), tmp, inp,
                          tuple(names)), nprocs=world, join=True)
    except (torch.multiprocessing.ProcessExitedException,
            torch.multiprocessing.ProcessRaisedException) as e:
        logs = []
        for rank in range(world):
            try:
                with open(_stderr_path(tmp, rank)) as f:
                    text = f.read()
            except OSError as oe:
                text = f"(no stderr file: {oe})"
            logs.append(f"--- rank {rank} stderr ---\n{text}")
        raise RuntimeError("\n".join([f"mesh workers failed: {e}", *logs])
                           ) from e
    out = []
    for rank in range(world):
        with open(_result_path(tmp, rank), "rb") as f:
            out.append(pickle.load(f))
    return out
