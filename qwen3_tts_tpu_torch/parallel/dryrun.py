"""``dryrun_multichip``: the generation step and the serving primitives
over a dp x tp mesh of processes at tiny shapes (port of
__graft_entry__.py's dryrun_multichip).

    python -c "from qwen3_tts_tpu_torch.parallel import dryrun_multichip; \\
               dryrun_multichip(4, device='cpu')"

prints ``dryrun_multichip OK: mesh dp=2 tp=2, B=4, codes (2, 4, 16),
serving path (admit+ring+park) OK``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Spawn `n_devices` processes, one rank each (NCCL and one card each
    for ``cuda``, gloo for ``cpu``), make a dp x tp mesh (tp = 2 where
    n_devices is even), and on every rank: shard random tiny-config
    weights, run a 2-frame lock-step chunk over a sharded state, then the
    serving primitives on an int8 stacked cache (admit every slot, a ring
    chunk, park slot 0, another ring chunk; the parked slot must emit
    nothing). Rank 0 prints the OK line. Raises if a rank fails, or for
    ``cuda`` when there are fewer cards than `n_devices`."""
    kind = torch.device(device).type
    if kind == "cuda" and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < n_devices):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise ValueError(f"dryrun_multichip({n_devices}, 'cuda') needs "
                         f"{n_devices} CUDA devices, have {have}")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _worker, args=(n_devices, kind, os.path.join(tmp, "store")),
            nprocs=n_devices, join=True)


def _worker(rank: int, world: int, kind: str, store: str) -> None:
    if kind == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        _dryrun(rank, world, kind, dev)
    finally:
        dist.destroy_process_group()


def _dryrun(rank: int, world: int, kind: str, dev: torch.device) -> None:
    from ..models import talker
    from ..models.weights import init_talker_weights, tiny_talker_config
    from ..runtime.generate import (admit_slots, generate_chunk, init_state,
                                    make_consts, park_slot, required_ctx,
                                    required_ctx_ring)
    from .mesh import (dp_rows, gather_chunk, make_mesh, shard_consts,
                       shard_gen_state, shard_talker_weights)

    n_tp = 2 if world % 2 == 0 else 1
    n_dp = world // n_tp
    mesh = make_mesh(n_dp, n_tp, kind)
    # the tiny config at head dim 128: decode attention on the card serves
    # only the model's head dim
    cfg = dataclasses.replace(tiny_talker_config(), head_dim=128,
                              code_pred_head_dim=128)
    w = init_talker_weights(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    ws = shard_talker_weights(w, mesh, cfg)

    B = max(n_dp * 2, 2)
    host = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.text_vocab_size, (B, 16), generator=host,
                           dtype=torch.int32).to(dev)
    lens = torch.full((B,), 16, dtype=torch.int32, device=dev)
    spk = torch.zeros(B, cfg.hidden_size, device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    with torch.inference_mode():
        # the whole batch's state from the unsharded weights, then this
        # rank's slice of it
        prefill = talker.build_prefill_inputs(w, cfg, tokens, lens, spk)
        ctx = required_ctx(prefill.prefill_embd.shape[1], 4, 4)
        state = shard_gen_state(init_state(w, cfg, prefill, ctx, gen(0)),
                                mesh)
        consts = shard_consts(make_consts(prefill, 0.9, 1.05), mesh)
        state, codes, valid = generate_chunk(ws, cfg, state, consts,
                                             top_k=50, chunk_frames=2)
        codes, valid, _ = gather_chunk(mesh, codes, valid, state.done)
        if tuple(codes.shape) != (2, B, cfg.n_codebooks):
            raise AssertionError(f"lock-step codes {tuple(codes.shape)}")

        # serving: every slot parked, a batched admission into this rank's
        # slots, a ring chunk, park global slot 0, another ring chunk
        chunk = 4
        ring_ctx = required_ctx_ring(2 * chunk, chunk)
        dummy = talker.build_prefill_inputs(
            w, cfg, torch.zeros_like(tokens), lens, spk)
        sstate = shard_gen_state(
            init_state(w, cfg, dummy, ring_ctx, gen(1),
                       active=torch.zeros(B, dtype=torch.bool, device=dev),
                       kv_quant=True), mesh)
        sconsts = shard_consts(make_consts(dummy, 0.9, 1.05), mesh)
        lo, hi = dp_rows(mesh, B)
        mine = prefill._replace(**{f: getattr(prefill, f)[lo:hi]
                                   for f in prefill._fields})
        admit_slots(ws, cfg, sstate, sconsts,
                    torch.arange(hi - lo, device=dev), mine)
        generate_chunk(ws, cfg, sstate, sconsts, 50, chunk, ring=True,
                       read_ctx=ring_ctx)
        if lo == 0:
            park_slot(sstate, 0)
        _, scodes, svalid = generate_chunk(ws, cfg, sstate, sconsts, 50,
                                           chunk, ring=True,
                                           read_ctx=ring_ctx)
        scodes, svalid, _ = gather_chunk(mesh, scodes, svalid, sstate.done)
        if tuple(scodes.shape) != (chunk, B, cfg.n_codebooks):
            raise AssertionError(f"serving codes {tuple(scodes.shape)}")
        if bool(svalid[:, 0].any()):
            raise AssertionError("parked slot emitted frames")
    if rank == 0:
        print(f"dryrun_multichip OK: mesh dp={n_dp} tp={n_tp}, B={B}, codes "
              f"{tuple(codes.shape)}, serving path (admit+ring+park) OK",
              flush=True)
