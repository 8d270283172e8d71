"""Multi-device scale-out on torch.distributed: the device mesh and the
shardings (port of qwen3_tts_tpu/parallel/mesh.py).

The JAX package runs one process over every device and lets GSPMD insert
the collectives. The port runs one process per device (SPMD across
processes, as a ``torchrun`` program): NCCL on the card, gloo on the CPU.
Every rank calls the same entry points with the same arguments, and each
holds only its own slice:

- ``dp``: the batch of streams is split across ranks (data parallelism;
  no collective inside a frame). After each 40-frame chunk one
  ``all_gather`` over dp (``gather_chunk``) gives every rank the codes,
  valid flags and done flags of the whole batch, which the host reads.
- ``tp``: Megatron tensor parallelism of the talker and the code
  predictor. q, k, v, gate and up are split on their output columns, wo
  and w_down on their input rows; each rank runs n_heads / tp query heads
  and n_kv / tp KV heads (the group ratio is unchanged), and the f32
  partials after wo and w_down are summed by one ``all_reduce`` over tp
  (``tp_sum``). ``codec_head`` and the code predictor's heads are split
  on the vocabulary, and their logits are gathered over tp
  (``tp_gather``) before sampling, so that the tp ranks of a dp group
  sample the same codes from the same generator state.

Sharded weights and states are plain tensors holding this rank's slice,
not DTensors: the kernels take raw pointers, and a replayed frame graph
should not pass through DTensor dispatch. A weight tree sharded at tp > 1
records its tp group under ``TP_KEY`` in each dict that holds a split
tensor; ``tp_sum`` and ``tp_gather`` do nothing where no group is
recorded, so the unsharded path keeps its numerics and its launches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..ops.codepred_fused import drop_folded

TP_KEY = "tp_group"


class TPGroup(NamedTuple):
    """The tp process group a sharded weight tree was split over."""
    group: Any
    size: int
    rank: int


def make_mesh(n_dp: int, n_tp: int = 1, device="cuda"):
    """A ``DeviceMesh`` of shape (n_dp, n_tp) with dims ("dp", "tp") over
    the initialised default process group, whose world size must be
    n_dp * n_tp; rank r sits at (r // n_tp, r % n_tp). ``cuda``: each rank
    on the card it has set (NCCL; gloo also takes CUDA tensors, which is
    how two ranks can share one card, as NCCL refuses); ``cpu``: gloo.
    Raises ValueError without a process group, at another world size, or
    for a ``cuda`` mesh without a card: it never changes device on its
    own."""
    from torch.distributed.device_mesh import DeviceMesh
    if n_dp < 1 or n_tp < 1:
        raise ValueError(f"mesh dims must be >= 1, got dp={n_dp} tp={n_tp}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh needs an initialised default process "
                         "group (torch.distributed.init_process_group), one "
                         "process per device")
    n, world = n_dp * n_tp, dist.get_world_size()
    if world != n:
        raise ValueError(f"a dp={n_dp} x tp={n_tp} mesh needs {n} processes,"
                         f" the process group has {world}")
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise ValueError("a cuda mesh needs a CUDA device; make the mesh "
                         "with device='cpu' (gloo) to run on the CPU")
    if kind == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("a cpu mesh needs the gloo backend, not nccl")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unknown mesh device {device!r}")
    return DeviceMesh(kind, torch.arange(n).reshape(n_dp, n_tp),
                      mesh_dim_names=("dp", "tp"))


def mesh_dims(mesh) -> tuple[int, int]:
    """(dp, tp) of a mesh; (1, 1) for None."""
    if mesh is None:
        return 1, 1
    names = list(mesh.mesh_dim_names)
    return (mesh.shape[names.index("dp")], mesh.shape[names.index("tp")])


def mesh_coords(mesh) -> tuple[int, int]:
    """This rank's (dp index, tp index); (0, 0) for None."""
    if mesh is None:
        return 0, 0
    return mesh.get_local_rank("dp"), mesh.get_local_rank("tp")


def graphs_allowed(mesh) -> bool:
    """Whether generation on `mesh` may run as CUDA graphs: on a dp-only
    NCCL mesh no collective sits inside a frame (the per-chunk gather runs
    outside the graph). At tp > 1 each frame all-reduces between layers,
    and a gloo mesh copies through the host, so generation there runs
    eagerly."""
    if mesh is None:
        return True
    return (mesh_dims(mesh)[1] == 1
            and dist.get_backend(mesh.get_group("dp")) == "nccl")


def rank_seed(mesh, seed: int) -> int:
    """The seed of this rank's sampling generator: `seed` unsharded and on
    dp rank 0. The dp ranks draw apart, so that no two streams of a batch
    share their noise; the tp ranks of a dp group alike, so that they
    sample the same codes."""
    return seed + (mesh_coords(mesh)[0] << 32)


def dp_rows(mesh, batch: int) -> tuple[int, int]:
    """[lo, hi) of this rank's rows of a batch that dp divides."""
    dp, _ = mesh_dims(mesh)
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by dp={dp}")
    per = batch // dp
    lo = mesh_coords(mesh)[0] * per
    return lo, lo + per


# -- weights ---------------------------------------------------------------
def unfuse_stack_layers(layers: dict, n_heads: int, n_kv: int,
                        head_dim: int) -> dict:
    """Split the fused wqkv -> wq/wk/wv and w_gu -> w_gate/w_up, so that
    each projection can be column-split on tp without crossing the q/k/v
    (or gate/up) boundaries. models/stack.py takes both layouts."""
    out = dict(layers)
    wqkv = out.pop("wqkv")
    nq, nk = n_heads * head_dim, n_kv * head_dim
    out["wq"] = wqkv[..., :nq]
    out["wk"] = wqkv[..., nq:nq + nk]
    out["wv"] = wqkv[..., nq + nk:]
    w_gu = out.pop("w_gu")
    inter = w_gu.shape[-1] // 2
    out["w_gate"] = w_gu[..., :inter]
    out["w_up"] = w_gu[..., inter:]
    return out


def talker_shardings(mesh, unfused: bool = False) -> dict[str, Any]:
    """The weight tree of ``weights.load_talker_weights`` with, at each
    leaf, the dimension that tp splits, or None where the leaf is
    replicated (the JAX package's PartitionSpecs, leaf for leaf).

    Megatron layout: q/k/v and gate/up are column-parallel (dim 2 of
    [L, in, out]), o and down row-parallel (dim 1); norms, embeddings,
    text_proj and mtp_* are replicated; codec_head [H, V] and the code
    predictor's heads [15, H, V] are split on the vocabulary. With the
    fused layout (tp = 1) wqkv stays replicated: a plain column split
    would cross its q/k/v boundaries. `mesh` is not read (the JAX
    signature: there it builds the NamedShardings)."""
    col, row = 2, 1

    def stack_spec():
        base = {"attn_norm": None, "q_norm": None, "k_norm": None,
                "ffn_norm": None, "wo": row, "w_down": row}
        if unfused:
            base.update({"wq": col, "wk": col, "wv": col,
                         "w_gate": col, "w_up": col})
        else:
            base.update({"wqkv": None, "w_gu": col})
        return base

    return {
        "text_embd": None,
        "text_proj": {"fc1_w": None, "fc1_b": None,
                      "fc2_w": None, "fc2_b": None},
        "codec_embd": None,
        "codec_head": 1,
        "output_norm": None,
        "layers": stack_spec(),
        "code_pred": {
            "layers": stack_spec(),
            "output_norm": None,
            "embd": None,
            "heads": 2,
            "mtp_w": None,
            "mtp_b": None,
        },
    }


def _split(t: torch.Tensor, dim: int, tp: TPGroup, name: str):
    if t.shape[dim] % tp.size:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} is not "
                         f"divisible by tp={tp.size}")
    n = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * n, n).contiguous()


def shard_talker_weights(w, mesh, cfg=None):
    """This rank's slice of the talker weights (plain tensors). At tp = 1
    the tree is returned as it is (fused layout, every rank holds it all).
    At tp > 1 pass the TalkerConfig: the fused wqkv/w_gu of the talker and
    code-predictor stacks are unfused, every projection split Megatron
    style (``talker_shardings``), and each dict holding a split tensor
    records the tp group under ``TP_KEY``. The code predictor's folded
    mtp rows (``codepred_fused.fold_mtp``) are dropped there: they serve
    only the kernel, which a tp-split code predictor never runs."""
    _, n_tp = mesh_dims(mesh)
    if n_tp == 1:
        return w
    if cfg is None:
        raise ValueError("tp>1 sharding needs cfg to unfuse wqkv/w_gu")
    if cfg.n_key_value_heads % n_tp or cfg.code_pred_n_kv_heads % n_tp:
        raise ValueError(f"tp={n_tp} must divide the KV heads "
                         f"({cfg.n_key_value_heads}, "
                         f"{cfg.code_pred_n_kv_heads})")
    w = dict(w)
    w["layers"] = unfuse_stack_layers(
        w["layers"], cfg.n_attention_heads, cfg.n_key_value_heads,
        cfg.head_dim)
    w["code_pred"] = drop_folded(w["code_pred"])
    w["code_pred"]["layers"] = unfuse_stack_layers(
        w["code_pred"]["layers"], cfg.code_pred_n_attention_heads,
        cfg.code_pred_n_kv_heads, cfg.code_pred_head_dim)
    tp = TPGroup(mesh.get_group("tp"), n_tp, mesh_coords(mesh)[1])

    def place(tree, spec, path):
        out, split = {}, False
        for k, v in tree.items():
            s = spec.get(k)
            if isinstance(v, dict):
                out[k] = place(v, s or {}, f"{path}.{k}")
            elif v is None or s is None:
                out[k] = v
            else:
                out[k] = _split(v, s, tp, f"{path}.{k}")
                split = True
        if split:
            out[TP_KEY] = tp
        return out

    return place(w, talker_shardings(mesh, unfused=True), "w")


def tp_group(tree) -> TPGroup | None:
    """The tp group a weight dict records (None: not split)."""
    return tree.get(TP_KEY) if isinstance(tree, dict) else None


def tp_size(tree) -> int:
    g = tp_group(tree)
    return 1 if g is None else g.size


def tp_sum(x: torch.Tensor, tree) -> torch.Tensor:
    """The row-parallel sum: ``all_reduce(SUM)`` of the f32 partial `x`
    over the tp group that `tree` records, in place; `x` as it is where
    none is recorded."""
    g = tp_group(tree)
    if g is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g.group)
    return x


def tp_gather(x: torch.Tensor, tree) -> torch.Tensor:
    """The vocabulary gather: this rank's logits [..., V / tp] -> the full
    [..., V], ``all_gather`` over the tp group that `tree` records (in tp
    rank order); `x` as it is where none is recorded."""
    g = tp_group(tree)
    if g is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(g.size)]
    dist.all_gather(parts, x, group=g.group)
    return torch.cat(parts, dim=-1)


# -- generation state --------------------------------------------------------
def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def shard_gen_state(state, mesh):
    """This rank's slice of a GenState built for the whole batch with the
    unsharded weights: rows [r_dp * B/dp, (r_dp + 1) * B/dp) of every
    per-stream tensor, and KV heads [r_tp * kv/tp, ...) of the stacked
    cache [L, 2, B, kv, S, D] (bf16, or int8 with its scales
    [L, 2, B, kv, S]). write_slot is replicated; the generator is shared
    (the caller gives every rank the same seed). Every tensor is a new
    contiguous copy. The JAX package's layered-cache branch is not ported
    (the port has no layered cache)."""
    from ..models.stack import QuantKV
    B = state.n_past.shape[0]
    lo, hi = dp_rows(mesh, B)
    _, n_tp = mesh_dims(mesh)
    r_tp = mesh_coords(mesh)[1]

    def cache_slice(t):
        n_kv = t.shape[3]
        if n_kv % n_tp:
            raise ValueError(f"tp={n_tp} does not divide {n_kv} KV heads")
        k = n_kv // n_tp
        return _copy(t[:, :, lo:hi, r_tp * k:(r_tp + 1) * k])

    cache = state.kv_cache
    if isinstance(cache, QuantKV):
        cache = QuantKV(values=cache_slice(cache.values),
                        scales=cache_slice(cache.scales))
    else:
        cache = cache_slice(cache)
    rows = {f.name: _copy(getattr(state, f.name)[lo:hi])
            for f in dataclasses.fields(state)
            if f.name not in ("kv_cache", "generator", "write_slot")}
    return dataclasses.replace(state, kv_cache=cache,
                               write_slot=_copy(state.write_slot), **rows)


def shard_consts(consts, mesh):
    """This rank's rows of GenConsts, copied (temperature and repetition
    penalty are replicated scalars)."""
    lo, hi = dp_rows(mesh, consts.trailing_len.shape[0])
    return dataclasses.replace(consts, **{
        name: _copy(getattr(consts, name)[lo:hi])
        for name in ("trailing_hidden", "trailing_len", "tts_pad_embed",
                     "expected_frames")})


def gather_chunk(mesh, codes: torch.Tensor, valid: torch.Tensor,
                 done: torch.Tensor):
    """One ``all_gather`` over dp of a chunk's outputs: this rank's codes
    [chunk, b, n_cb] int32, valid [chunk, b] bool and done [b] bool ->
    the whole batch's (codes [chunk, dp * b, n_cb], valid, done), rows in
    dp rank order, on every rank. The three travel packed in one int32
    tensor [b, chunk * n_cb + chunk + 1]."""
    chunk, b, n_cb = codes.shape
    packed = torch.cat([codes.permute(1, 0, 2).reshape(b, chunk * n_cb),
                        valid.t().to(torch.int32),
                        done[:, None].to(torch.int32)], dim=1).contiguous()
    group = mesh.get_group("dp")
    parts = [torch.empty_like(packed)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, packed, group=group)
    full = torch.cat(parts)
    n = full.shape[0]
    return (full[:, :chunk * n_cb].reshape(n, chunk, n_cb).permute(1, 0, 2),
            full[:, chunk * n_cb:chunk * n_cb + chunk].t().bool(),
            full[:, -1].bool())


def gather_objects(mesh, obj) -> list:
    """``all_gather_object`` over dp: every dp rank's `obj`, in dp rank
    order (host objects, e.g. the audio of a rank's streams)."""
    group = mesh.get_group("dp")
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
