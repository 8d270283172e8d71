"""The sparse mixture-of-experts FFN of Qwen3-Omni's talker on the card:
a router, a grouped-expert product and a gated shared expert in four
hand-written CUDA launches (csrc/moe.cu), and their plain torch twin.

It replaces no TPU kernel: the JAX package has no MoE talker. It is the
``Qwen3OmniMoeTalkerTextSparseMoeBlock`` of transformers'
modeling_qwen3_omni_moe.py. Semantics, shared by the kernel and the twin,
for rows h [N, H] f32 (the FFN's normed input) and a layer's leaves
(models/weights.moe_layers):

- x = bf16(h); router logits x @ w_router in f32; p = softmax(logits) in
  f32; (w, e) = the top_k of p (ties to the lower expert), w /= sum(w)
  when ``norm_topk_prob``, then w = bf16(w);
- each routed pair (token t, slot j): [g | u] = x_t @ w_gu_e[e] (f32
  sums), a = bf16(silu(g) * u), o_tj = a @ w_down_e[e] (f32 sums);
- the shared expert: the same SwiGLU over w_gu_s / w_down_s, o_ts, with
  the gate s_t = sigmoid(x_t . w_sgate) in f32;
- y_t = ((w_t0 o_t0 + w_t1 o_t1) + ...) + s_t o_ts, summed in that order
  in f32.

What bounds it on the card: the experts' bytes. At B = 192 decode rows
and top-6 of 128 experts, 1,152 pairs touch nearly every expert, ~9 rows
each, so a layer streams ~302 MB of expert weights for ~3.7 GFLOP: ~25x
under the tensor cores' rate. The design reads each expert's weights
once for all rows routed to it:

1. ``moe_route``: CTAs of 4 tokens compute the router logits (each
   router weight read once a CTA), softmax, top-k, the weights and the
   shared gate, and write bf16(h). The last CTA to finish (an atomic
   ticket) counts the pairs per expert, lays the pairs out by expert
   (``order``) and lists the work chunks: up to 64 rows of one expert,
   the shared expert's rows being every token. Counts, offsets and the
   list stay in device memory; the grids below have a fixed size and a
   CTA past the list's end returns, so the whole op is captured in a CUDA
   graph at fixed shapes, with no host sync and no data-dependent shape.
2. ``moe_gemm<gated>``: one CTA a (chunk, 64 intermediate columns): the
   chunk's rows gathered from x, [gate | up] of those columns streamed
   through a 3-stage cp.async ring, mma.sync m16n8k16 for the chunk's m16
   tiles only, silu(g) * u in the epilogue, bf16 into ``act``.
3. ``moe_gemm<down>``: one CTA a (chunk, 128 output columns) over the
   expert's width, f32 partials per pair into ``out``.
4. ``moe_combine``: y_t in the order above, no atomics: deterministic,
   so a graph replay is bitwise the eager call.

LongCat-Flash's block (``LongcatFlashMoE``; a config.MoEConfig with no
shared expert) takes the expert-parallel path, whose router, chunk list
and combine are their own kernels around the same grouped product:

- x = bf16(h); logits x @ w_router in f32 over the router's n_experts +
  n_zero_experts outputs (cuBLAS: bf16 operands, f32 sums, as ``dot``);
  p = softmax(logits) in f32; the top_k of p + e_bias (the layer's
  correction bias, where it holds one; ties to the lower id) are chosen,
  and weighted by p (renormalised when ``norm_topk_prob``) times
  ``routed_scaling``, in f32;
- a chosen id from n_experts up is an identity expert: o_tj = x_t; a real
  expert held here ([expert_offset, + held)) gives the SwiGLU above over
  its local leaves ``w_gu_e`` / ``w_down_e`` [held, ...]; a real expert
  held elsewhere is skipped: what its chip would add is not this chip's
  part of the result;
- y_t = sum over j in order of w_tj o_tj (skipped pairs left out), in f32.
  The route kernel (one warp a token) writes the ids and weights; its
  last CTA lists the held experts' pairs and chunks as ``moe_route`` does.

A CPU tensor runs the twin; a CUDA tensor launches the kernels or raises.
``moe_ffn.launches`` counts calls that launched. Where the layer's leaves
hold ``moe_counts`` (int32 [3], or [5] on the expert-parallel path: the
layer's row of the engine's counters, runtime/pipeline.py), every call
adds to it: the (token, expert) pairs that the grouped product computed
(every routed pair, on the other path: those of held experts), the rows
it computed (pairs padded to its m16 tiles, per expert), the most rows
one expert got in one call (a max), then the pairs routed to identity
experts and those routed to real experts held elsewhere.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .layers import dot

CHUNK_ROWS = 64        # rows a work chunk of the grouped product
M_TILE = 16            # rows of an mma tile: the padding unit of `rows`
GU_COLS = 64           # intermediate columns a gate/up CTA (each of g, u)
DOWN_COLS = 128        # output columns a down CTA
MAX_EXPERTS = 128      # router: experts a warp holds (4 a lane)
MAX_TOP_K = 8
EP_MAX_ROUTER = 1024   # expert-parallel router: outputs a warp holds
EP_MAX_TOP_K = 16
EP_MAX_HELD = 256      # held experts: one thread each in the chunk list

_TICKETS: dict = {}    # device -> the route kernel's ticket (int32 [1])


def route(h: torch.Tensor, w_router: torch.Tensor, w_sgate: torch.Tensor,
          top_k: int, norm_topk_prob: bool):
    """(x = bf16(h) [N, H], experts [N, k] int64, weights [N, k] f32 of
    bf16 values, shared gate [N] f32), as the module docstring."""
    x = h.to(torch.bfloat16)
    xf = x.float()
    p = torch.softmax(xf @ w_router.float(), dim=-1)
    w, e = torch.topk(p, top_k, dim=-1)
    if norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    s = torch.sigmoid(xf @ w_sgate.float())
    return x, e, w.to(torch.bfloat16).float(), s


def swiglu(x: torch.Tensor, w_gu: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """bf16(silu(g) * u) @ w_down with [g | u] = x @ w_gu, f32 sums."""
    g, u = (x.float() @ w_gu.float()).chunk(2, dim=-1)
    return (F.silu(g) * u).to(torch.bfloat16).float() @ w_down.float()


def _count(cnt: torch.Tensor, e: torch.Tensor, n_experts: int) -> None:
    """Add one call's counts (module docstring) to cnt [3]."""
    rows = torch.bincount(e.reshape(-1), minlength=n_experts)
    padded = (rows + M_TILE - 1) // M_TILE * M_TILE
    cnt[0] += e.numel()
    cnt[1] += padded.sum().to(cnt.dtype)
    cnt[2] = torch.maximum(cnt[2], rows.max().to(cnt.dtype))


def expert_parallel(moe) -> bool:
    """Whether `moe` takes the expert-parallel path (no shared expert)."""
    return moe.shared_intermediate == 0


def route_ep(h: torch.Tensor, w_router: torch.Tensor,
             e_bias: torch.Tensor | None, moe):
    """(x = bf16(h) [N, H], router ids [N, k] int64, weights [N, k] f32) of
    the expert-parallel path (module docstring)."""
    x = h.to(torch.bfloat16)
    p = torch.softmax(x.float() @ w_router.float(), dim=-1)
    choice = p if e_bias is None else p + e_bias.float()
    e = torch.sort(choice, dim=-1, descending=True,
                   stable=True).indices[:, :moe.top_k]
    w = p.gather(1, e)
    if moe.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return x, e, w * moe.routed_scaling


def _count_ep(cnt: torch.Tensor, e: torch.Tensor, moe) -> None:
    """Add one expert-parallel call's counts (module docstring) to cnt [5]."""
    local = e - moe.expert_offset
    held = (local >= 0) & (local < moe.held)
    rows = torch.bincount(local[held], minlength=moe.held)
    padded = (rows + M_TILE - 1) // M_TILE * M_TILE
    zero = int((e >= moe.n_experts).sum())
    cnt[0] += int(held.sum())
    cnt[1] += padded.sum().to(cnt.dtype)
    cnt[2] = torch.maximum(cnt[2], rows.max().to(cnt.dtype))
    cnt[3] += zero
    cnt[4] += e.numel() - int(held.sum()) - zero


def _moe_ffn_ep_twin(h: torch.Tensor, wl: dict, moe) -> torch.Tensor:
    x, e, w = route_ep(h, wl["w_router"], wl.get("e_bias"), moe)
    N, H = h.shape
    local = e - moe.expert_offset
    held = (local >= 0) & (local < moe.held)
    out = x.float()[:, None, :].expand(N, moe.top_k, H).clone()
    for ex in local[held].unique().tolist():
        t, j = ((local == ex) & held).nonzero(as_tuple=True)
        out[t, j] = swiglu(x[t], wl["w_gu_e"][ex], wl["w_down_e"][ex])
    counted = (held | (e >= moe.n_experts))[..., None]
    y = torch.zeros(N, H, dtype=torch.float32, device=h.device)
    for j in range(moe.top_k):
        y = y + torch.where(counted[:, j], w[:, j, None] * out[:, j], 0.0)
    if "moe_counts" in wl:
        _count_ep(wl["moe_counts"], e, moe)
    return y


def moe_ffn_twin(h: torch.Tensor, wl: dict, moe) -> torch.Tensor:
    """Plain torch version of the module docstring's semantics: each
    expert over the pairs routed to it, by indexing. h [N, H] f32 ->
    [N, H] f32."""
    if expert_parallel(moe):
        return _moe_ffn_ep_twin(h, wl, moe)
    x, e, w, s = route(h, wl["w_router"], wl["w_sgate"], moe.top_k,
                       moe.norm_topk_prob)
    N, H = h.shape
    out = torch.zeros(N, moe.top_k, H, dtype=torch.float32, device=h.device)
    for ex in e.unique().tolist():
        t, j = (e == ex).nonzero(as_tuple=True)
        out[t, j] = swiglu(x[t], wl["w_gu_e"][ex], wl["w_down_e"][ex])
    y = w[:, 0, None] * out[:, 0]
    for j in range(1, moe.top_k):
        y = y + w[:, j, None] * out[:, j]
    if "moe_counts" in wl:
        _count(wl["moe_counts"], e, moe.n_experts)
    return y + s[:, None] * swiglu(x, wl["w_gu_s"], wl["w_down_s"])


def max_chunks(N: int, top_k: int, n_experts: int) -> int:
    """Work chunks the grouped product may list for N rows: the routed
    pairs' (at most one partial chunk an expert) and the shared expert's."""
    return (-(-N * top_k // CHUNK_ROWS) + n_experts
            + -(-N // CHUNK_ROWS))


def _scratch(dev, N: int, H: int, k: int, E: int, ld: int):
    """The call's scratch. Everything but the ticket comes from the
    caching allocator each call (a captured call's from its graph's pool),
    so a prefill of any N keeps nothing on the card after it; the ticket,
    which the kernel sets back to 0, is one a device."""
    if dev not in _TICKETS:
        _TICKETS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)
    return dict(
        x=empty(N, H, dtype=torch.bfloat16), experts=empty(N, k),
        weights=empty(N, k, dtype=torch.float32),
        sgate=empty(N, dtype=torch.float32), order=empty(N * k),
        chunks=empty(max_chunks(N, k, E), 3), n_chunks=empty(1),
        ticket=_TICKETS[dev],
        act=empty(N * (k + 1), ld, dtype=torch.bfloat16),
        out=empty(N * (k + 1), H, dtype=torch.float32))


def supported(H: int, moe) -> str | None:
    """Why the kernel cannot serve these widths (None: it can)."""
    if H % DOWN_COLS:
        return f"hidden {H} not a multiple of {DOWN_COLS}"
    if expert_parallel(moe):
        if moe.expert_intermediate % GU_COLS:
            return (f"expert width {moe.expert_intermediate} not a multiple "
                    f"of {GU_COLS}")
        if not 1 <= moe.top_k <= min(EP_MAX_TOP_K, moe.router_width):
            return f"top_k {moe.top_k} outside 1..{EP_MAX_TOP_K}"
        if moe.router_width > EP_MAX_ROUTER:
            return (f"{moe.router_width} router outputs: more than "
                    f"{EP_MAX_ROUTER}")
        if not (1 <= moe.held <= EP_MAX_HELD and moe.expert_offset >= 0
                and moe.expert_offset + moe.held <= moe.n_experts):
            return (f"held experts [{moe.expert_offset}, +{moe.held}) not "
                    f"inside 0..{moe.n_experts}, at most {EP_MAX_HELD}")
        return None
    if (moe.n_zero_experts or moe.routed_scaling != 1.0 or moe.expert_offset
            or moe.n_held not in (0, moe.n_experts)):
        return "a shared-expert block with LongCat's router settings"
    for name, n in (("expert", moe.expert_intermediate),
                    ("shared", moe.shared_intermediate)):
        if n % GU_COLS:
            return f"{name} width {n} not a multiple of {GU_COLS}"
    if not 1 <= moe.top_k <= min(MAX_TOP_K, moe.n_experts):
        return f"top_k {moe.top_k} outside 1..{MAX_TOP_K}"
    if moe.n_experts > MAX_EXPERTS or moe.n_experts % 8:
        return (f"{moe.n_experts} experts: not a multiple of 8 up to "
                f"{MAX_EXPERTS}")
    return None


def moe_ffn(h: torch.Tensor, wl: dict, moe,
            scratch: dict | None = None) -> torch.Tensor:
    """The MoE FFN of one layer (module docstring): h [N, H] f32, wl the
    layer's tensors (``stack.layer_weights``), moe a config.MoEConfig.
    Returns [N, H] f32. A `scratch` dict given on a CUDA tensor receives
    the call's scratch tensors (the routing the kernel chose, for tests)."""
    if not h.is_cuda:
        return moe_ffn_twin(h, wl, moe)
    N, H = h.shape
    why = supported(H, moe)
    if why is not None:
        raise ValueError(f"moe kernel: {why}")
    if expert_parallel(moe):
        return _moe_ffn_ep(h, wl, moe, scratch)
    E, k = moe.n_experts, moe.top_k
    Ie, Is = moe.expert_intermediate, moe.shared_intermediate
    req = kernels.require
    req(h, "h", torch.float32, (N, H))
    bf = torch.bfloat16
    req(wl["w_router"], "w_router", bf, (H, E))
    req(wl["w_sgate"], "w_sgate", bf, (H,))
    req(wl["w_gu_e"], "w_gu_e", bf, (E, H, 2 * Ie))
    req(wl["w_down_e"], "w_down_e", bf, (E, Ie, H))
    req(wl["w_gu_s"], "w_gu_s", bf, (H, 2 * Is))
    req(wl["w_down_s"], "w_down_s", bf, (Is, H))
    dev = h.device
    cnt = wl.get("moe_counts")
    if cnt is not None:
        req(cnt, "moe_counts", torch.int32, (3,))
    ld = max(Ie, Is)
    s = _scratch(dev, N, H, k, E, ld)
    if scratch is not None:
        scratch.update(s)
    y = torch.empty(N, H, dtype=torch.float32, device=dev)
    kernels.check(kernels.lib().q3_moe_ffn(
        h.data_ptr(), wl["w_router"].data_ptr(), wl["w_sgate"].data_ptr(),
        wl["w_gu_e"].data_ptr(), wl["w_down_e"].data_ptr(),
        wl["w_gu_s"].data_ptr(), wl["w_down_s"].data_ptr(),
        s["x"].data_ptr(), s["experts"].data_ptr(), s["weights"].data_ptr(),
        s["sgate"].data_ptr(), s["order"].data_ptr(), s["chunks"].data_ptr(),
        s["n_chunks"].data_ptr(), s["ticket"].data_ptr(),
        s["act"].data_ptr(), s["out"].data_ptr(), y.data_ptr(),
        None if cnt is None else cnt.data_ptr(), N, H, E, k, Ie, Is,
        max_chunks(N, k, E), int(moe.norm_topk_prob), kernels.stream(dev)),
        "q3_moe_ffn")
    moe_ffn.launches += 1
    return y


def _moe_ffn_ep(h: torch.Tensor, wl: dict, moe,
                scratch: dict | None) -> torch.Tensor:
    """The expert-parallel path on the card (module docstring): the router
    product by cuBLAS, then route, gate/up, down and combine kernels."""
    N, H = h.shape
    Et, k, held, Ie = moe.router_width, moe.top_k, moe.held, \
        moe.expert_intermediate
    req = kernels.require
    req(h, "h", torch.float32, (N, H))
    bf = torch.bfloat16
    req(wl["w_router"], "w_router", bf, (H, Et))
    req(wl["w_gu_e"], "w_gu_e", bf, (held, H, 2 * Ie))
    req(wl["w_down_e"], "w_down_e", bf, (held, Ie, H))
    bias = wl.get("e_bias")
    if bias is not None:
        req(bias, "e_bias", torch.float32, (Et,))
    cnt = wl.get("moe_counts")
    if cnt is not None:
        req(cnt, "moe_counts", torch.int32, (5,))
    dev = h.device
    if dev not in _TICKETS:
        _TICKETS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    x = h.to(bf)
    logits = dot(x, wl["w_router"])
    n_ch = -(-N * k // CHUNK_ROWS) + held

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)
    s = dict(x=x, logits=logits, experts=empty(N, k),
             weights=empty(N, k, dtype=torch.float32), order=empty(N * k),
             chunks=empty(n_ch, 3), n_chunks=empty(1), ticket=_TICKETS[dev],
             act=empty(N * k, Ie, dtype=bf),
             out=empty(N * k, H, dtype=torch.float32))
    if scratch is not None:
        scratch.update(s)
    y = torch.empty(N, H, dtype=torch.float32, device=dev)
    kernels.check(kernels.lib().q3_moe_ffn_ep(
        logits.data_ptr(), None if bias is None else bias.data_ptr(),
        x.data_ptr(), wl["w_gu_e"].data_ptr(), wl["w_down_e"].data_ptr(),
        s["experts"].data_ptr(), s["weights"].data_ptr(),
        s["order"].data_ptr(), s["chunks"].data_ptr(),
        s["n_chunks"].data_ptr(), s["ticket"].data_ptr(),
        s["act"].data_ptr(), s["out"].data_ptr(), y.data_ptr(),
        None if cnt is None else cnt.data_ptr(), N, H, Et, moe.n_experts,
        moe.expert_offset, held, k, Ie, n_ch, int(moe.norm_topk_prob),
        float(moe.routed_scaling), kernels.stream(dev)), "q3_moe_ffn_ep")
    moe_ffn.launches += 1
    return y


def n_counts(moe) -> int:
    """Columns of a layer's counters (module docstring)."""
    return 5 if expert_parallel(moe) else 3


moe_ffn.launches = 0
