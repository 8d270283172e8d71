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

A CPU tensor runs the twin; a CUDA tensor launches the kernels or raises.
``moe_ffn.launches`` counts calls that launched. Where the layer's leaves
hold ``moe_counts`` (int32 [3], the layer's row of the engine's counters,
runtime/pipeline.py), every call adds to it: the (token, expert) pairs
routed, the rows the grouped product computed (pairs padded to its m16
tiles, per expert) and the most rows one expert got in one call (a max).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

CHUNK_ROWS = 64        # rows a work chunk of the grouped product
M_TILE = 16            # rows of an mma tile: the padding unit of `rows`
GU_COLS = 64           # intermediate columns a gate/up CTA (each of g, u)
DOWN_COLS = 128        # output columns a down CTA
MAX_EXPERTS = 128      # router: experts a warp holds (4 a lane)
MAX_TOP_K = 8

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


def moe_ffn_twin(h: torch.Tensor, wl: dict, moe) -> torch.Tensor:
    """Plain torch version of the module docstring's semantics: each
    expert over the pairs routed to it, by indexing. h [N, H] f32 ->
    [N, H] f32."""
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


moe_ffn.launches = 0
