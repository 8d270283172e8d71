"""The plain reference of LongCat-Flash's shortcut MoE and of its double
layers (transformers' ``LongcatFlashTopkRouter``, ``LongcatFlashMoE`` and
``LongcatFlashDecoderLayer``), built on reference/mla.py and
reference/layers.py: float32 products (or the float8 control, ``Prec``),
no cache, no kernel; the routed experts one at a time over the tokens
routed to them, by indexing. It reads the layout of benchmark/archs/
longcat_flash_talker.py (the program's): router ``w_router`` [L, H, E + Z],
correction bias ``e_bias`` [L, E + Z], the held experts ``w_gu_e`` [L,
held, H, 2 Ie] ([gate | up]) / ``w_down_e`` [L, held, Ie, H], the dense
FFNs ``w_gu`` [L, 2, H, 2 I] / ``w_down`` [L, 2, I, H].

The block: p = softmax(h W_router) in f32 over E real and Z identity
experts; the top_k of p + e_bias; weights p times the scaling, not
renormalised; a real expert a SwiGLU, an identity expert h itself; no
shared expert. Of the real experts only those held ([expert_offset, +
held)) are computed: what the others add lies on other chips of the
deployment, and is left out here as in the program.

A double layer, for x: y = x + MLA_0(norm_in0(x)); h1 = norm_post0(y);
m = MoE(h1); y = y + FFN_0(h1); y = y + MLA_1(norm_in1(y)); y = y +
FFN_1(norm_post1(y)) + m.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Prec, rms_norm
from .mla import mla


def route(p: Prec, h, w_router, e_bias, top_k: int, scaling: float):
    """(router ids [N, k], weights [N, k]) of rows h [N, H]."""
    probs = torch.softmax(p.mm(h, w_router), dim=-1)
    e = torch.topk(probs + e_bias.float(), top_k, dim=-1).indices
    return e, probs.gather(1, e) * scaling


def swiglu(p: Prec, h, w_gu, w_down):
    g, u = p.mm(h, w_gu).chunk(2, dim=-1)
    return p.mm(F.silu(g) * u, w_down)


def moe_block(p: Prec, lw: dict, l: int, h, *, n_experts: int, top_k: int,
              scaling: float, expert_offset: int, routes: list | None = None):
    """Double layer l's shortcut MoE over rows h [N, H] -> [N, H] f32;
    `routes`, when a list, gains the ids chosen [N, k]."""
    e, w = route(p, h, lw["w_router"][l], lw["e_bias"][l], top_k, scaling)
    if routes is not None:
        routes.append(e)
    y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for i in range(lw["w_gu_e"][l].shape[0]):
        t, j = (e == expert_offset + i).nonzero(as_tuple=True)
        if len(t):
            o = swiglu(p, h[t], lw["w_gu_e"][l][i], lw["w_down_e"][l][i])
            y.index_add_(0, t, w[t, j, None] * o)
    t, j = (e >= n_experts).nonzero(as_tuple=True)
    return y.index_add_(0, t, w[t, j, None] * h[t].float())


def longcat_stack(p: Prec, lw: dict, x, *, eps: float, mla_kw: dict,
                  moe_kw: dict, routes: list | None = None):
    """The double layers over x [B, T, H] -> their output [B, T, H] (before
    the output norm). mla_kw: reference.mla.mla's keywords; moe_kw:
    moe_block's."""
    B, T, H = x.shape
    x = x.float()
    for l in range(lw["attn_norm"].shape[0]):
        for s in (0, 1):
            x = x + mla(p, lw, l, s, rms_norm(x, lw["attn_norm"][l][s], eps),
                        **mla_kw)
            h = rms_norm(x, lw["ffn_norm"][l][s], eps)
            if s == 0:
                m = moe_block(p, lw, l, h.reshape(B * T, H), routes=routes,
                              **moe_kw).reshape(B, T, H)
            x = x + swiglu(p, h, lw["w_gu"][l][s], lw["w_down"][l][s])
        x = x + m
    return x
