"""Random weights from the seed, made on the device in a few large calls,
in the layouts that the program's ``Qwen3TTS.from_components`` takes and
that the reference reads (linear weights [in, out]; per-layer tensors
stacked [L, ...]; fused ``wqkv`` [q | k | v] and ``w_gu`` [gate | up];
convolutions in torch order). An architecture (benchmark/archs/) lists
its leaves in a ``Spec``, from the shared stack and vocoder specs here and
its own, and makes them from the seed.

The normal draws of each dtype come from one ``torch.Generator`` on the
device in chunks of ``CHUNK`` values, and each leaf is a view of one flat
buffer, scaled to its own standard deviation. The same seed on the same
device gives the same bits, which is how the reference gets its weights:
it makes them again from the seed after the program's state is freed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

CHUNK = 1 << 27


@dataclass
class Leaf:
    path: tuple
    shape: tuple
    dtype: torch.dtype
    kind: str            # "normal", "one_plus_normal", "const"
    arg: float           # std, or the constant


class Spec:
    def __init__(self):
        self.leaves: list[Leaf] = []

    def add(self, path, shape, dtype, kind, arg):
        self.leaves.append(Leaf(tuple(path), tuple(shape), dtype, kind,
                                float(arg)))

    def materialize(self, generator: torch.Generator, device) -> dict:
        """Every leaf as a view of one flat buffer per dtype; the normal
        draws in chunks of CHUNK values."""
        out: dict = {}
        for dtype in dict.fromkeys(l.dtype for l in self.leaves):
            group = [l for l in self.leaves if l.dtype == dtype]
            rand = [l for l in group if l.kind != "const"]
            offs, o = {}, 0
            for leaf in rand + [l for l in group if l.kind == "const"]:
                offs[id(leaf)] = (o, o + math.prod(leaf.shape))
                o += math.prod(leaf.shape)
            flat = torch.empty(o, dtype=dtype, device=device)
            n_rand = sum(math.prod(l.shape) for l in rand)
            for c0 in range(0, n_rand, CHUNK):
                c1 = min(c0 + CHUNK, n_rand)
                z = torch.randn(c1 - c0, generator=generator, device=device)
                for leaf in rand:
                    a, b = offs[id(leaf)]
                    lo, hi = max(a, c0), min(b, c1)
                    if lo >= hi:
                        continue
                    v = z[lo - c0:hi - c0] * leaf.arg
                    if leaf.kind == "one_plus_normal":
                        v += 1.0
                    flat[lo:hi] = v.to(dtype)
            for leaf in group:
                a, b = offs[id(leaf)]
                if leaf.kind == "const":
                    flat[a:b] = leaf.arg
                _put(out, leaf.path, flat[a:b].view(leaf.shape))
        return out


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def stack_spec(spec: Spec, prefix: tuple, s, std: float, norm_std: float):
    """A dense decoder stack's leaves under `prefix` (`s`: model.Stack):
    the layout that reference.layers.decoder_stack reads."""
    bf, f32 = torch.bfloat16, torch.float32
    L, H, D = s.layers, s.hidden, s.head_dim
    spec.add(prefix + ("attn_norm",), (L, H), f32, "one_plus_normal", norm_std)
    spec.add(prefix + ("wqkv",), (L, H, (s.heads + 2 * s.kv_heads) * D), bf,
             "normal", std)
    spec.add(prefix + ("wo",), (L, s.heads * D, H), bf, "normal", std)
    spec.add(prefix + ("q_norm",), (L, D), f32, "one_plus_normal", norm_std)
    spec.add(prefix + ("k_norm",), (L, D), f32, "one_plus_normal", norm_std)
    spec.add(prefix + ("ffn_norm",), (L, H), f32, "one_plus_normal", norm_std)
    spec.add(prefix + ("w_gu",), (L, H, 2 * s.intermediate), bf, "normal", std)
    spec.add(prefix + ("w_down",), (L, s.intermediate, H), bf, "normal", std)


def vocoder_spec(m, matrix_dtype: torch.dtype) -> Spec:
    """Vocoder leaves of model `m` (its ``vocoder`` shapes and
    ``random`` scales; the program's layout): matrices and convolutions
    normal(0, 1/sqrt(fan_in)) in `matrix_dtype`, 1-D parameters f32. The
    decoder blocks' convT times ``decoder_convt_gain`` and their residual
    units' k7 convolutions times ``res_branch_gain`` keep the activations
    from growing block by block (where Snake's sin^2 of a large argument
    would turn bf16 rounding into phase noise); the last convolution
    times ``vocoder_out_gain`` sets the audio's level below tanh's knee."""
    v, f32, md = m.vocoder, torch.float32, matrix_dtype
    nstd = m.random["norm_std"]
    spec = Spec()

    def mat(path, shape, fan_in):
        spec.add(path, shape, md, "normal", fan_in ** -0.5)

    def vec(path, n, kind="const", arg=0.0):
        spec.add(path, (n,), f32, kind, arg)

    w, q = v.hidden, v.latent_dim
    spec.add(("vq_first_codebook",), (v.codebook_size, v.codebook_dim), md,
             "normal", 1.0)
    mat(("vq_first_out_proj",), (v.codebook_dim, v.hidden), v.codebook_dim)
    spec.add(("vq_rest_codebooks",),
             (v.n_codebooks - 1, v.codebook_size, v.codebook_dim), md,
             "normal", 1.0)
    mat(("vq_rest_out_proj",), (v.codebook_dim, v.hidden),
        v.codebook_dim * (v.n_codebooks - 1))
    mat(("pre_conv_w",), (q, v.hidden, 3), 3 * v.hidden)
    vec(("pre_conv_b",), q)
    t = ("pre_tfm",)
    mat(t + ("in_w",), (q, w), q)
    vec(t + ("in_b",), w)
    mat(t + ("out_w",), (w, q), w)
    vec(t + ("out_b",), q)
    vec(t + ("norm",), w, "one_plus_normal", nstd)
    L = t + ("layers",)
    spec.add(L + ("attn_norm",), (v.layers, w), f32, "one_plus_normal", nstd)
    for k in ("wq", "wk", "wv"):
        spec.add(L + (k,), (v.layers, w, q), md, "normal", w ** -0.5)
    spec.add(L + ("wo",), (v.layers, q, w), md, "normal", q ** -0.5)
    spec.add(L + ("attn_scale",), (v.layers, w), f32, "const", 0.5)
    spec.add(L + ("ffn_norm",), (v.layers, w), f32, "one_plus_normal", nstd)
    for k in ("w_gate", "w_up"):
        spec.add(L + (k,), (v.layers, w, 2 * w), md, "normal", w ** -0.5)
    spec.add(L + ("w_down",), (v.layers, 2 * w, w), md, "normal",
             (2 * w) ** -0.5)
    spec.add(L + ("ffn_scale",), (v.layers, w), f32, "const", 0.5)
    for i in range(2):
        u = ("upsample", i)
        mat(u + ("conv_t_w",), (q, q, 2), q)
        vec(u + ("conv_t_b",), q)
        mat(u + ("dw_w",), (q, 1, 7), 7)
        vec(u + ("dw_b",), q)
        vec(u + ("ln_w",), q, "one_plus_normal", nstd)
        vec(u + ("ln_b",), q)
        mat(u + ("pw1_w",), (q, 2 * q), q)
        vec(u + ("pw1_b",), 2 * q)
        mat(u + ("pw2_w",), (2 * q, q), 2 * q)
        vec(u + ("pw2_b",), q)
        vec(u + ("gamma",), q, "const", 0.5)
    c = v.decoder_dim
    mat(("dec0_w",), (c, q, 7), 7 * q)
    vec(("dec0_b",), c)
    for i, rate in enumerate(v.upsample_rates):
        d = ("dec_blocks", i)
        vec(d + ("snake_a",), c, "normal", 0.3)
        vec(d + ("snake_b",), c, "normal", 0.3)
        spec.add(d + ("conv_t_w",), (c, c // 2, 2 * rate), md, "normal",
                 m.random["decoder_convt_gain"] * (2 * c) ** -0.5)
        vec(d + ("conv_t_b",), c // 2, "normal", 0.1)
        ch = c // 2
        for j in range(3):
            rb = d + ("res", j)
            vec(rb + ("a1",), ch, "normal", 0.3)
            vec(rb + ("b1",), ch, "normal", 0.3)
            spec.add(rb + ("c1_w",), (ch, ch, 7), md, "normal",
                     m.random["res_branch_gain"] * (7 * ch) ** -0.5)
            vec(rb + ("c1_b",), ch, "normal", 0.1)
            vec(rb + ("a2",), ch, "normal", 0.3)
            vec(rb + ("b2",), ch, "normal", 0.3)
            mat(rb + ("c2_w",), (ch, ch, 1), ch)
            vec(rb + ("c2_b",), ch, "normal", 0.1)
        c = ch
    vec(("dec5_a",), c, "normal", 0.3)
    vec(("dec5_b",), c, "normal", 0.3)
    spec.add(("dec6_w",), (1, c, 7), md, "normal",
             m.random["vocoder_out_gain"] * (7 * c) ** -0.5)
    vec(("dec6_b",), 1)
    return spec


def as_lists(tree):
    """Dicts keyed 0..n-1 (upsample, dec_blocks, res) as lists."""
    if isinstance(tree, dict):
        tree = {k: as_lists(v) for k, v in tree.items()}
        if tree and all(isinstance(k, int) for k in tree):
            return [tree[i] for i in range(len(tree))]
    return tree


@dataclass
class Weights:
    talker: dict
    vocoder: dict
    voices: torch.Tensor       # [n_voices, hidden] f32
