"""Port parity: qwen3_tts_tpu_torch.models.vocoder and the vocoder kernel
twins against the JAX package (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import vocoder as jv  # noqa: E402
from qwen3_tts_tpu.ops import vocoder_fused as jvf  # noqa: E402
from qwen3_tts_tpu_torch.models import vocoder as tv  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.ops import vocoder_fused as tvf  # noqa: E402

from .test_torch_config import port_cfg  # noqa: E402

VCFG = dataclasses.replace(jv.tiny_vocoder_config(), codebook_size=2048)
TVCFG = port_cfg(VCFG)


def _to_torch(tree, device="cpu"):
    return W.vocoder_weights_from_numpy(jax.tree.map(np.asarray, tree),
                                        device)


def _with_snake_params(w, seed):
    """Non-zero snake alphas/betas so exp(alpha), exp(-beta) matter."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        name = getattr(path[-1], "key", "")
        if name in ("a1", "b1", "a2", "b2", "snake_a", "snake_b",
                    "dec5_a", "dec5_b"):
            return jnp.asarray(rng.standard_normal(a.shape) * 0.3, a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, w)


@pytest.fixture(scope="module")
def weights():
    jw = _with_snake_params(
        jv.init_vocoder_weights(np.random.default_rng(2025), VCFG), 1)
    return jw, _to_torch(jw)


@pytest.fixture(scope="module")
def codes():
    return np.random.default_rng(3).integers(0, 2048, (2, 6, 16)).astype(
        np.int32)


@pytest.mark.parametrize("trim", ["both", "causal"])
def test_vocoder_decode_f32(weights, codes, trim):
    jw, tw = weights
    want = np.asarray(jv.vocoder_decode(jw, VCFG, jnp.asarray(codes), trim))
    got = tv.vocoder_decode(tw, TVCFG, torch.from_numpy(codes), trim).numpy()
    assert got.shape == want.shape
    assert got.shape[1] == tv.vocoder_output_length(tw, TVCFG, 6, trim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_vocoder_decode_bf16_subbatched_pcm16(weights):
    """The serving configuration: bf16 matrices (cast_weights), front
    once and the tail per sub-batch, int16 PCM."""
    jw, _ = weights
    jwb = jv.cast_weights(jw)
    twb = _to_torch(jwb)
    assert twb["dec_blocks"][0]["conv_t_w"].dtype == torch.bfloat16
    assert twb["dec_blocks"][0]["snake_a"].dtype == torch.float32
    c = np.random.default_rng(4).integers(0, 2048, (4, 40, 16)).astype(
        np.int32)
    want = np.asarray(jv.vocoder_decode_subbatched(
        jwb, VCFG, jnp.asarray(c), trim="causal", pcm16=True, sub=2))
    got = tv.vocoder_decode_subbatched(twb, TVCFG, torch.from_numpy(c),
                                       trim="causal", pcm16=True,
                                       sub=2).numpy()
    assert got.dtype == np.int16 and got.shape == (4, 40 * 16 * 4)
    # bf16 operand roundings can land one ulp apart; a few PCM steps
    assert np.abs(got.astype(np.int32) - want).max() <= 64


def test_cast_weights_matches_jax(weights):
    jw, tw = weights
    jc, tc = jv.cast_weights(jw), tv.cast_weights(tw)
    for jl_, tl_ in zip(jax.tree.leaves(jc), jax.tree.leaves(
            tc, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        assert str(tl_.dtype).split(".")[-1] == jl_.dtype.name


@pytest.mark.parametrize("stride,k", [(2, 2), (3, 6), (4, 8)])
def test_conv_transpose1d(stride, k):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    w = rng.standard_normal((8, 5, k)).astype(np.float32)
    want = jv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), stride)
    got = tv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                              stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _res_list(C, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    return [{"a1": rn(C, s=0.3), "b1": rn(C, s=0.3), "c1_w": rn(C, C, 7),
             "c1_b": rn(C), "a2": rn(C, s=0.3), "b2": rn(C, s=0.3),
             "c2_w": rn(C, C, 1), "c2_b": rn(C)} for _ in range(3)]


def _torch_res(res):
    tres = [{k: torch.from_numpy(v) for k, v in rw.items()} for rw in res]
    for rw in tres:
        rw["c1_w"] = rw["c1_w"].to(torch.bfloat16)
        rw["c2_w"] = rw["c2_w"].to(torch.bfloat16)
    return tres


def test_residual_chain_twin_matches_pallas_interpret():
    """Twin (the XLA chain with bf16 weights) vs the JAX Pallas chain in
    interpret mode; both round snake outputs and weights to bf16."""
    B, T, C = 2, 256, 64
    res = _res_list(C, 5)
    x = np.random.default_rng(6).standard_normal((B, T, C)).astype(
        np.float32)
    want = np.asarray(jvf.fused_residual_chain(
        jnp.asarray(x), jax.tree.map(jnp.asarray, res), interpret=True))
    got = tvf.fused_residual_chain(torch.from_numpy(x),
                                   {"res": _torch_res(res)}).numpy()
    # one bf16 ulp of a snake output where the f32 sums differ in order
    np.testing.assert_allclose(got, want, atol=5e-3 * np.abs(want).max())


def _head_block(C, C2, r, seed):
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal(C) * 0.3).astype(np.float32), (
        rng.standard_normal(C) * 0.3).astype(np.float32)
    w = (rng.standard_normal((C, C2, 2 * r)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(C2) * 0.1).astype(np.float32)
    return a, b, w, bias


def test_snake_convt_twin_matches_pallas_interpret():
    B, T, C, C2, r = 2, 64, 64, 32, 4
    a, b, w, bias = _head_block(C, C2, r, 7)
    x = np.random.default_rng(8).standard_normal((B, T, C)).astype(
        np.float32)
    want = np.asarray(jvf.fused_snake_convt(
        *map(jnp.asarray, (x, a, b, w, bias)), r, interpret=True))
    blk = {"snake_a": torch.from_numpy(a), "snake_b": torch.from_numpy(b),
           "conv_t_w": torch.from_numpy(w).to(torch.bfloat16),
           "conv_t_b": torch.from_numpy(bias)}
    got = tvf.fused_snake_convt(torch.from_numpy(x), blk, r).numpy()
    assert got.shape == (B, T * r, C2)
    np.testing.assert_allclose(got, want, atol=5e-3 * np.abs(want).max())


def _snake_bf16(x, a, ib):
    from qwen3_tts_tpu_torch.ops.layers import fast_sin2
    return (x + ib * fast_sin2(a * x)).to(torch.bfloat16).float()


def test_pack_block_reproduces_twins():
    """The kernels' math written in plain torch on pack_block's tensors
    (the [Whi; Wlo] head over [s[t] | s[t+1]], the tap-major w7 and the
    transposed w1, exp'd snake parameters) equals the twins, so the packed
    layouts the CUDA kernels read are the twins' weights."""
    B, T, C, C2, r = 2, 48, 64, 32, 4
    a, b, w, bias = _head_block(C, C2, r, 9)
    blk = {"snake_a": torch.from_numpy(a), "snake_b": torch.from_numpy(b),
           "conv_t_w": torch.from_numpy(w).to(torch.bfloat16),
           "conv_t_b": torch.from_numpy(bias), "res": _torch_res(
               _res_list(C2, 10))}
    packed = tvf.pack_block(blk)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (B, T, C)).astype(np.float32))

    wp, bp, ap, ibp = packed["head"]
    s = _snake_bf16(x, ap, ibp)
    s_next = torch.cat([s[:, 1:], torch.zeros_like(s[:, :1])], dim=1)
    head = (torch.cat([s, s_next], -1) @ wp.float() + bp).view(B, T * r, C2)
    want = tvf.snake_convt_twin(x, blk, r)
    torch.testing.assert_close(head, want, atol=1e-4, rtol=1e-4)

    y = want
    for (a1, ib1, w7, b1, a2, ib2, w1, b2), d in zip(packed["res"],
                                                     tvf.DILATIONS):
        s1 = torch.nn.functional.pad(_snake_bf16(y, a1, ib1),
                                     (0, 0, 6 * d, 0))
        h = b1 + sum(s1[:, k * d:k * d + T * r] @ w7[k].float()
                     for k in range(7))
        y = y + _snake_bf16(h, a2, ib2) @ w1.float() + b2
    ref = tvf.residual_chain_twin(want, blk)
    # one bf16 ulp of a snake output where the f32 sums differ in order
    torch.testing.assert_close(y, ref, atol=5e-3 * ref.abs().max().item(),
                               rtol=0)


@pytest.mark.parametrize("C,tile", [(768, 128), (384, 128), (192, 96),
                                    (96, 96), (64, 0), (100, 0)])
def test_chain_tile_n(C, tile):
    """The residual chain's column tile serves the four decoder blocks'
    widths without padding (96 where C is not a multiple of 128)."""
    assert tvf.tile_n(C) == tile
    assert tile == 0 or C % tile == 0


# the four heads' (C, r * C2) at the vocoder's widths
@pytest.mark.parametrize("C,N,tile", [(1536, 6144, 128), (768, 1920, 128),
                                      (384, 768, 128), (192, 288, 96)])
def test_head_tiles(C, N, tile):
    """Every head's width is served without padding: N by a column tile,
    its K = 2C depth by whole 64-row stages."""
    assert tvf.tile_n(N) == tile and N % tile == 0
    assert C % tvf.HEAD_K_STAGE == 0


def test_head_folds_streams_into_rows():
    """The head kernel's form: the B streams' rows stacked (row b*T + t),
    each row's K = 2C operand [s[row] | s[row + 1]] with the row after a
    stream's last one zeroed, times pack_block's [Whi; Wlo], equals the
    twin stream by stream."""
    B, T, C, C2, r = 3, 5, 64, 32, 4
    a, b, w, bias = _head_block(C, C2, r, 13)
    blk = {"snake_a": torch.from_numpy(a), "snake_b": torch.from_numpy(b),
           "conv_t_w": torch.from_numpy(w).to(torch.bfloat16),
           "conv_t_b": torch.from_numpy(bias), "res": []}
    wp, bp, ap, ibp = tvf.pack_block(blk)["head"]
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (B, T, C)).astype(np.float32))
    s = _snake_bf16(x, ap, ibp).reshape(B * T, C)
    ends = (torch.arange(B * T) + 1) % T == 0
    s_next = torch.cat([s[1:], torch.zeros(1, C)]).masked_fill(
        ends[:, None], 0.0)
    head = (torch.cat([s, s_next], -1) @ wp.float() + bp).view(B, T * r, C2)
    torch.testing.assert_close(head, tvf.snake_convt_twin(x, blk, r),
                               atol=1e-4, rtol=1e-4)


def test_head_scratch_cached_per_width(monkeypatch):
    """The head's bf16 s: a view of a flat buffer kept per (device, C),
    reused by a smaller call, grown for a larger one, apart from the
    chain's buffers of the same C."""
    monkeypatch.setattr(tvf, "_HEAD_SCRATCH", {})
    monkeypatch.setattr(tvf, "_CHAIN_SCRATCH", {})
    dev = torch.device("cpu")
    s = tvf._head_scratch(dev, 2, 40, 192)
    assert s.dtype == torch.bfloat16 and s.shape == (2, 40, 192)
    assert tvf._head_scratch(dev, 1, 70, 192).data_ptr() == s.data_ptr()
    assert tvf._head_scratch(dev, 3, 40, 192).shape == (3, 40, 192)
    assert tvf._chain_scratch(dev, 2, 40, 192)[0].data_ptr() != \
        tvf._head_scratch(dev, 2, 40, 192).data_ptr()
    assert len(tvf._HEAD_SCRATCH) == 1 and len(tvf._CHAIN_SCRATCH) == 1


def test_chain_scratch_cached_per_shape(monkeypatch):
    """The chain's bf16 s / y2 and f32 ping-pong buffers: views of flat
    buffers kept per (device, C), reused by a call of the same or a
    smaller shape and grown for a larger one."""
    monkeypatch.setattr(tvf, "_CHAIN_SCRATCH", {})
    dev = torch.device("cpu")
    s, y2, tmp = tvf._chain_scratch(dev, 2, 40, 96)
    assert (s.dtype, y2.dtype, tmp.dtype) == (torch.bfloat16,) * 2 + (
        torch.float32,)
    assert s.shape == y2.shape == tmp.shape == (2, 40, 96)
    assert all(t.is_contiguous() for t in (s, y2, tmp))
    again = tvf._chain_scratch(dev, 1, 30, 96)
    assert [t.data_ptr() for t in again] == [t.data_ptr()
                                             for t in (s, y2, tmp)]
    assert again[0].shape == (1, 30, 96)
    assert tvf._chain_scratch(dev, 2, 40, 192)[0].data_ptr() != s.data_ptr()
    bigger = tvf._chain_scratch(dev, 3, 40, 96)
    assert bigger[0].shape == (3, 40, 96)
    assert len(tvf._CHAIN_SCRATCH) == 2


@pytest.mark.parametrize("impl", ["xla", "fused", "auto"])
@pytest.mark.parametrize("trim", ["both", "causal"])
def test_res_chain_switch_on_cpu(weights, codes, impl, trim):
    """The ported set_res_chain_impl switch: every implementation runs the
    plain path on CPU tensors, as the JAX package takes its XLA chain off
    the TPU, so the audio is the JAX package's under each; None restores
    the default, auto; fused_interpret raises."""
    jw, tw = weights
    want = np.asarray(jv.vocoder_decode(jw, VCFG, jnp.asarray(codes), trim))
    tv.set_res_chain_impl(impl)
    try:
        assert tv._resolve_impl() == impl
        got = tv.vocoder_decode(tw, TVCFG, torch.from_numpy(codes), trim)
    finally:
        tv.set_res_chain_impl(None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert tv._resolve_impl() == "auto"
    with pytest.raises(ValueError, match="fused_interpret"):
        tv.set_res_chain_impl("fused_interpret")


def test_snake_fast_vs_exact():
    """set_snake_sin2_impl (tests/test_ops.py::TestFastSin2): fast against
    exact at the JAX test's tolerance (1e-5), each mode against the JAX
    snake in the same mode (f32 sines a few ulps apart: 1e-6); fast is
    the default; an unknown value raises."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 64, 8)) * 20).astype(np.float32)
    a = (rng.standard_normal(8) * 0.3).astype(np.float32)
    b = (rng.standard_normal(8) * 0.3).astype(np.float32)
    got, want = {}, {}
    assert tv.snake_sin2_impl() == "fast"
    for impl in ("exact", "fast"):
        tv.set_snake_sin2_impl(impl)
        jv.set_snake_sin2_impl(impl)
        try:
            got[impl] = tv.snake(*map(torch.from_numpy, (x, a, b))).numpy()
            want[impl] = np.asarray(jv.snake(*map(jnp.asarray, (x, a, b))))
        finally:
            tv.set_snake_sin2_impl("fast")
            jv.set_snake_sin2_impl("fast")
        np.testing.assert_allclose(got[impl], want[impl], atol=1e-6,
                                   rtol=1e-6)
    np.testing.assert_allclose(got["fast"], got["exact"], atol=1e-5,
                               rtol=1e-5)
    assert not np.array_equal(got["fast"], got["exact"])
    with pytest.raises(ValueError):
        tv.set_snake_sin2_impl("nope")


@pytest.mark.parametrize("kernel", ["chain", "head"])
def test_twins_exact_match_pallas_interpret(kernel):
    """Both vocoder kernels' twins in the exact sin^2 mode against the JAX
    Pallas kernels (interpret mode) in the JAX package's exact mode, at
    the fast-mode tests' tolerance above (one bf16 ulp of a snake
    output)."""
    rng = np.random.default_rng(9)
    tv.set_snake_sin2_impl("exact")
    jv.set_snake_sin2_impl("exact")
    try:
        if kernel == "chain":
            res = _res_list(64, 5)
            x = (rng.standard_normal((2, 256, 64)) * 3).astype(np.float32)
            want = np.asarray(jvf.fused_residual_chain(
                jnp.asarray(x), jax.tree.map(jnp.asarray, res),
                interpret=True))
            got = tvf.fused_residual_chain(torch.from_numpy(x),
                                           {"res": _torch_res(res)}).numpy()
        else:
            a, b, w, bias = _head_block(64, 32, 4, 7)
            x = (rng.standard_normal((2, 64, 64)) * 3).astype(np.float32)
            want = np.asarray(jvf.fused_snake_convt(
                *map(jnp.asarray, (x, a, b, w, bias)), 4, interpret=True))
            blk = {"snake_a": torch.from_numpy(a),
                   "snake_b": torch.from_numpy(b),
                   "conv_t_w": torch.from_numpy(w).to(torch.bfloat16),
                   "conv_t_b": torch.from_numpy(bias)}
            got = tvf.fused_snake_convt(torch.from_numpy(x), blk, 4).numpy()
    finally:
        tv.set_snake_sin2_impl("fast")
        jv.set_snake_sin2_impl("fast")
    np.testing.assert_allclose(got, want, atol=5e-3 * np.abs(want).max())


def test_res_chain_impl_traced():
    """res_chain_impl_traced (tests/test_vocoder_fused.py::
    test_res_chain_impl_traced_observation) reads what _res_chain took
    since the last reset, as the JAX function does over the same calls:
    untraced, auto on the CPU (the plain path, "xla"), fused (the
    wrappers, which run their twins on CPU tensors; the JAX package's
    fused_interpret), both ("mixed")."""
    C, T, B = 32, 64, 2
    res = _res_list(C, 11)
    x = np.random.default_rng(12).standard_normal((B, T, C)).astype(
        np.float32)
    jres, jx = jax.tree.map(jnp.asarray, res), jnp.asarray(x)
    tres, tx = {"res": _torch_res(res)}, torch.from_numpy(x)
    readings = []
    for port in (False, True):
        mod = tv if port else jv
        fused = "fused" if port else "fused_interpret"
        got = []
        mod.reset_res_chain_traced()
        got.append(mod.res_chain_impl_traced())
        run = ((lambda: tv._res_chain(tres, tx)) if port
               else (lambda: jv._res_chain(jres, jx)))
        run()
        got.append(mod.res_chain_impl_traced())
        mod.reset_res_chain_traced()
        mod.set_res_chain_impl(fused)
        try:
            run()
            got.append(mod.res_chain_impl_traced())
            mod.set_res_chain_impl("xla")
            run()
            got.append(mod.res_chain_impl_traced())
        finally:
            mod.set_res_chain_impl(None if port else "auto")
        readings.append(got)
    assert readings[0] == readings[1] == ["untraced", "xla", "fused",
                                          "mixed"]
