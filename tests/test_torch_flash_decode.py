"""Port parity: the decode-attention kernel's twin (ops/flash_decode.py)
against the JAX package's Pallas flash_decode / flash_decode_masked in
interpret mode, in every mode; the int8 twin against the JAX XLA path; and
the dispatcher's CPU route."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tts_tpu.ops import attention as jattn  # noqa: E402
from qwen3_tts_tpu.ops.flash_decode import (flash_decode,  # noqa: E402
                                            flash_decode_masked)
from qwen3_tts_tpu.ops.layers import (  # noqa: E402
    gqa_attention_step_kvmajor as j_kvmajor)
from qwen3_tts_tpu_torch.ops import attention as tattn  # noqa: E402
from qwen3_tts_tpu_torch.ops import flash_decode as fd  # noqa: E402

# the kernel's f32 algorithm against the Pallas kernel's, both in f32
TOL = dict(atol=2e-5, rtol=2e-4)


def _mk(B, S, n_heads, n_kv, D, seed):
    """q [B, h, D], k/v kv-major [B, kv, S, D] (f32 numpy)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, n_heads, D)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, D)).astype(np.float32)
    return q, k, v


def _seq_major(a):
    return jnp.asarray(a.transpose(0, 2, 1, 3))


def _window_mask(B, S, P, lo, hi, seed):
    """Valid bits in the prefill rows and, at random, inside each
    stream's ring window [lo, hi) (wrapping when lo > hi)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, S), bool)
    for b in range(B):
        mask[b, :10] = True
        if lo[b] <= hi:
            sl = np.arange(lo[b], hi)
        else:
            sl = np.r_[np.arange(P, hi), np.arange(lo[b], S)]
        mask[b, sl] = rng.random(len(sl)) < 0.7
    return mask


PREFIX_CASES = {
    # (B, S, n_heads, n_kv, D), n_valid, read_ctx
    "talker_dims": ((2, 256, 16, 8, 128), [77, 256], None),
    "tiny_dims": ((2, 16, 4, 2, 64), [16, 5], None),
    "ragged": ((4, 384, 16, 8, 128), [1, 128, 200, 384], None),
    "nondivisible": ((2, 200, 8, 4, 64), [200, 77], None),
    "read_ctx_bound": ((2, 512, 8, 4, 64), [100, 250], 256),
    "empty_stream": ((2, 32, 4, 2, 16), [0, 5], None),
}


@pytest.mark.parametrize("case", list(PREFIX_CASES))
def test_twin_prefix_matches_pallas(case):
    shape, n_valid, read_ctx = PREFIX_CASES[case]
    q, k, v = _mk(*shape, seed=len(case))
    nv = np.asarray(n_valid, np.int32)
    want = flash_decode(jnp.asarray(q), _seq_major(k), _seq_major(v),
                        jnp.asarray(nv), read_ctx=read_ctx, block_s=128,
                        interpret=True)
    got = fd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(nv),
                          read_ctx=read_ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_twin_scattered_mask_matches_pallas():
    B, S, n_heads, n_kv, D = 3, 256, 16, 8, 128
    q, k, v = _mk(B, S, n_heads, n_kv, D, seed=5)
    mask = np.random.default_rng(6).random((B, S)) < 0.4
    mask[:, 0] = True
    want = flash_decode_masked(jnp.asarray(q), _seq_major(k), _seq_major(v),
                               jnp.asarray(mask), block_s=128, interpret=True)
    got = fd.flash_decode_masked(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


WINDOW_CASES = {
    # (B, S, n_heads, n_kv, D), lo per stream, scalar hi
    "window": ((4, 512, 16, 8, 128), [16, 130, 300, 450], 460),
    "wraparound": ((2, 384, 8, 4, 64), [300, 350], 120),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_twin_window_matches_pallas(case):
    shape, lo, hi = WINDOW_CASES[case]
    B, S = shape[:2]
    q, k, v = _mk(*shape, seed=7 + len(case))
    lo = np.asarray(lo, np.int32)
    mask = _window_mask(B, S, 16, lo, hi, seed=8)
    want = flash_decode_masked(
        jnp.asarray(q), _seq_major(k), _seq_major(v), jnp.asarray(mask),
        window_lo=jnp.asarray(lo), window_hi=jnp.int32(hi), prefill_len=16,
        block_s=128, interpret=True)
    got = fd.flash_decode_masked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), window_lo=torch.from_numpy(lo),
        window_hi=torch.tensor(hi, dtype=torch.int32), prefill_len=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_twin_window_predicate_drops_bits_outside():
    """A valid bit outside [0, prefill_len) U [lo, hi) lies in a block the
    kernel never reads, and the twin drops it too (the predicate is ANDed
    into the mask, so a wrong predicate in the kernel shows as a
    mismatch). Outside bits in a read block still count."""
    B, S = 1, 256
    q, k, v = (torch.from_numpy(a) for a in _mk(B, S, 4, 2, 64, seed=12))
    mask = torch.zeros(B, S, dtype=torch.bool)
    mask[0, [3, 100, 200]] = True            # prefill, read block, far
    lo = torch.tensor([64], dtype=torch.int32)
    hi = torch.tensor(101, dtype=torch.int32)
    got = fd.flash_decode_masked(q, k, v, mask, window_lo=lo, window_hi=hi,
                                 prefill_len=16)
    only = mask.clone()
    only[0, 200] = False
    want = fd.flash_decode_masked(q, k, v, only)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_empty_stream_outputs_zero():
    """A stream with no valid slot outputs 0 (prefix and bitmask)."""
    q, k, v = (torch.from_numpy(a) for a in _mk(2, 32, 4, 2, 16, seed=13))
    out = fd.flash_decode(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                          torch.tensor([0, 5], dtype=torch.int32))
    assert out[0].abs().max() == 0 and out[1].abs().max() > 0
    mask = torch.zeros(2, 32, dtype=torch.bool)
    mask[1, 4] = True
    out = fd.flash_decode_masked(q, k, v, mask)
    assert out[0].abs().max() == 0
    # one valid slot: each query head returns its kv head's V row
    torch.testing.assert_close(out[1].reshape(4, 16),
                               v[1, :, 4].repeat_interleave(2, dim=0))


def test_int8_twin_matches_xla_path():
    """int8 cache: the twin dequantizes rows to f32 and keeps f32
    probabilities; the JAX XLA path rounds p * v_scale to bf16 before the
    PV product. That rounding (relative 2^-9 per term) bounds the gap:
    |out| <= max|v| ~ 3, so 1e-2 absolute holds it with room, while a
    dropped scale moves the output by O(1)."""
    B, S, n_heads, n_kv, D = 3, 256, 16, 8, 128
    rng = np.random.default_rng(14)
    q = rng.standard_normal((B, n_heads, D)).astype(np.float32)
    kf = rng.standard_normal((2, B, n_kv, S, D)).astype(np.float32)
    scales = np.abs(kf).max(-1) / 127.0
    vals = np.clip(np.round(kf / scales[..., None]), -127, 127).astype(
        np.int8)
    mask = rng.random((B, S)) < 0.5
    mask[:, 0] = True
    want = j_kvmajor(jnp.asarray(q, jnp.bfloat16), jnp.asarray(vals[0]),
                     jnp.asarray(vals[1]), jnp.asarray(mask),
                     jnp.asarray(scales[0]), jnp.asarray(scales[1]))
    t = torch.from_numpy
    got = fd.flash_decode_masked(
        t(q).bfloat16(), t(vals[0]), t(vals[1]), t(mask),
        k_scale=t(scales[0]), v_scale=t(scales[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)
    dropped = fd.flash_decode_masked(
        t(q).bfloat16(), t(vals[0]), t(vals[1]), t(mask),
        k_scale=t(scales[0]), v_scale=torch.ones_like(t(scales[1])))
    assert np.abs(dropped.numpy() - np.asarray(want)).max() > 1.0


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_dispatcher_cpu_route_is_xla_path(quant):
    """On the CPU both dispatchers run the port of the XLA path and agree
    with the JAX dispatcher (whose 'auto' is that path) on the kv-major
    cache, prefix and bitmask."""
    B, S, n_heads, n_kv, D = 2, 128, 8, 4, 64
    rng = np.random.default_rng(15)
    q = rng.standard_normal((B, n_heads, D)).astype(np.float32)
    kv = rng.standard_normal((2, B, n_kv, S, D)).astype(np.float32)
    if quant:
        scales = np.abs(kv).max(-1) / 127.0
        kv = np.clip(np.round(kv / scales[..., None]), -127, 127).astype(
            np.int8)
        ks, vs = scales[0], scales[1]
        tk, tv = torch.from_numpy(kv[0]), torch.from_numpy(kv[1])
        jk, jv = jnp.asarray(kv[0]), jnp.asarray(kv[1])
    else:
        ks = vs = None
        tk = torch.from_numpy(kv[0]).bfloat16()
        tv = torch.from_numpy(kv[1]).bfloat16()
        jk = jnp.asarray(kv[0], jnp.bfloat16)
        jv = jnp.asarray(kv[1], jnp.bfloat16)
    tq = torch.from_numpy(q).bfloat16()
    jq = jnp.asarray(q, jnp.bfloat16)
    tks, tvs = ((None, None) if ks is None
                else (torch.from_numpy(ks), torch.from_numpy(vs)))
    jks, jvs = (None, None) if ks is None else (jnp.asarray(ks),
                                                jnp.asarray(vs))
    nv = np.array([40, 101], np.int32)
    got = tattn.decode_attention(tq, tk, tv, torch.from_numpy(nv),
                                 read_ctx=112, k_scale=tks, v_scale=tvs)
    want = jattn.decode_attention(jq, jk, jv, jnp.asarray(nv), read_ctx=112,
                                  k_scale=jks, v_scale=jvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    mask = rng.random((B, S)) < 0.5
    lo = torch.tensor([16, 90], dtype=torch.int32)
    got = tattn.decode_attention_masked(
        tq, tk, tv, torch.from_numpy(mask), read_ctx=128, window_lo=lo,
        window_hi=torch.tensor(40, dtype=torch.int32), prefill_len=16,
        k_scale=tks, v_scale=tvs)
    want = jattn.decode_attention_masked(
        jq, jk, jv, jnp.asarray(mask), read_ctx=128, k_scale=jks, v_scale=jvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_masked_window_requires_pair():
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 32, 4, 2, 16, seed=16))
    with pytest.raises(ValueError, match="together"):
        fd.flash_decode_masked(q, k, v, torch.ones(1, 32, dtype=torch.bool),
                               window_lo=torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("n_pairs,n_tiles,want",
                         [(64, 18, (2, 9)), (256, 18, (2, 9)),
                          (8, 18, (1, 18)), (64, 1, (1, 1))],
                         ids=["B8", "B32", "B1", "one_tile"])
def test_split_plan_fills_the_card_in_few_waves(n_pairs, n_tiles, want):
    """Talker widths (8 kv heads) on 132 SMs of 3 CTAs: at read_ctx 1,152
    (18 tiles) B=8 and B=32 take two-tile splits, which fill the card;
    one stream takes one-tile splits, which two-tile ones would not."""
    assert fd.split_plan(n_pairs, n_tiles, 132) == want


def test_split_plan_covers_every_tile_once():
    for n_pairs in (1, 8, 64, 256, 4096):
        for n_tiles in (1, 2, 7, 18, 64):
            per, n_split = fd.split_plan(n_pairs, n_tiles, 132)
            assert 1 <= n_split <= n_tiles
            assert (n_split - 1) * per < n_tiles <= n_split * per


def test_dispatcher_switch(monkeypatch):
    """set_decode_attention_impl (tests/test_flash_decode.py::
    test_dispatcher_switch): auto, flash (the kernel's twin on CPU
    tensors) and xla each agree with the JAX dispatcher's xla at the
    kernel's tolerance (TOL); only flash reaches the kernel's wrapper on
    the CPU; None restores auto; bogus and flash_interpret raise."""
    q, k, v = _mk(1, 64, 4, 2, 64, seed=4)
    n_valid = np.array([33], np.int32)
    jattn.set_decode_attention_impl("xla")
    try:
        want = np.asarray(jattn.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(n_valid)))
    finally:
        jattn.set_decode_attention_impl("auto")
    calls = []
    wrapper = tattn.flash_decode
    monkeypatch.setattr(tattn, "flash_decode",
                        lambda *a, **kw: calls.append(1) or wrapper(*a, **kw))
    for impl in ("auto", "flash", "xla"):
        tattn.set_decode_attention_impl(impl)
        try:
            assert tattn.get_decode_attention_impl() == impl
            got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                         torch.from_numpy(n_valid))
        finally:
            tattn.set_decode_attention_impl(None)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert len(calls) == (impl == "flash"), impl
        calls.clear()
    assert tattn.get_decode_attention_impl() == "auto"
    for bad in ("bogus", "flash_interpret"):
        with pytest.raises(ValueError):
            tattn.set_decode_attention_impl(bad)
