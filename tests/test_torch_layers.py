"""Port parity: qwen3_tts_tpu_torch.ops.layers / models.stack quantization
against the JAX package on the same numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import stack as jstack  # noqa: E402
from qwen3_tts_tpu.ops import layers as jl  # noqa: E402
from qwen3_tts_tpu_torch.models import stack as tstack  # noqa: E402
from qwen3_tts_tpu_torch.ops import layers as tl  # noqa: E402


def _bf16_pair(a):
    """The same bf16 values in both frameworks."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_neox(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    want = jl.rope_neox(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.rope_neox(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # f32 cos/sin of angles up to ~500 rad: a few ulps of the angle
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_gqa_attention_prefill():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 6, 4, 16))
    k = rng.standard_normal((2, 6, 2, 16))
    v = rng.standard_normal((2, 6, 2, 16))
    (qj, qt), (kj, kt), (vj, vt) = map(_bf16_pair, (q, k, v))
    want = jl.gqa_attention_prefill(qj, kj, vj)
    got = tl.gqa_attention_prefill(qt, kt, vt)
    # probabilities round to bf16 before PV in both: 1 bf16 ulp can flip
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_gqa_attention_step_kvmajor(quant):
    rng = np.random.default_rng(3)
    B, kv, S, D = 3, 2, 24, 16
    q = rng.standard_normal((B, 4, D))
    kf = rng.standard_normal((B, kv, S, D)).astype(np.float32)
    vf = rng.standard_normal((B, kv, S, D)).astype(np.float32)
    mask = np.arange(S)[None, :] < np.array([5, 17, 24])[:, None]
    qj, qt = _bf16_pair(q)
    if quant:
        kq, ks = jstack.quantize_kv_rows(jnp.asarray(kf))
        vq, vs = jstack.quantize_kv_rows(jnp.asarray(vf))
        want = jl.gqa_attention_step_kvmajor(qj, kq, vq, jnp.asarray(mask),
                                             ks, vs)
        tk, tks = tstack.quantize_kv_rows(torch.from_numpy(kf))
        tv, tvs = tstack.quantize_kv_rows(torch.from_numpy(vf))
        got = tl.gqa_attention_step_kvmajor(qt, tk, tv,
                                            torch.from_numpy(mask), tks, tvs)
    else:
        (kj, kt), (vj, vt) = _bf16_pair(kf), _bf16_pair(vf)
        want = jl.gqa_attention_step_kvmajor(qj, kj, vj, jnp.asarray(mask))
        got = tl.gqa_attention_step_kvmajor(qt, kt, vt, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_quantize_kv_rows_exact():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 3, 5, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                     # all-zero row: the 1e-8 floor
    qj, sj = jstack.quantize_kv_rows(jnp.asarray(x))
    qt, st = tstack.quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_fast_sin2():
    rng = np.random.default_rng(5)
    z = np.concatenate([rng.standard_normal(4000) * 30,
                        rng.standard_normal(100) * 1e5,
                        [0.0, np.pi / 2, -3e4, 3e4, 1e10]]).astype(np.float32)
    want = np.asarray(jl.fast_sin2(jnp.asarray(z)))
    got = tl.fast_sin2(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    small = np.abs(z) < 1e3
    np.testing.assert_allclose(got[small], np.sin(z[small]) ** 2, atol=1e-5)


def test_dot_keeps_f32_result():
    rng = np.random.default_rng(6)
    a, w = rng.standard_normal((4, 33)), rng.standard_normal((33, 7))
    (aj, at), (wj, wt) = _bf16_pair(a), _bf16_pair(w)
    want = jnp.dot(aj, wj, preferred_element_type=jnp.float32)
    got = tl.dot(at, wt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swiglu(dtype):
    """ops.swiglu (exported as in the JAX ops package) against
    jl.swiglu: f32 inputs, or bf16 inputs and weights; the activation
    rounds to Wd's dtype in both, so a bf16 ulp of it may land apart."""
    rng = np.random.default_rng(4)
    x, wg, wu, wd = (rng.standard_normal(s) * 0.3 for s in
                     ((3, 5, 32), (32, 48), (32, 48), (48, 32)))
    if dtype == "bf16":
        (jx, tx), (jg, tg), (ju, tu), (jd, td) = map(_bf16_pair,
                                                     (x, wg, wu, wd))
    else:
        jx, jg, ju, jd = (jnp.asarray(a, jnp.float32) for a in (x, wg, wu, wd))
        tx, tg, tu, td = (torch.from_numpy(a.astype(np.float32))
                          for a in (x, wg, wu, wd))
    from qwen3_tts_tpu_torch import ops
    got = ops.swiglu(tx, tg, tu, td)
    want = jl.swiglu(jx, jg, ju, jd)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 if dtype == "f32" else 2e-2)


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "mask"])
def test_gqa_attention_step_seq_major(masked):
    """ops.gqa_attention_step (prefix) and gqa_attention_step_masked
    (bitmask) over the seq-major cache [B, S, n_kv, D] against the JAX
    functions; probabilities round to bf16 before PV in both (1 bf16 ulp,
    as in test_gqa_attention_prefill)."""
    from qwen3_tts_tpu_torch import ops
    rng = np.random.default_rng(5)
    B, S, n_heads, n_kv, D = 3, 24, 8, 2, 16
    q = rng.standard_normal((B, n_heads, D))
    k = rng.standard_normal((B, S, n_kv, D))
    v = rng.standard_normal((B, S, n_kv, D))
    (qj, qt), (kj, kt), (vj, vt) = map(_bf16_pair, (q, k, v))
    if masked:
        mask = rng.random((B, S)) < 0.5
        mask[:, 0] = True
        want = jl.gqa_attention_step_masked(qj, kj, vj, jnp.asarray(mask))
        got = ops.gqa_attention_step_masked(qt, kt, vt,
                                            torch.from_numpy(mask))
    else:
        n_valid = np.array([1, 13, 24], np.int32)
        want = jl.gqa_attention_step(qj, kj, vj, jnp.asarray(n_valid))
        got = ops.gqa_attention_step(qt, kt, vt, torch.from_numpy(n_valid))
    assert got.shape == (B, n_heads * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)
