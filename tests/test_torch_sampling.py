"""Port parity: qwen3_tts_tpu_torch.ops.sampling against the JAX package.

Greedy must match exactly; sampled mode matches exactly when the port is
fed the Gumbel noise that jax.random.categorical draws from the same key
(categorical(key, x) == argmax(gumbel(key, x.shape) + x))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.ops import sampling as js  # noqa: E402
from qwen3_tts_tpu_torch.ops import sampling as ts  # noqa: E402

B, V = 6, 512


def _logits(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    x[0, 10:14] = x[0].max() + 1.0          # a 4-way tie at the top
    return x


def _gumbel(key, shape):
    return np.array(jax.random.gumbel(key, shape, jnp.float32))


def test_apply_top_k_keeps_ties():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5]], np.float32)
    got = ts.apply_top_k(torch.from_numpy(x), 2).numpy()
    want = np.asarray(js.apply_top_k(jnp.asarray(x), 2))
    np.testing.assert_array_equal(got, want)
    assert (got == 3.0).sum() == 3                   # all tied survivors


@pytest.mark.parametrize("top_k", [0, 1, 50, V])
def test_apply_top_k(top_k):
    x = _logits(1)
    np.testing.assert_array_equal(
        ts.apply_top_k(torch.from_numpy(x), top_k).numpy(),
        np.asarray(js.apply_top_k(jnp.asarray(x), top_k)))


def test_gumbel_matches_categorical_law():
    """The identity the port relies on, checked on the JAX side."""
    x = jnp.asarray(_logits(2))
    key = jax.random.PRNGKey(11)
    want = jax.random.categorical(key, x, axis=-1)
    got = jnp.argmax(jax.random.gumbel(key, x.shape, jnp.float32) + x, -1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["greedy", "t0", "sampled"])
def test_sample_codes(mode):
    x = _logits(3)
    key = jax.random.PRNGKey(5)
    temp = 0.0 if mode == "t0" else 0.8
    want = js.sample_codes(jnp.asarray(x), jnp.float32(temp), 50, key,
                           greedy=mode == "greedy")
    got = ts.sample_codes(torch.from_numpy(x), temp, 50,
                          greedy=mode == "greedy",
                          gumbel=torch.from_numpy(_gumbel(key, x.shape)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mode != "sampled":
        assert got[0] == 10                         # first of the tied max


def _cb0_inputs(seed):
    rng = np.random.default_rng(seed)
    vocab = 3072
    logits = (rng.standard_normal((B, vocab)) * 2).astype(np.float32)
    seen = rng.random((B, vocab)) < 0.05
    frame_idx = np.array([0, 10, 30, 45, 60, 90], np.int32)
    expected = np.array([20, 20, 24, 40, 40, 48], np.int32)
    return logits, seen, frame_idx, expected


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_sample_cb0(mode):
    logits, seen, frame_idx, expected = _cb0_inputs(4)
    key = jax.random.PRNGKey(9)
    kw = dict(eos_id=2150, suppress_start=2048, greedy=mode == "greedy")
    want = js.sample_cb0(jnp.asarray(logits), jnp.asarray(seen),
                         jnp.asarray(frame_idx), jnp.asarray(expected),
                         jnp.float32(1.05), jnp.float32(0.9), 50, key, **kw)
    got = ts.sample_cb0(torch.from_numpy(logits), torch.from_numpy(seen),
                        torch.from_numpy(frame_idx),
                        torch.from_numpy(expected), 1.05, 0.9, 50,
                        gumbel=torch.from_numpy(
                            _gumbel(key, logits.shape)), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # suppressed ids never come out; the fully ramped stream ends
    assert ((got.numpy() < 2048) | (got.numpy() == 2150)).all()
    if mode == "greedy":
        assert got[5] == 2150


def test_sample_cb0_draws_from_generator():
    logits, seen, frame_idx, expected = _cb0_inputs(6)
    args = (torch.from_numpy(logits), torch.from_numpy(seen),
            torch.from_numpy(frame_idx), torch.from_numpy(expected), 1.05,
            0.9, 50)
    kw = dict(eos_id=2150, suppress_start=2048)
    a = ts.sample_cb0(*args, torch.Generator().manual_seed(1), **kw)
    b = ts.sample_cb0(*args, torch.Generator().manual_seed(1), **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("top_k", [0, 50, V])
@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9])
def test_apply_top_p(top_p, top_k):
    """After top-k, the same surviving set and values as the JAX filter."""
    x = _logits(8)
    want = js.apply_top_p(js.apply_top_k(jnp.asarray(x), top_k), top_p, top_k)
    got = ts.apply_top_p(ts.apply_top_k(torch.from_numpy(x), top_k), top_p,
                         top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = got.numpy() > js.NEG_INF / 2
    assert kept[np.arange(B), x.argmax(-1)].all()    # the argmax survives
    assert (kept.sum(-1) < (top_k if 0 < top_k < V else V)).any()


@pytest.mark.parametrize("top_k", [0, 50])
def test_sample_codes_top_p(top_k):
    x = _logits(9)
    key = jax.random.PRNGKey(13)
    want = js.sample_codes(jnp.asarray(x), jnp.float32(0.8), top_k, key,
                           top_p=0.7)
    got = ts.sample_codes(torch.from_numpy(x), 0.8, top_k, top_p=0.7,
                          gumbel=torch.from_numpy(_gumbel(key, x.shape)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_codes_tiny_top_p_is_greedy():
    """top_p -> 0 leaves only the argmax: sampled draws give JAX's greedy
    codes (row 0's 4-way tie at the top survives whole, so it is left
    out)."""
    x = _logits(10)[1:]
    want = js.sample_codes(jnp.asarray(x), jnp.float32(0.8), 50,
                           jax.random.PRNGKey(0), greedy=True)
    for seed in range(3):
        got = ts.sample_codes(torch.from_numpy(x), 0.8, 50, top_p=1e-6,
                              generator=torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cb0_call(pkg, logits, seen, frame_idx, expected, top_k, top_p, key):
    kw = dict(eos_id=2150, suppress_start=2048, top_p=top_p)
    if pkg is js:
        return np.asarray(js.sample_cb0(
            jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(frame_idx),
            jnp.asarray(expected), jnp.float32(1.05), jnp.float32(0.9), top_k,
            key, **kw))
    return ts.sample_cb0(
        torch.from_numpy(logits), torch.from_numpy(seen),
        torch.from_numpy(frame_idx), torch.from_numpy(expected), 1.05, 0.9,
        top_k, gumbel=torch.from_numpy(_gumbel(key, logits.shape)),
        **kw).numpy()


@pytest.mark.parametrize("top_k", [0, 50])
def test_sample_cb0_top_p_keeps_eos(top_k):
    """The nucleus filter runs over the top_k + 1 survivors and EOS is put
    back after it: with the noise spiked on EOS every stream samples EOS,
    however little mass it has; with JAX's own draws the codes equal
    JAX's. top_k = 0 is ROADMAP C.3's cell: the nucleus sees one entry, so
    only the argmax and EOS can come out, in both packages."""
    logits, seen, frame_idx, expected = _cb0_inputs(12)
    logits[:, 2150] = logits.min() - 5.0            # EOS far below the rest
    frame_idx[:] = 0                                # no EOS ramp
    key = jax.random.PRNGKey(21)
    want = _cb0_call(js, logits, seen, frame_idx, expected, top_k, 0.9, key)
    got = _cb0_call(ts, logits, seen, frame_idx, expected, top_k, 0.9, key)
    np.testing.assert_array_equal(got, want)
    spiked = np.zeros(logits.shape, np.float32)
    spiked[:, 2150] = 1e30
    eos = ts.sample_cb0(
        torch.from_numpy(logits), torch.from_numpy(seen),
        torch.from_numpy(frame_idx), torch.from_numpy(expected), 1.05, 0.9,
        top_k, eos_id=2150, suppress_start=2048, top_p=0.9,
        gumbel=torch.from_numpy(spiked))
    assert (eos.numpy() == 2150).all()
    if top_k == 0:
        greedy = _cb0_call(ts, logits, seen, frame_idx, expected, 0, 1.0,
                           key)
        ts_greedy = ts.sample_cb0(
            torch.from_numpy(logits), torch.from_numpy(seen),
            torch.from_numpy(frame_idx), torch.from_numpy(expected), 1.05,
            0.9, 0, eos_id=2150, suppress_start=2048, greedy=True).numpy()
        assert ((got == ts_greedy) | (got == 2150)).all()
        assert not (greedy == ts_greedy).all()      # top_p = 1 samples
