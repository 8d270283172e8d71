"""The port's CUDA kernels against their plain torch twins, on a card.

Marked ``cuda``: they skip where torch sees no CUDA device. This file
imports no JAX and nothing of the JAX package; on a GPU machine without
JAX, skip tests/conftest.py (which imports it):
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_tts_tpu_torch.config import (  # noqa: E402
    TalkerConfig, TokenizerSpecialTokens, VocoderConfig)
from qwen3_tts_tpu_torch.models import vocoder  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.ops import codepred_fused as cf  # noqa: E402
from qwen3_tts_tpu_torch.ops import vocoder_fused as vf  # noqa: E402
from qwen3_tts_tpu_torch.runtime.pipeline import (  # noqa: E402
    Qwen3TTS, TTSParams)
from qwen3_tts_tpu_torch.tokenizer import TextTokenizer  # noqa: E402

import chip_smoke  # noqa: E402  (the repository root: its model writer)

pytestmark = pytest.mark.cuda

# logits, kernels vs twin: activations round to bf16 after f32 sums taken
# in another order, so a value can land one bf16 ulp apart; measured
# 1.3e-2 at B=8 on an H100 (chip_smoke.py)
LOGIT_TOL = 5e-2
# vocoder outputs relative to the twin's RMS, as chip_smoke.py: bf16
# operands that round the other way (and, in the chain, the flips they
# cause downstream) stay near 1e-3 in RMS; a skipped snake parameter or a
# dropped bias moves the error's RMS by several 1e-2
VOC_MAX_TOL = 5e-2          # max |err| / RMS
VOC_RMS_TOL = 5e-3          # RMS(err) / RMS


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _code_pred_weights(cfg, gen, dev):
    """Only what the code predictor reads: codec_embd and code_pred."""
    w = W.init_talker_weights(
        TalkerConfig(text_vocab_size=16, n_layers=1), gen, dev)
    return {"codec_embd": w["codec_embd"], "code_pred": w["code_pred"]}


@pytest.fixture(scope="module")
def cp_weights(dev):
    cfg = TalkerConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, _code_pred_weights(cfg, gen, dev)


# B = 1, 17 and 64 leave ragged 16-row MMA tiles and one or two 64-row
# groups; B = 64 fills a group
@pytest.mark.parametrize("B", [1, 8, 17, 64])
def test_codepred_forced_frame(dev, cp_weights, B):
    """Teacher-forced frame (spiked noise feeds fixed codes): the kernel
    returns the forced codes, and every position's logits match the twin."""
    cfg, w = cp_weights
    gen = torch.Generator(device=dev).manual_seed(B)
    V = cfg.code_pred_vocab_size
    hidden = torch.randn(B, cfg.hidden_size, generator=gen, device=dev) * 0.5
    cb0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    forced = torch.randint(0, V, (15, B, 1), generator=gen, device=dev)
    spikes = torch.zeros(15, B, V, device=dev).scatter_(2, forced, 1e30)
    lk, lt = (torch.empty(15, B, V, device=dev) for _ in range(2))
    before = cf.predict_codes_fused.launches
    got = cf.predict_codes_fused(w, cfg, hidden, cb0, 1.0, 0, gumbel=spikes,
                                 logits_out=lk)
    ref = cf.predict_codes_twin(w, cfg, hidden, cb0, 1.0, 0, gumbel=spikes,
                                logits_out=lt)
    assert cf.predict_codes_fused.launches == before + 1
    assert torch.equal(got, forced[:, :, 0].t().int())
    assert torch.equal(ref, got)
    assert (lk - lt).abs().max().item() <= LOGIT_TOL


def _profiled_kernels(fn) -> list:
    """Names of the kernels (copies and fills left out) that a
    torch.profiler session saw while fn ran once and the card finished.
    The session opens PROFILER_PAD_S before fn and closes as long after
    the synchronize: on some hosts the profiler drops the kernels that
    run near the edges of its capture window (ROADMAP C.5)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower()]


PROFILER_PAD_S = 0.05


def test_codepred_one_launch_per_frame(dev, cp_weights):
    """A frame is one cooperative kernel launch: the C side's count moves
    by one, and the profiler sees one kernel and nothing else on the
    card (cb0 already int32, the noise given)."""
    from qwen3_tts_tpu_torch import kernels
    cfg, w = cp_weights
    gen = torch.Generator(device=dev).manual_seed(5)
    B, V = 8, cfg.code_pred_vocab_size
    hidden = torch.randn(B, cfg.hidden_size, generator=gen, device=dev)
    cb0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    noise = cf.gumbel_noise((15, B, V), gen, dev)
    cf.predict_codes_fused(w, cfg, hidden, cb0, 0.9, 50, gumbel=noise)
    torch.cuda.synchronize()                        # scratch allocated
    before = kernels.codepred_launches(), cf.predict_codes_fused.launches
    names = _profiled_kernels(lambda: cf.predict_codes_fused(
        w, cfg, hidden, cb0, 0.9, 50, gumbel=noise))
    assert kernels.codepred_launches() == before[0] + 1
    assert cf.predict_codes_fused.launches == before[1] + 1
    assert len(names) == 1 and "codepred_frame_kernel" in names[0], names


def test_codepred_refuses_other_dims(dev):
    cfg = W.tiny_talker_config()
    gen = torch.Generator(device=dev).manual_seed(1)
    w = W.init_talker_weights(cfg, gen, dev)
    hidden = torch.zeros(2, cfg.hidden_size, device=dev)
    with pytest.raises(ValueError):
        cf.predict_codes_fused(w, cfg, hidden, torch.zeros(
            2, dtype=torch.int32, device=dev), 0.9, 50, greedy=True)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def _near_tie_divergences(got, ref, lg_got, lg_ref):
    """Per stream: the logits of both runs up to its first differing code
    (where the fed-back codes still agree) within LOGIT_TOL, and the
    reference's margin between its code and the other's there a near-tie
    (<= LOGIT_TOL). Returns the failures."""
    bad = []
    for b in range(got.shape[0]):
        differs = torch.nonzero(got[b] != ref[b]).flatten()
        p = int(differs[0]) if len(differs) else got.shape[1] - 1
        err = (lg_got[:p + 1, b] - lg_ref[:p + 1, b]).abs().max().item()
        if err > LOGIT_TOL:
            bad.append((b, p, "logits", err))
        if len(differs):
            lg = lg_ref[p, b]
            margin = (lg[ref[b, p]] - lg[got[b, p]]).item()
            if margin > LOGIT_TOL:
                bad.append((b, p, "margin", margin))
    return bad


# the 1.7B shape in small: an mtp_w projects the 512-wide talker space
# into a 256-wide code predictor; D = 128 and 4 / 2 heads, which the
# decode-attention kernel serves (G = 2)
MTP_CFG = dict(text_vocab_size=16, n_layers=1, hidden_size=512,
               n_attention_heads=4, n_key_value_heads=2, head_dim=128,
               intermediate_size=512, code_pred_hidden_size=256,
               code_pred_intermediate_size=512, code_pred_n_attention_heads=4,
               code_pred_n_kv_heads=2, code_pred_head_dim=128,
               code_pred_vocab_size=256)


def test_codepred_auto_mtp_takes_xla_path(dev):
    """QWEN3_TTS_CODEPRED=auto with an mtp_w on CUDA tensors: the XLA-path
    branch, whose attention is the decode-attention kernel over the
    16-slot cache (a launch per layer and step), and no code-predictor
    kernel. Greedy codes equal those of
    the same call on CPU tensors; the two devices round bf16 in other
    places, so a stream may part only at a near-tie of the CPU logits."""
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.models import code_predictor as cp
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    cfg = TalkerConfig(**MTP_CFG)
    gen = torch.Generator(device=dev).manual_seed(21)
    w = W.init_talker_weights(cfg, gen, dev)
    w = {"codec_embd": w["codec_embd"], "code_pred": w["code_pred"]}
    B, V = 4, cfg.code_pred_vocab_size
    assert w["code_pred"]["mtp_w"] is not None and not cf.supported(cfg, B, w)
    hidden = torch.randn(B, cfg.hidden_size, generator=gen, device=dev)
    cb0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    before = (kernels.codepred_launches(), cf.predict_codes_fused.launches,
              fd.flash_decode.launches)
    lg, lg_cpu = torch.empty(15, B, V, device=dev), torch.empty(15, B, V)
    got = cp.predict_codes(w, cfg, hidden, cb0, 0.9, 50, greedy=True,
                           logits_out=lg)
    torch.cuda.synchronize()
    assert (kernels.codepred_launches(),
            cf.predict_codes_fused.launches) == before[:2]
    assert fd.flash_decode.launches == before[2] + cfg.code_pred_layers * 14
    ref = cp.predict_codes(_tree_to(w, "cpu"), cfg, hidden.cpu(), cb0.cpu(),
                           0.9, 50, greedy=True, logits_out=lg_cpu)
    assert got.shape == (B, 15) and got.dtype == torch.int32
    assert not _near_tie_divergences(got.cpu(), ref, lg.cpu(), lg_cpu)


def test_codepred_auto_top_p_takes_xla_path(dev, cp_weights):
    """top_p < 1 under auto at the kernel's own dims: the XLA-path branch
    (no code-predictor kernel), codes in range; at top_p -> 0 only each
    position's argmax survives, so sampled draws give the greedy codes of
    the same branch."""
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.models import code_predictor as cp
    cfg, w = cp_weights
    gen = torch.Generator(device=dev).manual_seed(22)
    B, V = 8, cfg.code_pred_vocab_size
    hidden = torch.randn(B, cfg.hidden_size, generator=gen, device=dev) * 0.5
    cb0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    before = kernels.codepred_launches(), cf.predict_codes_fused.launches
    codes = cp.predict_codes(w, cfg, hidden, cb0, 0.9, 50, gen, top_p=0.9)
    tiny = cp.predict_codes(w, cfg, hidden, cb0, 0.9, 50, gen, top_p=1e-6)
    torch.cuda.synchronize()
    assert (kernels.codepred_launches(),
            cf.predict_codes_fused.launches) == before
    assert codes.shape == (B, 15) and 0 <= codes.min() <= codes.max() < V
    cp.set_codepred_impl("xla")
    try:
        greedy = cp.predict_codes(w, cfg, hidden, cb0, 0.9, 50, greedy=True)
    finally:
        cp.set_codepred_impl(None)
    assert torch.equal(tiny, greedy)


def test_codepred_fused_refuses_mtp(dev, monkeypatch):
    from qwen3_tts_tpu_torch.models import code_predictor as cp
    cfg = TalkerConfig(**MTP_CFG)
    gen = torch.Generator(device=dev).manual_seed(23)
    w = W.init_talker_weights(cfg, gen, dev)
    monkeypatch.setenv("QWEN3_TTS_CODEPRED", "fused")
    with pytest.raises(ValueError, match="QWEN3_TTS_CODEPRED=fused"):
        cp.predict_codes(w, cfg, torch.zeros(2, 512, device=dev),
                         torch.zeros(2, dtype=torch.int32, device=dev), 0.9,
                         50, greedy=True)


def _blocks(seed, dev):
    """Packed bf16 decoder blocks at the real widths, conv kernels at
    1/sqrt(fan_in) (the chain stays O(1)), random snake parameters and
    biases."""
    cfg = VocoderConfig()
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks, c = [], cfg.decoder_dim
    for rate in cfg.upsample_rates:
        blocks.append(W.init_decoder_block(c, rate, gen, dev, scale=None))
        c //= 2
    return vocoder.pack_kernel_weights(
        {"dec_blocks": vocoder.cast_weights(blocks)})["dec_blocks"], gen


def _assert_close_rms(got, ref):
    rms = ref.square().mean().sqrt()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= VOC_MAX_TOL * rms
    assert (got - ref).square().mean().sqrt() <= VOC_RMS_TOL * rms


# the four decoder blocks' (C, T) of a 40-frame chunk at B = 2; B = 1 and
# 3 with T not a multiple of the kernel's 128-row tile
@pytest.mark.parametrize("blk_idx,t,B", [
    (0, 1280, 2), (1, 6400, 2), (2, 25600, 2), (3, 76800, 2),
    (0, 1000, 1), (1, 333, 3), (2, 130, 3), (3, 7681, 1)])
def test_residual_chain(dev, blk_idx, t, B):
    blocks, gen = _blocks(blk_idx, dev)
    blk = blocks[blk_idx]
    c = blk["conv_t_w"].shape[1]
    x = torch.randn(B, t, c, generator=gen, device=dev)
    before = vf.fused_residual_chain.launches
    got = vf.fused_residual_chain(x, blk)
    again = vf.fused_residual_chain(x, blk)
    ref = vf.residual_chain_twin(x, blk)
    assert vf.fused_residual_chain.launches == before + 2
    assert torch.equal(got, again)                  # deterministic
    _assert_close_rms(got, ref)


# the four heads' T of a 40-frame chunk at B = 2 and 16; B = 3 and 1 with
# T off the 128-row tile (a stream's last row inside a tile)
@pytest.mark.parametrize("blk_idx,t,B", [
    (0, 160, 2), (1, 1280, 2), (2, 6400, 2), (3, 25600, 2),
    (0, 160, 16), (1, 1280, 16), (2, 6400, 16), (3, 25600, 16),
    (0, 37, 3), (3, 1001, 1)])
def test_snake_convt(dev, blk_idx, t, B):
    blocks, gen = _blocks(10 + blk_idx, dev)
    blk = blocks[blk_idx]
    rate = VocoderConfig().upsample_rates[blk_idx]
    x = torch.randn(B, t, blk["conv_t_w"].shape[0], generator=gen,
                    device=dev)
    before = vf.fused_snake_convt.launches
    got = vf.fused_snake_convt(x, blk, rate)
    again = vf.fused_snake_convt(x, blk, rate)
    ref = vf.snake_convt_twin(x, blk, rate)
    assert vf.fused_snake_convt.launches == before + 2
    assert torch.equal(got, again)                  # deterministic
    assert got.shape == ref.shape
    _assert_close_rms(got, ref)


def test_vocoder_wrappers_refuse_unserved_shapes(dev):
    blocks, _ = _blocks(2, dev)
    blk = blocks[3]
    x = torch.randn(2, 64, 96, device=dev)
    with pytest.raises(ValueError):                 # not contiguous
        vf.fused_residual_chain(x.transpose(0, 1), blk)
    with pytest.raises(ValueError):                 # K != 2 * rate
        vf.fused_snake_convt(torch.randn(1, 8, 192, device=dev), blk, 4)
    with pytest.raises(ValueError):                 # C not a multiple of 64
        vf.fused_snake_convt(torch.randn(1, 8, 96, device=dev), blk, 3)
    with pytest.raises(ValueError):                 # not packed
        vf.fused_residual_chain(x, {k: v for k, v in blk.items()
                                    if k != "kernel"})


# decode attention, kernel vs twin: both f32 over the same dequantized
# rows in another summation order; measured <= 4e-6 on outputs of O(1)
# on an H100 (chip_smoke.py)
ATTN_TOL = 1e-4


def _attn_inputs(mode, kv, dev, B=8, S=1152, read_ctx=1024):
    """Talker widths. Stream 2 is empty; windows keep hi - 1 on a block
    start with its bit set, lo >= 64 (plain) or lo > hi (wrapped)."""
    from qwen3_tts_tpu_torch.models.stack import quantize_kv_rows
    gen = torch.Generator(device=dev).manual_seed(
        ["prefix", "mask", "window", "wrap"].index(mode) * 2 + (kv == "int8"))
    q = torch.randn(B, 16, 128, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, 8, S, 128, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    ks = vs = None
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    slot = torch.arange(S, device=dev)[None]
    if mode == "prefix":
        kw = dict(n_valid=torch.tensor([1, read_ctx, 0, 5, 64, 65, 700, 999],
                                       dtype=torch.int32, device=dev))
    elif mode == "mask":
        m = torch.rand(B, S, generator=gen, device=dev) < 0.4
        m[2] = False
        kw = dict(valid_mask=m)
    else:
        hi = 961 if mode == "window" else 129
        lo = torch.randint(64, 959, (B,), device=dev, generator=gen,
                           dtype=torch.int32)
        if mode == "window":
            inside = (slot >= lo[:, None]) & (slot < hi)
        else:
            lo = lo.clamp_min(hi + 64)
            inside = ((slot >= 16) & (slot < hi)) | (
                (slot >= lo[:, None]) & (slot < read_ctx))
        m = inside & (torch.rand(B, S, generator=gen, device=dev) < 0.7)
        m[:, :10] = True
        m[:, hi - 1] = True
        m[2] = False
        kw = dict(valid_mask=m, window_lo=lo, prefill_len=16,
                  window_hi=torch.tensor(hi, dtype=torch.int32, device=dev))
    return q, k, v, ks, vs, kw, read_ctx


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["prefix", "mask", "window", "wrap"])
def test_flash_decode_matches_twin(dev, mode, kv):
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    q, k, v, ks, vs, kw, rc = _attn_inputs(mode, kv, dev)
    before = fd.flash_decode.launches
    if mode == "prefix":
        got = fd.flash_decode(q, k, v, kw["n_valid"], read_ctx=rc,
                              k_scale=ks, v_scale=vs)
    else:
        rest = {n: a for n, a in kw.items() if n != "valid_mask"}
        got = fd.flash_decode_masked(q, k, v, kw["valid_mask"], read_ctx=rc,
                                     k_scale=ks, v_scale=vs, **rest)
    ref = fd.flash_decode_twin(q, k, v, read_ctx=rc, k_scale=ks, v_scale=vs,
                               **kw)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    assert got[2].abs().max().item() == 0.0          # empty stream
    assert (got - ref).abs().max().item() <= ATTN_TOL


# (B, query heads, kv heads, read_ctx, n_valid or None for a bitmask):
# read_ctx off the 64-slot tile, one stream, G = 1 / 2 / 4, and a prefix
# of a few slots in a long cache, where most splits find no needed tile
SHAPE_CASES = {
    "ragged_ctx": (8, 16, 8, 1000, None),
    "one_stream": (1, 16, 8, 1152, None),
    "g1": (4, 8, 8, 700, None),
    "g4": (4, 32, 8, 1152, [1000, 0, 64, 65]),
    "idle_splits": (1, 16, 8, 1152, [5]),
}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(SHAPE_CASES))
def test_flash_decode_shapes(dev, case, kv):
    """Odd shapes against the twin; a second call of the same shape
    reuses the cached split scratch and gives the same output."""
    from qwen3_tts_tpu_torch.models.stack import quantize_kv_rows
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    B, n_heads, n_kv, rc, nv = SHAPE_CASES[case]
    S = 1152
    gen = torch.Generator(device=dev).manual_seed(len(case))
    q = torch.randn(B, n_heads, 128, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, n_kv, S, 128, generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    ks = vs = None
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    if nv is not None:
        n_valid = torch.tensor(nv, dtype=torch.int32, device=dev)
        run = lambda: fd.flash_decode(q, k, v, n_valid, read_ctx=rc,  # noqa
                                      k_scale=ks, v_scale=vs)
        ref = fd.flash_decode_twin(q, k, v, n_valid=n_valid, read_ctx=rc,
                                   k_scale=ks, v_scale=vs)
    else:
        mask = torch.rand(B, S, generator=gen, device=dev) < 0.5
        run = lambda: fd.flash_decode_masked(q, k, v, mask, read_ctx=rc,  # noqa
                                             k_scale=ks, v_scale=vs)
        ref = fd.flash_decode_twin(q, k, v, valid_mask=mask, read_ctx=rc,
                                   k_scale=ks, v_scale=vs)
    def held():
        return {key: tuple(map(id, ts)) for key, ts in fd._SCRATCH.items()}

    got = run()
    scratch = held()
    again = run()
    torch.cuda.synchronize()
    assert held() == scratch                        # nothing allocated
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() <= ATTN_TOL
    if nv is not None and 0 in nv:
        assert got[nv.index(0)].abs().max().item() == 0.0


def test_flash_decode_code_predictor_cache(dev):
    """The XLA-path code predictor's attention on the card: 16 query heads
    over 8 kv heads (G = 2) in a 16-slot bf16 cache, shorter than one
    64-slot tile (views of a stacked [L, 2, B, 8, 16, 128] cache), every
    valid length 1..16, against the twin."""
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    gen = torch.Generator(device=dev).manual_seed(31)
    B = 16
    cache = torch.randn(3, 2, B, 8, 16, 128, generator=gen,
                        device=dev).bfloat16()
    q = torch.randn(B, 16, 128, generator=gen, device=dev).bfloat16()
    n_valid = torch.arange(1, B + 1, dtype=torch.int32, device=dev)
    k, v = cache[1, 0], cache[1, 1]
    got = fd.flash_decode(q, k, v, n_valid)
    ref = fd.flash_decode_twin(q, k, v, n_valid=n_valid)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= ATTN_TOL


def test_flash_decode_refuses_unserved_calls(dev):
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(2, 4, 128, 64, dtype=torch.bfloat16, device=dev)
    n64 = torch.ones(2, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):                 # D != 128
        fd.flash_decode(q, k, k, n64.int())
    q = torch.zeros(2, 16, 128, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(2, 8, 128, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):                 # int64 n_valid
        fd.flash_decode(q, k, k, n64)
    with pytest.raises(ValueError):                 # int8 without scales
        fd.flash_decode(q, k.to(torch.int8), k.to(torch.int8), n64.int())
    with pytest.raises(ValueError):                 # not contiguous
        fd.flash_decode(q, k.transpose(2, 3), k, n64.int())


def test_continuous_batcher_on_card(dev):
    """A small serving run on the card: the full-width code predictor and
    vocoder, a 2-layer talker; every request completes, and the serving
    path launched the decode-attention kernel in window mode."""
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    eng = _engine(dev, 7)
    before = fd.flash_decode.launches_by_mode["window"]
    talker.set_talker_step_impl("xla")
    try:
        cb = ContinuousBatcher(eng, n_slots=2,
                               params=TTSParams(temperature=0.0, seed=0),
                               max_frames=8)
        rids = [cb.submit(t) for t in ("hello.", "world.", "he")]
        results = cb.run_all()
    finally:
        talker.set_talker_step_impl(None)
    _check_results([results[r] for r in rids], eng)
    assert fd.flash_decode.launches_by_mode["window"] > before


def _engine(dev, seed):
    """Full-width code predictor and vocoder (their kernels need the real
    widths), a 2-layer talker, an in-memory vocabulary."""
    tokens = ["<|im_start|>", "<|im_end|>", "assistant", "Ċ", "h", "e", "l",
              "o", "Ġ", "w", "r", "d", "."]
    tok = TextTokenizer(tokens, [], TokenizerSpecialTokens(
        bos_token_id=0, eos_token_id=1, pad_token_id=1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg, vcfg = TalkerConfig(n_layers=2), VocoderConfig()
    return Qwen3TTS.from_components(
        tok, cfg, W.init_talker_weights(cfg, gen, dev), vcfg,
        W.init_vocoder_weights(vcfg, gen, dev), dev)


def _check_results(results, eng):
    for res in results:
        assert res.success, res.error_msg
        assert np.isfinite(res.audio).all()
        assert len(res.audio) == res.n_frames * eng.voc_cfg.samples_per_frame


# talker megakernel vs twin, relative to the twin's RMS, as chip_smoke.py
# (there, 28 layers stay under 4.8e-3 RMS and 2.4e-2 at most): both sum in
# f32 in other orders, so a value rounded to bf16 (or an int8 row) can
# land one step apart
TF_MAX_TOL = 5e-2           # max |err| / RMS
TF_RMS_TOL = 1e-2           # RMS(err) / RMS


def _tf_inputs(mode, kv, dev, B=4, S=256, read_ctx=192, widx=150):
    """A small talker (H 256, 4/2 heads, D 128, I 768, 2 layers) and a
    cache with NaN at and past read_ctx. Prefix: stream 0 live at widx,
    1 frozen below it, 2 empty, 3 claims S slots (only read_ctx count),
    any further stream ragged. Mask: scattered bits up to widx, lane 1
    dead at widx, bits set past read_ctx. B < 4 keeps the first B
    streams."""
    from qwen3_tts_tpu_torch.models.stack import QuantKV, quantize_kv_rows
    cfg = TalkerConfig(hidden_size=256, n_layers=2, n_attention_heads=4,
                       n_key_value_heads=2, intermediate_size=768,
                       head_dim=128, text_vocab_size=16, codec_vocab_size=64)
    gen = torch.Generator(device=dev).manual_seed(
        ["prefix", "mask"].index(mode) * 2 + (kv == "int8"))
    lw = W.init_talker_weights(cfg, gen, dev)["layers"]
    cache = (torch.randn(2, 2, B, 2, S, 128, generator=gen, device=dev)
             * 0.5).bfloat16()
    if kv == "int8":
        cache = QuantKV(*quantize_kv_rows(cache))
        cache.scales[..., read_ctx:] = float("nan")
    else:
        cache[..., read_ctx:, :] = float("nan")
    x = torch.randn(B, 256, generator=gen, device=dev)
    extra = max(0, B - 4)
    pos = torch.cat([torch.tensor([widx, 40, 7, 300][:B], device=dev),
                     torch.randint(0, 2000, (extra,), generator=gen,
                                   device=dev)]).int()
    n_valid, mask = None, None
    if mode == "prefix":
        n_valid = torch.cat([
            torch.tensor([widx + 1, 90, 0, S][:B], device=dev),
            torch.randint(1, widx + 2, (extra,), generator=gen,
                          device=dev)]).int()
    else:
        mask = torch.rand(B, S, generator=gen, device=dev) < 0.4
        mask[:, widx + 1:read_ctx] = False
        mask[:, widx] = True
        mask[1:2, widx] = False
    kw = dict(n_heads=4, n_kv=2, head_dim=128, eps=cfg.rms_norm_eps,
              theta=cfg.rope_theta, read_ctx=read_ctx, valid_mask=mask)
    return lw, x, pos, cache, widx, n_valid, kw


def _parts(c):
    return (c.values, c.scales) if hasattr(c, "scales") else (c,)


def _clone(c):
    return type(c)(*[t.clone() for t in c]) if hasattr(c, "scales") \
        else c.clone()


# B = 17 and 32 leave ragged and full 16-row MMA tiles; read_ctx 200 is
# not a multiple of the 64-slot attention tile
@pytest.mark.parametrize("B,read_ctx", [(1, 192), (4, 192), (4, 200),
                                        (17, 200), (32, 192)])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["prefix", "mask"])
def test_talker_fused_matches_twin(dev, mode, kv, B, read_ctx):
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    lw, x, pos, cache, widx, n_valid, kw = _tf_inputs(mode, kv, dev, B=B,
                                                      read_ctx=read_ctx)
    ck, ct = _clone(cache), _clone(cache)
    widx_t = torch.tensor(widx, dtype=torch.int32, device=dev)
    before = tf.talker_step_fused.launches
    y, out = tf.talker_step_fused(lw, x, pos, ck, widx_t, n_valid, **kw)
    ref, _ = tf.talker_step_fused_twin(lw, x, pos, ct, widx_t, n_valid,
                                       **kw)
    torch.cuda.synchronize()
    assert out is ck and tf.talker_step_fused.launches == before + 1
    assert torch.isfinite(y).all()
    rms = ref.square().mean().sqrt()
    assert (y - ref).abs().max() <= TF_MAX_TOL * rms
    assert (y - ref).square().mean().sqrt() <= TF_RMS_TOL * rms
    keep = torch.ones(256, dtype=torch.bool, device=dev)
    keep[widx] = False
    for a, b, c in zip(_parts(ck), _parts(ct), _parts(cache)):
        a, b, c = (t.float()[..., keep, :] if t.dim() == 6
                   else t[..., keep] for t in (a, b, c))
        assert torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
        assert torch.equal(b.nan_to_num(7.0), c.nan_to_num(7.0))
    # the written rows, less one rounding step of the stored value (the
    # int8 row's scale, or a bf16 ulp <= |value| * 2^-7)
    if kv == "int8":
        step = ct.scales[..., widx, None]
        rk = ck.values[..., widx, :].float() * ck.scales[..., widx, None]
        rt = ct.values[..., widx, :].float() * step
    else:
        rk, rt = ck[..., widx, :].float(), ct[..., widx, :].float()
        step = rt.abs() * 2.0 ** -7
    err = ((rk - rt).abs() - step).clamp_min(0.0)
    assert err.max() <= TF_MAX_TOL * rt.square().mean().sqrt()


def test_talker_fused_reuses_scratch_one_launch(dev):
    """A second step of the same shape reuses the cached scratch and is
    one kernel launch, with nothing else on the card."""
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    lw, x, pos, cache, widx, n_valid, kw = _tf_inputs("prefix", "bf16", dev)
    widx_t = torch.tensor(widx, dtype=torch.int32, device=dev)
    tf.talker_step_fused(lw, x, pos, cache, widx_t, n_valid, **kw)
    torch.cuda.synchronize()
    ids = {k: tuple(map(id, v)) for k, v in tf._SCRATCH.items()}
    before = tf.talker_step_fused.launches
    out = []
    names = _profiled_kernels(lambda: out.append(tf.talker_step_fused(
        lw, x, pos, cache, widx_t, n_valid, **kw)[0]))
    y = out[0]
    assert {k: tuple(map(id, v)) for k, v in tf._SCRATCH.items()} == ids
    assert tf.talker_step_fused.launches == before + 1
    assert len(names) == 1 and "talker_step_kernel" in names[0], names
    assert torch.isfinite(y).all()


def test_talker_fused_refuses_unserved_calls(dev):
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    lw, x, pos, cache, widx, n_valid, kw = _tf_inputs("prefix", "bf16", dev)
    with pytest.raises(ValueError):                 # int64 write slot
        tf.talker_step_fused(lw, x, pos, cache, torch.tensor(
            widx, device=dev), n_valid, **kw)
    with pytest.raises(ValueError):                 # head_dim 64
        tf.talker_step_fused(lw, x, pos, cache, widx, n_valid,
                             **dict(kw, head_dim=64, n_kv=4, n_heads=8))
    with pytest.raises(ValueError):                 # f32 weights
        tf.talker_step_fused(dict(lw, wo=lw["wo"].float()), x, pos, cache,
                             widx, n_valid, **kw)


def test_synthesize_batch_auto_runs_talker_kernel(dev):
    """QWEN3_TTS_TALKER=auto on the card: lock-step synthesis goes through
    the megakernel (and not the per-layer decode attention)."""
    from qwen3_tts_tpu_torch.ops import flash_decode as fd
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    eng = _engine(dev, 3)
    before = tf.talker_step_fused.launches, fd.flash_decode.launches
    res = eng.synthesize_batch(["hello world.", "he"], params=TTSParams(
        max_audio_tokens=16, temperature=0.0, seed=0))
    _check_results(res, eng)
    assert tf.talker_step_fused.launches > before[0]
    assert fd.flash_decode.launches == before[1]


@pytest.fixture(scope="module")
def model_dir(dev, tmp_path_factory):
    """A small-depth model directory (2 talker layers; the code predictor,
    vocoder and speaker encoder at their full widths) written by
    chip_smoke's writer, and the weights written."""
    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig
    from qwen3_tts_tpu_torch.models import speaker_encoder as spk
    eng = _engine(dev, 11)
    gen = torch.Generator(device=dev).manual_seed(12)
    scfg = SpeakerEncoderConfig()
    spk_w = spk.init_speaker_encoder_weights(scfg, gen, dev)
    voc_w = {k: v for k, v in eng.voc_w.items() if k != "dec_blocks"}
    voc_w["dec_blocks"] = [{k: v for k, v in b.items() if k != "kernel"}
                           for b in eng.voc_w["dec_blocks"]]
    root = tmp_path_factory.mktemp("card_model")
    chip_smoke.write_model_dir(str(root), eng.tokenizer, eng.talker_cfg,
                               eng.talker_w, scfg, spk_w, eng.voc_cfg, voc_w)
    return str(root), eng, spk_w


def test_load_models_onto_the_card(dev, model_dir):
    """Qwen3TTS().load_models(dir) with no device argument: every tensor
    on cuda:0, bitwise the weights written; the loaded engine runs."""
    root, eng, spk_w = model_dir
    loaded = Qwen3TTS()
    assert loaded.load_models(root), loaded.error_msg
    assert loaded.device == dev
    chip_smoke._check_bits(loaded.talker_w, eng.talker_w, dev, "talker")
    chip_smoke._check_bits(loaded.voc_w, eng.voc_w, dev, "vocoder")
    assert loaded._ensure_speaker_encoder()
    chip_smoke._check_bits(loaded.spk_w, spk_w, dev, "speaker encoder")
    res = loaded.synthesize_batch(["hello world.", "he"], params=TTSParams(
        max_audio_tokens=16, temperature=0.0, seed=0, print_timing=False))
    _check_results(res, loaded)


def test_low_mem_engine_stages_its_vocoder(dev, model_dir, monkeypatch):
    """QWEN3_TTS_LOW_MEM=1: the vocoder's weights, packed ones included,
    stay in pinned host memory; the card holds less; the audio is the
    normal engine's, bitwise."""
    root, _, _ = model_dir
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    normal = Qwen3TTS()
    assert normal.load_models(root)
    held = torch.cuda.memory_allocated(dev) - base
    monkeypatch.setenv("QWEN3_TTS_LOW_MEM", "1")
    low = Qwen3TTS()
    assert low.load_models(root)
    low_held = torch.cuda.memory_allocated(dev) - base - held
    leaves = [t for _, t in chip_smoke._leaves(low.voc_w)]
    assert all(t.device.type == "cpu" and t.is_pinned() for t in leaves)
    voc_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert low_held <= held - voc_bytes
    p = TTSParams(max_audio_tokens=24, temperature=0.0, seed=0,
                  print_timing=False)
    a = normal.synthesize_batch(["hello world.", "he"], params=p)
    b = low.synthesize_batch(["hello world.", "he"], params=p)
    for x, y in zip(a, b):
        assert x.success and y.success
        assert np.array_equal(x.audio, y.audio)


def test_speaker_encoder_on_card_with_default_tf32(dev):
    """The encoder keeps f32 itself: with TF32 at PyTorch's defaults
    (cuDNN allowed, unlike the dev fixture) its embedding is within 1e-4
    of the RMS of the same encoder's on CPU tensors."""
    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig
    from qwen3_tts_tpu_torch.models import speaker_encoder as spk
    cfg = SpeakerEncoderConfig()
    w = spk.init_speaker_encoder_weights(
        cfg, torch.Generator(device=dev).manual_seed(21), dev)
    rng = np.random.default_rng(22)
    mel = np.zeros((2, 384, cfg.n_mels), np.float32)
    mel[:, :300] = rng.standard_normal((2, 300, cfg.n_mels))
    n = torch.tensor([300, 211])
    want = spk.encode(chip_smoke._to(w, "cpu"), cfg, torch.from_numpy(mel), n)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = spk.encode(w, cfg, torch.from_numpy(mel).to(dev), n.to(dev))
        assert torch.backends.cudnn.allow_tf32       # restored after
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    rms = want.square().mean().sqrt()
    assert (got.cpu() - want).abs().max() <= 1e-4 * rms


def test_device_mel_matches_host_mel(dev):
    """mel_spectrogram_batch on the card (cuFFT) against the host numpy
    mel, clip by clip, at the full mel geometry."""
    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig
    from qwen3_tts_tpu_torch.models import speaker_encoder as spk
    cfg = SpeakerEncoderConfig()
    rng = np.random.default_rng(23)
    lens = [24000, 17001, 50000]
    clips = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in lens]
    batch = np.zeros((3, spk.bucket_samples(max(lens), cfg)), np.float32)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    mel, n_frames = spk.mel_spectrogram_batch(
        torch.from_numpy(batch).to(dev), torch.tensor(lens, device=dev), cfg)
    mel, n_frames = mel.cpu().numpy(), n_frames.cpu().numpy()
    for i, c in enumerate(clips):
        want = spk.mel_spectrogram(c, cfg)
        assert n_frames[i] == len(want)
        np.testing.assert_allclose(mel[i, :len(want)], want, atol=1e-4,
                                   rtol=1e-4)
        assert np.all(mel[i, len(want):] == 0.0)


def test_stager_copies_in_chunks(dev):
    """HostStager: a payload of several chunks crosses whole through the
    two alternating pinned buffers."""
    from qwen3_tts_tpu_torch.io.gguf import HostStager
    raw = np.random.default_rng(24).integers(0, 256, 5000).astype(np.uint8)
    out = HostStager(chunk=1024).to_device(raw, dev)
    assert out.device == dev and np.array_equal(out.cpu().numpy(), raw)


# -- CUDA graphs (runtime/graphs.py): replay against eager --------------------
GRAPH_TEXTS = ["hello world.", "he", "world hello.", "hello."]


def _replays(eng) -> int:
    return sum(g.replays for g in eng.graphs.graphs.values())


def _graph_vs_eager(eng, monkeypatch, params, impl=None):
    """synthesize_batch three times: the first captures the chunk and
    vocoder graphs (its chunks run eagerly on the side stream), the
    second replays them, the third runs with QWEN3_TTS_AOT=0. Returns
    the three results."""
    from qwen3_tts_tpu_torch.models import talker
    talker.set_talker_step_impl(impl)
    try:
        monkeypatch.delenv("QWEN3_TTS_AOT", raising=False)
        first = eng.synthesize_batch(GRAPH_TEXTS, params=params)
        before = _replays(eng)
        graph = eng.synthesize_batch(GRAPH_TEXTS, params=params)
        assert _replays(eng) > before, "the second call did not replay"
        monkeypatch.setenv("QWEN3_TTS_AOT", "0")
        eager = eng.synthesize_batch(GRAPH_TEXTS, params=params)
    finally:
        talker.set_talker_step_impl(None)
    for runs in (first, graph, eager):
        _check_results(runs, eng)
    return first, graph, eager


def _assert_same_audio(*runs):
    for res in zip(*runs):
        assert len({r.n_frames for r in res}) == 1
        for r in res[1:]:
            np.testing.assert_array_equal(r.audio, res[0].audio)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_graph_lockstep_greedy_bitwise(dev, monkeypatch, kv):
    """QWEN3_TTS_TALKER=auto, greedy: the replayed chunk and vocoder
    graphs give the eager codes and PCM bit for bit (two chunks)."""
    monkeypatch.setenv("QWEN3_TTS_KV", kv)
    _assert_same_audio(*_graph_vs_eager(
        _engine(dev, 21), monkeypatch,
        TTSParams(max_audio_tokens=48, temperature=0.0, seed=0)))


def test_graph_lockstep_sampled_same_codes(dev, monkeypatch):
    """Temperature 0.9, one seed: a replay draws the Gumbel noise the
    eager run draws (the graph's generator takes the caller's state), so
    codes and PCM are equal."""
    _assert_same_audio(*_graph_vs_eager(
        _engine(dev, 22), monkeypatch,
        TTSParams(max_audio_tokens=48, temperature=0.9, seed=7)))


def test_graph_lockstep_xla_and_top_p(dev, monkeypatch):
    """QWEN3_TTS_TALKER=xla (decode attention and cuBLAS products in the
    graph) and top_p 0.9 (the code predictor's XLA path): replay and eager
    agree. cuBLAS may pick another algorithm under capture; a greedy code
    could then flip only at a bf16 near-tie (ROADMAP.md's rule), and the
    codes here show none."""
    eng = _engine(dev, 23)
    _assert_same_audio(*_graph_vs_eager(
        eng, monkeypatch,
        TTSParams(max_audio_tokens=40, temperature=0.0, seed=0), "xla"))
    _assert_same_audio(*_graph_vs_eager(
        eng, monkeypatch,
        TTSParams(max_audio_tokens=40, temperature=0.9, top_p=0.9, seed=3)))


def test_graph_replay_counts_launches(dev, monkeypatch):
    """A replayed 40-frame chunk under auto launches the code-predictor
    kernel and the talker megakernel once a frame, as the profiler sees
    it, and the launch counts (wrappers and the C side's) add exactly
    those launches."""
    from qwen3_tts_tpu_torch import kernels
    from qwen3_tts_tpu_torch.ops import talker_fused as tf
    monkeypatch.delenv("QWEN3_TTS_AOT", raising=False)
    eng = _engine(dev, 24)
    params = TTSParams(max_audio_tokens=40, temperature=0.0, seed=0)
    eng.synthesize_batch(GRAPH_TEXTS, params=params)           # capture
    torch.cuda.synchronize()
    before = (cf.predict_codes_fused.launches, kernels.codepred_launches(),
              tf.talker_step_fused.launches, _replays(eng))
    names = _profiled_kernels(
        lambda: eng.synthesize_batch(GRAPH_TEXTS, params=params))
    after = (cf.predict_codes_fused.launches, kernels.codepred_launches(),
             tf.talker_step_fused.launches, _replays(eng))
    assert after[3] > before[3]
    assert [a - b for a, b in zip(after[:3], before[:3])] == [40, 40, 40]
    assert sum("codepred_frame_kernel" in n for n in names) == 40
    assert sum("talker_step_kernel" in n for n in names) == 40


def test_graph_ring_chunk_bitwise(dev, monkeypatch):
    """One ring-mode chunk (serving) from one state, three times: the
    first call (frame 0 eager, then its graph captured and replayed),
    all replays, and QWEN3_TTS_AOT=0: codes, valid frames and the state
    after it bit for bit."""
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    monkeypatch.delenv("QWEN3_TTS_AOT", raising=False)
    eng = _engine(dev, 25)
    cb = ContinuousBatcher(eng, n_slots=4,
                           params=TTSParams(temperature=0.0, seed=0),
                           max_frames=80)
    for t in GRAPH_TEXTS:
        cb.submit(t)
    names = ("n_past", "frame_idx", "last_hidden", "logits", "seen_mask",
             "done", "valid_mask", "write_slot", "ring_lo")
    with torch.inference_mode():
        cb._admit_pending()
        st = cb.state

        def snap():
            out = {n: getattr(st, n).clone() for n in names}
            out["kv"] = st.kv_cache.clone()
            return out

        def restore(saved):
            for n in names:
                getattr(st, n).copy_(saved[n])
            st.kv_cache.copy_(saved["kv"])

        saved = snap()
        runs = []
        for aot in ("1", "1", "0"):
            monkeypatch.setenv("QWEN3_TTS_AOT", aot)
            restore(saved)
            before = _replays(eng)
            codes, valid = cb._gen_fn(128)()
            runs.append((codes.clone(), valid.clone(), snap(),
                         _replays(eng) - before))
        torch.cuda.synchronize()
    assert [r[3] for r in runs] == [39, 40, 0]
    for codes, valid, state, _ in runs[1:]:
        assert torch.equal(codes, runs[0][0])
        assert torch.equal(valid, runs[0][1])
        for n, t in state.items():
            assert torch.equal(t, runs[0][2][n]), n


def test_graph_vocoder_bucket_bitwise(dev, monkeypatch):
    """A vocoder decode bucket: the replayed graph (both vocoder kernels
    inside it) gives the eager int16 PCM bit for bit."""
    monkeypatch.delenv("QWEN3_TTS_AOT", raising=False)
    eng = _engine(dev, 26)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2048, (4, 40, 16)).astype(np.int32)
    first = eng._decode_chunk_batch(codes, pcm16=True).clone()
    other = rng.integers(0, 2048, (4, 40, 16)).astype(np.int32)
    eng._decode_chunk_batch(other, pcm16=True)             # replay: other
    got = eng._decode_chunk_batch(codes, pcm16=True).clone()
    monkeypatch.setenv("QWEN3_TTS_AOT", "0")
    want = eng._decode_chunk_batch(codes, pcm16=True)
    assert _replays(eng) == 2
    assert torch.equal(first, want) and torch.equal(got, want)


def test_graph_warmed_serving_matches_eager(dev, monkeypatch):
    """ContinuousBatcher.warmup() captures every bucket the serving loop
    meets: 3 requests after it capture nothing new, replay, and give the
    audio of an unwarmed batcher running eagerly, bit for bit."""
    from qwen3_tts_tpu_torch.runtime.serve import ContinuousBatcher
    monkeypatch.delenv("QWEN3_TTS_AOT", raising=False)
    eng = _engine(dev, 27)
    texts = ("hello world.", "he", "world hello world.")

    def serve(cb):
        rids = [cb.submit(t) for t in texts]
        out = cb.run_all()
        return [out[r] for r in rids]

    params = TTSParams(temperature=0.0, seed=0)
    cb = ContinuousBatcher(eng, n_slots=2, params=params, max_frames=48)
    cb.warmup()
    n_warm, replays = len(eng.graphs.graphs), _replays(eng)
    assert n_warm > 0
    got = serve(cb)
    assert len(eng.graphs.graphs) == n_warm, "serving captured a new bucket"
    assert _replays(eng) > replays
    monkeypatch.setenv("QWEN3_TTS_AOT", "0")
    want = serve(ContinuousBatcher(eng, n_slots=2, params=params,
                                   max_frames=48))
    _check_results(got, eng)
    _assert_same_audio(got, want)


def test_graph_capture_with_host_sync_raises(dev):
    """A capture that meets a host sync raises (nothing falls back to the
    eager path), and the card keeps working."""
    from qwen3_tts_tpu_torch.runtime.graphs import GraphCache
    x = torch.ones(4, device=dev)
    fn = GraphCache().get_or_capture("sync", lambda: x * x.sum().item(), dev)
    with pytest.raises(RuntimeError):
        fn()
    assert fn.graph is None
    assert float((x + 1).sum()) == 8.0


# -- the mesh at world size 1 over NCCL (parallel/mesh.py) -------------------
@pytest.fixture(scope="module")
def nccl_mesh(dev, tmp_path_factory):
    """A world-size-1 NCCL process group in this process, and its 1x1
    mesh; the group is destroyed after the module's tests."""
    import torch.distributed as dist
    from qwen3_tts_tpu_torch.parallel import make_mesh
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh(1, 1, "cuda")
    finally:
        dist.destroy_process_group()


def _mesh_state(eng, dev, kv_quant):
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.runtime import generate as G
    cfg, B = eng.talker_cfg, 4
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.text_vocab_size, (B, 16), generator=gen,
                           device=dev, dtype=torch.int32)
    pf = talker.build_prefill_inputs(
        eng.talker_w, cfg, tokens,
        torch.full((B,), 16, dtype=torch.int32, device=dev),
        torch.zeros(B, cfg.hidden_size, device=dev))
    ctx = G.required_ctx(pf.prefill_embd.shape[1], 40, 40)
    return (G.init_state(eng.talker_w, cfg, pf, ctx, None, kv_quant=kv_quant),
            G.make_consts(pf, 0.0, 1.05), ctx)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_mesh_shard_gen_state_on_card(dev, nccl_mesh, kv_quant):
    """shard_gen_state / shard_consts on the card: at 1x1 this rank's
    slice is the whole state, every tensor a contiguous copy on the
    card, the int8 cache with its scales."""
    import dataclasses
    from qwen3_tts_tpu_torch.models.stack import QuantKV
    from qwen3_tts_tpu_torch.parallel import shard_consts, shard_gen_state
    state, consts, _ = _mesh_state(_engine(dev, 31), dev, kv_quant)
    got = shard_gen_state(state, nccl_mesh)
    assert isinstance(got.kv_cache, QuantKV) == kv_quant
    pairs = ([(got.kv_cache.values, state.kv_cache.values),
              (got.kv_cache.scales, state.kv_cache.scales)] if kv_quant else
             [(got.kv_cache, state.kv_cache)])
    for f in dataclasses.fields(state):
        if f.name not in ("kv_cache", "generator"):
            pairs.append((getattr(got, f.name), getattr(state, f.name)))
    sc = shard_consts(consts, nccl_mesh)
    pairs += [(getattr(sc, n), getattr(consts, n)) for n in
              ("trailing_hidden", "trailing_len", "tts_pad_embed",
               "expected_frames")]
    for a, b in pairs:
        assert a.is_cuda and a.is_contiguous() and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()


def test_mesh_generate_chunk_bitwise(dev, nccl_mesh):
    """A 40-frame chunk over the sharded state and weights (1x1), its
    outputs gathered over dp through NCCL, equals the unsharded chunk bit
    for bit."""
    from qwen3_tts_tpu_torch.parallel import (shard_consts, shard_gen_state,
                                              shard_talker_weights)
    from qwen3_tts_tpu_torch.parallel.mesh import gather_chunk
    from qwen3_tts_tpu_torch.runtime import generate as G
    eng = _engine(dev, 32)
    cfg = eng.talker_cfg
    runs = []
    for mesh in (None, nccl_mesh):
        state, consts, ctx = _mesh_state(eng, dev, False)
        w = eng.talker_w
        if mesh is not None:
            w = shard_talker_weights(w, mesh, cfg)
            state = shard_gen_state(state, mesh)
            consts = shard_consts(consts, mesh)
        _, codes, valid = G.generate_chunk(w, cfg, state, consts, 50, 40,
                                           greedy=True, read_ctx=ctx)
        done = state.done
        if mesh is not None:
            codes, valid, done = gather_chunk(mesh, codes, valid, done)
        runs.append((codes.clone(), valid.clone(), done.clone()))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_mesh_frame_graph_replays_bitwise(dev, nccl_mesh, monkeypatch):
    """A sharded engine on a dp mesh captures its frame and vocoder
    graphs (keys tagged -m1x1 and the rank): replayed, they give the
    eager audio and the unsharded engine's, bit for bit."""
    params = TTSParams(max_audio_tokens=48, temperature=0.0, seed=0)
    eng = _engine(dev, 33).shard(nccl_mesh)
    first, graph, eager = _graph_vs_eager(eng, monkeypatch, params)
    monkeypatch.delenv("QWEN3_TTS_AOT", raising=False)
    plain = _engine(dev, 33).synthesize_batch(GRAPH_TEXTS, params=params)
    _assert_same_audio(first, graph, eager, plain)
    keys = [k for k, _ in eng.graphs.graphs]
    assert keys and all(k.endswith("-m1x1-rk0") for k in keys), keys


# -- the offline pipeline (qwen3_tts_tpu_torch/tools) --------------------
# the talker and code predictor at the widths the kernels serve, one
# talker layer; a small text vocabulary and speaker encoder
CARD_GEOMETRY = dict(layers=1, text_vocab=256, text_hidden=64,
                     spk_hidden=16)


def test_converted_bf16_checkpoint_loads_bitwise_on_card(dev, tmp_path):
    """A small BF16 HF checkpoint converted at f16 by the port's converter
    into a model directory: load_models(dir, "cuda") gives bitwise the
    CPU load (the vocoder's matrices cast to bf16 on the card, as
    load_models casts them there), speaker encoder included."""
    from qwen3_tts_tpu_torch.config import VocoderConfig as VCfg
    from qwen3_tts_tpu_torch.io.gguf import GGUFReader
    from qwen3_tts_tpu_torch.runtime.pipeline import CODEC_FILE, TTS_FILE
    from qwen3_tts_tpu_torch.tools import convert_checkpoints as cc
    tts, codec = tmp_path / "hf_tts", tmp_path / "hf_codec"
    chip_smoke.write_hf_checkpoints(tts, codec, 61, device=dev,
                                    **CARD_GEOMETRY)
    mdir = tmp_path / "models"
    mdir.mkdir()
    cc.convert_tts(tts, mdir / TTS_FILE, "f16")
    cc.convert_codec(codec, mdir / CODEC_FILE, "f16")
    card, host = Qwen3TTS(), Qwen3TTS()
    assert card.load_models(str(mdir), "cuda"), card.error_msg
    assert host.load_models(str(mdir), "cpu"), host.error_msg
    chip_smoke._check_bits(card.talker_w, host.talker_w, dev, "talker")
    with GGUFReader(str(mdir / CODEC_FILE)) as r:
        voc_w = vocoder.load_vocoder_weights(r, VCfg.from_gguf(r), "cpu")
    # cast on the host, packed on the card (exp(alpha) rounds apart there)
    chip_smoke._check_bits(card.voc_w, vocoder.pack_kernel_weights(
        chip_smoke._to(vocoder.cast_weights(voc_w), dev)), dev, "vocoder")
    assert card._ensure_speaker_encoder() and host._ensure_speaker_encoder()
    chip_smoke._check_bits(card.spk_w, host.spk_w, dev, "speaker encoder")


def test_parity_on_card_takes_the_kernels(dev, tmp_path):
    """tools/parity.run_parity on the card (talker stages): both passes
    pass; the bf16 pass's step launches the talker megakernel, its xla
    step decode attention once a layer, its code predictor its kernel;
    the f32 pass none of the kernels that need bf16 weights."""
    from qwen3_tts_tpu_torch.tools import parity
    tts, codec = tmp_path / "hf_tts", tmp_path / "hf_codec"
    chip_smoke.write_hf_checkpoints(tts, codec, 62, device=dev,
                                    **CARD_GEOMETRY)
    report = []
    failures, _ = parity.run_parity(tts, None, "cuda", seed=62,
                                    report=report)
    assert failures == []
    by = {r["stage"]: r for r in report}
    assert by["bf16:step_hidden[fused]"]["launches"] == {"talker_fused": 1}
    assert by["bf16:step_hidden[xla]"]["launches"] == {"flash_decode": 1}
    assert by["bf16:code_pred_codes"]["launches"] == {"codepred": 1}
    assert not any(k in r["launches"] for r in report if r["pass"] == "f32"
                   for k in ("talker_fused", "codepred"))


def test_vocoder_xla_switch_on_card(dev, tmp_path):
    """set_res_chain_impl("xla") takes the plain path on CUDA tensors (no
    vocoder kernel launch), "auto" the kernels; the audio agrees. The
    codec is a synthetic checkpoint at its full widths, whose audio stays
    off tanh's rails (chip_smoke.hf_codec_tensors)."""
    from qwen3_tts_tpu_torch.config import VocoderConfig as VCfg
    from qwen3_tts_tpu_torch.io.gguf import GGUFReader
    from qwen3_tts_tpu_torch.tools import convert_checkpoints as cc
    chip_smoke.write_hf_checkpoints(
        tmp_path / "t", tmp_path / "c", 63, device=dev, hidden=64, layers=1,
        heads=4, kv_heads=2, head_dim=16, inter=192, text_vocab=64,
        text_hidden=16, cp_layers=1, cp_vocab=64, spk_hidden=16)
    cc.convert_codec(tmp_path / "c", tmp_path / "codec.gguf", "f16")
    with GGUFReader(str(tmp_path / "codec.gguf")) as r:
        vcfg = VCfg.from_gguf(r)
        w = vocoder.load_vocoder_weights(r, vcfg, dev)
    w = vocoder.pack_kernel_weights(vocoder.cast_weights(w))
    gen = torch.Generator(device=dev).manual_seed(63)
    codes = torch.randint(0, vcfg.codebook_size, (2, 4, vcfg.n_codebooks),
                          generator=gen, device=dev, dtype=torch.int32)
    out = {}
    for impl in ("xla", "auto"):
        vocoder.set_res_chain_impl(impl)
        before = (vf.fused_residual_chain.launches,
                  vf.fused_snake_convt.launches)
        try:
            out[impl] = vocoder.vocoder_decode(w, vcfg, codes, "causal")
            torch.cuda.synchronize()
        finally:
            vocoder.set_res_chain_impl(None)
        ran = (vf.fused_residual_chain.launches - before[0],
               vf.fused_snake_convt.launches - before[1])
        assert ran == ((0, 0) if impl == "xla" else (4, 4)), (impl, ran)
    ref, got = out["xla"].float(), out["auto"].float()
    assert torch.isfinite(got).all()
    assert (ref.abs() > 0.99).float().mean() < 0.01    # off the rails
    rms = ref.pow(2).mean().sqrt()
    assert (got - ref).pow(2).mean().sqrt() / rms < VOC_MAX_TOL
