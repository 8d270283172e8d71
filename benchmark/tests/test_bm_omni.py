"""Qwen3-Omni's speech stage in the benchmark (benchmark/archs/
qwen3_omni_moe_talker.py, benchmark/reference/moe.py and code2wav.py):
its weights from the seed, its counts, its reference against the
repository's own plain reference of the talker and of Code2Wav
(tests/omni_talker_reference.py), a tiny run to ``correct`` through the
harness, and its cell as BENCHMARK.json names it."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import run as bench_run
from benchmark import spec
from benchmark.reference import moe as ref_moe
from benchmark.reference.layers import Prec
from benchmark.tests.tiny import REPO, load_model, make_root, tiny_config

ARCH = "qwen3_omni_moe_talker"
SEED = 2**31 + 11


def tiny_omni() -> dict:
    """The program's test widths with a sparse talker: 8 experts of 32,
    top-2, a shared expert of 64, 4 / 1 heads; Code2Wav at 32 wide, 2
    layers of 4 heads, SwiGLU 48, a window of 5 frames, rates 2, 2, 2, 2."""
    c = tiny_config()
    c["name"], c["arch"] = "tiny", ARCH
    del c["vocoder_config"]
    omni = json.loads((REPO / "benchmark/configs/qwen3-omni-30b-a3b-talker"
                       ".json").read_text())
    c["code2wav_config"] = dict(
        omni["code2wav_config"], hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        sliding_window=5, decoder_dim=32, upsample_rates=[2, 2, 2, 2])
    c["talker_config"].update(
        num_key_value_heads=1, num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=32, shared_expert_intermediate_size=64,
        norm_topk_prob=True)
    c["random_weights"]["router_std"] = 0.3
    return c


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def test_weights_follow_the_seed():
    arch, m = load_model(tiny_omni())
    a, b = (arch.make_weights(m, SEED, "cpu") for _ in range(2))
    c = arch.make_weights(m, SEED + 1, "cpu")
    la, lb = list(_leaves(a.talker)), list(_leaves(b.talker))
    assert len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))
    lw = a.talker["layers"]
    assert "w_gu" not in lw and tuple(lw["w_gu_e"].shape) == (2, 8, 64, 64)
    assert not torch.equal(lw["w_gu_e"], c.talker["layers"]["w_gu_e"])


def test_counts_follow_the_routed_experts():
    arch, m = load_model("qwen3-omni-30b-a3b-talker")
    H, Ie, Is, E = 1024, 384, 768, 128
    assert (m.n_experts, m.top_k, m.expert_inter, m.shared_inter) == (
        E, 6, Ie, Is)
    f1, b1 = arch.moe_layer(m, 192, 100)
    f2, b2 = arch.moe_layer(m, 192, 101)
    assert f1 == f2                               # active parameters only
    assert b2 - b1 == 2 * 3 * H * Ie              # one more expert read
    assert f1 == 2 * 192 * (6 * 3 * H * Ie + 3 * H * Is + H + H * E)
    s_all = arch.talker_step(m, 192, 138, [E] * 20)
    s_few = arch.talker_step(m, 192, 138, [6] * 20)
    assert s_all[0] == s_few[0]
    assert s_all[1] - s_few[1] == 20 * (E - 6) * 2 * 3 * H * Ie
    # a frame counts 6 of the 128 experts: widening the expert pool moves
    # no operation, one more expert a token moves 3 H Ie a layer, twice
    import dataclasses
    wide = dataclasses.replace(m, n_experts=256)
    more = dataclasses.replace(m, top_k=7)
    d = arch.frame_flops(wide, 0) - arch.frame_flops(m, 0)
    assert d == 20 * 2 * H * 128                  # the router's columns
    assert arch.frame_flops(more, 0) - arch.frame_flops(m, 0) == \
        20 * 2 * 3 * H * Ie
    # ~6.9 GB a B = 192 step at the median position, every expert read
    assert 6.5e9 < s_all[1] < 7.2e9


def _load_reference():
    return spec.load_file_module(REPO / "tests/omni_talker_reference.py",
                                 "omni_talker_reference")


def test_reference_agrees_with_the_repository_reference():
    arch, m = load_model(tiny_omni())
    w = arch.make_weights(m, SEED, "cpu").talker
    ref = _load_reference()
    x = torch.randn(2, 9, m.talker.hidden,
                    generator=torch.Generator().manual_seed(3))
    t = m.talker
    routes_a, routes_b = [], []
    with torch.no_grad():
        want, _ = ref.talker_forward(
            w, x, heads=t.heads, kv_heads=t.kv_heads, head_dim=t.head_dim,
            eps=m.rms_norm_eps, theta=m.rope_theta, routes=routes_a,
            moe=dict(n_experts=m.n_experts, top_k=m.top_k,
                     norm_topk_prob=m.norm_topk_prob))
        got = arch.talker_hidden(Prec("f32"), w, m, [x[0], x[1]],
                                 routes=routes_b)
    for a, b in zip(routes_a, routes_b):
        assert torch.equal(a, b)
    for i in range(2):
        err = (got[i] - want[i]).norm() / want[i].norm()
        assert err < 1e-5           # float32 sums in other orders


def test_code2wav_agrees_with_the_repository_reference():
    """The arch's ``vocode`` (benchmark/reference/code2wav.py) against
    tests/omni_talker_reference.code2wav with the streaming cut, over
    more frames than the window: float32 sums in other orders."""
    arch, m = load_model(tiny_omni())
    w = arch.make_weights(m, SEED, "cpu").vocoder
    v = m.vocoder
    codes = torch.randint(0, v.codebook_size, (2, 12, v.n_codebooks),
                          generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = arch.vocode(Prec("f32"), w, v, codes)
        want = _load_reference().code2wav(
            w, codes, heads=v.heads, eps=v.rms_norm_eps, theta=v.rope_theta,
            window=v.sliding_window, rates=v.upsample_rates, trim="causal")
        far = _load_reference().code2wav(
            w, codes, heads=v.heads, eps=v.rms_norm_eps, theta=v.rope_theta,
            window=None, rates=v.upsample_rates, trim="causal")
    assert got.shape == (2, 12 * v.samples_per_frame)
    assert (got - want).norm() / want.norm() < 1e-5
    assert (far - want).norm() / want.norm() > 1e-3     # the window counts
    assert 0.05 < want.pow(2).mean().sqrt() < 0.5       # audio, not silence


def test_code2wav_counts():
    """Code2Wav's counts at the published widths: the pre-transformer's
    products and the ConvNeXt's 4x pointwise width move the operations;
    its weights, not the code table, and the gathered rows the bytes."""
    import dataclasses
    arch, m = load_model("qwen3-omni-30b-a3b-talker")
    v = m.vocoder
    assert (v.hidden, v.intermediate, v.layers, v.sliding_window,
            v.samples_per_frame) == (1024, 3072, 8, 72, 1920)
    f = arch.code2wav_flops_per_stream(m, 40)
    deeper = dataclasses.replace(m, vocoder=dataclasses.replace(
        v, layers=9))
    H, I = 1024, 3072
    assert arch.code2wav_flops_per_stream(deeper, 40) - f == \
        2 * 40 * (4 * H * H + 3 * H * I) + 4 * H * 40 * 41 // 2
    f1, b1 = arch.vocoder_chunk(m, 1)
    f2, b2 = arch.vocoder_chunk(m, 2)
    assert f2 == 2 * f1 == 2 * f
    assert b2 - b1 == 2 * H * 40 * 16 + 40 * (4 * 16 + 2 * 1920)
    import math
    spec = arch.code2wav_spec(m, torch.bfloat16)
    every = sum(math.prod(l.shape) * l.dtype.itemsize for l in spec.leaves)
    weights = b1 - 2 * H * 40 * 16 - 40 * (4 * 16 + 2 * 1920)
    assert weights == every - 16 * 2048 * H * 2      # not the code table
    assert weights > 2 * 8 * (4 * H * H + 3 * H * I)


def test_step_experts_is_the_step_reference():
    """``step_experts``' one-step routing equals the full reference's
    over a sequence of that one row (position 0, no cached row)."""
    arch, m = load_model(tiny_omni())
    w = arch.make_weights(m, SEED, "cpu").talker
    x = torch.randn(3, m.talker.hidden,
                    generator=torch.Generator().manual_seed(4))
    steps = arch.step_experts(w, m, x, 0)
    routes = []
    with torch.no_grad():
        lw = w["layers"]
        h = x[:, None]
        y = ref_moe.moe_stack(Prec("f32"), lw, h, heads=m.talker.heads,
                              kv_heads=m.talker.kv_heads,
                              head_dim=m.talker.head_dim, eps=m.rms_norm_eps,
                              theta=m.rope_theta, routes=routes,
                              n_experts=m.n_experts, top_k=m.top_k,
                              norm_topk_prob=m.norm_topk_prob)
    assert y.shape == h.shape
    assert [e.tolist() for e in steps] == [r.unique().tolist()
                                           for r in routes]


def test_tiny_offline_run_is_correct(tmp_path, capsys):
    root = make_root(tmp_path)
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(tiny_omni()))
    rc = bench_run.main(["--workload", "tiny-offline", "--seed",
                         str(2**31 + 78), "--seconds", "1"],
                        root=root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell", ["offline-omni-b192", "offline-0.6b-b16"])
def test_cells_load(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1 and c.mix["kind"] == "offline"
    assert c.arch.__file__ == str(Path(REPO / "benchmark/archs") / (
        f"{ARCH}.py" if "omni" in cell else "qwen3_tts_12hz.py"))
    names = {x["name"] for x in c.per_layer}
    offline = {"talker_roofline", "codepred_roofline", "vocoder_roofline",
               "mfu", "device_idle_share", "graph_warmup_s", "tail_flush_ms",
               "voc_pad_share", "late_captures"}
    if "omni" in cell:
        assert c.mix == spec.load_cell("offline-0.6b-b192").mix
        assert names == offline | {"moe_roofline", "moe_pad_share"}
        assert c.model.talker.kv_heads == 2 and c.model.n_experts == 128
    else:
        assert c.mix["batch"] == 16
        assert names == offline
    assert {x["name"] for x in c.end_to_end} == {"audio_s_per_s", "setup_s"}
