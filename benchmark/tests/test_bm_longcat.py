"""LongCat-Flash-Omni's backbone block in the benchmark (benchmark/archs/
longcat_flash_talker.py, benchmark/reference/mla.py and longcat_moe.py):
its weights from the seed, its counts, its reference against the
repository's own plain reference (tests/longcat_talker_reference.py), a
tiny run to ``correct`` through the harness, and its cell as
BENCHMARK.json names it."""

import dataclasses
import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark import spec
from benchmark.reference.layers import Prec
from benchmark.tests.tiny import REPO, TINY_SPECIAL, load_model, make_root, \
    tiny_config

ARCH = "longcat_flash_talker"
CONFIG = "longcat-flash-omni-talker"
SEED = 2**31 + 23


def tiny_longcat() -> dict:
    """The program's test widths with double layers: hidden 96, 4 heads of
    16 nope + 8 rope, values 16, ranks 32 / 32, dense FFN 128; 8 real and 4
    identity experts of 32, top-3, experts 2..5 held; the tiny code
    predictor (64 wide, behind an mtp projection) and vocoder."""
    small = tiny_config()
    c = json.loads((REPO / f"benchmark/configs/{CONFIG}.json").read_text())
    c.update(name="tiny", hidden_size=96, num_attention_heads=4,
             ffn_hidden_size=128, q_lora_rank=32, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             num_layers=2, n_routed_experts=4, zero_expert_num=4,
             moe_topk=3, expert_ffn_hidden_size=32)
    c["published"] = dict(c["published"], n_routed_experts=8)
    c["deployment"] = dict(c["deployment"], held_experts=[2, 6])
    c["speech_interface"] = dict(c["speech_interface"], text_hidden_size=64,
                                 text_vocab_size=512)
    for group in ("code_predictor_config", "vocoder_config"):
        c[group] = small[group]
    c["special_tokens"] = dict(TINY_SPECIAL)
    c["random_weights"] = dict(c["random_weights"], router_std=0.1,
                               e_bias_std=0.2)
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
    arch, m = load_model(tiny_longcat())
    a, b = (arch.make_weights(m, SEED, "cpu") for _ in range(2))
    c = arch.make_weights(m, SEED + 1, "cpu")
    la, lb = list(_leaves(a.talker)), list(_leaves(b.talker))
    assert len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))
    lw = a.talker["layers"]
    assert "wqkv" not in lw and tuple(lw["w_gu_e"].shape) == (2, 4, 96, 64)
    assert tuple(lw["w_router"].shape) == (2, 96, 12)
    assert tuple(lw["wkv_b"].shape) == (2, 2, 32, 4 * 32)
    assert lw["e_bias"].dtype == torch.float32 and lw["e_bias"].std() > 0.05
    assert not torch.equal(lw["w_gu_e"], c.talker["layers"]["w_gu_e"])


def test_config_keeps_the_published_keys():
    """The file holds the published config.json's language-model keys,
    only num_layers and n_routed_experts cut, both in ``reduced`` beside
    the published values and the deployment."""
    raw = json.loads((REPO / f"benchmark/configs/{CONFIG}.json").read_text())
    assert raw["reduced"] == ["num_layers", "n_routed_experts"]
    assert (raw["num_layers"], raw["n_routed_experts"]) == (4, 16)
    assert raw["published"] == {"num_layers": 28, "n_routed_experts": 512}
    dep = raw["deployment"]
    assert dep["chips_sharing_a_layer"] * dep["experts_held"] == 512
    assert dep["pipeline_stages"] * dep["double_layers_a_stage"] == 28
    widths = dict(hidden_size=6144, ffn_hidden_size=12288,
                  expert_ffn_hidden_size=2048, num_attention_heads=64,
                  kv_lora_rank=512, q_lora_rank=1536, qk_rope_head_dim=64,
                  v_head_dim=128, qk_nope_head_dim=128, zero_expert_num=256,
                  moe_topk=12, routed_scaling_factor=6, rope_theta=10000000,
                  rms_norm_eps=1e-05, vocab_size=131072)
    assert {k: raw[k] for k in widths} == widths


def test_counts_follow_the_routed_experts():
    arch, m = load_model(CONFIG)
    H, Ie, Et = 6144, 2048, 768
    assert (m.n_experts, m.n_zero, m.top_k, m.held, m.router_width) == (
        512, 256, 12, 16, Et)
    f1, b1 = arch.moe_layer(m, 192, 15, 48)
    f2, b2 = arch.moe_layer(m, 192, 16, 48)
    assert f1 == f2                               # active parameters only
    assert b2 - b1 == 2 * 3 * H * Ie              # one more expert read
    assert arch.moe_layer(m, 192, 15, 49)[0] - f1 == 2 * 3 * H * Ie
    assert f1 == 2 * (48 * 3 * H * Ie + 192 * H * Et)
    # ~1.0 TFLOP and ~10 GB a B = 192 step at the median position: ~3 ms
    f, b = arch.talker_step(m, 192, 138)
    assert 0.95e12 < f < 1.1e12 and 9.5e9 < b < 10.5e9
    # one sublayer's decode attention: 57.5 MB of rows, queries and outputs
    fm, bm = arch.mla_call(m, 192, 139)
    assert bm == 2 * 192 * (139 * 576 + 64 * 576 + 64 * 512)
    assert fm == 192 * 2 * 64 * (576 + 512) * 139
    # a frame counts a quarter of an expert a token (12 x 16 / 768)
    wide = dataclasses.replace(m, held=32)
    assert arch.frame_flops(wide, 0) - arch.frame_flops(m, 0) == \
        pytest.approx(4 * 2 * 0.25 * 3 * H * Ie)


def _load_reference():
    return spec.load_file_module(REPO / "tests/longcat_talker_reference.py",
                                 "longcat_talker_reference")


def test_reference_agrees_with_the_repository_reference():
    arch, m = load_model(tiny_longcat())
    w = arch.make_weights(m, SEED, "cpu").talker
    ref = _load_reference()
    x = torch.randn(2, 9, m.talker.hidden,
                    generator=torch.Generator().manual_seed(3))
    routes_a, routes_b = [], []
    with torch.no_grad():
        want, _ = ref.talker_forward(
            w, x, heads=m.talker.heads, eps=m.rms_norm_eps,
            theta=m.rope_theta, routes=routes_a,
            mla_cfg=dict(q_lora_rank=m.q_lora, kv_lora_rank=m.kv_lora,
                         qk_nope_head_dim=m.nope, qk_rope_head_dim=m.rope,
                         v_head_dim=m.v_dim),
            moe=dict(n_experts=m.n_experts, top_k=m.top_k,
                     routed_scaling=m.scaling,
                     expert_offset=m.expert_offset))
        got = arch.talker_hidden(Prec("f32"), w, m, [x[0], x[1]],
                                 routes=routes_b)
    for a, b in zip(routes_a, routes_b):
        assert torch.equal(a, b)
    for i in range(2):
        err = (got[i] - want[i]).norm() / want[i].norm()
        assert err < 1e-5           # float32 sums in other orders


def test_step_experts_is_the_step_reference():
    """``step_experts``' one step at position 0 equals the full reference's
    routing over a sequence of that one row."""
    from benchmark.reference import longcat_moe
    arch, m = load_model(tiny_longcat())
    w = arch.make_weights(m, SEED, "cpu").talker
    x = torch.randn(5, m.talker.hidden,
                    generator=torch.Generator().manual_seed(4))
    steps = arch.step_experts(w, m, x, 0)
    routes = []
    with torch.no_grad():
        longcat_moe.longcat_stack(
            Prec("f32"), w["layers"], x[:, None], eps=m.rms_norm_eps,
            mla_kw=arch._mla_kw(m), moe_kw=arch._moe_kw(m), routes=routes)
    want = []
    for r in routes:
        e = r - m.expert_offset
        e = e[(e >= 0) & (e < m.held)]
        want.append((len(e.unique()), len(e)))
    assert steps == want


def test_tiny_offline_run_is_correct(tmp_path, capsys):
    root = make_root(tmp_path)
    (root / "benchmark/configs/tiny.json").write_text(
        json.dumps(tiny_longcat()))
    rc = bench_run.main(["--workload", "tiny-offline", "--seed",
                         str(2**31 + 78), "--seconds", "1"],
                        root=root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True, line["checks"]


def test_cell_loads():
    c = spec.load_cell("offline-longcat-b192")
    assert c.chips == 1 and c.mix == spec.load_cell("offline-0.6b-b192").mix
    assert c.arch.__file__ == str(REPO / f"benchmark/archs/{ARCH}.py")
    names = {x["name"] for x in c.per_layer}
    assert names == {"talker_roofline", "codepred_roofline",
                     "vocoder_roofline", "mfu", "device_idle_share",
                     "graph_warmup_s", "tail_flush_ms", "voc_pad_share",
                     "late_captures", "moe_roofline", "moe_pad_share",
                     "mla_roofline", "moe_zero_share"}
    assert {x["name"] for x in c.end_to_end} == {"audio_s_per_s", "setup_s"}
    assert c.model.talker.hidden == 6144 and c.model.latent_width == 576
    assert set(c.limits) >= {"cb0_gap", "code_gap", "pcm_err"}
