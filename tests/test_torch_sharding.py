"""The port's mesh layer (qwen3_tts_tpu_torch/parallel/) against the JAX
package's tests/test_sharding.py: dp x tp over gloo worker processes on
the CPU, at tiny dims.

Each mesh shape runs once, in ``torch.multiprocessing.spawn`` workers
(tests/torch_mesh_workers.py, which imports no JAX) that share a
``file://`` store under tmp_path; the workers return numpy results and
the tests assert on them. The same jobs run unsharded in this process,
and the JAX package's XLA path runs here on the same weights
(``weights.tree_from_numpy``).

Greedy codes and valid masks are compared exactly: with these weights
(the seeds of tests/test_sharding.py), tokens and texts no code of the
compared frames sits at a bf16 near-tie, where the f32 partial sums that
tp adds in another order could flip it (ROADMAP.md C). Audio is compared
bitwise wherever the codes are equal: the vocoder reads only the codes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import talker as jtalker  # noqa: E402
from qwen3_tts_tpu.models import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu.parallel import mesh as jmesh  # noqa: E402
from qwen3_tts_tpu.runtime import generate as jgen  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.parallel import dryrun_multichip  # noqa: E402
from qwen3_tts_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from qwen3_tts_tpu_torch.runtime import graphs  # noqa: E402

from . import torch_mesh_workers as MW  # noqa: E402
from .test_tokenizer import make_tiny_tokenizer  # noqa: E402
from .test_torch_config import port_cfg, port_tokenizer  # noqa: E402

CFG = tiny_talker_config()
# name: (world size, tp), and the jobs each mesh runs
MESHES = {"dp2": (2, 1), "tp2": (2, 2), "dp2xtp2": (4, 2), "dp4": (4, 1)}
JOBS = {
    "dp2": ("facts", "chunk", "sampled", "serving", "synth", "ragged",
            "write_slot"),
    "tp2": ("facts", "chunk", "serving"),
    "dp2xtp2": ("facts", "chunk", "serving", "batcher"),
    "dp4": ("synth",),
}
SHORT, LONG = "hello.", "hello world hello world hello world hello world."


@pytest.fixture(scope="module")
def jax_weights():
    return init_talker_weights(np.random.default_rng(61), CFG)


@pytest.fixture(scope="module")
def inputs(jax_weights):
    rng = np.random.default_rng(62)
    vcfg = dataclasses.replace(jvoc.tiny_vocoder_config(),
                               codebook_size=2048)
    jvw = jvoc.init_vocoder_weights(rng, vcfg)
    tokens = rng.integers(0, CFG.text_vocab_size, (MW.B, 16)).astype(
        np.int32)

    def gumbel(*shape):
        return rng.gumbel(size=shape).astype(np.float32)

    return MW.Inputs(
        cfg=port_cfg(CFG),
        talker_w=W.tree_from_numpy(jax.tree.map(np.asarray, jax_weights),
                                   "cpu"),
        voc_cfg=port_cfg(vcfg),
        voc_w=W.tree_from_numpy(jax.tree.map(np.asarray, jvw), "cpu"),
        tokenizer=port_tokenizer(make_tiny_tokenizer()),
        tokens=tokens,
        serve_tokens=np.random.default_rng(77).integers(
            0, CFG.text_vocab_size, (MW.B, 16)).astype(np.int32),
        cb0_gumbel=gumbel(MW.CHUNK, MW.B, CFG.codec_vocab_size),
        codes_gumbel=gumbel(MW.CHUNK, CFG.n_codebooks - 1, MW.B,
                            CFG.code_pred_vocab_size),
        texts=["hello world.", "hello.", "hello hello.", "world hello.",
               "hello world hello.", "world.", "hello hello world.",
               "hello world. hello."],
        ragged_texts=["hello.", "hello world.", "hello hello."],
        # dp=2: rank 0 holds the short streams (EOS ramp from frame 40),
        # rank 1 the long ones (ramp from frame 128, past the 80 cap)
        slot_texts=[SHORT, SHORT, LONG, LONG],
        batcher_texts=["hello world.", "hello.", "hello hello.",
                       "hello world. hello."])


@pytest.fixture(scope="module")
def mesh_run(inputs, tmp_path_factory):
    """mesh name -> each rank's results, spawned once per mesh."""
    @functools.cache
    def run(name):
        world, n_tp = MESHES[name]
        return MW.spawn(inputs, world, n_tp, JOBS[name],
                        tmp_path_factory.mktemp(name))
    return run


@pytest.fixture(scope="module")
def base(inputs):
    """job name -> the unsharded port's result, computed once."""
    @functools.cache
    def run(job):
        return MW.run_jobs(inputs, None, (job,))[job]
    return run


@pytest.fixture(scope="module")
def jax_chunk(jax_weights, inputs):
    """The JAX package's XLA-path lock-step chunk, greedy."""
    B = MW.B
    jp = jtalker.build_prefill_inputs(
        jax_weights, CFG, jnp.asarray(inputs.tokens),
        jnp.full((B,), 16, jnp.int32), jnp.zeros((B, CFG.hidden_size)))
    ctx = jgen.required_ctx(jp.prefill_embd.shape[1], MW.CHUNK, MW.CHUNK)
    js = jgen.init_state(jax_weights, CFG, jp, ctx, jax.random.PRNGKey(0))
    jc = jgen.make_consts(jp, 0.0, 1.05)
    _, codes, valid = jgen.generate_chunk(jax_weights, CFG, js, jc, 50,
                                          MW.CHUNK, greedy=True,
                                          read_ctx=ctx, lockstep=True)
    return np.asarray(codes), np.asarray(valid)


def _ranks(mesh_run, name, job):
    return [r[job] for r in mesh_run(name)]


def _same_results(got, want, atol=0.0):
    assert len(got) == len(want)
    for (gs, gn, ga), (ws, wn, wa) in zip(got, want):
        assert gs and ws and gn == wn
        if atol:
            np.testing.assert_allclose(ga, wa, atol=atol)
        else:
            np.testing.assert_array_equal(ga, wa)


# -- the mesh --------------------------------------------------------------
@pytest.mark.parametrize("name", ["dp2", "tp2", "dp2xtp2"])
def test_mesh_shapes(mesh_run, name):
    world, n_tp = MESHES[name]
    for rank, facts in enumerate(_ranks(mesh_run, name, "facts")):
        assert facts["names"] == ("dp", "tp")
        assert facts["dims"] == (world // n_tp, n_tp)
        assert facts["coords"] == (rank // n_tp, rank % n_tp)
        assert "processes" in facts["bigger"]      # a mesh past the world


def test_rank_seeds_apart_over_dp_alike_over_tp(mesh_run):
    seeds = [f["seed"] for f in _ranks(mesh_run, "dp2xtp2", "facts")]
    assert seeds[0] == seeds[1] == 7 and seeds[2] == seeds[3] != 7


def test_make_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_mesh(1, 1, "cpu")


def test_cuda_mesh_without_a_card_raises(mesh_run):
    assert "CUDA device" in _ranks(mesh_run, "dp2", "facts")[0]["cuda"]


def test_graph_keys_carry_the_mesh():
    key = dict(model_tag="abcd1234", buffers=1, B=4, ctx=1152,
               kv_quant=False, talker_impl="auto", codepred_impl="auto",
               read_ctx=512, top_k=50, greedy=True, ring=True, trailing=256,
               top_p=1.0, temperature=0.0, repetition_penalty=1.05,
               device="cuda:0")
    plain = graphs.gen_key(**key)
    r1 = graphs.gen_key(**key, mesh=(2, 1, 1))
    assert r1 == plain + "-m2x1-rk1"
    assert r1 != graphs.gen_key(**key, mesh=(2, 1, 0))
    assert graphs.voc_key(model_tag="t", n=8, frames=40, sub=None,
                          pcm16=True, res_impl="auto", device="cuda:0",
                          mesh=(1, 1, 0)).endswith("-m1x1-rk0")


# -- weights -----------------------------------------------------------------
def test_unfuse_stack_layers_matches_jax(jax_weights, inputs):
    args = (CFG.n_attention_heads, CFG.n_key_value_heads, CFG.head_dim)
    want = jmesh.unfuse_stack_layers(jax_weights["layers"], *args)
    got = tmesh.unfuse_stack_layers(inputs.talker_w["layers"], *args)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(
            got[k].float().numpy(), np.asarray(want[k]).astype(np.float32))


@pytest.mark.parametrize("unfused", [False, True], ids=["fused", "unfused"])
def test_talker_shardings_match_jax_specs(unfused):
    """Leaf for leaf, the dim the port splits on tp is where the JAX
    PartitionSpec names "tp" (conftest's 8 virtual CPU devices)."""
    want = jmesh.talker_shardings(jmesh.make_mesh(4, 2), unfused=unfused)
    got = tmesh.talker_shardings(None, unfused=unfused)

    def walk(g, w, path):
        assert set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{path}.{k}")
            else:
                spec = tuple(w[k].spec)
                dim = spec.index("tp") if "tp" in spec else None
                assert g[k] == dim, (f"{path}.{k}", spec)
    walk(got, want, "w")


@pytest.mark.parametrize("name", ["tp2", "dp2xtp2"])
def test_tp_requires_cfg(mesh_run, name):
    assert "cfg" in _ranks(mesh_run, name, "facts")[0]["no_cfg"]


@pytest.mark.parametrize("name", ["tp2", "dp2xtp2"])
def test_tp_projections_actually_split(mesh_run, name):
    """tp > 1 unfuses wqkv/w_gu, and each rank holds half of every
    projection, of codec_head's vocabulary and of the heads'."""
    facts = _ranks(mesh_run, name, "facts")[0]
    for stack, (nh, nkv, d, inter, hidden) in (
            ("talker", (CFG.n_attention_heads, CFG.n_key_value_heads,
                        CFG.head_dim, CFG.intermediate_size,
                        CFG.hidden_size)),
            ("code_pred", (CFG.code_pred_n_attention_heads,
                           CFG.code_pred_n_kv_heads, CFG.code_pred_head_dim,
                           CFG.code_pred_intermediate_size,
                           CFG.code_pred_hidden_size))):
        s = facts["stacks"][stack]
        assert "wqkv" not in s and "w_gu" not in s
        assert s["wq"][-1] == nh * d // 2
        assert s["wk"][-1] == s["wv"][-1] == nkv * d // 2
        assert s["w_gate"][-1] == s["w_up"][-1] == inter // 2
        assert s["wo"][1] == nh * d // 2 and s["wo"][2] == hidden
        assert s["w_down"][1] == inter // 2
    assert facts["heads"] == ((CFG.hidden_size, CFG.codec_vocab_size // 2),
                              (CFG.n_codebooks - 1, CFG.code_pred_hidden_size,
                               CFG.code_pred_vocab_size // 2))


# -- generation --------------------------------------------------------------
@pytest.mark.parametrize("name", ["dp2", "tp2", "dp2xtp2"])
def test_generate_chunk_matches_unsharded_and_jax(mesh_run, base, jax_chunk,
                                                  name):
    want = base("chunk")
    np.testing.assert_array_equal(want["codes"], jax_chunk[0])
    np.testing.assert_array_equal(want["valid"], jax_chunk[1])
    for got in _ranks(mesh_run, name, "chunk"):
        for k in ("codes", "valid", "done"):
            np.testing.assert_array_equal(got[k], want[k])


def test_sampled_chunk_with_draws_matches_unsharded(mesh_run, base):
    want = base("sampled")
    for got in _ranks(mesh_run, "dp2", "sampled"):
        for k in ("codes", "valid", "done"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", ["dp2", "dp4"])
def test_synthesize_batch_matches_unsharded(mesh_run, base, name):
    """Every rank returns every result; on_chunk fires on the rank that
    decodes the stream, its own dp rows."""
    ranks = _ranks(mesh_run, name, "synth")
    per = MW.B // MESHES[name][0]
    for rank, got in enumerate(ranks):
        _same_results(got["results"], base("synth")["results"])
        assert got["chunked"] == list(range(rank * per, (rank + 1) * per))


def test_ragged_batch_warns_and_stays_correct(mesh_run, base):
    ranks = _ranks(mesh_run, "dp2", "ragged")
    assert "not divisible by dp=2" in ranks[0]["stderr"]
    for got in ranks:
        _same_results(got["results"], base("ragged")["results"])


def test_rank_all_done_while_another_runs(mesh_run, base):
    """The lock-step write slot is each rank's own max(n_past): rank 0's
    streams end early in the second chunk while rank 1's run through it to
    the 80-frame cap, and the results equal the unsharded engine's."""
    want = base("write_slot")["results"]
    frames = [n for _, n, _ in want]
    assert max(frames[:2]) < 60 and min(frames[2:]) == 80, frames
    for got in _ranks(mesh_run, "dp2", "write_slot"):
        _same_results(got["results"], want)


# -- serving -----------------------------------------------------------------
@pytest.mark.parametrize("name", ["dp2", "tp2", "dp2xtp2"])
def test_serving_path_matches_unsharded(mesh_run, base, name):
    want = base("serving")["chunks"]
    assert not want[2][1][:, 0].any()         # the parked slot
    for got in _ranks(mesh_run, name, "serving"):
        for g, w in zip(got["chunks"], want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_continuous_batcher_dp2xtp2_matches_unsharded(mesh_run, base):
    """Every rank returns every result; a request's final on_audio call
    comes on the ranks of the dp group that owns its slot (both tp
    ranks), once for each request over the dp groups."""
    ranks = _ranks(mesh_run, "dp2xtp2", "batcher")
    for got in ranks:
        _same_results(got["results"], base("batcher")["results"],
                      atol=1e-3)
    assert ranks[0]["finals"] == ranks[1]["finals"]
    assert ranks[2]["finals"] == ranks[3]["finals"]
    assert sorted(ranks[0]["finals"] + ranks[2]["finals"]) == list(
        range(len(base("batcher")["results"])))


# -- errors ------------------------------------------------------------------
def test_batcher_slots_not_a_multiple_of_dp_raise(mesh_run):
    facts = _ranks(mesh_run, "dp2", "facts")[0]
    assert "not a multiple of dp=2" in facts["odd_slots"]


@pytest.mark.parametrize("switch", ["talker", "codepred"])
def test_fused_at_tp_raises(mesh_run, switch):
    assert "tp > 1" in _ranks(mesh_run, "tp2", "facts")[0][f"fused_{switch}"]


def test_dryrun_multichip_cpu(capfd):
    dryrun_multichip(4, device="cpu")
    assert ("dryrun_multichip OK: mesh dp=2 tp=2, B=4, codes (2, 4, 16), "
            "serving path (admit+ring+park) OK") in capfd.readouterr().out
