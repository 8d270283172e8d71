"""The port's measurement programs (qwen3_tts_tpu_torch/tools/bench.py,
bench_serve.py, bench_breakdown.py) on the CPU at tiny dims, in process
with ``--device cpu --tiny``: their JSON records carry the JAX tools'
keys, ``--ladder`` parses as the JAX bench parses it, the bench's token
ids and the serving bench's tokenizer are the JAX tools' own, and the
first lock-step chunk the bench builds equals the JAX package's greedy
chunk exactly. The numbers of a CPU run describe no card."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from qwen3_tts_tpu.models import talker as jtalker  # noqa: E402
from qwen3_tts_tpu.models.weights import (init_talker_weights,  # noqa: E402
                                          tiny_talker_config)
from qwen3_tts_tpu.runtime import generate as jgen  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.runtime.pipeline import Qwen3TTS  # noqa: E402
from qwen3_tts_tpu_torch.tools import bench  # noqa: E402
from qwen3_tts_tpu_torch.tools import bench_breakdown  # noqa: E402
from qwen3_tts_tpu_torch.tools import bench_serve  # noqa: E402

from .test_torch_config import port_cfg  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu", "--tiny"]

# the JAX bench's record, bench.py:321-334
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "voc_impl", "kv",
              "cache_layout", "talker_impl", "gen_ms_per_frame",
              "voc_ms_per_frame", "total_ms_per_frame",
              "realtime_streams_ok"]
# the JAX serving bench's record, tools/bench_serve.py:194-201
SERVE_KEYS = ["metric", "value", "unit", "vs_baseline", "ttfa_p50_ms",
              "ttfa_p99_ms"]
# the JAX breakdown prints no record (stderr only); the port's record
BREAKDOWN_KEYS = ["metric", "value", "unit", "batch", "kv", "talker_impl",
                  "codepred_impl", "talker_step_ms", "talker_step_device_ms",
                  "code_predictor_ms", "code_predictor_device_ms",
                  "sample_cb0_ms", "sample_cb0_device_ms",
                  "frame_step_embedding_ms",
                  "frame_step_embedding_device_ms", "sum_of_stages_ms",
                  "frame_graph_ms", "frame_graph_device_ms",
                  "frame_graph_device_ms_by_group"]


def _records(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.strip()]


# -- the records -------------------------------------------------------------
def test_bench_record_has_the_jax_keys(capsys):
    assert bench.main([*CPU, "--batch", "4", "--chunks", "1", "--runs", "1",
                       "--check-fused"]) == 0
    captured = capsys.readouterr()
    (rec,) = _records(captured.out)
    assert list(rec) == BENCH_KEYS
    assert rec["metric"] == "ms_per_frame_per_stream_b4"
    assert (rec["kv"], rec["cache_layout"], rec["talker_impl"]) == (
        "int8", "stacked", "auto")
    # what ran: on CPU tensors the plain path under the default switch
    assert rec["voc_impl"] == "xla"
    assert rec["value"] > 0 and rec["total_ms_per_frame"] > 0
    assert "vocoder sub-batch: 4 streams" in captured.err
    assert "kernel launches in the entry" in captured.err


def test_bench_serve_record_has_the_jax_keys(capsys):
    assert bench_serve.main([*CPU, "--slots", "2", "--requests", "3",
                             "--frames", "40"]) == 0
    captured = capsys.readouterr()
    (rec,) = _records(captured.out)
    assert list(rec) == SERVE_KEYS
    assert rec["metric"] == "aggregate_realtime_x_slots2"
    assert rec["value"] > 0 and rec["ttfa_p50_ms"] > 0
    assert "queue wait ms" in captured.err


def test_bench_serve_exits_2_when_a_request_fails(capsys, monkeypatch):
    encode = bench_serve.RandomTokenizer.encode_for_tts

    def poisoned(self, text):
        if text == "request number 1":
            raise ValueError("poisoned text")
        return encode(self, text)

    monkeypatch.setattr(bench_serve.RandomTokenizer, "encode_for_tts",
                        poisoned)
    assert bench_serve.main([*CPU, "--slots", "2", "--requests", "2",
                             "--frames", "40"]) == 2
    captured = capsys.readouterr()
    (rec,) = _records(captured.out)
    assert rec["error"] == "1/2 requests failed"
    assert rec["value"] == 0
    assert "request FAILED" in captured.err


def test_breakdown_record(capsys):
    assert bench_breakdown.main([*CPU, "--batch", "2", "--iters", "1"]) == 0
    captured = capsys.readouterr()
    (rec,) = _records(captured.out)
    assert list(rec) == BREAKDOWN_KEYS
    assert rec["metric"] == "frame_breakdown_b2"
    stages = ("talker_step", "code_predictor", "sample_cb0",
              "frame_step_embedding")
    assert rec["sum_of_stages_ms"] == pytest.approx(
        sum(rec[f"{s}_ms"] for s in stages), rel=1e-3)
    # no device time on the CPU
    assert all(rec[f"{s}_device_ms"] is None for s in stages)
    assert rec["frame_graph_device_ms"] is None


@pytest.mark.parametrize("tool", [bench, bench_serve, bench_breakdown],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cuda_without_a_card_exits_nonzero(tool, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--device", "cuda", "--tiny"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    err = captured.err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]


# -- the ladder ----------------------------------------------------------------
@pytest.mark.parametrize("ladder, want", [
    ("192:int8:stacked", [(192, "int8", "stacked", None)]),
    ("192:int8:stacked,192:bf16:stacked",
     [(192, "int8", "stacked", None), (192, "bf16", "stacked", None)]),
    ("224:int8:stacked:fused, 16:bf16:stacked:xla",
     [(224, "int8", "stacked", "fused"), (16, "bf16", "stacked", "xla")]),
])
def test_ladder_parses_as_the_jax_bench(ladder, want):
    """The JAX bench's parse (bench.py:446-457): split on ",", strip,
    split on ":", (int(B), kv, cache, talker or --talker)."""
    assert bench.parse_args(["--ladder", ladder]).entries == want


def test_ladder_talker_defaults_to_the_flag():
    args = bench.parse_args(["--ladder", "8:bf16:stacked", "--talker",
                             "xla"])
    assert args.entries == [(8, "bf16", "stacked", "xla")]
    assert bench.parse_args([]).entries == [(192, "int8", "stacked", None)]


@pytest.mark.parametrize("ladder", [
    "192:int8:layered", "192:int8:stacked,256:int8:layered", "192:int4:stacked",
    "192:int8", "192:int8:stacked:pallas", "b192:int8:stacked",
    "192:int8:stacked:auto:x"])
def test_ladder_refuses(ladder, capsys):
    with pytest.raises(SystemExit) as e:
        bench.parse_args(["--ladder", ladder])
    assert e.value.code != 0
    if "layered" in ladder:
        assert "no layered cache" in capsys.readouterr().err


# -- the workload --------------------------------------------------------------
@pytest.mark.parametrize("B", [1, 4, 192])
@pytest.mark.parametrize("vocab", [512, 151936])
def test_token_ids_are_the_jax_bench_draws(B, vocab):
    """bench.py:96-98: rng = default_rng(0); integers(0, min(1000,
    text_vocab_size), (B, 48))."""
    rng = np.random.default_rng(0)
    want = rng.integers(0, min(1000, vocab), (B, 48))
    np.testing.assert_array_equal(bench.token_ids(B, vocab), want)


def test_random_tokenizer_is_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_serve", ROOT / "tools" / "bench_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)           # defines; main() does not run
    for vocab in (512, 151936):
        jtok, ttok = mod.RandomTokenizer(vocab), bench_serve.RandomTokenizer(
            vocab)
        for text in ("warmup", "request number 0", "request number 47",
                     "", "héllo wörld."):
            assert ttok.encode_for_tts(text) == jtok.encode_for_tts(text)


@pytest.mark.parametrize("B, sub", [(4, None), (48, None), (64, 32),
                                    (192, 48), (224, 32), (256, 32),
                                    (320, 32)])
def test_default_vocoder_sub_batch_is_the_pipelines(B, sub):
    assert Qwen3TTS().voc_sub(B) == sub


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_first_chunk_equals_jax_greedy(kv, monkeypatch):
    """--temperature 0: the bench's first lock-step chunk, through the
    engine's own chunk, against generate_chunk(lockstep=True,
    greedy=True) on the same weights (weights.tree_from_numpy), token ids
    and cache: codes and valid masks exactly (the goldens' gate)."""
    monkeypatch.setenv("QWEN3_TTS_KV", kv)
    cfg, B = tiny_talker_config(), 3
    jw = init_talker_weights(np.random.default_rng(13), cfg)
    tw = W.tree_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    engine = Qwen3TTS.from_components(None, port_cfg(cfg), tw, None, None,
                                      "cpu")
    wl = bench.Workload(engine, B, 400, 0.0)
    wl.fresh()
    codes, valid = (t.clone().numpy() for t in wl.chunk())

    tokens = bench.token_ids(B, cfg.text_vocab_size)
    jp = jtalker.build_prefill_inputs(
        jw, cfg, jnp.asarray(tokens), jnp.full((B,), 48, jnp.int32),
        jnp.zeros((B, cfg.hidden_size), jnp.float32))
    P = jp.prefill_embd.shape[1]
    ctx = jgen.required_ctx(P, 400, 40)
    assert (P, ctx) == (wl.prefill_len, wl.ctx)
    js = jgen.init_state(jw, cfg, jp, ctx, jax.random.PRNGKey(1),
                         kv_quant=kv == "int8")
    jc = jgen.make_consts(jp, 0.0, 1.05)
    _, jcodes, jvalid = jgen.generate_chunk(
        jw, cfg, js, jc, 50, 40, greedy=True,
        read_ctx=jgen.ctx_bucket(P, 40, ctx), lockstep=True)
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    np.testing.assert_array_equal(codes, np.asarray(jcodes))
    assert valid.any()
