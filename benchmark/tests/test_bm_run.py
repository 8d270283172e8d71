"""A whole run of the tiny cells on the CPU (the look for a card
skipped): the last line's keys, the checks beside their limits, the
check for JAX by whole top-level names, and no result without a card or
without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run as bench_run
from benchmark.tests.tiny import REPO, make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _main(root, capsys, cell, trace=0, seed=2**31 + 11, seconds=1):
    rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        root=root, device="cpu")
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell,e2e", [
    ("tiny-offline", {"audio_s_per_s", "setup_s"}),
    ("tiny-serve", {"audio_s_per_s", "setup_s", "ttfa_p95_ms",
                    "chunk_gap_p95_ms"})])
def test_last_line(tmp_path, capsys, cell, e2e):
    rc, line, err = _main(make_root(tmp_path), capsys, cell)
    assert rc == 0
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == e2e
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"cb0_gap", "code_gap", "pcm_err"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"]
    last = err.strip().splitlines()[-3:]
    assert [x.split(":")[0] for x in last] == [
        "check cb0_gap", "check code_gap", "check pcm_err"]
    assert "streams that ended before their EOS ramp: 0 of" in err


def test_traced_line_has_per_layer(tmp_path, capsys):
    rc, line, _ = _main(make_root(tmp_path), capsys, "tiny-serve", trace=1)
    assert rc == 0
    # the CPU has no device trace: the readers find nothing and say so by
    # leaving their metric out
    assert set(line["metrics"]) == {"queue_wait_p95_ms", "graph_warmup_s"}


def test_forbidden_by_whole_top_level_name():
    f = bench_run.forbidden_modules
    assert f({"qwen3_tts_tpu_torch", "qwen3_tts_tpu_torch.models"}) == []
    assert f({"jaxtyping", "flaxen", "jax_stub"}) == []
    assert f({"qwen3_tts_tpu.models.talker"}) == ["qwen3_tts_tpu"]
    assert f({"jax.numpy", "jaxlib", "flax.linen"}) == ["flax", "jax",
                                                        "jaxlib"]


def test_run_imports_no_jax():
    """The harness, a cell with its architecture, the program's entry
    points and the reference, in a fresh process, leave no JAX module
    loaded."""
    code = ("import sys\n"
            "from benchmark import run, check, spec, timing\n"
            "spec.load_cell('offline-0.6b-b192')\n"
            "from benchmark.kinds import offline, serve\n"
            "import qwen3_tts_tpu_torch.runtime.serve\n"
            "import qwen3_tts_tpu_torch.runtime.pipeline\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder:
    a nonzero exit and nothing on stdout."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "offline-0.6b-b192", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("frame_cap,opened", [
    (256, ("trace-a", 6)),          # the first call's last full wave
    (1024, ("trace-a", "end"))])    # fewer waves: at the first call's end
def test_offline_trace_spans_a_call_boundary(monkeypatch, frame_cap, opened):
    """The offline slice opens in the first traced call, holds its flush
    and the gap, and closes at the second call's first wave, which stops
    that call."""
    import math

    import torch

    from benchmark.kinds import offline
    where, log = [None], []

    class Slice:
        def __init__(self, device, start_at, steps, on):
            self.start_at, self.on = start_at, True
            self.prof = self.t_close = None

        def tick(self):
            if self.prof is None and self.start_at == -math.inf:
                self.prof = "open"
                log.append(("open",) + where[0])
            elif self.prof is not None and self.t_close is None:
                self.t_close = 1.0
                log.append(("close",) + where[0])

        def finish(self):
            return {"log": log}

    class Tap:
        batches = 0

    tap = Tap()

    def call(key, first_id, in_window, tick):
        # six lock-step waves of 4 streams, then a flush of 4 single decodes
        for wave in list(range(1, 7)) + ["flush"] * 4:
            tap.batches += 1
            for _ in range(4 if wave != "flush" else 1):
                where[0] = (key, wave)
                tick()
        where[0] = (key, "end")
        return []

    monkeypatch.setattr(offline, "Slice", Slice)
    out = offline._trace_boundary(call, tap, torch.device("cpu"),
                                  {"frame_cap": frame_cap}, 0, 4)
    assert out["log"] == [("open",) + opened, ("close", "trace-b", 1)]
