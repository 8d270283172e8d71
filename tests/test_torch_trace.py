"""The port's utils/trace.py, mirroring tests/test_utils.py: the stage
timer and its report, the memory snapshot, and the torch.profiler trace
behind QWEN3_TTS_PROFILE."""

import io
import json
import time

import pytest

torch = pytest.importorskip("torch")

from qwen3_tts_tpu_torch.utils import (StageTimer, log_memory,  # noqa: E402
                                       memory_snapshot, profile_trace)


def test_stage_timer_accumulates_and_reports():
    t = StageTimer()
    with t.stage("Tokenize"):
        time.sleep(0.01)
    with t.stage("Generate"):
        time.sleep(0.02)
    t.add("Generate", 5.0)
    assert t.stages["Tokenize"] >= 10
    assert t.stages["Generate"] >= 25
    buf = io.StringIO()
    t.report(audio_seconds=1.0, file=buf)
    out = buf.getvalue()
    assert "Tokenize:" in out and "RTF=" in out and "x realtime" in out


def test_memory_snapshot_and_log():
    m = memory_snapshot()
    assert m["rss_peak_bytes"] > 0
    assert set(m) == {"rss_peak_bytes", "device_bytes_in_use",
                      "device_bytes_peak", "device_bytes_limit"}
    buf = io.StringIO()
    log_memory("test/label", file=buf)
    assert "[mem] test/label" in buf.getvalue() and "rss=" in buf.getvalue()


def test_profile_trace_noop_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv("QWEN3_TTS_PROFILE", raising=False)
    with profile_trace("x"):
        torch.ones(8).sum()
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("how", ["argument", "env"])
def test_profile_trace_writes_a_chrome_trace(tmp_path, monkeypatch, how):
    kw = {}
    if how == "env":
        monkeypatch.setenv("QWEN3_TTS_PROFILE", str(tmp_path))
    else:
        kw["trace_dir"] = str(tmp_path)
    with profile_trace("bench", **kw):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list(tmp_path.glob("bench.*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "bench" in names
