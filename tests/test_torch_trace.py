"""The port's utils/trace.py: the span recorder (nesting, request ids,
the bounded buffer, the off switch, the profiler's ranges), the memory
snapshot, and the torch.profiler trace behind QWEN3_TTS_PROFILE. The
program's spans on the tiny engine are in tests/test_torch_serve.py and
tests/test_torch_pipeline.py."""

import io
import json
import time

import pytest

torch = pytest.importorskip("torch")

from qwen3_tts_tpu_torch.utils import (memory_snapshot,  # noqa: E402
                                       print_report, profile_trace, trace)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.delenv("QWEN3_TTS_TRACE", raising=False)
    trace.reset()
    yield
    trace.reset()


def test_span_nesting_and_parents():
    with trace.span("outer", n=2) as outer:
        with trace.span("inner") as inner:
            time.sleep(0.001)
            inner.set(k=1)
        with trace.span("inner"):
            trace.add("stamped", 5, 6)
    with trace.span("next"):
        pass
    s = {(x.name, x.sid): x for x in trace.spans()}
    out = next(x for x in s.values() if x.name == "outer")
    ins = [x for x in s.values() if x.name == "inner"]
    assert out.parent is None and out.attrs == {"n": 2}
    assert [x.parent for x in ins] == [out.sid, out.sid]
    assert ins[0].attrs == {"k": 1} and ins[0].ms >= 1.0
    assert out.t0 <= ins[0].t0 <= ins[0].t1 <= ins[1].t0 <= out.t1
    stamped = next(x for x in s.values() if x.name == "stamped")
    assert stamped.parent == ins[1].sid and (stamped.t0, stamped.t1) == (5, 6)
    nxt = next(x for x in s.values() if x.name == "next")
    assert nxt.parent is None and nxt.t0 >= out.t1
    assert len({x.sid for x in s.values()}) == 5
    # ended order: children before their parent
    assert [x.name for x in trace.spans()] == [
        "inner", "stamped", "inner", "outer", "next"]


def test_request_spans_share_rid_and_window():
    t = time.monotonic_ns()
    trace.add("req.queue", t, t + 10, rid=7)
    trace.add("req.queue", t + 5, t + 20, rid=8)
    with trace.span("req.work", rid=7):
        pass
    trace.add("req.first_audio", t + 10, t + 50, rid=7)
    assert [x.name for x in trace.spans() if x.rid == 7] == [
        "req.queue", "req.work", "req.first_audio"]
    assert [x.rid for x in trace.spans() if x.name == "req.queue"] == [7, 8]
    # spans(t0, t1): the spans that began in [t0, t1)
    assert [x.rid for x in trace.spans(t + 1, t + 11)] == [8, 7]
    assert trace.spans(t + 51) == [
        x for x in trace.spans() if x.name == "req.work"]
    trace.count("c")
    trace.count("c", 4)
    assert trace.counters() == {"c": 5}


def test_bounded_buffer_drops_oldest():
    rec = trace.Recorder(capacity=4)
    for i in range(10):
        with rec.span("s", i=i):
            pass
    assert [x.attrs["i"] for x in rec.spans()] == [6, 7, 8, 9]
    assert rec.counters() == {"trace.dropped": 6}
    rec.reset()
    assert rec.spans() == [] and rec.counters() == {}


def test_off_switch_records_nothing(monkeypatch):
    monkeypatch.setenv("QWEN3_TTS_TRACE", "0")
    assert not trace.enabled()
    with trace.span("a", x=1) as sp:
        sp.set(y=2)
        with trace.span("b"):
            pass
    trace.add("c", 1, 2, rid=3)
    trace.count("d")
    assert trace.spans() == [] and trace.counters() == {}
    monkeypatch.setenv("QWEN3_TTS_TRACE", "1")
    with trace.span("a"):
        pass
    assert [x.name for x in trace.spans()] == ["a"]


def test_profiler_sees_q3_ranges():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("serve.step"):
            with trace.span("serve.decode"):
                torch.ones(16).sum()
    names = {e.name for e in prof.events()}
    assert {"q3/serve.step", "q3/serve.decode"} <= names
    assert [x.name for x in trace.spans()] == ["serve.decode", "serve.step"]


def test_no_record_function_without_profiler(monkeypatch):
    """With no profiler recording, a span enters no profiler range
    (``record_function`` costs ~11 us a use even then): one flag check
    only. With one, a host-only range, never ``record_function``'s user
    annotation (which the profiler mirrors onto the card's timeline)."""
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "RANGE", Spy)
    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    assert not torch.autograd._profiler_enabled()
    with trace.span("call"):
        with trace.span("call.decode", rows=1, bucket=1):
            pass
    assert entered == [] and len(trace.spans()) == 2
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("call"):
            pass
    assert entered == ["q3/call"]


def test_profiler_range_is_a_host_op(tmp_path):
    """The q3/ range lands in the trace as a host op (``cpu_op``), not as
    a user annotation."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("serve.step"):
            torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    cats = {e.get("cat") for e in json.loads((tmp_path / "t.json")
                                             .read_text())["traceEvents"]
            if e.get("name") == "q3/serve.step"}
    assert cats == {"cpu_op"}


def test_print_report_shape():
    buf = io.StringIO()
    print_report({"Tokenization": 1.0, "Host waits": 20.0}, 150.0,
                 audio_seconds=3.0, file=buf)
    out = buf.getvalue()
    assert out.startswith("\nTiming:")
    assert "Tokenization:" in out and "Host waits:" in out
    assert "Total:" in out and "RTF=0.050" in out and "x realtime" in out


def test_memory_snapshot_and_log():
    m = memory_snapshot()
    assert m["rss_peak_bytes"] > 0
    assert set(m) == {"rss_peak_bytes", "device_bytes_in_use",
                      "device_bytes_peak", "device_bytes_limit"}


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
        with trace.span("call"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list(tmp_path.glob("bench.*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"bench", "q3/call"} <= names
