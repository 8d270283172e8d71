"""The readers of the program's spans (first_audio_p95_ms, slot_occupancy,
tail_flush_ms, voc_pad_share, late_captures) on a made-up run on a card
device, with spans planted in the program's recorder: the window,
p95 by nearest rank, the occupancy and padding arithmetic, and nothing
read off the card, with no span, or from a program without the
recorder; and the tiny CPU cells' traced lines without them."""

import json
import math
import time

import pytest
import torch

from benchmark import record, spec
from benchmark import run as bench_run
from benchmark.tests.tiny import make_root
from qwen3_tts_tpu_torch.utils import trace

NEW = ("first_audio_p95_ms", "slot_occupancy", "tail_flush_ms",
       "voc_pad_share", "late_captures")
MS = 1_000_000                     # ns


@pytest.fixture
def plant(tmp_path, monkeypatch):
    """(read, w0): a reader by name over a run on "cuda" whose window
    opens at w0 (ns) and lasts 10 s; the recorder starts empty."""
    monkeypatch.delenv("QWEN3_TTS_TRACE", raising=False)
    trace.reset()
    cell = spec.load_cell("tiny-serve", make_root(tmp_path))
    run = record.Run(cell, 1, 10.0, True, torch.device("cuda"), 0.0)
    now = time.monotonic()
    run.t_window0, run.t_window1 = now + 100.0, now + 110.0
    w0 = int(run.t_window0 * 1e9)
    yield (lambda name: spec.reader(cell, name)(run)), w0, run
    trace.reset()


def test_first_audio_p95_over_requests_queued_in_window(plant):
    read, w0, _ = plant
    for rid in range(20):                       # queued in the window
        t = w0 + rid * 400 * MS
        trace.add("req.queue", t, t + 5 * MS, rid=rid)
        trace.add("req.first_codes", t + 5 * MS, t + 505 * MS, rid=rid)
        trace.add("req.first_audio", t + 5 * MS, t + (5 + 100 * (rid + 1))
                  * MS, rid=rid)
    # queued before the window: its first audio, in the window, not read
    trace.add("req.queue", w0 - 50 * MS, w0 - 40 * MS, rid=99)
    trace.add("req.first_audio", w0 - 40 * MS, w0 + 90_000 * MS, rid=99)
    # queued after it
    trace.add("req.queue", w0 + 10_500 * MS, w0 + 10_501 * MS, rid=98)
    trace.add("req.first_audio", w0 + 10_501 * MS, w0 + 99_000 * MS, rid=98)
    # 100..2000 ms: the 19th of 20 (request 19's first audio ends after
    # the window, and still counts)
    assert read("first_audio_p95_ms") == pytest.approx(1900.0)
    assert read("slot_occupancy") is None        # no step planted


def test_slot_occupancy_mean_of_steps_in_window(plant):
    read, w0, _ = plant
    for i, busy in enumerate((2, 4, 3, 3)):
        trace.add("serve.step", w0 + i * MS, w0 + (i + 1) * MS, busy=busy,
                  slots=4)
    trace.add("serve.step", w0 - MS, w0, busy=0, slots=4)     # before
    trace.add("serve.step", w0 + 10_000 * MS, w0 + 10_001 * MS, busy=0,
              slots=4)                                         # at the end
    assert read("slot_occupancy") == pytest.approx(75.0)
    assert read("first_audio_p95_ms") is None    # no request planted


def test_tail_flush_median_and_pad_share(plant):
    read, w0, _ = plant
    for k, ms in enumerate((700.0, 900.0, 800.0)):
        t = w0 + k * 2000 * MS
        trace.add("call.decode", t, t + MS, rows=150, bucket=192)
        trace.add("call.tail_flush", t + MS, t + MS + int(ms * MS))
        trace.add("call.decode", t + 2 * MS, t + 3 * MS, rows=1, bucket=1)
    trace.add("call.tail_flush", w0 - 10_000 * MS, w0 - 1)     # before
    trace.add("serve.decode", w0 + 9000 * MS, w0 + 9001 * MS, rows=5,
              bucket=8)
    trace.add("serve.decode", w0 - 5 * MS, w0, rows=1, bucket=128)  # before
    assert read("tail_flush_ms") == pytest.approx(800.0)
    pad = 3 * 42 + 3
    assert read("voc_pad_share") == pytest.approx(
        100.0 * pad / (3 * 192 + 3 * 1 + 8))
    assert read("late_captures") == 0.0          # spans, but no capture


def test_late_captures_count_in_window(plant):
    read, w0, _ = plant
    assert read("late_captures") is None         # no span at all
    trace.add("graphs.capture", w0 - 100 * MS, w0 - 90 * MS, kind="gen")
    assert read("late_captures") is None         # only set-up's
    trace.add("graphs.capture", w0 + 5 * MS, w0 + 90 * MS, kind="voc")
    trace.add("graphs.capture", w0 + 95 * MS, w0 + 99 * MS, kind="gen")
    assert read("late_captures") == 2.0


def test_nothing_off_the_card_or_without_the_recorder(plant, monkeypatch):
    read, w0, run = plant
    trace.add("req.queue", w0, w0 + MS, rid=1)
    trace.add("req.first_audio", w0 + MS, w0 + 2 * MS, rid=1)
    trace.add("serve.step", w0, w0 + MS, busy=1, slots=2)
    trace.add("call.tail_flush", w0, w0 + MS)
    trace.add("call.decode", w0, w0 + MS, rows=1, bucket=4)
    values = {n: read(n) for n in NEW}
    assert all(v is not None and math.isfinite(v) for v in values.values())
    assert values["voc_pad_share"] == pytest.approx(75.0)
    run.device = torch.device("cpu")
    assert all(read(n) is None for n in NEW)
    run.device = torch.device("cuda")
    monkeypatch.delattr(trace, "spans")          # a program without it
    assert all(read(n) is None for n in NEW)


@pytest.mark.parametrize("cell,want", [
    ("tiny-serve", {"queue_wait_p95_ms", "graph_warmup_s"}),
    ("tiny-offline", {"graph_warmup_s", "mfu"})])
def test_tiny_traced_line_unchanged(tmp_path, capsys, cell, want):
    """On the CPU the new readers find the program's spans but no card,
    and leave their metrics out of the traced line."""
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]
              if cell in m.get("workloads", [cell])}
    assert {"voc_pad_share", "late_captures"} <= listed
    rc = bench_run.main(["--workload", cell, "--seed", str(2**31 + 5),
                         "--seconds", "1", "--trace", "1"], root=root,
                        device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == want
    assert any(s.name in ("serve.step", "call") for s in trace.spans())
