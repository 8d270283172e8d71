"""The metric arithmetic on a made-up run: p95 over all requests with a
failure as a miss, gaps that end in the drain, the rate over the
window."""

import math
from types import SimpleNamespace

import pytest

from benchmark import record, spec
from benchmark.tests.tiny import make_root


class _Res:
    def __init__(self, ok=True, frames=40, queue=5.0):
        self.success, self.n_frames = ok, frames
        self.error_msg, self.t_queue_ms = "" if ok else "failed", queue


class _Tap:
    def take(self):
        return None


def _run(tmp_path):
    cell = spec.load_cell("tiny-serve", make_root(tmp_path))
    run = record.Run(cell, 1, 10.0, False, None, 0.0)
    run.t_window0, run.t_window1 = 100.0, 110.0
    for i in range(20):
        s = record.Stream(SimpleNamespace(rid=i, tokens=[1] * 20),
                          due=100.0 + i * 0.5, in_window=True)
        # first audio 1 s after due (request 19: 3 s); chunks 2 s apart
        t1 = s.due + (3.0 if i == 19 else 1.0)
        for k in range(3):
            s.on_audio(_Tap(), [0.0] * 64 * 40, t=t1 + 2.0 * k)
        s.finish(_Res(queue=float(i)))
        run.streams.append(s)
    late = record.Stream(SimpleNamespace(rid=99, tokens=[1] * 20), 99.0,
                         False)
    late.on_audio(_Tap(), [0.0] * 64 * 40, t=100.5)
    late.finish(_Res())
    run.streams.append(late)
    return cell, run


def test_p95_nearest_rank():
    assert record.p95(range(1, 101)) == 95
    assert record.p95([1.0] * 19 + [math.inf]) == 1.0
    assert record.p95([1.0] * 18 + [math.inf] * 2) == math.inf
    assert math.isnan(record.p95([]))


def test_ttfa_gaps_rate_queue(tmp_path):
    cell, run = _run(tmp_path)
    read = lambda n: spec.reader(cell, n)(run)            # noqa: E731
    assert read("ttfa_p95_ms") == pytest.approx(1000.0)
    run.streams[19].events[0] = (run.streams[19].due + 9.0, 2560)
    assert read("ttfa_p95_ms") == pytest.approx(1000.0)   # 1 of 20 beyond
    run.streams[18].finish(_Res(ok=False))                # a failure: a miss
    assert read("ttfa_p95_ms") == pytest.approx(9000.0)   # 19th of 20
    run.streams[17].finished = False                      # never came
    assert read("ttfa_p95_ms") == math.inf
    # gaps: 2 s apart, those that end after the window (drain) included
    assert read("chunk_gap_p95_ms") == pytest.approx(2000.0)
    # audio delivered inside [100, 110]: 40 frames of 64 samples a call
    n_in = sum(1 for s in run.streams for t, _ in s.events
               if 100.0 <= t <= 110.0)
    assert read("audio_s_per_s") == pytest.approx(
        n_in * 64 * 40 / 24000 / 10.0)
    assert read("queue_wait_p95_ms") == pytest.approx(19.0)  # 18 served ok
    assert read("setup_s") == pytest.approx(100.0)


def test_idle_share_and_missing(tmp_path):
    cell, run = _run(tmp_path)
    read = lambda n: spec.reader(cell, n)(run)            # noqa: E731
    assert read("device_idle_share.serve") is None        # nothing traced
    run.profile = {"busy_s": 0.9, "window_s": 1.2}
    assert read("device_idle_share.serve") == pytest.approx(25.0)
    assert read("talker_roofline") is None                # nothing timed
    assert read("graph_warmup_s") is None


def test_trace_events_are_the_profilers():
    """devtrace.events reads what prof.events() lists, at the same times
    and in the same order; it keeps a child that the profiler's tree
    folds into a same-named parent (the inner aten::sum here)."""
    import torch

    from benchmark import devtrace
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    x = torch.randn(64, 64)
    (x @ x).sum()
    prof.stop()
    got = devtrace.events(prof)
    want = [(e.device_type, e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]
    extra = list(got)
    for e in want:
        extra.remove(e)
    assert [e for e in got if e not in extra] == want
    for _, name, s, e in extra:
        assert any(n == name and a <= s and e <= b and (a, b) != (s, e)
                   for _, n, a, b in want)
    assert devtrace.host_ops(got)[0][0] == "aten::randn"
