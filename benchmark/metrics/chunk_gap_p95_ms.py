"""p95 over every gap between successive audio callbacks of one stream,
for the streams due in the window, gaps that end after it included
(host clock). Real time per stream holds while it stays under one chunk
of audio (3,200 ms)."""

from benchmark.record import p95


def read(run):
    v = [g for s in run.window_streams() for g in s.gaps_ms()]
    return p95(v) if v else None
