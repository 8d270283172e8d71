"""p95 over the requests due in the window of the time from when each was
due to its first audio (host clock); a failed request or one that never
came is infinite, a miss of any limit."""

from benchmark.record import p95


def read(run):
    v = [s.ttfa_ms() for s in run.window_streams()]
    return p95(v) if v else None
