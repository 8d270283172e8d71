"""p95 of the program's ``TTSResult.t_queue_ms`` (submit to admission)
over the requests due in the window that it served."""

from benchmark.record import p95


def read(run):
    v = [s.t_queue_ms for s in run.window_streams() if s.ok]
    return p95(v) if v else None
