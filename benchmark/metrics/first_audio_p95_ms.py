"""p95 by nearest rank of the program's ``req.first_audio`` spans (a
request's admission to its first ``on_audio`` call with samples) over the
requests whose ``req.queue`` span (submit to admission) began in the
window. TTFA is the loop's lateness, the queue wait and this. None off
the card or with no such span."""

from benchmark.record import p95


def _spans(run, to_end=False):
    """The program's spans (qwen3_tts_tpu_torch/utils/trace.py, on the
    host clock of the window) that began in the window, or from its start
    on with to_end; None off the card or where the program keeps none."""
    if getattr(run.device, "type", None) != "cuda":
        return None
    try:
        from qwen3_tts_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = getattr(trace, "spans", None)
    if spans is None:
        return None
    return spans(int(run.t_window0 * 1e9),
                 None if to_end else int(run.t_window1 * 1e9))


def read(run):
    spans = _spans(run, to_end=True)
    if not spans:
        return None
    t1 = int(run.t_window1 * 1e9)
    rids = {s.rid for s in spans if s.name == "req.queue" and s.t0 < t1}
    v = [s.ms for s in spans if s.name == "req.first_audio" and s.rid in rids]
    return p95(v) if v else None
