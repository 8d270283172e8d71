"""Median length of the program's ``call.tail_flush`` spans (after a
lock-step call's last chunk: its ragged tails decoded one stream at a
time, read back, and the closing synchronize) over the window's calls.
None off the card or with no such span."""

import statistics


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
    v = [s.ms for s in _spans(run) or () if s.name == "call.tail_flush"]
    return statistics.median(v) if v else None
