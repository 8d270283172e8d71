"""Share of the vocoder's decode rows that are padding, in %: 100 x the
sum of (bucket - rows) over the sum of bucket, over the program's decode
spans (``serve.decode`` a serving wave, ``call.decode`` a lock-step wave
or tail decode) that began in the window. None off the card or with no
such span."""

DECODES = ("serve.decode", "call.decode")


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
    waves = [s.attrs for s in _spans(run) or () if s.name in DECODES]
    total = sum(a["bucket"] for a in waves)
    if not total:
        return None
    return 100.0 * sum(a["bucket"] - a["rows"] for a in waves) / total
