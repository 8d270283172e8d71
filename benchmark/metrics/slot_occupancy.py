"""Mean share of the batcher's slots busy at a step's dispatch, in %,
over the program's ``serve.step`` spans (attributes ``busy``, ``slots``)
that began in the window. None off the card or with no such span."""


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
    steps = [s for s in _spans(run) or () if s.name == "serve.step"]
    if not steps:
        return None
    return 100.0 * sum(s.attrs["busy"] / s.attrs["slots"]
                       for s in steps) / len(steps)
