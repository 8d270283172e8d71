"""CUDA graphs captured inside the window: the program's
``graphs.capture`` spans that began in it (0 where the set-up captured
every bucket the window meets). None off the card, or where no program
span at all began in the window."""


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
    spans = _spans(run)
    if not spans:
        return None
    return float(sum(s.name == "graphs.capture" for s in spans))
