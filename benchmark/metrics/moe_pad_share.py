"""Share of the grouped-expert product's rows that are padding, in %:
100 x (sum of ``rows`` - sum of ``pairs``) / sum of ``rows`` over the
program's ``talker.moe`` spans (one a generation chunk: the (token,
expert) pairs routed and the rows computed, each expert's rows padded to
the product's 16-row tiles) that began in the window. None off the card,
on a program without the span, or with no such span."""

from pathlib import Path

from benchmark.spec import load_file_module

_spans = load_file_module(Path(__file__).with_name("voc_pad_share.py"),
                          "benchmark_metric_voc_pad_share")._spans


def read(run):
    moe = [s.attrs for s in _spans(run) or () if s.name == "talker.moe"]
    rows = sum(a["rows"] for a in moe)
    if not rows:
        return None
    return 100.0 * (rows - sum(a["pairs"] for a in moe)) / rows
