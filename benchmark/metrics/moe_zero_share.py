"""Share of the routed (token, expert) pairs that went to identity
("zero-compute") experts, in %: 100 x sum of ``zero`` / sum of (``pairs``
+ ``zero`` + ``remote``) over the program's ``talker.moe`` spans (one a
generation chunk: the pairs computed by the experts held here, those
routed to identity experts, and those routed to real experts held on
other chips) that began in the window. None off the card, on a program
without the span or without its ``zero`` count, or with no such span."""

from pathlib import Path

from benchmark.spec import load_file_module

_spans = load_file_module(Path(__file__).with_name("voc_pad_share.py"),
                          "benchmark_metric_voc_pad_share")._spans


def read(run):
    moe = [s.attrs for s in _spans(run) or ()
           if s.name == "talker.moe" and "zero" in s.attrs]
    total = sum(a["pairs"] + a["zero"] + a["remote"] for a in moe)
    if not total:
        return None
    return 100.0 * sum(a["zero"] for a in moe) / total
