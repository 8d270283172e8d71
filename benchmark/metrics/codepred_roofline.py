"""The codepred layer's least time on the chip (benchmark/roofline.py) over
its time by CUDA events (benchmark/timing.py), in %."""

from benchmark import roofline


def read(run):
    t = run.layer_ms.get("codepred")
    if t is None:
        return None
    seconds, _, flops, nbytes = t
    return roofline.share_pct(flops, nbytes, seconds)
