"""The MoE FFN's least time on the chip (benchmark/roofline.py) over its
time by CUDA events (benchmark/timing.py), in %: one layer's router,
grouped experts and gated shared expert at the cell's batch, captured in
a graph and replayed alone (``layer_calls``' ``moe``). The bytes are the
weights of the experts its rows route to, read once; the operations
those of the active parameters. None where the architecture times no
such layer."""

from benchmark import roofline


def read(run):
    t = run.layer_ms.get("moe")
    if t is None:
        return None
    seconds, _, flops, nbytes = t
    return roofline.share_pct(flops, nbytes, seconds)
