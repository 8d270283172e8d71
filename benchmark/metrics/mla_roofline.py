"""Latent attention's decode kernel: its least time on the chip
(benchmark/roofline.py) over its time by CUDA events (benchmark/
timing.py), in %: one sublayer's absorbed decode attention of the cell's
batch over a bf16 latent cache at the mix's median position, captured in
a graph and replayed alone (``layer_calls``' ``mla``). The bytes are the
valid rows read once, the latent queries in and the outputs out. None
where the architecture times no such layer."""

from benchmark import roofline


def read(run):
    t = run.layer_ms.get("mla")
    if t is None:
        return None
    seconds, _, flops, nbytes = t
    return roofline.share_pct(flops, nbytes, seconds)
