"""Seconds of the set-up's warm-up (host clock, ending in a
synchronize): ``ContinuousBatcher.warmup``, or the first
``synthesize_batch`` of the cell's shape and the vocoder's buckets."""

import math


def read(run):
    return None if math.isnan(run.graph_warmup_s) else run.graph_warmup_s
