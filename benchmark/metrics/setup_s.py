"""Seconds from process start to the window's start (host clock): CUDA
start-up, weights made from the seed, the kernel library, graph capture
of the cell's buckets and, when serving, the lead-in."""


def read(run):
    return run.setup_s
