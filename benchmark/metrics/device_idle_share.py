"""Share of the traced slice (offline: one boundary between two calls,
benchmark/kinds/offline.py; serving: a few steps) in which no kernel ran
on the device (torch.profiler; benchmark/devtrace.py)."""


def read(run):
    p = run.profile
    if not p or not p["window_s"] > 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
