"""The traced run's device trace: ``torch.profiler`` over one slice of
traffic after the window (offline: one boundary between two calls;
serving: ``trace_slice_steps`` batcher steps of the mix, about a chunk),
opened and closed by the traffic kind's loop between two steps. From it: the
device's busy time (the union of kernel intervals) over the span from the
first kernel launched in the slice to the last one's end, the kernels that
took most time, and the longest idle gaps with the host operation that
spanned each (the arithmetic of chip_smoke.py's ``profile_pipelined``).
The slice's CUDA-event time goes to stderr beside it."""

from __future__ import annotations

import sys
import time

import torch
from torch.autograd.profiler_util import _filter_name


def events(prof) -> list:
    """(device type, name, start us, end us) of the events that
    ``prof.events()`` lists, at its times (microseconds from the trace's
    start) and in its order, read from the profiler's kineto results
    without building its ``FunctionEvent`` tree: that takes ~3 minutes over
    a 1.7B slice's ~660,000 kernels, this ~6 seconds. A host event that the
    tree folds into a parent of the same name stays in the list."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    out = [(e.device_type(), e.name(), (e.start_ns() - t0) / 1000,
            (e.end_ns() - t0) / 1000)
           for e in res.events()
           if not _filter_name(e.name())
           and not getattr(e, "is_hidden_event", lambda: False)()]
    out.sort(key=lambda e: (e[2], -e[3]))
    return out


def kernel_events(evs) -> list:
    """(name, start us, end us) of every kernel the profiler saw."""
    return [(name, s, e) for dev, name, s, e in evs
            if dev == torch.autograd.DeviceType.CUDA
            and "memcpy" not in name.lower()
            and "memset" not in name.lower()]


def host_ops(evs) -> list:
    return [(name, s, e) for dev, name, s, e in evs
            if dev == torch.autograd.DeviceType.CPU]


def merged(events) -> list:
    """The union of (name, start, end) intervals as sorted [start, end]."""
    out: list = []
    for _, start, end in sorted(events, key=lambda e: e[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def idle_gaps(kernels, host, n: int) -> list:
    """The n longest gaps between busy intervals, longest first, as
    (host operation that spanned the gap, gap us): the innermost host
    event covering at least half of the gap, else the one covering most
    of it."""
    busy = merged(kernels)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:n]
    out = []
    for us, g0, g1 in gaps:
        cover = [(min(g1, e) - max(g0, s), e - s, name)
                 for name, s, e in host if s < g1 and e > g0]
        inner = [c for c in cover if c[0] >= us / 2]
        best = (min(inner, key=lambda c: c[1]) if inner
                else max(cover, default=(0.0, 0.0, "(no host event)")))
        out.append((best[2], us))
    return out


def summarize(kernels, host, n: int = 10) -> dict | None:
    """busy_s, window_s and the breakdown of one slice's events; None
    when the slice holds no kernel."""
    if not kernels:
        return None
    busy = sum(e - s for s, e in merged(kernels)) / 1e6
    span = (max(e for _, _, e in kernels) - min(s for _, s, _ in kernels)) / 1e6
    by: dict = {}
    for name, s, e in kernels:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    gaps = [(name, us / 1e6) for name, us in idle_gaps(kernels, host, n)]
    return {"busy_s": busy, "window_s": span, "kernels": len(kernels),
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


class Slice:
    """Opens the profiler at the first tick (a step or a wave of audio, as
    the traffic kind's loop calls it) at or after `start_at` (host monotonic seconds)
    and closes it `steps` ticks later, so that every run's slice holds the
    same steps whatever the profiler's own start-up took; ``finish()``
    closes it if the loop stopped first. A slice that is off never
    opens."""

    def __init__(self, device, start_at: float, steps: int, on: bool):
        self.device, self.start_at, self.steps = device, start_at, steps
        self.on = on and device.type == "cuda"
        self.prof = None
        self.t_open = self.t_close = None
        self._ticks = 0

    def tick(self, now: float | None = None) -> None:
        if not self.on or self.t_close is not None:
            return
        now = time.monotonic() if now is None else now
        if self.prof is not None:
            self._ticks += 1
        if self.prof is None and now >= self.start_at:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self._ev0.record()
            self.t_open = time.monotonic()
        elif self.prof is not None and self._ticks >= self.steps:
            self._close()

    def _close(self) -> None:
        """Every kernel launched inside the slice ends before the
        profiler stops, so that its trace holds them all."""
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        torch.cuda.synchronize(self.device)
        self.t_close = time.monotonic()
        self.prof.stop()
        self.event_s = self._ev0.elapsed_time(ev1) / 1e3

    def finish(self) -> dict | None:
        """Close the slice if open; then read it (outside the window)."""
        if self.prof is not None and self.t_close is None:
            self._close()
        if self.prof is None:
            return None
        ev = events(self.prof)
        r = summarize(kernel_events(ev), host_ops(ev))
        if r is not None:
            print(f"trace slice: host {self.t_close - self.t_open:.4f} s, "
                  f"CUDA events {self.event_s:.4f} s, first kernel to last "
                  f"{r['window_s']:.4f} s, busy {r['busy_s']:.4f} s "
                  f"({r['kernels']} kernels)", file=sys.stderr, flush=True)
        return r
