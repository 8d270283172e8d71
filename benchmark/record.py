"""What a run observed, which the metric readers and the check read:
per request its schedule, its audio callbacks (host time, samples, the
codes that became them) and its result; per run the window, the set-up,
the trace slice and the layer timings."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Stream:
    """One request as its caller saw it."""
    req: object                     # traffic.Request
    due: float                      # host monotonic time it was due
    in_window: bool
    submitted: float = math.nan     # host time of submit (serving)
    events: list = field(default_factory=list)     # (time, samples)
    chunks: list = field(default_factory=list)     # (codes [40, 16], pcm)
    finished: bool = False
    success: bool = False
    n_frames: int = 0
    error: str = ""
    t_queue_ms: float = math.nan

    def on_audio(self, tap, samples, t: float | None = None) -> None:
        """An audio callback with `samples` (host f32): stamped, and paired
        with the codes that the tap says became them."""
        if len(samples) == 0:
            return
        self.events.append((time.monotonic() if t is None else t,
                            len(samples)))
        self.chunks.append((tap.take(), samples))

    def finish(self, result) -> None:
        self.finished = True
        self.success = bool(result.success)
        self.n_frames = int(result.n_frames)
        self.error = result.error_msg
        self.t_queue_ms = float(result.t_queue_ms)

    @property
    def ok(self) -> bool:
        return self.finished and self.success and bool(self.events)

    def ttfa_ms(self) -> float:
        """From due to the first audio; infinite for a failed request."""
        if not self.ok:
            return math.inf
        return (self.events[0][0] - self.due) * 1e3

    def gaps_ms(self) -> list:
        t = [e[0] for e in self.events]
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

    def codes(self, samples_per_frame: int) -> np.ndarray | None:
        """The served frames [F, 16] in order, or None where the tap lost
        a chunk."""
        parts = []
        for codes, pcm in self.chunks:
            if codes is None:
                return None
            parts.append(codes[:len(pcm) // samples_per_frame])
        return np.concatenate(parts) if parts else None


@dataclass
class Run:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                       # process start (host monotonic)
    t_window0: float = math.nan
    t_window1: float = math.nan
    graph_warmup_s: float = math.nan
    streams: list = field(default_factory=list)
    profile: dict | None = None
    layer_ms: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0

    @property
    def setup_s(self) -> float:
        return self.t_window0 - self.t0

    @property
    def window_s(self) -> float:
        return self.t_window1 - self.t_window0

    def window_streams(self) -> list:
        return [s for s in self.streams if s.in_window]

    def audio_in_window_s(self, sample_rate: int) -> float:
        """Audio delivered to callers inside the window, in seconds."""
        n = sum(k for s in self.streams for t, k in s.events
                if self.t_window0 <= t <= self.t_window1)
        return n / sample_rate


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it (an infinite value, a failed
    request, stays infinite)."""
    v = sorted(values)
    if not v:
        return math.nan
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
