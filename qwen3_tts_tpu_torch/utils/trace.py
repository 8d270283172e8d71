"""Stage timing, memory telemetry and profiler traces (port of
qwen3_tts_tpu/utils/trace.py).

Monotonic per-stage wall times printed with the real-time factor, ``[mem]``
snapshots of the host's peak RSS and the card's allocated memory, and a
``torch.profiler`` trace of a region when ``QWEN3_TTS_PROFILE=<dir>`` is
set (a Chrome trace, viewable in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import resource
import sys
import time
from dataclasses import dataclass, field

import torch


def _now_ms() -> float:
    return time.monotonic() * 1e3


@dataclass
class StageTimer:
    """Accumulates per-stage wall-clock ms; prints a timing report."""
    stages: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = _now_ms()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (_now_ms() - t0)

    def add(self, name: str, ms: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + ms

    def report(self, audio_seconds: float = 0.0, file=None) -> None:
        file = file or sys.stderr
        total = sum(self.stages.values())
        print("\nTiming:", file=file)
        for name, ms in self.stages.items():
            print(f"  {name + ':':<17}{ms:8.0f} ms", file=file)
        print(f"  {'Total:':<17}{total:8.0f} ms", file=file)
        if audio_seconds > 0 and total > 0:
            wall = total / 1e3
            print(f"  Audio duration:  {audio_seconds:.2f} s", file=file)
            print(f"  Throughput:      {audio_seconds / wall:.2f}x realtime "
                  f"(RTF={wall / audio_seconds:.3f})", file=file)
        file.flush()


def memory_snapshot() -> dict[str, int]:
    """Host peak RSS, and the current card's memory: allocated now, the
    peak since the last reset and the card's total (zeros without a
    card)."""
    # ru_maxrss is KB on Linux but bytes on macOS
    rss_scale = 1 if sys.platform == "darwin" else 1024
    out = {"rss_peak_bytes":
           resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * rss_scale,
           "device_bytes_in_use": 0, "device_bytes_peak": 0,
           "device_bytes_limit": 0}
    if torch.cuda.is_available():
        stats = torch.cuda.memory_stats()
        out["device_bytes_in_use"] = int(
            stats.get("allocated_bytes.all.current", 0))
        out["device_bytes_peak"] = int(stats.get("allocated_bytes.all.peak", 0))
        out["device_bytes_limit"] = int(
            torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory)
    return out


def log_memory(label: str, file=None) -> None:
    """`[mem] label rss=… device=…`."""
    file = file or sys.stderr
    m = memory_snapshot()

    def fmt(n):
        for unit in ("B", "KB", "MB", "GB", "TB"):
            if n < 1024 or unit == "TB":
                return f"{n:.2f} {unit}"
            n /= 1024
    print(f"  [mem] {label:<24} rss={fmt(m['rss_peak_bytes'])}  "
          f"device={fmt(m['device_bytes_in_use'])}", file=file, flush=True)


@contextlib.contextmanager
def profile_trace(label: str = "qwen3-tts", trace_dir: str | None = None):
    """A torch.profiler trace (host ops, and the card's kernels where there
    is one) of the region, written as a Chrome trace under `trace_dir`, or
    QWEN3_TTS_PROFILE when None. No-op when neither is set."""
    trace_dir = trace_dir or os.environ.get("QWEN3_TTS_PROFILE")
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(label):
            yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{label}.{os.getpid()}.{time.time_ns()}.json"))
