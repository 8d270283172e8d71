"""The port's spans and counters, memory telemetry and profiler traces.

One recorder per process keeps what the host loop did, where the work
happens (runtime/serve.py, runtime/pipeline.py, runtime/graphs.py):

- ``span(name, rid=None, **attrs)``, a context manager, records a
  ``Span(name, t0, t1, parent, rid, attrs, sid)``: host times in ns from
  ``time.monotonic_ns()`` (the clock of ``time.monotonic()``), the
  enclosing span's ``sid`` as ``parent`` (the host loop is one thread),
  ``rid`` the request id that all of one request's spans share, and
  small integers or short fixed strings as attributes (``set()`` adds
  some before the span ends).
- ``add(name, t0, t1, rid=None, **attrs)`` records a span whose two ends
  fall in different steps (a request's queue wait), from stamps the
  program keeps anyway.
- ``count(name, n=1)`` adds to a monotonic counter.
- ``spans(t0, t1)`` and ``counters()`` are for readers, ``reset()`` for
  tests.

Spans go into a bounded buffer (``CAPACITY``); the oldest go first and
the ``trace.dropped`` counter says how many went. Granularity is a step,
a chunk, a call, a request or a vocoder wave, never a frame or a kernel.
The recorder is on by default; ``QWEN3_TTS_TRACE=0`` makes ``span``,
``add`` and ``count`` no-ops.

The profiler's clock: while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``), every span also enters a
profiler range named ``"q3/" + name``, so the program's ranges lie in the
profiler's timeline beside the kernels. With no session recording that
costs one flag check (``torch.profiler.record_function`` costs ~11 us a
use even then). The range is a host operation
(``torch._C._profiler._RecordFunctionFast``, category ``cpu_op``), not
``record_function``'s user annotation: the profiler mirrors a user
annotation onto the card's timeline as a device event that spans the
kernels launched inside it, and a reader of the device's busy time
would count those as kernels.

Besides: ``memory_snapshot()`` (host peak RSS, the card's memory) and
``profile_trace``, a ``torch.profiler`` trace of a region when
``QWEN3_TTS_PROFILE=<dir>`` is set (a Chrome trace, viewable in Perfetto
or chrome://tracing), and ``print_report``, the ``Timing:`` report of a
lock-step call.
"""

from __future__ import annotations

import collections
import contextlib
import os
import resource
import sys
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 18          # spans held; the oldest are dropped first
PREFIX = "q3/"              # the profiler ranges' prefix
RANGE = torch._C._profiler._RecordFunctionFast   # a host-only range


class Span(NamedTuple):
    name: str
    t0: int                 # ns, time.monotonic_ns()
    t1: int
    parent: int | None      # the enclosing span's sid
    rid: int | None         # request id
    attrs: dict
    sid: int                # this span's id, unique in the process

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


def enabled() -> bool:
    """QWEN3_TTS_TRACE=0 turns the recorder off."""
    return os.environ.get("QWEN3_TTS_TRACE", "1") != "0"


class _Open:
    """A span being recorded: ``with`` enters it, ``set`` adds
    attributes."""

    __slots__ = ("rec", "name", "rid", "attrs", "sid", "parent", "t0",
                 "range")

    def __init__(self, rec: "Recorder", name: str, rid, attrs: dict):
        self.rec, self.name, self.rid, self.attrs = rec, name, rid, attrs
        self.range = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Open":
        rec = self.rec
        self.sid = rec._next_sid
        rec._next_sid += 1
        self.parent = rec._stack[-1] if rec._stack else None
        rec._stack.append(self.sid)
        if torch.autograd._profiler_enabled():
            self.range = RANGE(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic_ns()
        rec = self.rec
        if self.range is not None:
            self.range.__exit__(*exc)
        if rec._stack:              # empty after a reset() inside the span
            rec._stack.pop()
        rec._push(Span(self.name, self.t0, t1, self.parent, self.rid,
                       self.attrs, self.sid))


class _Off:
    """The span of a recorder that is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


class Recorder:
    """Spans in a bounded buffer and monotonic counters (module
    docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.reset()

    def reset(self) -> None:
        self._spans: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._counters: dict[str, int] = {}
        self._stack: list[int] = []
        self._next_sid = 0

    def _push(self, s: Span) -> None:
        if len(self._spans) == self.capacity:
            self._counters["trace.dropped"] = (
                self._counters.get("trace.dropped", 0) + 1)
        self._spans.append(s)

    def span(self, name: str, rid: int | None = None, **attrs):
        if not enabled():
            return _OFF
        return _Open(self, name, rid, attrs)

    def add(self, name: str, t0: int, t1: int, rid: int | None = None,
            **attrs) -> None:
        if not enabled():
            return
        sid = self._next_sid
        self._next_sid += 1
        self._push(Span(name, t0, t1, self._stack[-1] if self._stack
                        else None, rid, attrs, sid))

    def count(self, name: str, n: int = 1) -> None:
        if enabled():
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self, t0: int | None = None, t1: int | None = None) -> list:
        """The spans held that began in [t0, t1) (ns; None: open), in the
        order they ended."""
        return [s for s in self._spans
                if (t0 is None or s.t0 >= t0) and (t1 is None or s.t0 < t1)]

    def counters(self) -> dict[str, int]:
        return dict(self._counters)


RECORDER = Recorder()               # the process's recorder
span = RECORDER.span
add = RECORDER.add
count = RECORDER.count
spans = RECORDER.spans
counters = RECORDER.counters
reset = RECORDER.reset


def print_report(stages: dict[str, float], total_ms: float,
                 audio_seconds: float = 0.0, file=None) -> None:
    """``Timing:`` with each stage's ms (stages may nest: they need not
    add up to the total), the total, and the real-time factor."""
    file = file or sys.stderr
    print("\nTiming:", file=file)
    for name, ms in stages.items():
        print(f"  {name + ':':<17}{ms:8.0f} ms", file=file)
    print(f"  {'Total:':<17}{total_ms:8.0f} ms", file=file)
    if audio_seconds > 0 and total_ms > 0:
        wall = total_ms / 1e3
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


@contextlib.contextmanager
def profile_trace(label: str = "qwen3-tts", trace_dir: str | None = None):
    """A torch.profiler trace (host ops, the recorder's ``q3/`` ranges,
    and the card's kernels where there is one) of the region, written as
    a Chrome trace under `trace_dir`, or QWEN3_TTS_PROFILE when None.
    No-op when neither is set."""
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
