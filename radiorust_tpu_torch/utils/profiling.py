"""Profiling and tracing of the port.

The reference has no tracing subsystem (SURVEY.md §5); its only
observability is out-of-band events on the data path.  The port has:

- :class:`BlockStats` / :class:`StatsRegistry` (``GLOBAL_STATS``) —
  per-block chunk/sample counters with wall-time accounting, kept by the
  runtime's blocks or used manually around compiled steps.
- :class:`SpanRegistry` (``SPANS``, and the module functions
  :func:`span`, :func:`count`, :func:`snapshot`, :func:`reset`,
  :func:`report`, :func:`enable`, :func:`tracing`) — named spans (count,
  total and self time) and counters that the compiled entry
  (``blocks/base.py``) records.  Tracing is on while a ``torch.profiler``
  records or after ``enable(True)``; off, a caller checks
  :func:`tracing` once and opens :func:`no_span`, a shared no-op.  While
  a profiler records, each span is also a range in its trace (a
  ``cpu_op`` of the span's name; a ``user_annotation`` where torch lacks
  the fast form), on the clock of the device's events.
  A device span is a pair of CUDA events, resolved in :func:`snapshot`.
- :func:`device_trace` — context manager around a ``torch.profiler``
  trace of the host and the CUDA device, written as a Chrome trace (view
  in ``chrome://tracing`` or Perfetto).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict

import torch

__all__ = ["BlockStats", "StatsRegistry", "GLOBAL_STATS", "SpanRegistry",
           "SPANS", "tracing", "enable", "span", "no_span", "count",
           "device_start", "device_stop", "snapshot", "reset", "report",
           "device_trace"]


@dataclass
class BlockStats:
    """Counters for one block.  ``host_seconds`` is the host time the
    block itself spent on its chunks (staging, dispatch, fetch), without
    the time it waited for the device or for its peers."""

    name: str
    chunks: int = 0
    samples: int = 0
    events: int = 0
    wall_seconds: float = 0.0
    host_seconds: float = 0.0

    def record_chunk(self, n_samples: int, seconds: float = 0.0):
        self.chunks += 1
        self.samples += n_samples
        self.wall_seconds += seconds

    def record_host(self, seconds: float):
        self.host_seconds += seconds

    def record_event(self):
        self.events += 1

    @property
    def samples_per_second(self) -> float:
        return self.samples / self.wall_seconds if self.wall_seconds else 0.0


class StatsRegistry:
    """Process-wide registry of block stats."""

    def __init__(self):
        self._stats: Dict[str, BlockStats] = {}

    def get(self, name: str) -> BlockStats:
        if name not in self._stats:
            self._stats[name] = BlockStats(name)
        return self._stats[name]

    def unique(self, name: str) -> BlockStats:
        """A fresh entry, suffixing ``#k`` on collision (several blocks of
        the same type in one pipeline).

        Entries persist for post-run reporting; a long-lived serving
        process that churns through short-lived blocks should
        :meth:`drop` entries it is done with (or they accumulate)."""
        candidate, i = name, 1
        while candidate in self._stats:
            i += 1
            candidate = f"{name}#{i}"
        return self.get(candidate)

    def drop(self, stats_or_name) -> None:
        """Release a registry entry created by :meth:`get`/:meth:`unique`
        (existing ``BlockStats`` handles keep working, unregistered)."""
        name = getattr(stats_or_name, "name", stats_or_name)
        self._stats.pop(name, None)

    def report(self) -> str:
        lines = [f"{'block':24s} {'chunks':>8s} {'samples':>12s} "
                 f"{'events':>7s} {'wall_s':>8s} {'Msps':>8s}"]
        for s in self._stats.values():
            lines.append(
                f"{s.name:24s} {s.chunks:8d} {s.samples:12d} "
                f"{s.events:7d} {s.wall_seconds:8.3f} "
                f"{s.samples_per_second / 1e6:8.2f}")
        return "\n".join(lines)


GLOBAL_STATS = StatsRegistry()

_clock = time.perf_counter_ns
_profiler_enabled = torch.autograd._profiler_enabled
# A span's range in a profiler's trace: the fast form (about 1 us a range
# under a profiler, where ``record_function`` takes 11-13) where this torch
# has it.
_range = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.profiler.record_function)


class _NoSpan:
    """The span a site opens with tracing off.  Entering and leaving it is
    ``"".format``, a C function that takes any arguments and returns
    ``""`` (false: an exception goes on): the least a ``with`` can cost,
    about half of ``contextlib.nullcontext``'s."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_NO_SPAN = _NoSpan()
# CUDA event pairs held until a snapshot resolves them.
_MAX_PENDING = 4096


class _Span:
    """One open span: its registry's stack entry while it runs; ``ns``
    its duration once closed."""

    __slots__ = ("reg", "name", "rf", "t0", "child", "ns")

    def __init__(self, reg: "SpanRegistry", name: str):
        self.reg, self.name = reg, name

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = _range(self.name)
            self.rf.__enter__()
        self.child = 0
        self.reg._stack().append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.ns = dur = _clock() - self.t0
        stack = self.reg._stack()
        stack.pop()
        if stack:
            stack[-1].child += dur
        self.reg._add(self.name, dur, dur - self.child)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class SpanRegistry:
    """Spans and counters by name, process-wide and thread-safe.

    A span's self time is its duration less the time its child spans (in
    the same thread) cover.  Times are ``time.perf_counter_ns`` sums; a
    device span is the time between two CUDA events on one stream."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: Dict[str, list] = {}    # name -> [count, total, self]
        self._counters: Dict[str, int] = {}
        self._pending = deque()              # (name, start, end) events

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name: str, total_ns: int, self_ns: int) -> None:
        with self._lock:
            self._tally(name, total_ns, self_ns)

    def _tally(self, name: str, total_ns: int, self_ns: int) -> None:
        s = self._spans.setdefault(name, [0, 0, 0])
        s[0] += 1
        s[1] += total_ns
        s[2] += self_ns

    def tracing(self) -> bool:
        """Whether spans and counters record: ``enable(True)`` was set or
        a ``torch.profiler`` is recording."""
        return self.enabled or _profiler_enabled()

    def span(self, name: str, always: bool = False):
        """A context manager timing ``name`` where :meth:`tracing` (or
        ``always``: the rare, costly events); else a no-op."""
        if always or self.tracing():
            return _Span(self, name)
        return _NO_SPAN

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` (the caller decides whether
        tracing is on)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def device_start(self, device):
        """A started device span on ``device``'s current stream: a
        recorded CUDA event, or None off CUDA."""
        device = torch.device(device)
        if device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def device_stop(self, name: str, start, device) -> None:
        """Close a device span that :meth:`device_start` opened; it is
        resolved, without waiting, in :meth:`snapshot`.  At most
        ``_MAX_PENDING`` spans wait for that; past it the oldest unfinished
        one is dropped."""
        if start is None:
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(torch.device(device)))
        with self._lock:
            if len(self._pending) >= _MAX_PENDING:
                self._resolve()
                if len(self._pending) >= _MAX_PENDING:
                    self._pending.popleft()
            self._pending.append((name, start, end))

    def _resolve(self) -> None:
        """Add the finished device spans, oldest first (the lock held)."""
        while self._pending and self._pending[0][2].query():
            name, start, end = self._pending.popleft()
            ns = int(start.elapsed_time(end) * 1e6)
            self._tally(name, ns, ns)

    def snapshot(self) -> dict:
        """``{"spans": {name: {"count", "total_ns", "self_ns"}},
        "counters": {name: n}}``, the finished device spans included."""
        with self._lock:
            self._resolve()
            return {"spans": {k: {"count": c, "total_ns": t, "self_ns": s}
                              for k, (c, t, s) in self._spans.items()},
                    "counters": dict(self._counters)}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._pending.clear()

    def report(self) -> str:
        snap = self.snapshot()
        lines = [f"{'span':28s} {'count':>8s} {'total_ms':>11s} "
                 f"{'self_ms':>11s} {'mean_us':>10s}"]
        for name, s in sorted(snap["spans"].items(),
                              key=lambda kv: -kv[1]["total_ns"]):
            lines.append(
                f"{name:28s} {s['count']:8d} {s['total_ns'] / 1e6:11.3f} "
                f"{s['self_ns'] / 1e6:11.3f} "
                f"{s['total_ns'] / s['count'] / 1e3:10.2f}")
        lines.append(f"{'counter':28s} {'value':>8s}")
        for name, n in sorted(snap["counters"].items()):
            lines.append(f"{name:28s} {n:8d}")
        return "\n".join(lines)


SPANS = SpanRegistry()


def enable(on: bool = True) -> None:
    """The operator's switch: record spans and counters without a
    profiler (``enable(False)`` leaves them to a profiler alone)."""
    SPANS.enabled = bool(on)


def no_span(name: str):
    """What a span site opens where its caller found tracing off: one
    shared no-op, with no check, clock or profiler range."""
    return _NO_SPAN


tracing = SPANS.tracing
span = SPANS.span
count = SPANS.count
device_start = SPANS.device_start
device_stop = SPANS.device_stop
snapshot = SPANS.snapshot
reset = SPANS.reset
report = SPANS.report


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace host and CUDA activity with ``torch.profiler``; on exit the
    trace is written to ``logdir/trace.json`` (Chrome trace format).
    Yields the profiler, whose ``key_averages()`` sum the kernels."""
    import os

    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
