"""Profiling and tracing.

The reference has no tracing subsystem (SURVEY.md §5); its only
observability is out-of-band events on the data path.  The port keeps the
JAX package's:

- :class:`BlockStats` — per-block chunk/sample counters with wall-time
  accounting, attachable to runtime blocks or used manually around
  compiled steps.
- :func:`device_trace` — context manager around a ``torch.profiler``
  trace of the host and the CUDA device, written as a Chrome trace (view
  in ``chrome://tracing`` or Perfetto).
- :func:`timed` — lightweight section timer accumulating into a registry
  that :func:`report` renders.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict

import torch

__all__ = ["BlockStats", "StatsRegistry", "device_trace", "timed", "report"]


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

_sections = defaultdict(float)
_counts = defaultdict(int)


@contextlib.contextmanager
def timed(name: str):
    """Accumulate wall time for a named section."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sections[name] += time.perf_counter() - t0
        _counts[name] += 1


def report() -> str:
    """Render accumulated section timings."""
    lines = [f"{'section':32s} {'calls':>8s} {'total_s':>10s} {'avg_ms':>10s}"]
    for name, total in sorted(_sections.items(), key=lambda kv: -kv[1]):
        n = _counts[name]
        lines.append(f"{name:32s} {n:8d} {total:10.4f} "
                     f"{total / n * 1e3:10.3f}")
    return "\n".join(lines)


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
