"""What every loop shares: the window's record and the waits.

A loop is ``benchmark/loops/<loop>.py``, named by a traffic mix's
``loop`` key and found by that name (``harness/cells.py``).  Its class
``Loop(prog, xs, traffic, wrap)`` drives the program's entry: ``warm(n)``
makes ``n`` calls and returns the seconds of the last, and ``window(
seconds, keep=(), spans=False)`` runs until its host clock passes
``seconds`` and then drains, so the window holds all the work it
enqueued and all its time; it keeps the outputs of the calls the
comparison asks for (``keep``, indices of the window's calls, and the
last) and returns a :class:`Window`.  ``wrap(entry, prog, xs)``, where
given, replaces the compiled entry (the control and the planted faults).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch


class Sync:
    """An event to wait on: a CUDA event on the card, nothing on the CPU
    (eager steps there have finished when they return)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ev = torch.cuda.Event() if self.cuda else None

    def record(self):
        if self.cuda:
            self.ev.record()
        return self

    def wait(self):
        if self.cuda:
            self.ev.synchronize()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(on: bool, name: str):
    """A profiler span named ``name`` where ``on`` (the traced window)."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@dataclass
class Window:
    calls: int
    steps: int          # chunk steps
    samples: int        # complex input samples consumed, all streams
    seconds: float
    kept: list = field(default_factory=list)   # [(ring positions, {out: [k, B, n]})]
    latency_s: np.ndarray = None                # per chunk (live)
    enqueue_s: np.ndarray = None                # per chunk (live)
