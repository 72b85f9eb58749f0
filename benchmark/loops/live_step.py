"""The ``live_step`` loop (the ``live`` mix): one chunk at a time, copied
in from pinned host memory without blocking, one ``jit_step`` replay,
its outputs copied to pinned host buffers, and the host waits for them
before the next chunk.  Closed loop, one caller, no pipelining."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness.window import Sync, Window, span, sync


class Loop:
    def __init__(self, prog, xs, traffic: dict, wrap=None):
        self.prog = prog
        self.ring = xs.shape[0]
        self.pin = prog.device.type == "cuda"
        host = xs.cpu()
        self.host = host.pin_memory() if self.pin else host
        self.x = torch.empty_like(xs[0])
        step = prog.jit_step()
        self.step = step if wrap is None else wrap(step, prog, xs)
        self.state = prog.state0
        self.g = 0           # chunks enqueued since the start
        self.out = None

    def call(self):
        """One chunk: (enqueue start, enqueue end, outputs in host memory)."""
        t_a = time.perf_counter()
        self.x.copy_(self.host[self.g % self.ring], non_blocking=True)
        self.state, y = self.step(self.prog.params, self.state,
                                  self.prog.feed(self.x))
        y = self.prog.named(y)
        if self.out is None:
            self.out = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=self.pin)
                        for k, v in y.items()}
        for k, v in y.items():
            self.out[k].copy_(v, non_blocking=True)
        done = Sync(self.prog.device).record()
        t_b = time.perf_counter()
        done.wait()
        self.g += 1
        return t_a, t_b, time.perf_counter()

    def warm(self, n: int) -> float:
        for _ in range(n):
            t_a, _, t_c = self.call()
        return t_c - t_a

    def _kept(self):
        return ([(self.g - 1) % self.ring],
                {k: v.clone()[None] for k, v in self.out.items()})

    def window(self, seconds: float, keep=(), spans=False) -> Window:
        sync(self.prog.device)
        lat, enqueue, kept = [], [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with span(spans, "bench.chunk"):
                t_a, t_b, t_c = self.call()
            lat.append(t_c - t_a)
            enqueue.append(t_b - t_a)
            if len(lat) - 1 in keep:
                kept.append(self._kept())
        seconds = time.perf_counter() - t0
        if lat and len(lat) - 1 not in keep:
            kept.append(self._kept())
        b, n = self.host.shape[1:]
        return Window(len(lat), len(lat), len(lat) * b * n, seconds, kept,
                      np.asarray(lat), np.asarray(enqueue))
