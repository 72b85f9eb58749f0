"""The ``ring_scan`` loop (the ``fleet`` mix): one ``make_scan`` graph
over the whole ring of chunks, replayed back to back with the state
carried; up to the mix's ``in_flight`` replays are queued ahead so the
host never starves the card.  Closed loop, one caller."""

from __future__ import annotations

import time
from collections import deque

from benchmark.harness.window import Sync, Window, span, sync


class Loop:
    def __init__(self, prog, xs, traffic: dict, wrap=None):
        self.prog, self.xs = prog, xs
        self.ring = xs.shape[0]
        self.inp = prog.feed(xs)
        run = prog.make_scan()
        self.run = run if wrap is None else wrap(run, prog, xs)
        self.state = prog.state0
        self.depth = int(traffic["in_flight"])

    def call(self):
        self.state, ys = self.run(self.prog.params, self.state, self.inp)
        return ys

    def warm(self, n: int) -> float:
        """``n`` calls (the first captures); seconds of the last."""
        for _ in range(n):
            t0 = time.perf_counter()
            self.call()
            sync(self.prog.device)
        return time.perf_counter() - t0

    def window(self, seconds: float, keep=(), spans=False) -> Window:
        dev = self.prog.device
        sync(dev)
        queued, kept = deque(), []
        i, last = 0, None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if len(queued) >= self.depth:
                with span(spans, "bench.wait"):
                    queued.popleft().wait()
            with span(spans, "bench.enqueue"):
                ys = self.call()
            queued.append(Sync(dev).record())
            if i in keep:
                kept.append((list(range(self.ring)), self.prog.named(ys)))
            last, i = ys, i + 1
        with span(spans, "bench.drain"):
            sync(dev)
        seconds = time.perf_counter() - t0
        if last is not None and (i - 1) not in keep:
            kept.append((list(range(self.ring)), self.prog.named(last)))
        b, n = self.xs.shape[1:]
        return Window(i, i * self.ring, i * self.ring * b * n, seconds, kept)
