"""Signal and event types of the streaming runtime (port of the JAX
package's ``signal.py``; host-side asyncio and numpy, no torch).

A stream message is either a chunk of samples tagged with its sample
rate, or an out-of-band event that rides the same channel through every
block.  Events may mark a continuity break (``is_interrupt``: stateful
blocks reset) or request a flush.  On the compiled path events become
reset masks (see ``blocks/base.py``).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Callable, List

import numpy as np

__all__ = [
    "Samples", "Event", "Disconnection", "SamplesLost", "BufferOverflow",
    "Warmup", "EventHandlers", "EventHandlerGuard", "EventHandling",
    "is_event", "duration_of",
]


class Event:
    """Base event type."""

    @property
    def is_interrupt(self) -> bool:
        """Samples before/after this event are not seamlessly connected."""
        return False

    @property
    def is_flush(self) -> bool:
        return False

    def __repr__(self):
        return type(self).__name__


class Disconnection(Event):
    """A connected block was disconnected."""

    @property
    def is_interrupt(self) -> bool:
        return True


class Warmup(Event):
    """The next ``steps`` output chunks contain zero-primed history: the
    fixed-shape compiled path emits every step, so this event warns bulk
    consumers (e.g. metering) not to trust the first ``steps`` chunks
    after a (re)start."""

    def __init__(self, steps: int):
        self.steps = int(steps)

    def __repr__(self):
        return f"Warmup({self.steps})"


class SamplesLost(Event):
    """Samples were dropped."""

    @property
    def is_interrupt(self) -> bool:
        return True


class BufferOverflow(Event):
    """A buffer discarded stale data."""

    @property
    def is_interrupt(self) -> bool:
        return True


@dataclass
class Samples:
    """A chunk of samples with its sample rate.

    ``chunk`` is a 1-D array (numpy on the host, a tensor on the device),
    or a 2-D ``[streams, n]`` array: one chunk step of many independent
    streams.
    """

    sample_rate: float
    chunk: Any

    @property
    def duration(self) -> float:
        return np.shape(self.chunk)[-1] / self.sample_rate


def is_event(msg) -> bool:
    return isinstance(msg, Event)


def duration_of(msg) -> float:
    return msg.duration if isinstance(msg, Samples) else 0.0


class EventHandlerGuard:
    """Unregisters an event handler when closed."""

    def __init__(self, handlers: "EventHandlers", ident: int):
        self._handlers = handlers
        self._ident = ident
        self._auto = True

    def unregister(self):
        self._handlers._remove(self._ident)
        self._auto = False

    def forget(self):
        self._auto = False

    def __del__(self):
        if self._auto:
            try:
                self._handlers._remove(self._ident)
            except Exception:
                # A finalizer must not raise (e.g. during interpreter
                # shutdown, when the registry may already be gone).
                pass


class EventHandlers:
    """Synchronized callback registry."""

    def __init__(self):
        self._callbacks: List = []
        self._next_id = 0

    def register(self, func: Callable[[Event], None]) -> EventHandlerGuard:
        ident = self._next_id
        self._next_id += 1
        self._callbacks.append((ident, func))
        return EventHandlerGuard(self, ident)

    def _remove(self, ident: int):
        self._callbacks = [(i, f) for i, f in self._callbacks if i != ident]

    def invoke(self, event: Event):
        for _, func in list(self._callbacks):
            func(event)


class EventHandling:
    """Mixin for blocks exposing event observation."""

    event_handlers: EventHandlers

    def on_event(self, func: Callable[[Event], None]) -> EventHandlerGuard:
        return self.event_handlers.register(func)

    async def wait_for_event(self, predicate: Callable[[Event], bool]):
        fut = asyncio.get_running_loop().create_future()

        def cb(event):
            if not fut.done() and predicate(event):
                fut.set_result(None)

        guard = self.on_event(cb)
        try:
            await fut
        finally:
            guard.unregister()
