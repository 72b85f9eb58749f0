"""Flow layer: capacity-1 broadcast channels with backpressure, and
dynamically rewireable connectors.

Asyncio reimplementation of the reference's ``src/sync/broadcast_bp.rs``
and ``src/flow.rs`` semantics:

- A :class:`Sender` delivers each value to *every* current receiver before
  the next send proceeds (lock-step fan-out with backpressure,
  ``src/sync/broadcast_bp.rs:230-248,284-331``).
- :class:`ReceiverConnector` / :class:`SenderConnector` allow live
  (re)wiring; a receiver whose connector is rewired mid-stream synthesizes
  a :class:`Disconnection` interrupt event into the stream
  (``src/flow.rs:176-225``).
- Channel teardown (all senders or all receivers gone) surfaces as
  :class:`ChannelClosed`, the analog of ``RecvError``/``SendError``.
"""

from __future__ import annotations

import asyncio
from typing import Any, Generic, List, Optional, TypeVar

from ..signal import Disconnection

T = TypeVar("T")

__all__ = [
    "ChannelClosed", "Sender", "SenderConnector", "Receiver",
    "ReceiverConnector", "new_sender", "new_receiver",
]


class ChannelClosed(Exception):
    """Peer(s) gone: no more sends/recvs possible."""


class _Channel:
    """Capacity-1 broadcast state (one slot + per-receiver delivery)."""

    def __init__(self):
        self.value: Any = None
        self.seq = 0              # increments per send (slot toggle analog)
        self.unseen = 0           # receivers yet to take the current value
        self.receivers = 0
        self.senders = 1
        self.enlisters = 1
        self.reserved = False     # a Reservation holds the slot
        self.cond = asyncio.Condition()

    # -- sender side -------------------------------------------------------

    async def send(self, value) -> None:
        async with self.cond:
            while True:
                if self.enlisters == 0 and self.receivers == 0:
                    raise ChannelClosed
                if (self.unseen == 0 and self.receivers > 0
                        and not self.reserved):
                    break
                await self.cond.wait()
            self.value = value
            self.seq += 1
            self.unseen = self.receivers
            self.cond.notify_all()

    # -- receiver side -----------------------------------------------------

    async def recv(self, last_seq: int):
        async with self.cond:
            while True:
                if self.seq != last_seq:
                    break
                if self.senders == 0:
                    raise ChannelClosed
                await self.cond.wait()
            self.unseen -= 1
            if self.unseen == 0:
                self.cond.notify_all()
            return self.value, self.seq

    def _sync_notify(self):
        # Schedule waiter wakeup from synchronous contexts (drops, rewires).
        async def kick():
            async with self.cond:
                self.cond.notify_all()
        try:
            loop = asyncio.get_running_loop()
            loop.create_task(kick())
        except RuntimeError:
            pass


class Sender(Generic[T]):
    """Sending half (``src/sync/broadcast_bp.rs:103-117``)."""

    def __init__(self, channel: _Channel):
        self._channel = channel
        self._open = True

    async def send(self, value: T) -> None:
        await self._channel.send(value)

    async def reserve(self) -> "Reservation":
        """Claim the slot for a later non-blocking commit (two-phase send,
        ``src/sync/broadcast_bp.rs:225-292``).  While the reservation is
        outstanding, competing ``send``/``reserve`` calls block (the
        reference holds the channel guard inside its ``Reservation``);
        drop it via :meth:`Reservation.cancel` if unused."""
        ch = self._channel
        async with ch.cond:
            while True:
                if ch.enlisters == 0 and ch.receivers == 0:
                    raise ChannelClosed
                if (ch.unseen == 0 and ch.receivers > 0
                        and not ch.reserved):
                    ch.reserved = True
                    return Reservation(self)
                await ch.cond.wait()

    def try_reserve(self) -> Optional["Reservation"]:
        ch = self._channel
        if ch.enlisters == 0 and ch.receivers == 0:
            raise ChannelClosed
        if ch.unseen == 0 and ch.receivers > 0 and not ch.reserved:
            ch.reserved = True
            return Reservation(self)
        return None

    def close(self):
        """Drop the sending half (the reference's ``Sender`` Drop impl,
        ``src/sync/broadcast_bp.rs:170-179``): receivers observe channel
        closure once the last in-flight value is drained.  Idempotent."""
        if self._open:
            self._open = False
            self._channel.senders -= 1
            self._channel._sync_notify()

    def __del__(self):
        self.close()


class Reservation:
    """Claimed send slot; ``send`` commits without blocking
    (``src/sync/broadcast_bp.rs:284-292``)."""

    def __init__(self, sender: Sender):
        self._sender = sender
        self._active = True

    def send(self, value) -> None:
        if not self._active:
            raise RuntimeError("reservation already used or cancelled")
        ch = self._sender._channel
        self._active = False
        ch.reserved = False
        if ch.enlisters == 0 and ch.receivers == 0:
            # Every receiver (and the subscription point) vanished since
            # the claim; delivering would silently drop the value.
            ch._sync_notify()
            raise ChannelClosed
        ch.value = value
        ch.seq += 1
        ch.unseen = ch.receivers
        ch._sync_notify()

    def cancel(self) -> None:
        """Release the claim without sending.  Idempotent; also invoked by
        garbage collection (the reference's ``Reservation`` Drop)."""
        if self._active:
            self._active = False
            ch = self._sender._channel
            ch.reserved = False
            ch._sync_notify()

    def __del__(self):
        self.cancel()


class SenderConnector(Generic[T]):
    """Subscription point of a sender (the reference's ``Enlister``,
    ``src/sync/broadcast_bp.rs:294-299``)."""

    def __init__(self, channel: _Channel):
        self._channel = channel
        self._open = True

    def _subscribe(self) -> "_Subscription":
        ch = self._channel
        ch.receivers += 1
        ch._sync_notify()
        return _Subscription(ch, ch.seq)

    def close(self):
        """Drop the subscription point (the reference's ``Enlister`` Drop
        impl, ``src/sync/broadcast_bp.rs:181-190``): with no enlisters and
        no receivers left, a blocked sender's send/reserve raises
        :class:`ChannelClosed` instead of waiting forever.  Idempotent;
        also invoked by garbage collection (struct-drop parity)."""
        if self._open:
            self._open = False
            self._channel.enlisters -= 1
            self._channel._sync_notify()

    def __del__(self):
        self.close()


class _Subscription:
    def __init__(self, channel: _Channel, seq: int):
        self.channel = channel
        self.seq = seq
        self.active = True

    async def recv(self):
        value, self.seq = await self.channel.recv(self.seq)
        return value

    def drop(self):
        if self.active:
            self.active = False
            ch = self.channel
            ch.receivers -= 1
            # If we were the last holdout for the current value, release
            # the sender (src/sync/broadcast_bp.rs:188-198).
            if self.seq != ch.seq and ch.unseen > 0:
                ch.unseen -= 1
            ch._sync_notify()


class ReceiverConnector(Generic[T]):
    """Dynamically rewireable receive endpoint (``src/flow.rs:102-169``)."""

    def __init__(self):
        self._current: Optional[SenderConnector] = None
        self._version = 0
        self._changed = asyncio.Event()

    def connect(self, sender_connector: SenderConnector) -> None:
        self._current = sender_connector
        self._version += 1
        self._changed.set()

    def disconnect(self) -> None:
        self._current = None
        self._version += 1
        self._changed.set()

    def feed_from(self, producer) -> None:
        self.connect(producer.sender_connector)


class Receiver(Generic[T]):
    """Receiving half with live-rewire support (``src/flow.rs:171-226``)."""

    def __init__(self, connector: ReceiverConnector):
        self._connector = connector
        self._sub: Optional[_Subscription] = None
        self._seen_version = -1

    def clone(self) -> "Receiver":
        """An additional receiver on the same connector (the reference's
        ``Receiver`` Clone impl, ``src/sync/broadcast_bp.rs:337-375`` uses
        one): it subscribes independently on first ``recv`` and sees every
        value sent from then on, participating in lock-step delivery."""
        return Receiver(self._connector)

    def close(self):
        """Drop the receiving half (the reference's ``Receiver`` Drop impl,
        ``src/sync/broadcast_bp.rs:192-205``): unsubscribes so the upstream
        sender is released if this receiver was the last holdout.
        Idempotent; also invoked by garbage collection."""
        if self._sub is not None:
            self._sub.drop()
            self._sub = None

    def __del__(self):
        self.close()

    async def recv(self) -> T:
        c = self._connector
        while True:
            if self._seen_version != c._version:
                was_connected = self._sub is not None
                if self._sub is not None:
                    self._sub.drop()
                    self._sub = None
                self._seen_version = c._version
                c._changed.clear()
                if c._current is not None:
                    self._sub = c._current._subscribe()
                if was_connected:
                    # Rewire mid-stream: synthesize a Disconnection
                    # interrupt (src/flow.rs:184-189).
                    return Disconnection()
            if self._sub is None:
                await c._changed.wait()
                continue
            ch = self._sub.channel
            if ch.seq != self._sub.seq or ch.senders == 0:
                # Fast path: a value (or closure) is already waiting, so
                # skip the rewire race entirely — in saturated steady state
                # this avoids two task allocations per chunk.  Taking the
                # ready value over a concurrent rewire is a valid outcome
                # of the reference's select! race (src/flow.rs:191-224).
                return await self._sub.recv()
            recv_task = asyncio.ensure_future(self._sub.recv())
            change_task = asyncio.ensure_future(c._changed.wait())
            try:
                done, pending = await asyncio.wait(
                    [recv_task, change_task],
                    return_when=asyncio.FIRST_COMPLETED)
            except asyncio.CancelledError:
                # The caller's task was cancelled while we were parked:
                # reap both inner tasks so a late ChannelClosed completion
                # can't surface as 'Task exception was never retrieved'.
                for t in (recv_task, change_task):
                    t.cancel()
                    try:
                        await t
                    except (asyncio.CancelledError, ChannelClosed):
                        pass
                raise
            if recv_task in done:
                change_task.cancel()
                return recv_task.result()
            recv_task.cancel()
            try:
                await recv_task
            except (asyncio.CancelledError, ChannelClosed):
                pass
            # connector changed; loop re-subscribes / injects event


def new_sender() -> tuple:
    """(Sender, SenderConnector) pair (``src/flow.rs:68-71``)."""
    ch = _Channel()
    return Sender(ch), SenderConnector(ch)


def new_receiver() -> tuple:
    """(Receiver, ReceiverConnector) pair (``src/flow.rs:136-140``)."""
    conn = ReceiverConnector()
    return Receiver(conn), conn
