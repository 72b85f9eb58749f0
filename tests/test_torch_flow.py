"""The port's flow layer and host buffer pool (``runtime/flow.py``,
``bufferpool.py``): capacity-1 broadcast channels with backpressure, live
rewiring, teardown, two-phase sends, and zero-copy chunks whose storage
recycles — the scenarios of ``tests/test_runtime.py`` (channel part) and
``tests/test_bufferpool.py`` run against the port's own copies."""

import asyncio
import doctest
import gc

import numpy as np
import pytest

import radiorust_tpu_torch.bufferpool as bufferpool
from radiorust_tpu_torch.bufferpool import Chunk, ChunkBufPool
from radiorust_tpu_torch.runtime.flow import (ChannelClosed, new_receiver,
                                              new_sender)
from radiorust_tpu_torch.signal import Disconnection, Samples


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout), debug=True)


def test_broadcast_all_receivers_get_each_value():
    # One sender, three receivers, one of them a clone
    # (broadcast_bp.rs:337-375).
    async def main():
        sender, connector = new_sender()
        recvs = []
        for _ in range(2):
            r, rc = new_receiver()
            rc.connect(connector)
            recvs.append(r)
        recvs.append(recvs[0].clone())
        results = [[] for _ in range(3)]

        async def consume(i):
            for _ in range(3):
                results[i].append(await recvs[i].recv())

        async def produce():
            for v in "abc":
                await sender.send(v)

        await asyncio.gather(produce(), *[consume(i) for i in range(3)])
        assert results == [["a", "b", "c"]] * 3

    run(main())


def test_backpressure_capacity_one():
    async def main():
        sender, connector = new_sender()
        r, rc = new_receiver()
        rc.connect(connector)
        sent = []

        async def produce():
            for v in range(5):
                await sender.send(v)
                sent.append(v)

        task = asyncio.ensure_future(produce())
        await asyncio.sleep(0.05)
        assert len(sent) <= 1          # at most one value in flight
        got = [await r.recv() for _ in range(5)]
        await task
        assert got == list(range(5))

    run(main())


def test_recv_raises_when_sender_gone():
    async def main():
        sender, connector = new_sender()
        r, rc = new_receiver()
        rc.connect(connector)

        async def produce():
            await sender.send(1)
            sender.close()

        task = asyncio.ensure_future(produce())
        assert await r.recv() == 1
        await task
        with pytest.raises(ChannelClosed):
            await r.recv()

    run(main())


def test_rewire_injects_disconnection():
    async def main():
        s1, c1 = new_sender()
        s2, c2 = new_sender()
        r, rc = new_receiver()
        rc.connect(c1)
        t1 = asyncio.ensure_future(s1.send("one"))
        assert await r.recv() == "one"
        await t1
        rc.connect(c2)
        assert isinstance(await r.recv(), Disconnection)
        t2 = asyncio.ensure_future(s2.send("two"))
        assert await r.recv() == "two"
        await t2

    run(main())


def test_send_unblocks_when_peer_endpoints_dropped():
    async def main():
        sender, connector = new_sender()
        receiver, rc = new_receiver()
        rc.connect(connector)
        recv_task = asyncio.ensure_future(receiver.recv())
        await sender.send(Samples(1000.0, np.zeros(4, np.complex64)))
        await recv_task
        await sender.send(Samples(1000.0, np.ones(4, np.complex64)))
        send_task = asyncio.ensure_future(
            sender.send(Samples(1000.0, np.ones(4, np.complex64))))
        await asyncio.sleep(0.05)
        assert not send_task.done()     # backpressure
        receiver.close()
        del receiver, rc, connector
        gc.collect()
        with pytest.raises(ChannelClosed):
            await asyncio.wait_for(send_task, 5.0)

    run(main())


def test_reservation_claims_slot_against_competing_send():
    async def main():
        sender, connector = new_sender()
        receiver, rc = new_receiver()
        rc.connect(connector)
        recv1 = asyncio.ensure_future(receiver.recv())
        await asyncio.sleep(0)
        res = await sender.reserve()
        plain = asyncio.ensure_future(sender.send("second"))
        await asyncio.sleep(0.05)
        assert not plain.done()
        res.send("first")
        assert await recv1 == "first"
        assert await receiver.recv() == "second"
        await plain

    run(main())


def test_reservation_cancel_releases_slot():
    async def main():
        sender, connector = new_sender()
        receiver, rc = new_receiver()
        rc.connect(connector)
        recv1 = asyncio.ensure_future(receiver.recv())
        await asyncio.sleep(0)
        res = await sender.reserve()
        plain = asyncio.ensure_future(sender.send("x"))
        await asyncio.sleep(0.02)
        assert not plain.done()
        res.cancel()
        await plain
        assert await recv1 == "x"
        with pytest.raises(RuntimeError):
            res.send("y")

    run(main())


def test_reservation_send_raises_when_channel_closed():
    async def main():
        sender, connector = new_sender()
        receiver, rc = new_receiver()
        rc.connect(connector)
        recv1 = asyncio.ensure_future(receiver.recv())
        await asyncio.sleep(0)
        res = await sender.reserve()
        recv1.cancel()
        try:
            await recv1
        except asyncio.CancelledError:
            pass
        receiver.close()
        connector.close()
        with pytest.raises(ChannelClosed):
            res.send("lost")

    run(main())


# ---------------------------------------------------------------------------
# Host buffer pool (src/bufferpool.rs)
# ---------------------------------------------------------------------------

def test_bufferpool_doctest():
    result = doctest.testmod(bufferpool, verbose=False)
    assert result.attempted > 0 and result.failed == 0


def test_chunk_views_and_splits():
    c = Chunk.from_array(np.arange(10, dtype=np.complex64))
    assert len(c) == 10
    head = c.separate_beginning(4)
    rest = c.discard_beginning(4)
    np.testing.assert_array_equal(np.asarray(head), np.arange(4))
    np.testing.assert_array_equal(np.asarray(rest), np.arange(4, 10))
    assert np.shares_memory(head.data, c.data)      # zero-copy


def test_pool_recycles_storage():
    pool = ChunkBufPool(np.complex64)
    buf = pool.get_with_capacity(64)
    buf.extend(np.ones(32, np.complex64))
    chunk = buf.finalize()
    assert len(chunk) == 32 and pool.allocated == 1
    del chunk  # last view dropped -> storage returns to pool
    pool.get_with_capacity(16)
    assert pool.recycled == 1 and pool.allocated == 1


def test_chunkbuf_grows():
    pool = ChunkBufPool(np.float32)
    buf = pool.get()
    for _ in range(10):
        buf.extend(np.ones(7, np.float32))
    c = buf.finalize()
    assert len(c) == 70
    np.testing.assert_array_equal(np.asarray(c), np.ones(70))


def test_chunk_array_copy_isolation():
    base = Chunk.from_array(np.arange(8, dtype=np.complex64))
    head = base.separate_beginning(4)
    arr = head.__array__(copy=True)
    arr[:] = -1.0
    np.testing.assert_array_equal(np.asarray(base),
                                  np.arange(8, dtype=np.complex64))
    assert head.__array__().base is not None        # default: a view
