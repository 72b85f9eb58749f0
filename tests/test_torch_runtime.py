"""The port's streaming runtime (``radiorust_tpu_torch/runtime``) on CPU
tensors (``device="cpu"``).

1. The scenarios of ``tests/test_runtime.py`` (runtime blocks, host
   actors, teardown, stats, typed setters, graphs) against the port.
2. The actor equals the port's own ``scan`` / ``graph_scan`` bit for bit:
   on path A's chain (batched 2-D chunks, ``pipeline_depth`` 0 and 2),
   on path C's stereo graph (both outputs), on K's 44.1 kHz phase-mode
   tail (the valid prefixes, gapless), and across a ``set_shift``
   retune (the same host retune applied between the same chunks).
3. The same chunks through the JAX package's ``RuntimeBlock`` /
   ``RuntimeGraph`` and the port's give the same message sequence (event
   types and order, ``Warmup`` values, chunk shapes, sample rates), and
   samples within 3e-4 from ``valid_from`` — the WFM bound that
   ``tests/test_torch_compiled.py`` uses for the same chains — on A's
   chain, a retune mid-stream, C's graph and K's tail.
4. A mesh argument that is not the port's ``Mesh``, and a mesh mode or
   axis without a mesh, raise where the actor is made (the mesh modes
   themselves: ``test_torch_parallel_runtime.py``); without a card and
   without ``device="cpu"`` the actors raise.
"""

import asyncio

import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch

import oracles
import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu.blocks.base import Chain as JChain
from radiorust_tpu.blocks.filters import Filter as JFilter
from radiorust_tpu.blocks.modulation import FmDemod as JFmDemod
from radiorust_tpu.blocks.resampling import Downsampler as JDownsampler
from radiorust_tpu.blocks.transform import FreqShifter as JFreqShifter
from radiorust_tpu.models.stereo import \
    wfm_stereo_receiver as jwfm_stereo_receiver
from radiorust_tpu.models.wfm import _deemphasis_band as j_deemphasis_band
from radiorust_tpu.models.wfm import _lowpass_100k as j_lowpass_100k
from radiorust_tpu.models.wfm import wfm_receiver as jwfm_receiver
import radiorust_tpu.runtime as jrt
import radiorust_tpu_torch.runtime as trt
from radiorust_tpu_torch.blocks.base import Chain, StreamSig, scan
from radiorust_tpu_torch.blocks.filters import Filter
from radiorust_tpu_torch.blocks.graph import Graph, graph_scan
from radiorust_tpu_torch.blocks.modulation import FmDemod, FmMod
from radiorust_tpu_torch.blocks.morse import Speed
from radiorust_tpu_torch.blocks.resampling import Downsampler
from radiorust_tpu_torch.blocks.transform import (FreqShifter, GainControl,
                                                  MapSample)
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.models.stereo import wfm_stereo_receiver
from radiorust_tpu_torch.models.wfm import (_deemphasis_band, _lowpass_100k,
                                            wfm_receiver)
from radiorust_tpu_torch.runtime import (ArraySink, ArraySource, Blackhole,
                                         Buffer, KeyerSource, MapSignal,
                                         Rechunker, RuntimeBlock,
                                         RuntimeGraph, Silence, wait_until)
from radiorust_tpu_torch.runtime.flow import new_receiver, new_sender
from radiorust_tpu_torch.signal import (BufferOverflow, Disconnection,
                                        Samples, SamplesLost, Warmup)
from radiorust_tpu_torch.utils.profiling import GLOBAL_STATS

CPU = "cpu"
ATOL = 3e-4           # the WFM bound (tests/test_torch_compiled.py)
RATE = 1024000.0
CHAIN = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
             filter_ir_len=6144)
STEREO = dict(tune_shift=100e3, fuse_frontend=True, filter_ir_len=6144)


def run(coro, timeout=60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout), debug=True)


async def until(cond, timeout=30.0, interval=0.01):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(interval)


def feeder(make_sender=new_sender):
    """(sender, producer): a test-owned sending end to feed an actor."""
    sender, connector = make_sender()
    return sender, type("P", (), {"sender_connector": connector})()


def lowpass(cut):
    def resp(bins, freqs):
        return np.where(np.abs(freqs) <= cut, 1.0 + 0.0j, 0.0j)
    return resp


@pytest.fixture
def interpret_pallas_highest(monkeypatch):
    """The JAX package's kernels in interpret mode at float32 matmul
    precision, as its own CPU tests run them."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pfe.pl, "pallas_call", interp)
    monkeypatch.setattr(pfl.pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


# ---------------------------------------------------------------------------
# 1. The JAX package's runtime scenarios, on the port
# ---------------------------------------------------------------------------

def test_runtime_gain_block():
    async def main():
        data = np.arange(8, dtype=np.complex64)
        src = ArraySource(data, chunk_len=4, sample_rate=48000.0)
        gain = RuntimeBlock(GainControl(0.25), device=CPU)
        sink = ArraySink()
        gain.feed_from(src)
        sink.feed_from(gain)
        await until(lambda: len(sink.samples) >= len(data))
        np.testing.assert_allclose(sink.samples, data * 0.25)
        assert sink.sample_rate == 48000.0

    run(main())


def test_runtime_phase_mode_resampler_trims_to_schedule():
    rng = np.random.default_rng(13)
    data = (rng.standard_normal(800)
            + 1j * rng.standard_normal(800)).astype(np.complex64)

    async def main():
        src = ArraySource(data, chunk_len=100, sample_rate=1024.0)
        down = RuntimeBlock(Downsampler(384.0, 200.0), device=CPU)
        sink = ArraySink()
        down.feed_from(src)
        sink.feed_from(down)
        await until(lambda: len(sink.samples) >= 300)
        got = np.asarray(sink.samples)
        want = oracles.oracle_downsample(data, 1024.0, 384.0, 200.0)
        np.testing.assert_allclose(got, want[:len(got)], atol=2e-4)
        assert sink.sample_rate == 384.0

    run(main())


def test_runtime_shift_getter_and_update_shift():
    async def main():
        sender, producer = feeder()
        rx = RuntimeBlock(Chain(FreqShifter.with_shift(100.0),
                                GainControl(0.25)), device=CPU)
        sink = ArraySink()
        rx.feed_from(producer)
        sink.feed_from(rx)
        assert rx.shift() == 100.0 and rx.gain() == 0.25   # from the spec
        await sender.send(Samples(1000.0, np.ones(64, np.complex64)))
        await until(lambda: len(sink.chunks) >= 1)
        assert rx.shift() == 100.0          # bound: from the live block
        rx.update_shift(lambda s: s + 150.0)
        assert rx.shift() == 250.0
        rx.set_gain(0.5)
        assert rx.gain() == 0.5
        demod = RuntimeBlock(FmDemod(1500.0), device=CPU)
        assert abs(demod.deviation() - 1500.0) < 1e-6
        demod.set_deviation(2000.0)
        assert abs(demod.deviation() - 2000.0) < 1e-6
        await sender.send(Samples(1000.0, np.ones(64, np.complex64)))
        await until(lambda: len(sink.chunks) >= 2)
        step = np.angle(sink.chunks[1][2] * np.conj(sink.chunks[1][1]))
        np.testing.assert_allclose(step, 2 * np.pi * 250.0 / 1000.0,
                                   atol=1e-5)

    run(main())


def test_runtime_graph_getters():
    async def main():
        g = Graph()
        i = g.input("iq")
        g.output("out", g.chain([FreqShifter.with_shift(123.0),
                                 GainControl(0.5)], i))
        rg = RuntimeGraph(g, device=CPU)
        src = ArraySource(np.ones(256, np.complex64), chunk_len=64,
                          sample_rate=1000.0)
        sink = ArraySink()
        rg.feed_from(src)
        sink.feed_from(rg.out("out"))
        assert rg.shift() == 123.0 and rg.gain() == 0.5
        await until(lambda: rg._bound is not None)
        assert rg.shift() == 123.0 and rg.gain() == 0.5
        rg.update_shift(lambda s: s - 23.0)
        assert rg.shift() == 100.0

    run(main())


def test_runtime_rebind_on_rate_change():
    async def main():
        sender, producer = feeder()
        shifter = RuntimeBlock(FreqShifter.with_shift(100.0), device=CPU)
        sink = ArraySink()
        shifter.feed_from(producer)
        sink.feed_from(shifter)
        await sender.send(Samples(1000.0, np.ones(10, np.complex64)))
        await sender.send(Samples(2000.0, np.ones(10, np.complex64)))
        await until(lambda: len(sink.chunks) >= 2)
        steps = [np.angle(c[2] * np.conj(c[1])) for c in sink.chunks]
        np.testing.assert_allclose(steps, [2 * np.pi * 100.0 / 1000.0,
                                           2 * np.pi * 100.0 / 2000.0],
                                   atol=1e-5)

    run(main())


def test_silence_and_blackhole():
    async def main():
        src = Silence(chunk_size=256, sample_rate=8000.0)
        hole = Blackhole()
        hole.feed_from(src)
        await until(lambda: hole.samples_seen >= 256)
        src.stop()

    run(main())


@pytest.mark.parametrize("size,chunk,out", [(4096, 4096, 1024), (64, 8, 16)],
                         ids=["splits", "joins"])
def test_rechunker(size, chunk, out):
    async def main():
        data = np.arange(size, dtype=np.complex64)
        src = ArraySource(data, chunk_len=chunk, sample_rate=1.0)
        rechunk = Rechunker(out)
        sink = ArraySink()
        rechunk.feed_from(src)
        sink.feed_from(rechunk)
        await until(lambda: len(sink.samples) >= size)
        assert all(len(c) == out for c in sink.chunks)
        np.testing.assert_array_equal(sink.samples, data)

    run(main())


def test_keyer_source_events():
    async def main():
        speed = Speed.from_dits_per_minute(60.0 * 48000.0 / 64)
        keyer = KeyerSource(128, 48000.0, speed, message="E")
        sink = ArraySink()
        sink.feed_from(keyer)
        await until(lambda: len(sink.events) >= 2 and len(sink.chunks) >= 4)
        kinds = [type(e).__name__ for e in sink.events]
        assert "StartOfMessages" in kinds and "EndOfMessages" in kinds
        assert np.any(sink.samples.real == 1.0)
        keyer.stop()

    run(main())


def test_buffer_drops_stale_data():
    async def main():
        sender, producer = feeder()
        buf = Buffer(0.0, 0.0, 10.0, max_age=0.05)
        sink_r, sink_rc = new_receiver()
        buf.feed_from(producer)
        sink_rc.connect(buf.sender_connector)
        for i in range(5):
            await sender.send(Samples(1000.0, np.full(100, i, np.complex64)))
        await asyncio.sleep(0.2)
        got = []
        for _ in range(3):
            try:
                got.append(await asyncio.wait_for(sink_r.recv(), 1.0))
            except asyncio.TimeoutError:
                break
        assert any(isinstance(m, BufferOverflow) for m in got)
        buf.stop()

    run(main())


def test_buffer_passthrough():
    async def main():
        data = np.arange(32, dtype=np.complex64)
        src = ArraySource(data, chunk_len=8, sample_rate=1000.0)
        buf = Buffer(0.0, 0.0, 100.0, max_age=100.0)
        sink = ArraySink()
        buf.feed_from(src)
        sink.feed_from(buf)
        await until(lambda: len(sink.samples) >= len(data))
        np.testing.assert_array_equal(sink.samples, data)

    run(main())


def test_end_to_end_runtime_chain():
    # Keyer -> gain -> shifter -> sink, device compute per chunk.
    async def main():
        speed = Speed.from_dits_per_minute(60.0 * 48000.0 / 64)
        keyer = KeyerSource(128, 48000.0, speed, message="EE")
        gain = RuntimeBlock(GainControl(0.5), device=CPU)
        shift = RuntimeBlock(FreqShifter.with_shift(700.0), device=CPU)
        sink = ArraySink()
        gain.feed_from(keyer)
        shift.feed_from(gain)
        sink.feed_from(shift)
        await until(lambda: np.any(np.abs(sink.samples) > 0.4))
        s = sink.samples
        seg = s[np.flatnonzero(np.abs(s) > 0.4)[0]:][:50]
        steps = np.angle(seg[1:] * np.conj(seg[:-1]))
        np.testing.assert_allclose(steps, 2 * np.pi * 700.0 / 48000.0,
                                   atol=1e-4)
        keyer.stop()

    run(main())


def test_runtime_setters():
    async def main():
        src = ArraySource(np.ones(64, np.complex64), chunk_len=16,
                          sample_rate=1000.0, repeat=True)
        gain = RuntimeBlock(GainControl(1.0), device=CPU)
        sink = ArraySink()
        gain.feed_from(src)
        sink.feed_from(gain)
        await until(lambda: len(sink.chunks) >= 2)
        gain.set_gain(0.25)
        seen = len(sink.chunks)
        await until(lambda: len(sink.chunks) >= seen + 3)
        assert np.allclose(sink.chunks[-1], 0.25)
        src.stop()

    run(main())


def test_runtime_set_shift_phase_continuous():
    async def main():
        src = ArraySource(np.ones(400, np.complex64), chunk_len=40,
                          sample_rate=1000.0, repeat=True)
        shift = RuntimeBlock(FreqShifter.with_shift(100.0), device=CPU)
        sink = ArraySink()
        shift.feed_from(src)
        sink.feed_from(shift)
        await until(lambda: len(sink.chunks) >= 3)
        shift.set_shift(250.0)
        seen = len(sink.chunks)
        await until(lambda: len(sink.chunks) >= seen + 3)
        s = sink.chunks[-1]
        np.testing.assert_allclose(np.angle(s[1:] * np.conj(s[:-1])),
                                   2 * np.pi * 250.0 / 1000.0, atol=1e-3)
        src.stop()

    run(main())


def test_feed_from_none_disconnects():
    async def main():
        src = ArraySource(np.ones(64, np.complex64), chunk_len=16,
                          sample_rate=1000.0, repeat=True)
        sink = ArraySink()
        sink.feed_from(src)
        await until(lambda: len(sink.chunks) >= 2)
        sink.feed_from_none()
        await asyncio.sleep(0.1)
        assert any(isinstance(e, Disconnection) for e in sink.events)
        src.stop()
        sink.stop()

    run(main())


def test_runtime_block_resets_on_interrupt():
    # A Disconnection mid-stream clears the filter's overlap-save tail: the
    # next output equals a fresh filter's first output.
    rng = np.random.default_rng(0)
    chunks = (rng.standard_normal((3, 32))
              + 1j * rng.standard_normal((3, 32))).astype(np.complex64)

    async def main():
        sender, producer = feeder()
        filt = RuntimeBlock(Filter.new(lowpass(200.0)), device=CPU)
        sink = ArraySink()
        filt.feed_from(producer)
        sink.feed_from(filt)
        await sender.send(Samples(1000.0, chunks[0]))
        await sender.send(Samples(1000.0, chunks[1]))
        await sender.send(Disconnection())
        await sender.send(Samples(1000.0, chunks[2]))
        await until(lambda: len(sink.chunks) >= 3)
        return sink.chunks[2]

    got = run(main())
    b = Filter.new(lowpass(200.0)).bind(StreamSig(1, 32, 1000.0))
    _, want = scan(b, tree_to_torch(b.params, CPU),
                   tree_to_torch(b.init_state(), CPU),
                   torch.from_numpy(chunks[2][None, None, :]))
    np.testing.assert_array_equal(got, want.numpy()[0, 0])


def test_teardown_cascades_down_chain():
    async def main():
        data = np.arange(64, dtype=np.complex64)
        src = ArraySource(data, chunk_len=8, sample_rate=1000.0)
        mid = Rechunker(16)
        gain = RuntimeBlock(GainControl(1.0), device=CPU)
        sink = ArraySink()
        mid.feed_from(src)
        gain.feed_from(mid)
        sink.feed_from(gain)
        await asyncio.wait_for(asyncio.gather(
            src._task, mid._task, gain._task, sink._task), 20.0)
        np.testing.assert_array_equal(sink.samples, data)

    run(main())


def test_stop_releases_peers():
    async def main():
        src = ArraySource(np.arange(1 << 16, dtype=np.complex64),
                          chunk_len=256, sample_rate=1e6, repeat=True)
        sink = ArraySink()
        sink.feed_from(src)
        await until(lambda: len(sink.chunks) >= 2)
        sink.stop()
        src.stop()
        await asyncio.wait_for(asyncio.gather(
            src._task, sink._task, return_exceptions=True), 10.0)
        assert src._task.done() and sink._task.done()

    run(main())


def test_rechunker_zero_copy_and_pool_recycling():
    import gc

    async def main():
        sender, producer = feeder()
        rk = Rechunker(32)
        sink = Blackhole()
        rk.feed_from(producer)
        sink.feed_from(rk)
        for _ in range(10):
            await sender.send(Samples(1000.0, np.zeros(64, np.complex64)))
        await until(lambda: sink.samples_seen >= 640)
        assert rk.pool.allocated == 0, "aligned splits must be zero-copy"

        sender2, producer2 = feeder()
        rk2 = Rechunker(32)
        sink2 = Blackhole()
        rk2.feed_from(producer2)
        sink2.feed_from(rk2)
        for i in range(100):
            await sender2.send(Samples(1000.0, np.zeros(48, np.complex64)))
            if i % 10 == 0:
                gc.collect()
        await until(lambda: sink2.samples_seen >= 4780)
        assert rk2.pool.allocated <= 4 and rk2.pool.recycled > 0

    run(main())


def test_block_stats_recorded():
    async def main():
        data = np.arange(64, dtype=np.complex64)
        src = ArraySource(data, chunk_len=16, sample_rate=1000.0)
        gain = RuntimeBlock(GainControl(0.5), device=CPU)
        sink = ArraySink()
        gain.feed_from(src)
        sink.feed_from(gain)
        await until(lambda: len(sink.samples) >= 64)
        assert gain.stats.chunks == 4 and gain.stats.samples == 64
        assert gain.stats.wall_seconds > 0.0
        assert gain.stats.host_seconds > 0.0
        assert gain.stats.name in GLOBAL_STATS.report()

    run(main())


def test_warmup_event_on_zero_primed_history():
    async def main():
        src = ArraySource(np.ones(64, np.complex64), chunk_len=16,
                          sample_rate=1000.0)
        filt = RuntimeBlock(Filter.new(lowpass(200.0)), device=CPU)
        sink = ArraySink()
        filt.feed_from(src)
        sink.feed_from(filt)
        await until(lambda: len(sink.chunks) >= 4)
        warms = [e for e in sink.events if isinstance(e, Warmup)]
        assert len(warms) == 1 and warms[0].steps == 1

    run(main())


def test_runtime_batched_serving_matches_per_stream():
    rng = np.random.default_rng(3)
    data = (rng.standard_normal((3, 4, 16))
            + 1j * rng.standard_normal((3, 4, 16))).astype(np.complex64)

    async def serve(rows):
        sender, producer = feeder()
        blk = RuntimeBlock(FreqShifter.with_shift(125.0), device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        for t in range(4):
            await sender.send(Samples(1000.0, rows(t)))
        await until(lambda: len(sink.chunks) >= 4)
        return sink.chunks

    got = run(serve(lambda t: data[:, t, :]))
    assert all(c.shape == (3, 16) for c in got)
    for s in range(3):
        want = run(serve(lambda t: data[s, t, :]))
        np.testing.assert_array_equal(np.concatenate(got, axis=-1)[s],
                                      np.concatenate(want))


def test_runtime_pipeline_depth_matches_sync():
    rng = np.random.default_rng(7)
    data = (rng.standard_normal((8, 16))
            + 1j * rng.standard_normal((8, 16))).astype(np.complex64)

    async def drive(depth):
        sender, producer = feeder()
        blk = RuntimeBlock(FreqShifter.with_shift(100.0),
                           pipeline_depth=depth, device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        at_event = []
        guard = sink.on_event(lambda e: at_event.append(len(sink.chunks)))
        for i in range(4):
            await sender.send(Samples(1000.0, data[i]))
        await sender.send(Disconnection())
        for i in range(4, 8):
            await sender.send(Samples(1000.0, data[i]))
        await until(lambda: len(sink.chunks) >= 8)
        guard.unregister()
        return sink.samples, at_event

    async def main():
        got_sync, order_sync = await drive(0)
        got_pipe, order_pipe = await drive(3)
        np.testing.assert_array_equal(got_pipe, got_sync)
        assert order_sync == [4] and order_pipe == [4]

    run(main())


def test_runtime_set_map_params():
    async def main():
        sender, producer = feeder()
        blk = RuntimeBlock(MapSample.with_params(lambda x, p: x * p,
                                                 np.float32(3.0)),
                           device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        ones = np.ones(8, np.complex64)
        await sender.send(Samples(1000.0, ones))
        await until(lambda: len(sink.chunks) >= 1)
        blk.set_map_params(np.float32(5.0))
        await sender.send(Samples(1000.0, ones))
        await until(lambda: len(sink.chunks) >= 2)
        np.testing.assert_allclose(sink.chunks[0], ones * 3.0)
        np.testing.assert_allclose(sink.chunks[1], ones * 5.0)

    run(main())


def test_update_params_in_place_uploads_again():
    """A user fn that writes into the numpy params and returns the same
    object still reaches the device (the actor uploads again)."""
    async def main():
        sender, producer = feeder()
        blk = RuntimeBlock(MapSample.with_params(
            lambda x, p: x * p["k"], {"k": np.ones(1, np.float32)}),
            device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        ones = np.ones(8, np.complex64)
        await sender.send(Samples(1000.0, ones))
        await until(lambda: len(sink.chunks) >= 1)

        def in_place(bound, params):
            params["k"][0] = 7.0
            return params
        blk.update_params(in_place)
        await sender.send(Samples(1000.0, ones))
        await until(lambda: len(sink.chunks) >= 2)
        np.testing.assert_array_equal(sink.chunks[1], ones * 7.0)

    run(main())


def test_set_deviation_retunes_fused_blocks():
    from radiorust_tpu_torch.blocks.channelize import ChannelizerDemod
    from radiorust_tpu_torch.blocks.frontend import FilterDemodFilter
    from radiorust_tpu_torch.numbers import TAU

    async def main():
        blk = RuntimeBlock(FilterDemodFilter(lowpass(100000.0), 150000.0,
                                             lowpass(100000.0)), device=CPU)
        sender, producer = feeder()
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        await sender.send(Samples(RATE, np.ones((2, 4096), np.complex64)))
        await until(lambda: len(sink.chunks) >= 1)
        blk.set_deviation(75000.0)
        assert float(blk._bound.params["factor"]) == \
            np.float32(RATE / 75000.0 / TAU)

        blk2 = RuntimeBlock(ChannelizerDemod(64, 4000.0), device=CPU)
        sender2, producer2 = feeder()
        sink2 = ArraySink()
        blk2.feed_from(producer2)
        sink2.feed_from(blk2)
        await sender2.send(Samples(RATE, np.ones(1024, np.complex64)))
        await until(lambda: len(sink2.chunks) >= 1)
        blk2.set_deviation(8000.0)
        assert float(blk2._bound.params["factor"]) == \
            np.float32(RATE / 64 / 8000.0 / TAU)

    run(main())


def test_rechunker_rejects_batched_chunks():
    async def main():
        sender, producer = feeder()
        rk = Rechunker(8)
        sink = ArraySink()
        rk.feed_from(producer)
        sink.feed_from(rk)
        await sender.send(Samples(1000.0, np.ones((4, 16), np.complex64)))
        await until(lambda: rk.failure is not None)
        assert isinstance(rk.failure, TypeError) and "1-D" in str(rk.failure)
        await until(lambda: sink._task.done())

    run(main())


def test_rechunker_preserves_stream_dtype_across_boundaries():
    async def main():
        sender, producer = feeder()
        rk = Rechunker(10)
        sink = ArraySink()
        rk.feed_from(producer)
        sink.feed_from(rk)
        for i in range(5):
            await sender.send(Samples(
                1000.0, np.arange(i * 4, i * 4 + 4, dtype=np.float64)))
        await until(lambda: len(sink.chunks) >= 2)
        assert all(np.asarray(c).dtype == np.float64 for c in sink.chunks)
        np.testing.assert_array_equal(sink.samples[:20], np.arange(20.0))

    run(main())


def test_blackhole_counts_batched_samples():
    async def main():
        sender, producer = feeder()
        bh = Blackhole()
        bh.feed_from(producer)
        await sender.send(Samples(1000.0, np.ones((4, 16), np.complex64)))
        await sender.send(Samples(1000.0, np.ones(32, np.complex64)))
        await until(lambda: bh.samples_seen >= 48)
        assert bh.samples_seen == 48

    run(main())


def test_stats_registry_drop():
    s = GLOBAL_STATS.unique("EphemeralBlock")
    assert s.name in GLOBAL_STATS.report()
    GLOBAL_STATS.drop(s)
    assert s.name not in GLOBAL_STATS.report()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_actor_pipeline_matches_compiled_scan(seed):
    """A random chain through irregular source chunks -> Rechunker ->
    RuntimeBlock equals the port's scan of the same chain bit for bit."""
    rng = np.random.default_rng(seed)
    rate, n, total = 1000.0, 32, 288
    menu = [lambda: FreqShifter.with_shift(float(rng.integers(10, 400))),
            lambda: GainControl(float(rng.uniform(0.5, 2.0))),
            lambda: Filter.new(lowpass(300.0)),
            lambda: FmDemod(float(rng.integers(100, 400)))]
    chain = Chain(*[menu[i]() for i in
                    rng.integers(0, len(menu), rng.integers(2, 5))])
    data = (rng.standard_normal(total)
            + 1j * rng.standard_normal(total)).astype(np.complex64)

    async def actor():
        src = ArraySource(data, chunk_len=24, sample_rate=rate)
        rk = Rechunker(n)
        blk = RuntimeBlock(chain, device=CPU)
        sink = ArraySink()
        rk.feed_from(src)
        blk.feed_from(rk)
        sink.feed_from(blk)
        await until(lambda: len(sink.chunks) >= total // n)
        return sink.samples

    got = run(actor())
    bound = chain.bind(StreamSig(1, n, rate))
    _, want = scan(bound, tree_to_torch(bound.params, CPU),
                   tree_to_torch(bound.init_state(), CPU),
                   torch.from_numpy(data.reshape(total // n, 1, n)))
    np.testing.assert_array_equal(got, want.numpy().reshape(-1))


def test_runtime_graph_fanout():
    def build_graph():
        g = Graph()
        src = g.input("iq")
        mid = g.add(FreqShifter.with_shift(500.0), src)
        g.output("loud", g.add(GainControl(2.0), mid))
        g.output("quiet", g.add(GainControl(0.25), mid))
        return g

    rng = np.random.default_rng(0)
    data = (rng.standard_normal(64) + 1j * rng.standard_normal(64)
            ).astype(np.complex64)

    async def main():
        src = ArraySource(data, chunk_len=16, sample_rate=8000.0)
        rg = RuntimeGraph(build_graph(), device=CPU)
        sink_a, sink_b = ArraySink(), ArraySink()
        rg.feed_from(src)
        sink_a.feed_from(rg.out("loud"))
        sink_b.feed_from(rg.out("quiet"))
        await until(lambda: len(sink_a.samples) >= 64
                    and len(sink_b.samples) >= 64)
        assert rg.chunks_processed == 4   # shared prefix once per chunk
        return sink_a.samples, sink_b.samples

    got_loud, got_quiet = run(main())

    async def reference(gain):
        src = ArraySource(data, chunk_len=16, sample_rate=8000.0)
        blk = RuntimeBlock(Chain(FreqShifter.with_shift(500.0),
                                 GainControl(gain)), device=CPU)
        sink = ArraySink()
        blk.feed_from(src)
        sink.feed_from(blk)
        await until(lambda: len(sink.samples) >= 64)
        return sink.samples

    np.testing.assert_array_equal(got_loud, run(reference(2.0)))
    np.testing.assert_array_equal(got_quiet, run(reference(0.25)))


def test_runtime_graph_events_and_retune():
    async def main():
        sender, producer = feeder()
        g = Graph()
        src = g.input("x")
        g.output("a", g.add(GainControl(1.0), src))
        g.output("b", g.add(GainControl(1.0), src))
        rg = RuntimeGraph(g, device=CPU)
        rg.feed_from(producer)
        sink_a, sink_b = ArraySink(), ArraySink()
        sink_a.feed_from(rg.out("a"))
        sink_b.feed_from(rg.out("b"))
        await sender.send(Samples(8000.0, np.ones(8, np.complex64)))
        await until(lambda: len(sink_a.samples) >= 8)
        rg.set_gain(3.0)
        await sender.send(Disconnection())
        await sender.send(Samples(8000.0, np.ones(8, np.complex64)))
        await until(lambda: len(sink_a.samples) >= 16
                    and len(sink_b.samples) >= 16)
        for sink in (sink_a, sink_b):
            assert any(isinstance(e, Disconnection) for e in sink.events)
            np.testing.assert_allclose(sink.samples[8:], 3.0, atol=1e-6)

    run(main())


def test_runtime_graph_unconnected_output_drops():
    rng = np.random.default_rng(3)
    data = (rng.standard_normal(64) + 1j * rng.standard_normal(64)
            ).astype(np.complex64)

    async def main():
        g = Graph()
        src = g.input("x")
        g.output("a", g.add(GainControl(2.0), src))
        g.output("b", g.add(GainControl(0.5), src))  # never connected
        rg = RuntimeGraph(g, device=CPU)
        sink_a = ArraySink()
        rg.feed_from(ArraySource(data, chunk_len=16, sample_rate=8000.0))
        sink_a.feed_from(rg.out("a"))
        await until(lambda: len(sink_a.samples) >= 64)
        np.testing.assert_allclose(sink_a.samples, data * 2.0, atol=2e-4)

    run(main())


def test_runtime_block_event_handling_mid_chain():
    async def main():
        sender, producer = feeder()
        blk = RuntimeBlock(GainControl(2.0), device=CPU)
        mapper = MapSignal()
        sink = ArraySink()
        blk.feed_from(producer)
        mapper.feed_from(blk)
        sink.feed_from(mapper)
        seen_blk, seen_map = [], []
        g1 = blk.on_event(seen_blk.append)
        g2 = mapper.on_event(seen_map.append)
        waiter = asyncio.ensure_future(
            blk.wait_for_event(lambda e: isinstance(e, Disconnection)))
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await sender.send(Disconnection())
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await until(lambda: len(sink.chunks) >= 2)
        await asyncio.wait_for(waiter, timeout=5.0)
        assert len(seen_blk) == 1 and isinstance(seen_blk[0], Disconnection)
        assert len(seen_map) == 1 and isinstance(seen_map[0], Disconnection)
        g1.unregister()
        g2.unregister()

    run(main())


def test_runtime_block_failure_surfaces():
    async def main():
        sender, producer = feeder()
        # Scalar-style closure: the vectorized design call raises.
        blk = RuntimeBlock(Filter.new(lambda b, f: 1.0 if f > 0 else 0.0),
                           device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        await sender.send(Samples(8000.0, np.ones(64, np.complex64)))
        await until(lambda: blk.failure is not None)
        assert isinstance(blk.failure, ValueError)
        await until(lambda: sink._task.done())
        with pytest.raises(RuntimeError):
            await wait_until(lambda: False, blk, timeout=1.0)

    run(main())


def test_buffer_rechunker_event_handling():
    async def main():
        sender, producer = feeder()
        rechunk = Rechunker(8)
        buf = Buffer(0.0, 0.0, 10.0, 10.0)
        sink = ArraySink()
        rechunk.feed_from(producer)
        buf.feed_from(rechunk)
        sink.feed_from(buf)
        seen_r, seen_b = [], []
        g1 = rechunk.on_event(seen_r.append)
        g2 = buf.on_event(seen_b.append)
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await sender.send(Disconnection())
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await until(lambda: len(seen_r) >= 1 and len(seen_b) >= 1)
        assert isinstance(seen_r[0], Disconnection)
        assert isinstance(seen_b[0], Disconnection)
        g1.unregister()
        g2.unregister()
        buf.stop()

    run(main())


def test_mapsignal():
    async def main():
        src = ArraySource(np.arange(8, dtype=np.complex64), 4, 1000.0)
        ms = MapSignal(lambda m: Samples(m.sample_rate, m.chunk * 2)
                       if isinstance(m, Samples) else m)
        sink = ArraySink()
        ms.feed_from(src)
        sink.feed_from(ms)
        await until(lambda: len(sink.samples) >= 8)
        np.testing.assert_array_equal(sink.samples,
                                      np.arange(8, dtype=np.complex64) * 2)

        def boom(msg):
            raise RuntimeError("closure failed")
        sender, producer = feeder()
        mapper = MapSignal(boom)
        sink2 = ArraySink()
        mapper.feed_from(producer)
        sink2.feed_from(mapper)
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await until(lambda: mapper.failure is not None)
        assert isinstance(mapper.failure, RuntimeError)
        await until(lambda: sink2._task.done())

    run(main())


def test_set_shift_reaches_fused_mixer_decimator():
    """A fused MixerDecimator actor after set_shift matches an unfused
    FreqShifter + Downsampler actor after the same set_shift."""
    from radiorust_tpu_torch.blocks.frontend import MixerDecimator
    rng = np.random.default_rng(21)
    xs = (rng.standard_normal((4, 2048))
          + 1j * rng.standard_normal((4, 2048))).astype(np.complex64)

    async def drive(spec):
        sender, producer = feeder()
        blk = RuntimeBlock(spec, device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        for i in range(4):
            await sender.send(Samples(RATE, xs[i]))
            if i == 1:
                await until(lambda: len(sink.chunks) >= 2)
                blk.set_shift(-25000.0)
        await until(lambda: len(sink.chunks) >= 4)
        assert blk.failure is None
        return sink.chunks

    fused = run(drive(Chain(MixerDecimator(-57000.0, 384000.0, 200000.0))))
    plain = run(drive(Chain(FreqShifter.with_shift(-57000.0),
                            Downsampler(384000.0, 200000.0))))
    assert len(fused) == len(plain) == 4
    for f, p in zip(fused, plain):
        np.testing.assert_allclose(f, p, atol=5e-4)


def test_update_filter_reaches_filter_demod_filter():
    from radiorust_tpu_torch.blocks.frontend import FilterDemodFilter
    rng = np.random.default_rng(22)
    xs = (rng.standard_normal((2, 2, 512))
          + 1j * rng.standard_normal((2, 2, 512))).astype(np.complex64)

    async def main():
        sender, producer = feeder()
        blk = RuntimeBlock(Chain(FilterDemodFilter(
            lowpass(100000.0), 150000.0, _deemphasis_band)), device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        await sender.send(Samples(384000.0, xs[0]))
        await until(lambda: len(sink.chunks) >= 1)
        blk.update_filter(lowpass(50000.0))
        await sender.send(Samples(384000.0, xs[1]))
        await until(lambda: len(sink.chunks) >= 2)
        assert blk.failure is None
        return blk._bound

    bound = run(main())
    want = Chain(FilterDemodFilter(lowpass(50000.0), 150000.0,
                                   _deemphasis_band)).bind(
        StreamSig(2, 512, 384000.0))
    np.testing.assert_array_equal(np.asarray(bound.params[0]["response1"]),
                                  np.asarray(want.params[0]["response1"]))


def test_rechunker_shrink_to_exact_patchwork_emits_not_drops():
    async def main():
        sender, producer = feeder()
        rc = Rechunker(8)
        sink = ArraySink()
        rc.feed_from(producer)
        sink.feed_from(rc)
        await sender.send(Samples(8000.0, np.arange(1, 5,
                                                    dtype=np.complex64)))
        await asyncio.sleep(0.05)
        rc.set_output_chunk_len(4)
        await sender.send(Samples(8000.0, np.arange(5, 9,
                                                    dtype=np.complex64)))
        await until(lambda: len(sink.chunks) >= 2)
        return sink.chunks, sink.events

    chunks, events = run(main())
    assert not any(isinstance(e, SamplesLost) for e in events)
    np.testing.assert_array_equal(chunks[0], np.arange(1, 5))
    np.testing.assert_array_equal(chunks[1], np.arange(5, 9))


def test_typed_setters_compose_across_rebind():
    async def main():
        sender, producer = feeder()
        blk = RuntimeBlock(Chain(FmMod(5000.0), FmDemod(5000.0),
                                 GainControl(1.0)), name="c", device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        x = (0.25 * np.ones(256)).astype(np.complex64)
        await sender.send(Samples(8000.0, x))
        await until(lambda: len(sink.chunks) == 1)
        blk.set_gain(2.0)
        blk.set_deviation(2500.0)
        await sender.send(Samples(8000.0, np.resize(x, 128)))  # rebind
        await until(lambda: len(sink.chunks) == 2)
        assert blk.failure is None
        np.testing.assert_allclose(np.real(sink.chunks[1][8:]), 0.5,
                                   atol=1e-3)

    run(main())


def test_array_source_partial_tail_and_repeat():
    async def main():
        data = np.arange(10, dtype=np.complex64)
        src = ArraySource(data, chunk_len=4, sample_rate=1000.0)
        sink = ArraySink()
        sink.feed_from(src)
        await until(lambda: sum(len(c) for c in sink.chunks) >= 10)
        assert [len(c) for c in sink.chunks] == [4, 4, 2]
        rep = ArraySource(data, chunk_len=4, sample_rate=1000.0, repeat=True)
        sink2 = ArraySink()
        sink2.feed_from(rep)
        await until(lambda: sum(len(c) for c in sink2.chunks) >= 30)
        rep.stop()
        np.testing.assert_array_equal(sink2.samples[:30],
                                      np.resize(data, 30))

    run(main())


def test_chunks_cast_to_stream_dtype():
    """complex128 (and real float64) chunks run as complex64."""
    x = (np.arange(16) * (1 + 0.5j)).astype(np.complex128)

    async def main():
        sender, producer = feeder()
        blk = RuntimeBlock(GainControl(0.5), device=CPU)
        sink = ArraySink()
        blk.feed_from(producer)
        sink.feed_from(blk)
        await sender.send(Samples(1000.0, x))
        await sender.send(Samples(1000.0, x.real))
        await until(lambda: len(sink.chunks) >= 2)
        assert all(c.dtype == np.complex64 for c in sink.chunks)
        np.testing.assert_array_equal(sink.chunks[0],
                                      x.astype(np.complex64) * 0.5)
        np.testing.assert_array_equal(sink.chunks[1],
                                      x.real.astype(np.complex64) * 0.5)

    run(main())


# ---------------------------------------------------------------------------
# 2. The actor equals the port's scan / graph_scan bit for bit
# ---------------------------------------------------------------------------

T, B, N = 5, 2, 16384


def fm_tones(tones, t_chunks=T, n=N, offset=-100e3, deviation=150000.0):
    """[T, len(tones), n] complex64 FM tones (float64 synthesis)."""
    t = np.arange(t_chunks * n) / RATE
    rows = []
    for f in tones:
        audio = 0.5 * np.sin(2 * np.pi * f * t)
        phase = (2 * np.pi * deviation / RATE * np.cumsum(audio)
                 + 2 * np.pi * offset * t)
        rows.append(np.exp(1j * phase).astype(np.complex64))
    return np.stack(rows).reshape(len(tones), t_chunks, n).transpose(1, 0, 2)


def k_chain(m):
    """``examples/audio_44k_receiver.py``'s chain from the blocks of
    module namespace ``m``: a 44.1 kHz phase-mode tail."""
    return m.Chain(m.FreqShifter.with_shift(0.0),
                   m.Downsampler(384000.0, 200000.0),
                   m.Filter.new(m.lowpass_100k), m.FmDemod(150000.0),
                   m.Filter.new_rectangular(m.deemphasis_band),
                   m.Downsampler(44100.0, 36000.0))


class _P:
    Chain, FreqShifter, Downsampler = Chain, FreqShifter, Downsampler
    Filter, FmDemod = Filter, FmDemod
    lowpass_100k, deemphasis_band = _lowpass_100k, _deemphasis_band


class _J:
    Chain, FreqShifter, Downsampler = JChain, JFreqShifter, JDownsampler
    Filter, FmDemod = JFilter, JFmDemod
    lowpass_100k, deemphasis_band = j_lowpass_100k, j_deemphasis_band


async def _serve(make_actor, xs, outputs=None, retune=None, rt=trt):
    """Feed [T, batch, n] chunks to the actor ``make_actor()`` through a
    test-owned sender of runtime package ``rt`` (the port's or the JAX
    package's) and record every message each output delivers, in order.
    ``retune`` (index, fn) calls ``fn(actor)`` once the first ``index``
    chunks came out.  Returns ({output: [messages]}, actor)."""
    actor = make_actor()
    sender, producer = feeder(rt.new_sender)
    actor.feed_from(producer)
    logs, sinks = {}, {}
    for name in outputs or [None]:
        log = logs.setdefault(name, [])
        tap = rt.MapSignal(lambda m, log=log: (log.append(m), m)[1])
        tap.feed_from(actor if name is None else actor.out(name))
        sinks[name] = rt.ArraySink()
        sinks[name].feed_from(tap)

    def chunks_out():
        return min(len(_samples(log)) for log in logs.values())
    for i, x in enumerate(xs):
        if retune is not None and i == retune[0]:
            await until(lambda: chunks_out() >= i)
            retune[1](actor)
        await sender.send(Samples(RATE, x))
    sender.close()
    await asyncio.wait_for(asyncio.gather(
        *[s._task for s in sinks.values()]), 120.0)
    assert getattr(actor, "failure", None) is None
    return logs, actor


def _samples(log):
    return [m.chunk for m in log if type(m).__name__ == "Samples"]


def _summary(log):
    """Event types and Warmup values, chunk shapes and rates, in order
    (messages of either package, told apart by class name)."""
    def one(m):
        kind = type(m).__name__
        if kind == "Samples":
            return kind, np.shape(m.chunk), m.sample_rate
        return (kind, m.steps) if kind == "Warmup" else (kind,)
    return [one(m) for m in log]


def _port_chain_scan(bound, xs, retune=None):
    """The port's eager scan of ``bound`` over ``xs``, with ``retune``
    (index, shift) applied between chunks as the actor applies
    ``set_shift``: the same host retune of params and state."""
    params = bound.params
    state = tree_to_torch(bound.init_state(), CPU)
    ys = []
    for i, x in enumerate(xs):
        if retune is not None and i == retune[0]:
            host = tree_to_numpy(state)
            params, host = list(params), list(host)
            for j, blk in enumerate(bound.blocks):
                if hasattr(blk, "retune"):
                    params[j], host[j] = blk.retune(params[j], host[j],
                                                    retune[1])
            state = tree_to_torch(tuple(host), CPU)
        state, y = bound.process(tree_to_torch(tuple(params), CPU), state,
                                 torch.from_numpy(x),
                                 torch.zeros(x.shape[0], dtype=torch.bool))
        ys.append(y.numpy())
    return np.stack(ys)


@pytest.mark.parametrize("depth", [0, 2])
def test_actor_equals_scan_on_chain(depth):
    """Path A's chain through the actor (batched chunks) equals the port's
    scan bit for bit; one Warmup(valid_from) first; depth 2 equals 0."""
    xs = fm_tones([900.0, 2100.0])
    bound = wfm_receiver(**CHAIN).bind(StreamSig(B, N, RATE))
    want = _port_chain_scan(bound, xs)
    logs, blk = run(_serve(lambda: RuntimeBlock(
        wfm_receiver(**CHAIN), pipeline_depth=depth, device=CPU), xs))
    log = logs[None]
    assert _summary(log)[0] == ("Warmup", bound.valid_from)
    assert len(log) == T + 1
    np.testing.assert_array_equal(np.stack(_samples(log)), want)
    assert blk.stats.chunks == T


def test_actor_retune_equals_scan_with_retune():
    xs = fm_tones([900.0, 2100.0])
    bound = wfm_receiver(**CHAIN).bind(StreamSig(B, N, RATE))
    want = _port_chain_scan(bound, xs, retune=(3, 103e3))
    logs, blk = run(_serve(lambda: RuntimeBlock(wfm_receiver(**CHAIN),
                                                 device=CPU), xs,
                           retune=(3, lambda a: a.set_shift(103e3))))
    np.testing.assert_array_equal(np.stack(_samples(logs[None])), want)
    assert blk.shift() == 103e3


def test_actor_equals_graph_scan_on_stereo_graph():
    xs = fm_tones([900.0, 2100.0])
    bg = wfm_stereo_receiver(**STEREO).bind({"iq": StreamSig(B, N, RATE)})
    _, want = graph_scan(bg, tree_to_torch(bg.params, CPU),
                         tree_to_torch(bg.init_state(), CPU),
                         {"iq": torch.from_numpy(xs)})
    logs, _ = run(_serve(lambda: RuntimeGraph(wfm_stereo_receiver(**STEREO),
                                              device=CPU), xs,
                         outputs=["stereo", "pilot"]))
    for name in ("stereo", "pilot"):
        assert _summary(logs[name])[0] == ("Warmup", bg.valid_from[name])
        np.testing.assert_array_equal(np.stack(_samples(logs[name])),
                                      want[name].numpy())


def test_actor_phase_mode_tail_is_gapless():
    """K's 44.1 kHz tail through the actor: the valid prefix of each of
    the scan's padded chunks, nothing else, over a schedule period."""
    xs = fm_tones([900.0, 2100.0], t_chunks=6, offset=0.0)
    bound = k_chain(_P).bind(StreamSig(B, N, RATE))
    assert bound.ragged_output
    want = _port_chain_scan(bound, xs)
    valid = bound.valid_counts(0, len(xs))
    logs, _ = run(_serve(lambda: RuntimeBlock(k_chain(_P), device=CPU), xs))
    got = _samples(logs[None])
    kept = [want[k, :, :valid[k]] for k in range(len(xs)) if valid[k]]
    assert [g.shape for g in got] == [k.shape for k in kept]
    np.testing.assert_array_equal(np.concatenate(got, axis=-1),
                                  np.concatenate(kept, axis=-1))


# ---------------------------------------------------------------------------
# 3. The JAX package's actor and the port's, on the same chunks
# ---------------------------------------------------------------------------

def _vs_jax(got_log, want_log, valid_from):
    assert _summary(got_log) == _summary(want_log)
    got, want = _samples(got_log), _samples(want_log)
    for k, (g, w) in enumerate(zip(got, want)):
        if k >= valid_from:
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("retune", [False, True], ids=["plain", "retune"])
def test_actor_matches_jax_on_chain(interpret_pallas_highest, retune):
    xs = fm_tones([900.0, 2100.0])
    change = (3, lambda a: a.set_shift(103e3)) if retune else None
    want = run(_serve(lambda: jrt.RuntimeBlock(jwfm_receiver(**CHAIN)), xs,
                      retune=change, rt=jrt))[0][None]
    got = run(_serve(lambda: RuntimeBlock(wfm_receiver(**CHAIN), device=CPU),
                     xs, retune=change))[0][None]
    _vs_jax(got, want, wfm_receiver(**CHAIN).bind(
        StreamSig(B, N, RATE)).valid_from)


def test_graph_actor_matches_jax_on_stereo(interpret_pallas_highest):
    xs = fm_tones([900.0, 2100.0])
    outs = ["stereo", "pilot"]
    want = run(_serve(lambda: jrt.RuntimeGraph(
        jwfm_stereo_receiver(**STEREO)), xs, outputs=outs, rt=jrt))[0]
    got = run(_serve(lambda: RuntimeGraph(
        wfm_stereo_receiver(**STEREO), device=CPU), xs, outputs=outs))[0]
    bg = wfm_stereo_receiver(**STEREO).bind({"iq": StreamSig(B, N, RATE)})
    for name in outs:
        _vs_jax(got[name], want[name], bg.valid_from[name])


def test_actor_matches_jax_on_phase_mode_tail(interpret_pallas_highest):
    xs = fm_tones([900.0, 2100.0], t_chunks=6, offset=0.0)
    want = run(_serve(lambda: jrt.RuntimeBlock(k_chain(_J)), xs,
                      rt=jrt))[0][None]
    got = run(_serve(lambda: RuntimeBlock(k_chain(_P), device=CPU),
                     xs))[0][None]
    # Chunks before valid_from of the chain, in output chunks: the tail
    # emits one chunk per input chunk with a valid window.
    bound = k_chain(_P).bind(StreamSig(B, N, RATE))
    skip = int(np.count_nonzero(bound.valid_counts(0, bound.valid_from)))
    _vs_jax(got, want, skip)


# ---------------------------------------------------------------------------
# 4. Devices and mesh arguments
# ---------------------------------------------------------------------------

def test_mesh_arguments_raise():
    async def main():
        with pytest.raises(TypeError, match="Mesh"):
            RuntimeBlock(GainControl(1.0), mesh=object(), device=CPU)
        with pytest.raises(TypeError, match="Mesh"):
            RuntimeBlock(GainControl(1.0), mesh=object(), shard="time",
                         device=CPU)
        g = Graph()
        g.output("o", g.add(GainControl(1.0), g.input("x")))
        with pytest.raises(TypeError, match="Mesh"):
            RuntimeGraph(g, mesh=object(), device=CPU)
        with pytest.raises(ValueError):
            RuntimeBlock(GainControl(1.0), shard="time", device=CPU)
        with pytest.raises(ValueError):
            RuntimeBlock(GainControl(1.0), mesh_axis="x", device=CPU)

    run(main())


def test_default_device_is_cuda(monkeypatch):
    """Without ``device`` the actors run on CUDA, and without a card they
    raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def main():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RuntimeBlock(GainControl(1.0))
        g = Graph()
        g.output("o", g.add(GainControl(1.0), g.input("x")))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RuntimeGraph(g)
        assert RuntimeBlock(GainControl(1.0),
                            device=CPU).device.type == "cpu"

    run(main())
