"""The port's hardware I/O boundary (``radiorust_tpu_torch/runtime/io.py``)
with the shipped drivers: the SDR Request/State machine, loopback and file
drivers, the C++ IQ file loader built from the port's own sources, the
audio player and recorder, and the import-guarded hardware drivers — the
scenarios of ``tests/test_io.py`` (its examples wait for the port of the
examples), plus an SDR receiver feeding a ``RuntimeBlock`` on the CPU."""

import asyncio

import numpy as np
import pytest

from radiorust_tpu_torch.blocks.transform import FreqShifter
from radiorust_tpu_torch.runtime import ArraySink, ArraySource, RuntimeBlock
from radiorust_tpu_torch.runtime.flow import new_sender
from radiorust_tpu_torch.runtime.io import (
    AudioDriver, AudioPlayer, AudioRecorder, FileSdrDriver,
    LoopbackAudioDriver, LoopbackSdrDriver, NativeFileSdrDriver, SdrDriver,
    SdrError, SdrRx, SdrTx, SoapySdrDriver, SounddeviceAudioDriver,
    SyntheticSdrDriver, _CLOSED)
from radiorust_tpu_torch.signal import Samples


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout), debug=True)


async def until(cond, timeout=15.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(0.02)


def test_sdr_rx_activate_read_deactivate():
    async def main():
        drv = SyntheticSdrDriver(1024000.0, tones=((100000.0, 1.0),),
                                 noise=0.0)
        rx = SdrRx(drv)
        sink = ArraySink()
        sink.feed_from(rx)
        await rx.activate()
        await until(lambda: len(sink.samples) >= 16384)
        await rx.deactivate()
        assert sink.sample_rate == 1024000.0
        s = sink.samples[:8192]
        steps = np.angle(s[1:] * np.conj(s[:-1]))
        np.testing.assert_allclose(
            steps.mean(), 2 * np.pi * 100000.0 / 1024000.0, atol=1e-3)
        await rx.close()

    run(main())


def test_sdr_rx_into_runtime_block():
    """A synthetic tone shifted to DC by an actor on the CPU."""
    async def main():
        rx = SdrRx(SyntheticSdrDriver(48000.0, tones=((1000.0, 1.0),),
                                      noise=0.0))
        shift = RuntimeBlock(FreqShifter.with_shift(-1000.0), device="cpu")
        sink = ArraySink()
        shift.feed_from(rx)
        sink.feed_from(shift)
        await rx.activate()
        await until(lambda: len(sink.samples) >= 8192)
        await rx.deactivate()
        s = sink.samples[:8192]
        np.testing.assert_allclose(np.angle(s[1:] * np.conj(s[:-1])), 0.0,
                                   atol=1e-3)
        await rx.close()

    run(main())


def test_sdr_rx_error_surfaces_as_closed():
    class FailingDriver(SyntheticSdrDriver):
        def read(self, n):
            raise RuntimeError("device unplugged")

    async def main():
        rx = SdrRx(FailingDriver(48000.0))
        sink = ArraySink()
        sink.feed_from(rx)
        await rx.activate()
        await until(lambda: rx._ctl.state == _CLOSED)
        assert "unplugged" in str(rx._ctl.error)

    run(main())


def test_sdr_tx_loopback():
    async def main():
        drv = LoopbackSdrDriver(128000.0)
        tx = SdrTx(drv)
        src = ArraySource(np.arange(64, dtype=np.complex64),
                          chunk_len=32, sample_rate=128000.0)
        tx.feed_from(src)
        await tx.activate()
        rx_chunks = []
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(None, lambda: [
            rx_chunks.append(drv.read(64)) for _ in range(3)])
        await until(lambda: len(rx_chunks) >= 3)
        await fut
        flat = np.concatenate(rx_chunks)
        assert flat[0] == 0        # the silencing zero sample first
        np.testing.assert_array_equal(flat[1:33],
                                      np.arange(32, dtype=np.complex64))
        await tx.close()

    run(main())


def test_file_sdr_roundtrip(tmp_path):
    path = tmp_path / "iq.bin"
    data = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
    data.tofile(path)

    async def main():
        rx = SdrRx(FileSdrDriver(str(path), 48000.0))
        sink = ArraySink()
        sink.feed_from(rx)
        await rx.activate()
        await until(lambda: len(sink.samples) >= 100)
        np.testing.assert_array_equal(sink.samples[:100], data)

    run(main())


def test_audio_loopback_pipe():
    async def main():
        drv = LoopbackAudioDriver(48000.0)
        drv.play(np.sin(np.arange(4096) * 0.1).astype(np.float32))
        rec = AudioRecorder(drv, chunk_len=4096)
        out_drv = LoopbackAudioDriver(48000.0)
        player = AudioPlayer(out_drv)
        player.feed_from(rec)
        await until(lambda: len(out_drv.played) >= 1)
        np.testing.assert_allclose(out_drv.played[0],
                                   np.sin(np.arange(4096) * 0.1), atol=1e-6)
        rec.stop()
        player.stop()

    run(main())


def test_audio_player_rate_mismatch_raises():
    async def main():
        player = AudioPlayer(LoopbackAudioDriver(48000.0))
        sender, conn = new_sender()
        player.receiver_connector.connect(conn)
        await sender.send(Samples(44100.0, np.zeros(16, np.complex64)))
        await until(lambda: player._task.done())
        assert player._task.exception() is None
        assert isinstance(player.failure, AssertionError)

    run(main())


def test_loopback_driver_requeues_oversized_write_tail():
    drv = LoopbackSdrDriver(48000.0)
    data = np.arange(12, dtype=np.complex64)
    drv.write(data)
    np.testing.assert_array_equal(drv.read(8), data[:8])
    np.testing.assert_array_equal(drv.read(8), data[8:])


def test_sdr_tx_deactivate_while_idle():
    async def main():
        drv = LoopbackSdrDriver(48000.0)
        tx = SdrTx(drv)
        sender, conn = new_sender()
        tx.receiver_connector.connect(conn)
        await tx.activate()
        await asyncio.wait_for(tx.deactivate(), 5.0)
        await tx.activate()
        await sender.send(Samples(48000.0, np.arange(4, dtype=np.complex64)))
        await until(lambda: sum(len(c) for c in drv._buf) >= 4)
        await asyncio.wait_for(tx.close(), 5.0)

    run(main())


def test_hardware_drivers_import_guarded():
    assert issubclass(SoapySdrDriver, SdrDriver)
    assert issubclass(SounddeviceAudioDriver, AudioDriver)
    try:
        import SoapySDR  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            SoapySdrDriver(dict(driver="rtlsdr"), 1024000.0, 100e6)
    try:
        import sounddevice  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            SounddeviceAudioDriver(48000.0)


def test_native_file_driver_roundtrip(tmp_path):
    """The C++ mmap/prefetch IQ loader: exact replay, end of file, loop
    wraparound, and SdrRx integration."""
    data = (np.arange(1000) + 1j * np.arange(1000)[::-1]
            ).astype(np.complex64)
    path = tmp_path / "iq.raw"
    data.tofile(path)

    drv = NativeFileSdrDriver(str(path), 48000.0)
    assert drv.total_samples == 1000
    got = np.concatenate([drv.read(300), drv.read(300), drv.read(500)])
    np.testing.assert_array_equal(got, data)
    with pytest.raises(SdrError):
        drv.read(1)
    drv.close()

    looped = NativeFileSdrDriver(str(path), 48000.0, loop=True)
    np.testing.assert_array_equal(looped.read(2500),
                                  np.tile(data, 3)[:2500])
    looped.close()

    async def main():
        rx = SdrRx(NativeFileSdrDriver(str(path), 48000.0))
        sink = ArraySink()
        sink.feed_from(rx)
        await rx.activate()
        await until(lambda: len(sink.samples) >= 1000)
        np.testing.assert_array_equal(sink.samples[:1000], data)

    run(main())
