"""The port's hardware drivers (``radiorust_tpu_torch/runtime/io.py``)
exercised through injected fake modules: the scenarios of
``tests/test_io_hw_stubs.py`` against the port.

``SoapySdrDriver`` and ``SounddeviceAudioDriver`` wrap the SoapySDR and
sounddevice Python bindings, which are absent here, so these tests put
in-memory fakes into ``sys.modules`` and drive the drivers through setup,
MTU-sized reads, partial writes, activation and the error paths: a
readStream error closes the stream (radiorust's
``src/blocks/io/rf/soapysdr.rs:99-125``), and writes loop over partial
writes (``:322-356``).  No hardware is touched.
"""

import asyncio
import sys
import types

import numpy as np
import pytest

from radiorust_tpu_torch.runtime import ArraySink, ArraySource
from radiorust_tpu_torch.signal import Samples

SOAPY_SDR_RX, SOAPY_SDR_TX, SOAPY_SDR_CF32 = 1, 2, "CF32"


class _StreamResult:
    def __init__(self, ret):
        self.ret = ret


class FakeSoapyDevice:
    """In-memory SoapySDR.Device: RX yields a pure tone, TX records
    writes.  Knobs (`fail_read_after`, `max_write`) drive the error and
    partial-write paths."""

    def __init__(self, args):
        self.args = args
        self.calls = []           # (method, ...) log for assertions
        self.sample_rate = None
        self.frequency = None
        self.bandwidth = None
        self.active = False
        self.closed = False
        self.mtu = 1024
        self.tone_freq = 100e3
        self._pos = 0
        self.written = []
        self.fail_read_after = None   # raise driver error after N reads
        self.fail_write = False       # writeStream returns a negative code
        self.max_write = None         # cap per-call write (partial writes)
        self._reads = 0

    # --- configuration (soapysdr.rs: examples set rate/freq/bandwidth) ---
    def setSampleRate(self, direction, channel, rate):
        self.calls.append(("setSampleRate", direction, channel, rate))
        self.sample_rate = rate

    def setFrequency(self, direction, channel, freq):
        self.calls.append(("setFrequency", direction, channel, freq))
        self.frequency = freq

    def setBandwidth(self, direction, channel, bw):
        self.calls.append(("setBandwidth", direction, channel, bw))
        self.bandwidth = bw

    # --- stream lifecycle ---
    def setupStream(self, direction, fmt, channels):
        assert fmt == SOAPY_SDR_CF32, "driver must request CF32 frames"
        self.calls.append(("setupStream", direction, fmt, tuple(channels)))
        return ("stream", direction)

    def getStreamMTU(self, stream):
        return self.mtu

    def activateStream(self, stream):
        self.calls.append(("activateStream",))
        self.active = True

    def deactivateStream(self, stream):
        self.calls.append(("deactivateStream",))
        self.active = False

    def closeStream(self, stream):
        self.calls.append(("closeStream",))
        self.closed = True

    # --- data path ---
    def readStream(self, stream, buffs, n):
        self._reads += 1
        if self.fail_read_after is not None \
                and self._reads > self.fail_read_after:
            return _StreamResult(-1)   # SOAPY_SDR_TIMEOUT-style error code
        t = np.arange(self._pos, self._pos + n) / self.sample_rate
        self._pos += n
        buffs[0][:n] = np.exp(2j * np.pi * self.tone_freq * t
                              ).astype(np.complex64)
        return _StreamResult(n)

    def writeStream(self, stream, buffs, n):
        if self.fail_write:
            return _StreamResult(-2)
        take = n if self.max_write is None else min(n, self.max_write)
        self.written.append(np.asarray(buffs[0][:take], np.complex64).copy())
        return _StreamResult(take)


@pytest.fixture
def fake_soapy(monkeypatch):
    mod = types.ModuleType("SoapySDR")
    mod.SOAPY_SDR_RX = SOAPY_SDR_RX
    mod.SOAPY_SDR_TX = SOAPY_SDR_TX
    mod.SOAPY_SDR_CF32 = SOAPY_SDR_CF32
    devices = []

    def Device(args):
        dev = FakeSoapyDevice(args)
        devices.append(dev)
        return dev

    mod.Device = Device
    mod._devices = devices
    monkeypatch.setitem(sys.modules, "SoapySDR", mod)
    return mod


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def until(cond, timeout=15.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(0.02)


def test_soapy_driver_configures_device(fake_soapy):
    from radiorust_tpu_torch.runtime.io import SoapySdrDriver
    drv = SoapySdrDriver(dict(driver="fake"), 1024000.0, 100e6,
                         bandwidth=200e3, channel=0, direction="rx")
    dev = fake_soapy._devices[-1]
    assert dev.args == dict(driver="fake")
    assert ("setSampleRate", SOAPY_SDR_RX, 0, 1024000.0) in dev.calls
    assert ("setFrequency", SOAPY_SDR_RX, 0, 100e6) in dev.calls
    assert ("setBandwidth", SOAPY_SDR_RX, 0, 200e3) in dev.calls
    assert ("setupStream", SOAPY_SDR_RX, SOAPY_SDR_CF32, (0,)) in dev.calls
    assert drv.mtu() == dev.mtu   # MTU comes from the device, not a default
    drv.close()
    assert dev.closed


def test_soapy_rx_full_state_machine(fake_soapy):
    """SdrRx over the real SoapySdrDriver body: activate -> MTU reads ->
    deactivate -> close, with the tone arriving intact (soapysdr.rs:39-213)."""
    from radiorust_tpu_torch.runtime.io import SdrRx, SoapySdrDriver, _CLOSED

    async def main():
        drv = SoapySdrDriver(dict(driver="fake"), 1024000.0, 100e6)
        dev = fake_soapy._devices[-1]
        rx = SdrRx(drv)
        sink = ArraySink()
        sink.feed_from(rx)
        await rx.activate()
        assert dev.active
        await until(lambda: len(sink.samples) >= 4096)
        await rx.deactivate()
        assert not dev.active
        await rx.close()
        assert dev.closed and rx._ctl.state == _CLOSED
        # Chunks are MTU-sized (the blocking-read contract).
        s = sink.samples[:4096]
        steps = np.angle(s[1:] * np.conj(s[:-1]))
        np.testing.assert_allclose(
            steps.mean(), 2 * np.pi * 100e3 / 1024000.0, atol=1e-3)

    run(main())


def test_soapy_rx_read_error_closes_stream(fake_soapy):
    """readStream ret<0 -> SdrError -> State::Closed(err), visible to
    pending control calls (soapysdr.rs:99-125,160-163)."""
    from radiorust_tpu_torch.runtime.io import (SdrError, SdrRx, SoapySdrDriver,
                                          _CLOSED)

    async def main():
        drv = SoapySdrDriver(dict(driver="fake"), 48000.0, 100e6)
        dev = fake_soapy._devices[-1]
        dev.fail_read_after = 2
        rx = SdrRx(drv)
        sink = ArraySink()
        sink.feed_from(rx)
        await rx.activate()
        await until(lambda: rx._ctl.state == _CLOSED)
        assert isinstance(rx._ctl.error, SdrError)
        assert "readStream error -1" in str(rx._ctl.error)
        # A control call issued against the dead stream raises, it does
        # not hang (the reference resolves pending waiters with the error).
        with pytest.raises(SdrError):
            await rx.deactivate()
        # The two successful MTU reads were delivered before the failure.
        assert len(sink.samples) == 2 * dev.mtu

    run(main())


def test_soapy_tx_partial_writes_and_silencing(fake_soapy):
    """The write path loops over partial writeStream results (the
    reference's write_all, soapysdr.rs:322-356) and writes a zero sample
    on activation to silence the carrier (:322-328)."""
    from radiorust_tpu_torch.runtime.io import SdrTx, SoapySdrDriver

    async def main():
        drv = SoapySdrDriver(dict(driver="fake"), 128000.0, 7.1e6,
                             direction="tx")
        dev = fake_soapy._devices[-1]
        dev.max_write = 7   # force partial writes (63 samples -> 9 calls)
        tx = SdrTx(drv)
        data = (np.arange(63) - 31j * np.ones(63)).astype(np.complex64)
        from radiorust_tpu_torch.runtime.flow import new_sender
        sender, conn = new_sender()
        tx.receiver_connector.connect(conn)
        await tx.activate()
        await sender.send(Samples(128000.0, data))
        await until(lambda: sum(len(w) for w in dev.written) >= 64)
        flat = np.concatenate(dev.written)
        assert flat[0] == 0                      # silencing zero sample
        np.testing.assert_array_equal(flat[1:64], data)
        assert max(len(w) for w in dev.written) <= 7
        await tx.deactivate()
        # Deactivation silences the carrier again before stopping.
        assert dev.written[-1][0] == 0 and not dev.active

    run(main())


def test_soapy_tx_write_error_closes_stream(fake_soapy):
    from radiorust_tpu_torch.runtime.io import (SdrError, SdrTx, SoapySdrDriver,
                                          _CLOSED)

    async def main():
        drv = SoapySdrDriver(dict(driver="fake"), 48000.0, 7.1e6,
                             direction="tx")
        dev = fake_soapy._devices[-1]
        tx = SdrTx(drv)
        from radiorust_tpu_torch.runtime.flow import new_sender
        sender, conn = new_sender()
        tx.receiver_connector.connect(conn)
        await tx.activate()
        dev.fail_write = True
        await sender.send(Samples(48000.0, np.ones(16, np.complex64)))
        await until(lambda: tx._ctl.state == _CLOSED)
        assert isinstance(tx._ctl.error, SdrError)
        assert "writeStream error -2" in str(tx._ctl.error)

    run(main())


# ---------------------------------------------------------------------------
# sounddevice (PortAudio) fake
# ---------------------------------------------------------------------------

class _FakeSdStream:
    def __init__(self, kind, log, samplerate, channels, dtype, device):
        self.kind = kind
        self.log = log
        self.samplerate = samplerate
        self.channels = channels
        self.dtype = dtype
        self.device = device
        self.started = False
        log.append((kind, samplerate, channels, dtype, device))

    def start(self):
        self.started = True

    def write(self, data):
        assert self.started and self.kind == "out"
        assert data.dtype == np.float32
        self.log.append(("write", np.asarray(data).copy()))

    def read(self, n):
        assert self.started and self.kind == "in"
        # PortAudio returns (frames, channels)-shaped data + overflow flag.
        data = np.linspace(0, 1, n * self.channels, dtype=np.float32
                           ).reshape(n, self.channels)
        return data, False


@pytest.fixture
def fake_sounddevice(monkeypatch):
    mod = types.ModuleType("sounddevice")
    mod._log = []
    mod.OutputStream = lambda samplerate, channels, dtype, device: \
        _FakeSdStream("out", mod._log, samplerate, channels, dtype, device)
    mod.InputStream = lambda samplerate, channels, dtype, device: \
        _FakeSdStream("in", mod._log, samplerate, channels, dtype, device)
    monkeypatch.setitem(sys.modules, "sounddevice", mod)
    return mod


def test_sounddevice_play_opens_lazily_and_writes_f32(fake_sounddevice):
    from radiorust_tpu_torch.runtime.io import SounddeviceAudioDriver
    drv = SounddeviceAudioDriver(48000.0, device="fakecard")
    assert fake_sounddevice._log == []       # no stream until first play
    wave = np.sin(np.arange(256) * 0.1).astype(np.float32)
    drv.play(wave)
    drv.play(wave * 2)
    opens = [e for e in fake_sounddevice._log if e[0] == "out"]
    writes = [e for e in fake_sounddevice._log if e[0] == "write"]
    assert opens == [("out", 48000.0, 1, "float32", "fakecard")]  # one open
    assert len(writes) == 2
    np.testing.assert_array_equal(writes[0][1], wave)


def test_sounddevice_record_returns_mono(fake_sounddevice):
    from radiorust_tpu_torch.runtime.io import SounddeviceAudioDriver
    drv = SounddeviceAudioDriver(44100.0, channels=2)
    data = drv.record(128)
    assert data.shape == (128,) and data.dtype == np.float32
    opens = [e for e in fake_sounddevice._log if e[0] == "in"]
    assert opens == [("in", 44100.0, 2, "float32", None)]


def test_audio_player_over_sounddevice(fake_sounddevice):
    """AudioPlayer drives the real SounddeviceAudioDriver.play body
    (cpal.rs:84-171 analog), real part extracted, rate asserted."""
    from radiorust_tpu_torch.runtime.io import AudioPlayer, SounddeviceAudioDriver

    async def main():
        drv = SounddeviceAudioDriver(48000.0)
        player = AudioPlayer(drv)
        wave = (np.cos(np.arange(512) * 0.05)
                + 1j * np.sin(np.arange(512) * 0.05)).astype(np.complex64)
        src = ArraySource(wave, chunk_len=512, sample_rate=48000.0)
        player.feed_from(src)
        await until(lambda: any(e[0] == "write"
                                for e in fake_sounddevice._log))
        write = next(e for e in fake_sounddevice._log if e[0] == "write")
        np.testing.assert_allclose(write[1], wave.real, atol=1e-6)

    run(main())


def test_audio_recorder_over_sounddevice(fake_sounddevice):
    from radiorust_tpu_torch.runtime.io import AudioRecorder, SounddeviceAudioDriver

    async def main():
        drv = SounddeviceAudioDriver(48000.0)
        rec = AudioRecorder(drv, chunk_len=256)
        sink = ArraySink()
        sink.feed_from(rec)
        await until(lambda: len(sink.samples) >= 256)
        got = sink.samples[:256]
        np.testing.assert_allclose(
            got.real, np.linspace(0, 1, 256, dtype=np.float32), atol=1e-6)
        assert np.all(got.imag == 0)
        assert sink.sample_rate == 48000.0

    run(main())
