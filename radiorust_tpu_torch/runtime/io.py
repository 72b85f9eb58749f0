"""Hardware I/O boundary: SDR and audio source/sink blocks (port of the
JAX package's ``runtime/io.py``; host-side, no device work).

The port's equivalent of the reference's ``src/blocks/io/`` layer.  The
reference wraps cpal (audio callbacks, ``src/blocks/io/audio/cpal.rs``) and
SoapySDR (blocking driver calls through ``spawn_blocking``,
``src/blocks/io/rf/soapysdr.rs``).  Here the hardware edge is a *driver
protocol* — blocking ``read``/``write`` calls executed on the event loop's
thread pool (the ``spawn_blocking`` analog) — with the reference's control
semantics preserved:

- :class:`SdrRx` / :class:`SdrTx` run the Request/State machine
  (``soapysdr.rs:18-31``): ``activate()`` / ``deactivate()`` are async
  calls that signal the task and await the state transition; driver errors
  surface as ``Closed(error)`` to pending control calls
  (``soapysdr.rs:160-163``).
- :class:`SdrTx` throttles writes by wall-clock chunk duration to emulate
  hardware backpressure and writes a zero sample on activation/error to
  silence the transmitter (``soapysdr.rs:219-225,322-356,367-375``).
- :class:`AudioPlayer` asserts the stream's sample rate matches the device
  rate like the cpal player (``cpal.rs:137-164``) and supports
  play/pause; :class:`AudioRecorder` produces chunks from the driver.

Real hardware boards are not present in this environment; the shipped
drivers are :class:`SyntheticSdrDriver` (signal generator),
:class:`FileSdrDriver` (raw complex64 IQ files), :class:`LoopbackSdrDriver`
(rx<-tx in process), and :class:`LoopbackAudioDriver`.  A SoapySDR- or
sounddevice-backed driver plugs in by implementing the same protocol.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional

import numpy as np

from ..signal import Event, EventHandlers, EventHandling, Samples
from .blocks import _ConsumerMixin, _ProducerMixin, _spawn
from .flow import ChannelClosed, new_receiver, new_sender

__all__ = [
    "SdrDriver", "SyntheticSdrDriver", "FileSdrDriver",
    "NativeFileSdrDriver", "LoopbackSdrDriver", "SoapySdrDriver", "SdrRx",
    "SdrTx", "AudioDriver", "LoopbackAudioDriver", "SounddeviceAudioDriver",
    "AudioPlayer", "AudioRecorder", "SdrError",
]


class SdrError(RuntimeError):
    """Driver-reported failure (the analog of ``soapysdr::Error``)."""


# ---------------------------------------------------------------------------
# Driver protocols
# ---------------------------------------------------------------------------

class SdrDriver:
    """Blocking SDR stream driver protocol (SoapySDR stream analog)."""

    sample_rate: float

    def mtu(self) -> int:
        return 8192

    def activate(self) -> None:
        pass

    def deactivate(self) -> None:
        pass

    def read(self, n: int) -> np.ndarray:
        """Blocking read of up to n complex64 samples."""
        raise NotImplementedError

    def write(self, chunk: np.ndarray) -> None:
        """Blocking write of complex64 samples."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyntheticSdrDriver(SdrDriver):
    """Signal-generator RX driver: tones + noise, optionally wall-clock
    throttled to emulate a real device's sample pacing."""

    def __init__(self, sample_rate: float, tones=((100000.0, 0.5),),
                 noise: float = 0.01, throttle: bool = False, seed: int = 0):
        self.sample_rate = float(sample_rate)
        self.tones = tones
        self.noise = noise
        self.throttle = throttle
        self._rng = np.random.default_rng(seed)
        self._pos = 0
        self._t0 = None

    def read(self, n: int) -> np.ndarray:
        t = (np.arange(self._pos, self._pos + n)) / self.sample_rate
        self._pos += n
        out = np.zeros(n, np.complex64)
        for freq, amp in self.tones:
            out += (amp * np.exp(2j * np.pi * freq * t)).astype(np.complex64)
        if self.noise:
            out += (self.noise * (self._rng.standard_normal(n)
                                  + 1j * self._rng.standard_normal(n))
                    ).astype(np.complex64)
        if self.throttle:
            if self._t0 is None:
                self._t0 = time.monotonic()
            due = self._t0 + self._pos / self.sample_rate
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        return out


class FileSdrDriver(SdrDriver):
    """Raw complex64 IQ file driver (RX reads, TX appends)."""

    def __init__(self, path: str, sample_rate: float, mode: str = "r"):
        self.sample_rate = float(sample_rate)
        self._file = open(path, "rb" if mode == "r" else "ab")
        self._mode = mode

    def read(self, n: int) -> np.ndarray:
        data = np.fromfile(self._file, np.complex64, n)
        if len(data) == 0:
            raise SdrError("end of IQ file")
        return data

    def write(self, chunk: np.ndarray) -> None:
        np.asarray(chunk, np.complex64).tofile(self._file)

    def close(self) -> None:
        self._file.close()


class NativeFileSdrDriver(SdrDriver):
    """GIL-free IQ file replay via the C++ mmap/prefetch loader
    (``radiorust_tpu_torch/native/iq_loader.cpp``).

    The native analog of the reference's FFI stream readers
    (``src/blocks/io/rf/soapysdr.rs:99-125`` — MTU-sized blocking reads on
    a worker thread): a prefetch thread faults pages one window ahead so
    ``read`` is a warm memcpy, and ctypes releases the GIL for its
    duration, overlapping the copy with block compute under the threaded
    native executor.  ``loop=True`` replays the file forever (deterministic
    soak/bench input at production rates).
    """

    def __init__(self, path: str, sample_rate: float, loop: bool = False):
        from .native import load_library  # compiles on demand
        self.sample_rate = float(sample_rate)
        lib = load_library()
        self._lib = lib
        self._h = lib.iq_open(str(path).encode(), 1 if loop else 0)
        if not self._h:
            raise SdrError(f"cannot open IQ file {path!r}")

    @property
    def total_samples(self) -> int:
        return int(self._lib.iq_size(self._h))

    def read(self, n: int) -> np.ndarray:
        import ctypes
        out = np.empty(int(n), np.complex64)
        got = self._lib.iq_read(
            self._h, out.ctypes.data_as(ctypes.c_void_p), int(n))
        if got == 0:
            raise SdrError("end of IQ file")
        return out[:got]

    def close(self) -> None:
        if self._h:
            self._lib.iq_close(self._h)
            self._h = None


class LoopbackSdrDriver(SdrDriver):
    """In-process loopback: TX writes become RX reads (for tests)."""

    def __init__(self, sample_rate: float):
        self.sample_rate = float(sample_rate)
        self._buf: List[np.ndarray] = []
        self._cv = None
        import threading
        self._cv = threading.Condition()

    def write(self, chunk: np.ndarray) -> None:
        with self._cv:
            self._buf.append(np.asarray(chunk, np.complex64).copy())
            self._cv.notify_all()

    def read(self, n: int) -> np.ndarray:
        with self._cv:
            while not self._buf:
                if not self._cv.wait(timeout=5.0):
                    raise SdrError("loopback read timeout")
            out = self._buf[0]
            if len(out) > n:
                # Keep the tail queued: a write larger than the read MTU
                # must not silently lose samples.
                self._buf[0] = out[n:]
                out = out[:n]
            else:
                self._buf.pop(0)
        return out


class SoapySdrDriver(SdrDriver):
    """Real-hardware driver over the SoapySDR Python bindings
    (import-guarded, like the reference's ``soapysdr`` cargo feature,
    ``Cargo.toml:11-17`` / ``src/blocks/io/rf/soapysdr.rs:39-125``).

    ``args`` go to ``SoapySDR.Device`` (e.g. ``dict(driver="rtlsdr")``);
    set frequency/rate/bandwidth before constructing blocks, as the
    reference's examples do (``examples/bandwidth_meter/main.rs:43-52``).
    """

    def __init__(self, args, sample_rate: float, frequency: float,
                 bandwidth: float = 0.0, channel: int = 0,
                 direction: str = "rx"):
        try:
            import SoapySDR  # type: ignore
            from SoapySDR import SOAPY_SDR_CF32, SOAPY_SDR_RX, SOAPY_SDR_TX
        except ImportError as e:  # pragma: no cover - hardware-gated
            raise ImportError(
                "SoapySdrDriver requires the SoapySDR python bindings "
                "(python3-soapysdr)") from e
        self._soapy = SoapySDR
        self.sample_rate = float(sample_rate)
        self._dir = SOAPY_SDR_RX if direction == "rx" else SOAPY_SDR_TX
        self._dev = SoapySDR.Device(args)
        self._dev.setSampleRate(self._dir, channel, self.sample_rate)
        self._dev.setFrequency(self._dir, channel, float(frequency))
        if bandwidth:
            self._dev.setBandwidth(self._dir, channel, float(bandwidth))
        self._stream = self._dev.setupStream(self._dir, SOAPY_SDR_CF32,
                                             [channel])
        self._mtu = int(self._dev.getStreamMTU(self._stream))
        self._buf = np.zeros(self._mtu, np.complex64)

    def mtu(self) -> int:
        return self._mtu

    def activate(self) -> None:
        self._dev.activateStream(self._stream)

    def deactivate(self) -> None:
        self._dev.deactivateStream(self._stream)

    def read(self, n: int) -> np.ndarray:
        # Blocking MTU-sized read (soapysdr.rs:99-125); driver errors
        # surface as SdrError -> State::Closed(err).
        sr = self._dev.readStream(self._stream, [self._buf], min(n, self._mtu))
        if sr.ret < 0:
            raise SdrError(f"readStream error {sr.ret}")
        return self._buf[: sr.ret].copy()

    def write(self, chunk: np.ndarray) -> None:
        # write_all loop (soapysdr.rs:322-356).
        data = np.ascontiguousarray(chunk, np.complex64)
        off = 0
        while off < len(data):
            sr = self._dev.writeStream(self._stream, [data[off:]],
                                       len(data) - off)
            if sr.ret < 0:
                raise SdrError(f"writeStream error {sr.ret}")
            off += sr.ret

    def close(self) -> None:
        self._dev.closeStream(self._stream)


# ---------------------------------------------------------------------------
# SDR blocks with the reference's control state machine
# ---------------------------------------------------------------------------

_INACTIVE, _ACTIVE, _CLOSED = "inactive", "active", "closed"


class _SdrControl:
    """Request/State watch-channel pair (``soapysdr.rs:18-31``)."""

    def __init__(self):
        self.request: Optional[str] = None
        self.state = _INACTIVE
        self.error: Optional[Exception] = None
        self.changed = asyncio.Event()
        self.state_changed = asyncio.Event()

    def set_request(self, req: str):
        self.request = req
        self.changed.set()

    def set_state(self, state: str, error=None):
        self.state = state
        self.error = error
        self.state_changed.set()

    async def await_state(self, want: str):
        while True:
            if self.state == _CLOSED:
                if self.state == want:
                    return
                raise SdrError(str(self.error) if self.error
                               else "stream closed")
            if self.state == want:
                return
            self.state_changed.clear()
            await self.state_changed.wait()


class SdrRx(_ProducerMixin, EventHandling):
    """SDR receive stream producer (``soapysdr.rs:39-213``).

    Reads MTU-sized chunks through the driver on the thread pool while
    active; ``activate()``/``deactivate()`` drive the state machine.
    """

    def __init__(self, driver: SdrDriver):
        self.driver = driver
        self.sender, self.sender_connector = new_sender()
        self.event_handlers = EventHandlers()
        self._ctl = _SdrControl()
        self._task = _spawn(self._run())

    async def activate(self):
        self._ctl.set_request("activate")
        await self._ctl.await_state(_ACTIVE)

    async def deactivate(self):
        self._ctl.set_request("deactivate")
        await self._ctl.await_state(_INACTIVE)

    async def close(self):
        self._ctl.set_request("close")
        await self._ctl.await_state(_CLOSED)

    async def _run(self):
        loop = asyncio.get_running_loop()
        ctl = self._ctl
        try:
            while True:
                # Idle: wait for a request (soapysdr.rs:55-64).
                while ctl.request is None:
                    ctl.changed.clear()
                    await ctl.changed.wait()
                req, ctl.request = ctl.request, None
                if req == "close":
                    await loop.run_in_executor(None, self.driver.close)
                    ctl.set_state(_CLOSED)
                    return
                if req != "activate":
                    ctl.set_state(_INACTIVE)
                    continue
                try:
                    await loop.run_in_executor(None, self.driver.activate)
                except Exception as e:
                    ctl.set_state(_CLOSED, e)
                    return
                ctl.set_state(_ACTIVE)
                mtu = self.driver.mtu()
                # Read loop (soapysdr.rs:77-126).
                while ctl.request is None:
                    try:
                        chunk = await loop.run_in_executor(
                            None, self.driver.read, mtu)
                    except Exception as e:
                        ctl.set_state(_CLOSED, e)
                        return
                    await self.sender.send(
                        Samples(self.driver.sample_rate, chunk))
                try:
                    await loop.run_in_executor(None, self.driver.deactivate)
                except Exception as e:
                    ctl.set_state(_CLOSED, e)
                    return
                ctl.set_state(_INACTIVE)
        except ChannelClosed:
            ctl.set_state(_CLOSED)
            return
        except Exception as exc:
            # Surface unexpected failures to .failure/wait_until AND to
            # pending control calls (soapysdr.rs:160-163).
            ctl.set_state(_CLOSED, exc)
            self._record_failure(exc)
            return
        finally:
            self.sender.close()


class SdrTx(_ConsumerMixin, EventHandling):
    """SDR transmit stream consumer (``soapysdr.rs:232-466``).

    Throttles writes by wall-clock chunk duration (emulating driver
    backpressure) and writes one zero sample on activation to silence the
    transmitter, as the reference does.
    """

    def __init__(self, driver: SdrDriver, throttle: bool = False):
        self.driver = driver
        self.throttle = throttle
        receiver, self.receiver_connector = new_receiver()
        self.event_handlers = EventHandlers()
        self._ctl = _SdrControl()
        self._task = _spawn(self._run(receiver))

    async def activate(self):
        self._ctl.set_request("activate")
        await self._ctl.await_state(_ACTIVE)

    async def deactivate(self):
        self._ctl.set_request("deactivate")
        await self._ctl.await_state(_INACTIVE)

    async def close(self):
        self._ctl.set_request("close")
        await self._ctl.await_state(_CLOSED)

    async def _run(self, receiver):
        loop = asyncio.get_running_loop()
        ctl = self._ctl
        zero = np.zeros(1, np.complex64)
        recv_task = None  # persistent: pending messages survive control ops
        try:
            while True:
                while ctl.request is None:
                    ctl.changed.clear()
                    await ctl.changed.wait()
                req, ctl.request = ctl.request, None
                if req == "close":
                    await loop.run_in_executor(None, self.driver.close)
                    ctl.set_state(_CLOSED)
                    return
                if req != "activate":
                    ctl.set_state(_INACTIVE)
                    continue
                try:
                    await loop.run_in_executor(None, self.driver.activate)
                    # Silence the TX carrier on start
                    # (soapysdr.rs:322-328).
                    await loop.run_in_executor(None, self.driver.write, zero)
                except Exception as e:
                    ctl.set_state(_CLOSED, e)
                    return
                ctl.set_state(_ACTIVE)
                next_due = time.monotonic()
                while ctl.request is None:
                    # Race the receive against control requests so a
                    # deactivate()/close() issued while no producer is
                    # sending doesn't hang forever.  The recv task
                    # persists across wakeups (never cancelled mid-wait),
                    # so no message is lost.
                    if recv_task is None:
                        recv_task = asyncio.ensure_future(receiver.recv())
                    ctl.changed.clear()
                    ctl_task = asyncio.ensure_future(ctl.changed.wait())
                    done, _ = await asyncio.wait(
                        {recv_task, ctl_task},
                        return_when=asyncio.FIRST_COMPLETED)
                    if ctl_task not in done:
                        ctl_task.cancel()
                    if recv_task not in done:
                        continue  # control request: outer check handles it
                    msg = recv_task.result()  # ChannelClosed -> outer except
                    recv_task = None
                    if isinstance(msg, Event):
                        self.event_handlers.invoke(msg)
                        continue
                    chunk = np.asarray(msg.chunk, np.complex64)
                    try:
                        await loop.run_in_executor(
                            None, self.driver.write, chunk)
                    except Exception as e:
                        ctl.set_state(_CLOSED, e)
                        return
                    if self.throttle:
                        # Wall-clock pacing (soapysdr.rs:340-356).
                        next_due += len(chunk) / msg.sample_rate
                        delay = next_due - time.monotonic()
                        if delay > 0:
                            await asyncio.sleep(delay)
                try:
                    await loop.run_in_executor(None, self.driver.write, zero)
                    await loop.run_in_executor(None, self.driver.deactivate)
                except Exception as e:
                    ctl.set_state(_CLOSED, e)
                    return
                ctl.set_state(_INACTIVE)
        except ChannelClosed:
            ctl.set_state(_CLOSED)
            return
        except Exception as exc:
            ctl.set_state(_CLOSED, exc)
            self._record_failure(exc)
            return
        finally:
            if recv_task is not None:
                recv_task.cancel()
                try:
                    await recv_task
                except (asyncio.CancelledError, ChannelClosed):
                    pass
            receiver.close()


# ---------------------------------------------------------------------------
# Audio
# ---------------------------------------------------------------------------

class AudioDriver:
    """Blocking audio device protocol (cpal analog)."""

    sample_rate: float

    def play(self, samples: np.ndarray) -> None:
        raise NotImplementedError

    def record(self, n: int) -> np.ndarray:
        raise NotImplementedError


class LoopbackAudioDriver(AudioDriver):
    """In-process audio loopback (played samples become recordings)."""

    def __init__(self, sample_rate: float = 48000.0):
        import threading
        self.sample_rate = float(sample_rate)
        self._buf: List[np.ndarray] = []
        self._cv = threading.Condition()
        self.played: List[np.ndarray] = []

    def play(self, samples: np.ndarray) -> None:
        s = np.asarray(samples, np.float32).copy()
        with self._cv:
            self._buf.append(s)
            self.played.append(s)
            self._cv.notify_all()

    def record(self, n: int) -> np.ndarray:
        with self._cv:
            while not self._buf:
                if not self._cv.wait(timeout=5.0):
                    return np.zeros(n, np.float32)
            out = self._buf.pop(0)
        return out


class SounddeviceAudioDriver(AudioDriver):
    """Real audio device via the ``sounddevice`` (PortAudio) package
    (import-guarded, the reference's ``cpal`` feature analog,
    ``src/blocks/io/audio/cpal.rs:84-246``)."""

    def __init__(self, sample_rate: float = 48000.0, device=None,
                 channels: int = 1):
        try:
            import sounddevice as sd  # type: ignore
        except ImportError as e:  # pragma: no cover - hardware-gated
            raise ImportError(
                "SounddeviceAudioDriver requires the sounddevice package"
            ) from e
        self._sd = sd
        self.sample_rate = float(sample_rate)
        self._out = None
        self._in = None
        self._device = device
        self._channels = channels

    def play(self, samples: np.ndarray) -> None:
        # Mono f32 blocking write, like the cpal output callback path
        # (cpal.rs:131-164); the stream opens lazily on first use.
        if self._out is None:
            self._out = self._sd.OutputStream(
                samplerate=self.sample_rate, channels=self._channels,
                dtype="float32", device=self._device)
            self._out.start()
        self._out.write(np.ascontiguousarray(samples, np.float32))

    def record(self, n: int) -> np.ndarray:
        if self._in is None:
            self._in = self._sd.InputStream(
                samplerate=self.sample_rate, channels=self._channels,
                dtype="float32", device=self._device)
            self._in.start()
        data, _overflowed = self._in.read(n)
        return data[:, 0].copy() if data.ndim == 2 else data


class AudioPlayer(_ConsumerMixin, EventHandling):
    """Plays the real part of received IQ at the device rate
    (``cpal.rs:84-171``).  Asserts stream/device sample-rate match like the
    cpal callback does."""

    def __init__(self, driver: AudioDriver):
        self.driver = driver
        self.playing = True
        receiver, self.receiver_connector = new_receiver()
        self.event_handlers = EventHandlers()
        self._task = _spawn(self._run(receiver))

    def play(self):
        self.playing = True

    def pause(self):
        self.playing = False

    async def _run(self, receiver):
        loop = asyncio.get_running_loop()
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                    continue
                if not self.playing:
                    continue
                if msg.sample_rate != self.driver.sample_rate:
                    raise AssertionError(
                        f"sample rate mismatch: stream {msg.sample_rate} "
                        f"!= device {self.driver.sample_rate}")
                samples = np.asarray(msg.chunk)
                await loop.run_in_executor(
                    None, self.driver.play,
                    np.real(samples).astype(np.float32))
        except ChannelClosed:
            return
        except Exception as exc:
            # Rate-mismatch assertion or a driver error: record it so
            # wait_until/.failure observers see the root cause instead of
            # a silent dead task.
            self._record_failure(exc)
            return
        finally:
            receiver.close()


class AudioRecorder(_ProducerMixin):
    """Produces IQ chunks (imag = 0) from the audio driver
    (``cpal.rs:174-246``)."""

    def __init__(self, driver: AudioDriver, chunk_len: int = 4096):
        self.driver = driver
        self.chunk_len = chunk_len
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run())

    async def _run(self):
        loop = asyncio.get_running_loop()
        try:
            while True:
                data = await loop.run_in_executor(
                    None, self.driver.record, self.chunk_len)
                await self.sender.send(Samples(
                    self.driver.sample_rate,
                    np.asarray(data, np.float32).astype(np.complex64)))
        except ChannelClosed:
            return
        except Exception as exc:
            self._record_failure(exc)
            return
        finally:
            self.sender.close()
