"""Interactive WFM tuner (radiorust's ``examples/relm_app/`` analog,
terminal UI).

Runs the WFM receive chain live from a synthetic two-station SDR driver
and takes commands on stdin while streaming:

    f <hz>    retune the frequency shifter (phase-continuous)
    v <gain>  set the volume
    b         print the occupied bandwidth of the current pass band
    q         quit

A retune (``RuntimeBlock.set_shift``) rewrites the host params and the
carried phase state; on a card the next chunk uploads the new params and
recaptures the binding's CUDA graph.  A volume change edits the params
too, and they upload again.

With ``--auto`` it runs a scripted session (the smoke test).

    python -m radiorust_tpu_torch.examples.tuner --auto [--device cpu]
"""

import asyncio
import sys

import numpy as np

from ..metering import bandwidth, level
from ..models.wfm import wfm_receiver
from ..runtime import ArraySink, Rechunker, RuntimeBlock
from ..runtime.io import SdrRx, SyntheticSdrDriver
from ..runtime.blocks import resolve_device
from ._common import cli, dominant_tone

VOLUME_REL = 0.1    # --auto: audio RMS ratio after a volume change vs 2


class MultiStationDriver(SyntheticSdrDriver):
    """Two FM stations at +200 kHz (800 Hz tone) and -150 kHz (2.4 kHz)."""

    def __init__(self):
        super().__init__(1024000.0, tones=(), noise=0.002)
        self._phases = [0.0, 0.0]
        self._stations = [(200000.0, 800.0), (-150000.0, 2400.0)]

    def read(self, n):
        t = (np.arange(self._pos, self._pos + n)) / self.sample_rate
        self._pos += n
        out = np.zeros(n, np.complex64)
        for i, (carrier, audio_f) in enumerate(self._stations):
            audio = 0.5 * np.sin(2 * np.pi * audio_f * t)
            dphi = 2 * np.pi * (carrier + 150000.0 * audio) / self.sample_rate
            phase = self._phases[i] + np.cumsum(dphi)
            self._phases[i] = float(phase[-1]) % (2 * np.pi)
            out += np.exp(1j * phase).astype(np.complex64)
        out += (self.noise * self._rng.standard_normal(n)).astype(np.complex64)
        return out


async def session(device, auto: bool):
    sdr = SdrRx(MultiStationDriver())
    rechunk = Rechunker(16384)
    chain = RuntimeBlock(wfm_receiver(), name="wfm", device=device)
    sink = ArraySink()
    rechunk.feed_from(sdr)
    chain.feed_from(rechunk)
    sink.feed_from(chain)
    await sdr.activate()

    async def recent(k=4):
        """The newest k chunks of audio, after a change: two chunks in
        flight are dropped."""
        sink.chunks.clear()
        while len(sink.chunks) < k + 2:
            if chain.failure is not None:
                raise RuntimeError("wfm failed") from chain.failure
            await asyncio.sleep(0.05)
        return np.concatenate(sink.chunks[-k:]).real

    async def handle(cmd: str) -> bool:
        cmd = cmd.strip()
        if not cmd:
            return True
        if cmd.startswith("f "):
            shift = float(cmd[2:])
            # Down-shift the wanted carrier to baseband.
            chain.set_shift(-shift)
            sink.chunks.clear()
            print(f"tuned to {shift:+.0f} Hz")
        elif cmd.startswith("v "):
            chain.set_gain(float(cmd[2:]))
            print("volume set")
        elif cmd == "b":
            audio = (np.concatenate(sink.chunks[-4:])
                     if len(sink.chunks) >= 4 else None)
            if audio is None:
                print("no audio yet")
            else:
                # Occupied bandwidth of the demodulated pass band, like
                # radiorust's examples/bandwidth_meter/main.rs:76-94.
                bins = np.fft.fft(audio * np.hanning(len(audio)))
                bw = bandwidth(0.01, sink.sample_rate, bins)
                lvl = 10 * np.log10(max(level(audio), 1e-12))
                print(f"occupied bandwidth {bw:.0f} Hz "
                      f"(audio level {lvl:.1f} dB)")
        elif cmd == "q":
            return False
        return True

    report = {"devices": [chain.device]}
    if auto:
        t0 = dominant_tone(await recent(), sink.sample_rate)
        print(f"untuned dominant audio tone: {t0:.0f} Hz")
        await handle("f 200000")
        t1 = dominant_tone(await recent(), sink.sample_rate)
        print(f"tuned to +200 kHz station: {t1:.0f} Hz (expect ~800)")
        await handle("b")
        await handle("v 0.25")
        quiet = float(np.sqrt(np.mean((await recent()) ** 2)))
        await handle("v 0.5")
        loud = float(np.sqrt(np.mean((await recent()) ** 2)))
        print(f"volume 0.25 -> 0.5: audio RMS {quiet:.4f} -> {loud:.4f} "
              f"(x{loud / quiet:.3f}, expect x2)")
        await handle("f -150000")
        t2 = dominant_tone(await recent(), sink.sample_rate)
        print(f"tuned to -150 kHz station: {t2:.0f} Hz (expect ~2400)")
        if not (abs(t1 - 800.0) < 40 and abs(t2 - 2400.0) < 60
                and abs(loud / quiet / 2.0 - 1.0) < VOLUME_REL):
            raise AssertionError((t1, t2, loud / quiet))
        print("auto session OK")
        report.update(tones=(t0, t1, t2), volume_ratio=loud / quiet)
    else:
        loop = asyncio.get_running_loop()
        print("commands: f <hz> | v <gain> | b | q")
        while True:
            line = await loop.run_in_executor(None, sys.stdin.readline)
            if not line or not await handle(line):
                break
    await sdr.deactivate()
    return report


def main(device="cuda", auto: bool = False):
    return asyncio.run(session(resolve_device(device), auto))


if __name__ == "__main__":
    cli(main, __doc__, "--auto")
