"""WFM *stereo* receiver: decodes L and R from a broadcast-standard MPX.

Beyond the mono-only reference (radiorust's
``examples/relm_app/simple_receiver.rs`` plays the composite as mono): the
driver below synthesizes a stereo FM broadcast (mono + 19 kHz pilot +
38 kHz DSB-SC difference), and the ``wfm_stereo_receiver`` graph (tuner,
FM demod, pilot-locked stereo decode, deemphasis per ear) is served live
by a ``RuntimeGraph`` actor, one stream.  L rides the real plane, R the
imaginary plane of the "stereo" output; the "pilot" output gates a stereo
indicator.

    python -m radiorust_tpu_torch.examples.stereo_receiver [--device cpu]
"""

import asyncio

import numpy as np

from ..models.stereo import PILOT_FREQ, wfm_stereo_receiver
from ..runtime import ArraySink, Rechunker, RuntimeGraph, wait_until
from ..runtime.io import SdrRx, SyntheticSdrDriver
from ..runtime.blocks import resolve_device
from ._common import cli, dominant_tone


class StereoFmDriver(SyntheticSdrDriver):
    """Synthesizes a stereo FM broadcast: 1 kHz on the left ear, 2.5 kHz
    on the right, standard MPX framing, 150 kHz deviation."""

    _phase = 0.0

    def read(self, n):
        t = (np.arange(self._pos, self._pos + n)) / self.sample_rate
        self._pos += n
        left = 0.25 * np.sin(2 * np.pi * 1000.0 * t)
        right = 0.15 * np.sin(2 * np.pi * 2500.0 * t)
        th = 2 * np.pi * PILOT_FREQ * t
        mpx = (0.5 * (left + right)
               + 0.5 * (left - right) * np.cos(2 * th)
               + 0.1 * np.cos(th))
        phase = self._phase + np.cumsum(
            2 * np.pi * 150000.0 * mpx / self.sample_rate)
        self._phase = float(phase[-1]) % (2 * np.pi)
        return np.exp(1j * phase).astype(np.complex64)


async def session(device):
    sdr = SdrRx(StereoFmDriver(1024000.0, tones=(), noise=0.0))
    rechunk = Rechunker(16384)
    rx = RuntimeGraph(wfm_stereo_receiver(), name="wfm_stereo",
                      device=device)
    stereo_sink = ArraySink()
    pilot_sink = ArraySink()

    rechunk.feed_from(sdr)
    rx.feed_from(rechunk)
    stereo_sink.feed_from(rx.out("stereo"))
    pilot_sink.feed_from(rx.out("pilot"))

    await sdr.activate()
    await wait_until(  # 0.5 s of audio; fail fast if any actor failed
        lambda: sum(len(c) for c in stereo_sink.chunks) >= 24000,
        sdr, rechunk, rx, stereo_sink, pilot_sink)
    await sdr.deactivate()

    audio = stereo_sink.samples[4096:]
    left = dominant_tone(audio.real, 48000.0)
    right = dominant_tone(audio.imag, 48000.0)
    pilot_level = float(np.median(np.abs(pilot_sink.samples[8192:])))
    stereo_on = pilot_level > 0.05
    print(f"stereo audio: {stereo_sink.sample_rate} Hz, "
          f"{len(audio)} frames; L tone {left:.0f} Hz, "
          f"R tone {right:.0f} Hz; pilot {pilot_level:.3f} -> "
          f"{'STEREO' if stereo_on else 'mono'}")
    return {"left": left, "right": right, "pilot": pilot_level,
            "devices": [rx.device]}


def main(device="cuda"):
    return asyncio.run(session(resolve_device(device)))


if __name__ == "__main__":
    cli(main, __doc__)
