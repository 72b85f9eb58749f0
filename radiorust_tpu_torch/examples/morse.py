"""Morse transmitter (radiorust's ``examples/morse/main.rs`` analog).

Keys a message through the morse audio chain (slew limit -> 100 Hz
low-pass -> gain -> +700 Hz tone), one runtime block each, and plays it
through the audio driver (the loopback driver here; a sounddevice-backed
driver on a workstation).

    python -m radiorust_tpu_torch.examples.morse [--device cpu]
"""

import asyncio

import numpy as np

from ..blocks.filters import Filter, SlewRateLimiter
from ..blocks.morse import EndOfMessages, Speed
from ..blocks.transform import FreqShifter, GainControl
from ..runtime import KeyerSource, RuntimeBlock
from ..runtime.io import AudioPlayer, LoopbackAudioDriver
from ..runtime.blocks import resolve_device
from ._common import cli, dominant_tone


async def session(device):
    keyer = KeyerSource(4096, 48000.0, Speed.from_paris_wpm(16.0),
                        message="VVV")
    limiter = RuntimeBlock(SlewRateLimiter(100.0), device=device)
    filt = RuntimeBlock(Filter.new(
        lambda bins, freqs: np.where(np.abs(freqs) <= 100.0,
                                     1.0 + 0.0j, 0.0j)), device=device)
    volume = RuntimeBlock(GainControl(0.5), device=device)
    audio_mod = RuntimeBlock(FreqShifter.with_shift(700.0), device=device)
    driver = LoopbackAudioDriver(48000.0)
    playback = AudioPlayer(driver)

    limiter.feed_from(keyer)
    filt.feed_from(limiter)
    volume.feed_from(filt)
    audio_mod.feed_from(volume)
    playback.feed_from(audio_mod)

    await asyncio.wait_for(
        playback.wait_for_event(lambda e: isinstance(e, EndOfMessages)),
        60.0)
    audio = np.concatenate(driver.played)
    total = len(audio)
    print(f"played {total} samples "
          f"({total / 48000.0:.2f}s of keyed audio)")
    tone = dominant_tone(audio, 48000.0)
    peak = float(np.abs(audio).max())
    print(f"keyed tone {tone:.0f} Hz, peak {peak:.3f}")
    return {"samples": total, "audio": audio, "tone": tone, "peak": peak,
            "devices": [b.device for b in (limiter, filt, volume,
                                           audio_mod)]}


def main(device="cuda"):
    return asyncio.run(session(resolve_device(device)))


if __name__ == "__main__":
    cli(main, __doc__)
