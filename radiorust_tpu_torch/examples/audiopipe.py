"""Microphone-to-speaker pipe (radiorust's ``examples/audiopipe/main.rs``
analog).

With the ``sounddevice`` package and audio hardware this pipes the default
input device to the default output; without them it runs the same two-block
pipeline on the loopback driver.  It runs on the host only, so it takes no
device.

    python -m radiorust_tpu_torch.examples.audiopipe
"""

import asyncio

import numpy as np

from ..runtime.io import (AudioPlayer, AudioRecorder, LoopbackAudioDriver,
                          SounddeviceAudioDriver)
from ._common import cli


async def session():
    try:
        driver = SounddeviceAudioDriver(48000.0)
        print("using sounddevice (real audio hardware)")
    except ImportError:
        driver = LoopbackAudioDriver(48000.0)
        print("sounddevice not installed; using in-process loopback")

    recorder = AudioRecorder(driver, chunk_len=4096)
    player = AudioPlayer(driver)
    player.feed_from(recorder)          # the whole app, like the reference

    if isinstance(driver, LoopbackAudioDriver):
        # Seed the loopback with a tone so the pipe has something to carry.
        t = np.arange(4096) / 48000.0
        driver.play(np.sin(2 * np.pi * 440.0 * t).astype(np.float32))
        await asyncio.sleep(0.5)
        print(f"piped {len(driver.played)} chunks through recorder->player")
    else:  # pragma: no cover - real hardware
        await asyncio.sleep(30.0)


def main():
    return asyncio.run(session())


if __name__ == "__main__":
    cli(main, __doc__, device=False)
