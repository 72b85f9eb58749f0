"""WFM broadcast receiver (radiorust's ``examples/relm_app/simple_receiver.rs``
analog).

Feeds synthetic SDR IQ at 1.024 Msps through the WFM chain and writes the
demodulated 48 kHz audio to a sink, with an elastic Buffer bounding the
latency before playback, like the reference chain.

    python -m radiorust_tpu_torch.examples.wfm_receiver [--device cpu]
"""

import asyncio

from ..models.wfm import wfm_receiver
from ..runtime import ArraySink, Buffer, Rechunker, RuntimeBlock, wait_until
from ..runtime.io import SdrRx
from ..runtime.blocks import resolve_device
from ._common import FmToneDriver, cli, dominant_tone


async def session(device):
    sdr = SdrRx(FmToneDriver(1024000.0, tones=(), noise=0.0))
    rechunk = Rechunker(16384)
    chain = RuntimeBlock(wfm_receiver(volume=1.0), name="wfm",
                         device=device)
    buffer = Buffer(0.0, 0.0, 0.5, max_age=10.0)
    sink = ArraySink()

    rechunk.feed_from(sdr)
    chain.feed_from(rechunk)
    buffer.feed_from(chain)
    sink.feed_from(buffer)

    await sdr.activate()
    await wait_until(  # 1 s of audio; fail fast if any actor failed
        lambda: sum(len(c) for c in sink.chunks) >= 48000,
        sdr, rechunk, chain, buffer, sink)
    await sdr.deactivate()

    audio = sink.samples.real
    tone = dominant_tone(audio[4096:], 48000.0)
    print(f"output rate: {sink.sample_rate} Hz, "
          f"{len(audio)} samples, dominant tone {tone:.0f} Hz")
    return {"tone": tone, "devices": [chain.device]}


def main(device="cuda"):
    return asyncio.run(session(resolve_device(device)))


if __name__ == "__main__":
    cli(main, __doc__)
