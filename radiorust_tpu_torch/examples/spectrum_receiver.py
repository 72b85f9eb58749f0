"""WFM receiver with a live spectrum and bandwidth readout from one graph.

The radiorust way to get this shape is broadcasting the tuned stream to
two consumer chains (audio playback and analysis, ``src/flow.rs:44-52``,
``examples/bandwidth_meter/main.rs:54-94``).  Here the whole fan-out graph
(the shared tuned front end, the audio tail, and an Overlapper -> Fourier
spectrum tap, ``wfm_receiver_graph``) is one binding served by a
``RuntimeGraph`` actor that publishes "audio" and "spectrum" on separate
capacity-1 senders; on a card each chunk is one replay of its CUDA graph.
Occupied bandwidth is metered on each spectrum like the reference's
bandwidth_meter app.

    python -m radiorust_tpu_torch.examples.spectrum_receiver [--device cpu]
"""

import asyncio

import numpy as np

from ..metering import bandwidth
from ..models.wfm import wfm_receiver_graph
from ..runtime import ArraySink, Rechunker, RuntimeGraph, wait_until
from ..runtime.io import SdrRx
from ..runtime.blocks import resolve_device
from ._common import FmToneDriver, cli, dominant_tone


async def session(device):
    sdr = SdrRx(FmToneDriver(1024000.0, tones=(), noise=0.0))
    rechunk = Rechunker(16384)
    rx = RuntimeGraph(wfm_receiver_graph(quality=4), name="wfm_graph",
                      device=device)
    audio_sink = ArraySink()
    spectrum_sink = ArraySink()

    rechunk.feed_from(sdr)
    rx.feed_from(rechunk)
    audio_sink.feed_from(rx.out("audio"))
    spectrum_sink.feed_from(rx.out("spectrum"))

    await sdr.activate()
    await wait_until(  # 0.5 s of audio; fail fast if any actor failed
        lambda: sum(len(c) for c in audio_sink.chunks) >= 24000,
        sdr, rechunk, rx, audio_sink, spectrum_sink)
    await sdr.deactivate()

    audio = audio_sink.samples.real
    tone = dominant_tone(audio[4096:], 48000.0)
    # Occupied bandwidth from the newest spectrum chunk, like
    # radiorust's examples/bandwidth_meter/main.rs:76-94.
    bw = bandwidth(0.01, spectrum_sink.sample_rate,
                   np.asarray(spectrum_sink.chunks[-1]))
    print(f"audio: {audio_sink.sample_rate} Hz, {len(audio)} samples, "
          f"dominant tone {tone:.0f} Hz; "
          f"occupied bandwidth {bw / 1000.0:.1f} kHz")
    return {"tone": tone, "bandwidth": bw, "devices": [rx.device]}


def main(device="cuda"):
    return asyncio.run(session(resolve_device(device)))


if __name__ == "__main__":
    cli(main, __doc__)
