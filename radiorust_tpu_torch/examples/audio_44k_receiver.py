"""WFM receiver with 44.1 kHz audio output: the arbitrary-ratio story.

radiorust resamples between any pair of rates at any chunking through its
phase-accumulator loop (``src/blocks/resampling.rs:103-133``); sound cards
mostly want the 44.1 kHz family, which shares no convenient factors with
SDR rates (1.024 Msps / 44.1 kHz reduces to p = 10240 per q = 441).

Here the demodulated 384 kHz audio goes straight to 44.1 kHz through a
phase-mode :class:`~radiorust_tpu_torch.blocks.resampling.Downsampler`
(fixed padded output chunks and a deterministic valid schedule; the
runtime actor trims them into the gapless stream a sound card needs).
Chain:

    IQ 1.024 Msps -> shift -> decimate 384k -> LPF -> FM demod
      -> deemphasis -> Downsampler(44100)   [phase mode, p=1280/q=147]

    python -m radiorust_tpu_torch.examples.audio_44k_receiver [--device cpu]
"""

import asyncio

import numpy as np

from ..blocks.base import Chain
from ..blocks.filters import Filter
from ..blocks.modulation import FmDemod
from ..blocks.resampling import Downsampler
from ..blocks.transform import FreqShifter
from ..models.wfm import WFM_INPUT_RATE, _deemphasis_band, _lowpass_100k
from ..runtime import ArraySink, ArraySource, RuntimeBlock, wait_until
from ..runtime.blocks import resolve_device
from ._common import cli, dominant_tone

AUDIO_RATE = 44100.0
CHUNK = 16384


def make_iq(total: int) -> np.ndarray:
    """FM carrier with a 1 kHz program tone."""
    t = np.arange(total) / WFM_INPUT_RATE
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    return np.exp(1j * (2 * np.pi * 150000.0 / WFM_INPUT_RATE
                        * np.cumsum(audio))).astype(np.complex64)


async def session(device):
    iq = make_iq(32 * CHUNK)
    chain = Chain(
        FreqShifter.with_shift(0.0),
        Downsampler(384000.0, 200000.0),
        Filter.new(_lowpass_100k),
        FmDemod(150000.0),
        Filter.new_rectangular(_deemphasis_band),
        Downsampler(AUDIO_RATE, 2.0 * 18000.0),   # 384000/44100 = 1280/147
    )
    src = ArraySource(iq, chunk_len=CHUNK, sample_rate=WFM_INPUT_RATE)
    rx = RuntimeBlock(chain, device=device)
    sink = ArraySink()
    rx.feed_from(src)
    sink.feed_from(rx)
    want = int(len(iq) * AUDIO_RATE / WFM_INPUT_RATE * 0.9)
    # Fail fast if any actor dies (and count without re-concatenating).
    await wait_until(lambda: sum(len(c) for c in sink.chunks) >= want,
                     src, rx, sink, timeout=300.0)
    audio = np.real(sink.samples)
    peak = dominant_tone(audio[len(audio) // 2:], AUDIO_RATE)
    print(f"audio: {sink.sample_rate:.0f} Hz, {len(audio)} samples, "
          f"dominant tone {peak:.0f} Hz")
    if not (sink.sample_rate == AUDIO_RATE and abs(peak - 1000.0) < 30.0):
        raise AssertionError((sink.sample_rate, peak))
    return {"tone": peak, "rate": sink.sample_rate, "devices": [rx.device]}


def main(device="cuda"):
    return asyncio.run(session(resolve_device(device)))


if __name__ == "__main__":
    cli(main, __doc__)
