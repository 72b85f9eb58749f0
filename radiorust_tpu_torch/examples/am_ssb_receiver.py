"""AM and SSB receivers from the block library.

radiorust ships FM demodulators only and points users at ``MapSample``
for everything else (``src/blocks/transform.rs:108-187``); these chains
are that construction: an AM envelope detector and a filter-method USB/LSB
receiver built from existing blocks, served live by the runtime.

Synthesizes an AM station (1 kHz program tone, 30 kHz offset) and an SSB
station (1.5 kHz tone) into one 256 ksps IQ stream, then runs *both*
receivers off one SDR source in lock-step (the broadcast connector fans
the stream out like ``src/flow.rs:44-52``); on a card the two actors
capture their steps in turn.  Then two programs on the two sidebands of
one carrier through the ISB graph (``isb_demo``).

    python -m radiorust_tpu_torch.examples.am_ssb_receiver [--device cpu]
"""

import asyncio

import numpy as np
import torch

from ..blocks.base import StreamSig
from ..blocks.graph import graph_scan
from ..convert import tree_to_torch
from ..models.analog import (ANALOG_INPUT_CHUNK, ANALOG_INPUT_RATE,
                             am_receiver, isb_receiver, ssb_receiver)
from ..runtime import ArraySink, Rechunker, RuntimeBlock, wait_until
from ..runtime.io import SdrRx, SyntheticSdrDriver
from ..runtime.blocks import resolve_device
from ._common import cli, dominant_tone

AM_OFFSET = 30000.0
SSB_OFFSET = -60000.0
AUDIO_RATE = 32000.0


class TwoStationDriver(SyntheticSdrDriver):
    """One AM and one USB station sharing the passband."""

    def read(self, n):
        t = (np.arange(self._pos, self._pos + n)) / self.sample_rate
        self._pos += n
        program = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
        am = 0.8 * (1.0 + program) * np.exp(2j * np.pi * AM_OFFSET * t)
        usb = 0.5 * np.exp(2j * np.pi * (SSB_OFFSET + 1500.0) * t)
        return (am + usb).astype(np.complex64)


def program_tone(chunks) -> float:
    """The dominant tone of the second half of a run of audio chunks."""
    audio = np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).real
    return dominant_tone(audio[len(audio) // 2:], AUDIO_RATE)


async def session(device):
    sdr = SdrRx(TwoStationDriver(ANALOG_INPUT_RATE, tones=(), noise=0.0))
    rechunk = Rechunker(ANALOG_INPUT_CHUNK)
    am = RuntimeBlock(am_receiver(tune_shift=-AM_OFFSET), name="am",
                      device=device)
    ssb = RuntimeBlock(ssb_receiver(tune_shift=-SSB_OFFSET), name="ssb",
                       device=device)
    am_sink, ssb_sink = ArraySink(), ArraySink()

    rechunk.feed_from(sdr)
    am.feed_from(rechunk)       # both receivers subscribe to the same
    ssb.feed_from(rechunk)      # connector -> lock-step broadcast delivery
    am_sink.feed_from(am)
    ssb_sink.feed_from(ssb)

    await sdr.activate()
    await wait_until(
        lambda: sum(len(c) for c in am_sink.chunks) >= 32000
        and sum(len(c) for c in ssb_sink.chunks) >= 32000,
        sdr, rechunk, am, ssb, am_sink, ssb_sink)
    await sdr.deactivate()

    tones = {"am": program_tone(am_sink.chunks),
             "ssb": program_tone(ssb_sink.chunks)}
    print(f"AM  program tone: {tones['am']:.0f} Hz")
    print(f"SSB program tone: {tones['ssb']:.0f} Hz")
    return {"tones": tones, "devices": [am.device, ssb.device]}


def isb_demo(device):
    """Independent-sideband reception: two programs on the two sidebands
    of ONE carrier, decoded at once through a shared-transform FilterBank
    (``models.analog.isb_receiver``: on a card one launch of the bank
    kernel filters both sidebands off one forward transform)."""
    rate, n, t_chunks, f_off = ANALOG_INPUT_RATE, ANALOG_INPUT_CHUNK, 8, 30e3
    t = np.arange(t_chunks * n) / rate
    iq = (0.5 * np.exp(2j * np.pi * (f_off + 1000.0) * t)      # USB: 1 kHz
          + 0.5 * np.exp(2j * np.pi * (f_off - 2000.0) * t)    # LSB: 2 kHz
          ).astype(np.complex64).reshape(t_chunks, 1, n)
    g = isb_receiver(tune_shift=-f_off).bind({"iq": StreamSig(1, n, rate)})
    _, ys = graph_scan(g, tree_to_torch(g.params, device),
                       tree_to_torch(g.init_state(), device),
                       {"iq": torch.from_numpy(iq).to(device)})
    tones = {}
    for name in ("usb", "lsb"):
        tones[name] = program_tone(ys[name][:, 0].cpu().numpy())
        print(f"ISB {name} program tone: {tones[name]:.0f} Hz")
    return tones


def main(device="cuda"):
    device = resolve_device(device)
    report = asyncio.run(session(device))
    report["isb"] = isb_demo(device)
    return report


if __name__ == "__main__":
    cli(main, __doc__)
