"""AM and SSB receive chains (PyTorch port of the JAX package's
``models/analog.py``).

Each is built from existing blocks: tune with ``FreqShifter``,
channel-select with ``Downsampler``, shape with ``Filter``, and
demodulate with a ``MapSample`` of torch ops.

- :func:`am_receiver`: envelope detector; ``|x|`` is insensitive to a
  residual carrier offset or phase, and the audio band-pass removes the
  carrier's DC term.
- :func:`ssb_receiver`: filter-method SSB (USB/LSB): a one-sided
  ``Filter`` selects the sideband (gain 2 restores the half lost to the
  cut), then ``Re(x)`` collapses the analytic signal back to audio.
- :func:`isb_receiver`: both sidebands of one suppressed carrier, split
  by one two-band ``FilterBank`` in a ``Graph``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks.base import Chain
from ..blocks.filters import Filter, FilterBank
from ..blocks.graph import Graph
from ..blocks.resampling import Downsampler
from ..blocks.transform import AgcControl, FreqShifter, GainControl, MapSample

__all__ = ["am_receiver", "ssb_receiver", "isb_receiver",
           "ANALOG_INPUT_RATE", "ANALOG_INPUT_CHUNK",
           "ANALOG_AUDIO_RATE", "ANALOG_AUDIO_CHUNK"]

ANALOG_INPUT_RATE = 256000.0
ANALOG_INPUT_CHUNK = 8192
ANALOG_AUDIO_RATE = 32000.0
ANALOG_AUDIO_CHUNK = 1024


def _envelope(x):
    mag = torch.abs(x)
    return torch.complex(mag, torch.zeros_like(mag))


def _real_part(x):
    re = x.real
    return torch.complex(re, torch.zeros_like(re))


def _audio_band(low: float, high: float):
    def resp(bins, freqs):
        keep = (np.abs(bins) >= 1) & (np.abs(freqs) >= low) \
            & (np.abs(freqs) <= high)
        return np.where(keep, 1.0 + 0.0j, 0.0j)
    return resp


def _sideband(low: float, high: float, lsb: bool):
    lo, hi = (-high, -low) if lsb else (low, high)

    def resp(bins, freqs):
        keep = (freqs >= lo) & (freqs <= hi)
        # Gain 2 restores the amplitude lost by discarding the conjugate
        # half of the (real) audio spectrum.
        return np.where(keep, 2.0 + 0.0j, 0.0j)
    return resp


def _volume(volume: float, agc: bool):
    return (AgcControl(reference=volume, rate=1e-2) if agc
            else GainControl(volume))


def am_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                audio_low: float = 20.0, audio_high: float = 5000.0,
                agc: bool = False) -> Chain:
    """AM broadcast receiver.

    IQ at 256 ksps -> FreqShifter (center the carrier) -> Downsampler to
    32 ksps (10 kHz channel) -> envelope ``|x|`` -> audio band-pass (its
    DC notch removes the carrier term) -> gain or AGC.  The output is the
    real audio stream at 32 ksps; realness propagates, so the audio
    filter pair-packs two streams per transform.
    """
    return Chain(
        FreqShifter(tune_shift),
        Downsampler(ANALOG_AUDIO_RATE, 2.0 * audio_high),
        MapSample(_envelope, real_output=True),
        # Rectangular (exact bin-sampled) response: a windowed impulse
        # response smears the one-bin DC notch and lets the large carrier
        # term leak into the audio.
        Filter.new_rectangular(_audio_band(audio_low, audio_high)),
        _volume(volume, agc),
    )


def ssb_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                 lsb: bool = False, audio_low: float = 100.0,
                 audio_high: float = 3100.0, agc: bool = False) -> Chain:
    """Single-sideband receiver (filter method), USB by default.

    IQ at 256 ksps -> FreqShifter (suppressed carrier to DC) ->
    Downsampler to 32 ksps -> one-sided sideband Filter (``[audio_low,
    audio_high]`` above the carrier, or below it for LSB) -> ``Re(x)`` ->
    gain or AGC.
    """
    return Chain(
        FreqShifter(tune_shift),
        Downsampler(ANALOG_AUDIO_RATE, 2.0 * audio_high),
        Filter.new(_sideband(audio_low, audio_high, lsb)),
        MapSample(_real_part, real_output=True),
        _volume(volume, agc),
    )


def isb_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                 audio_low: float = 100.0, audio_high: float = 3100.0,
                 agc: bool = False) -> Graph:
    """Independent-sideband receiver: two programs on the upper and lower
    sidebands of one suppressed carrier, decoded together.

    Two filter-method SSB receivers share everything up to the sideband
    split, which is one :class:`FilterBank` (one forward transform, one
    history) instead of two filters; each band equals the standalone
    :func:`ssb_receiver` of that sideband.  Returns a :class:`Graph` with
    input ``"iq"`` (256 ksps) and real-audio outputs ``"usb"`` and
    ``"lsb"`` at 32 ksps.
    """
    g = Graph()
    iq = g.input("iq")
    common = g.chain([
        FreqShifter(tune_shift),
        Downsampler(ANALOG_AUDIO_RATE, 2.0 * audio_high),
    ], iq)
    usb_band = _sideband(audio_low, audio_high, lsb=False)
    lsb_band = _sideband(audio_low, audio_high, lsb=True)
    usb, lsb = g.bank(FilterBank([usb_band, lsb_band]), common)
    for name, node in (("usb", usb), ("lsb", lsb)):
        audio = g.add(MapSample(_real_part, real_output=True), node)
        g.output(name, g.add(_volume(volume, agc), audio))
    return g
