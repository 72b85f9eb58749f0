"""Morse transmit chains (PyTorch port of the JAX package's
``models/morse_tx.py``).

- :func:`morse_audio_chain`: keyer envelope -> SlewRateLimiter(100) ->
  100 Hz low-pass Filter -> GainControl(0.5) -> FreqShifter(+700 Hz):
  the audio tone.
- :func:`morse_rf_chain`: the same feeding an FM modulator for RF.

The keyer stays on the host (:class:`radiorust_tpu_torch.blocks.morse.
Keyer`): it is control logic generating the on/off envelope, and the DSP
runs on the device.
"""

from __future__ import annotations

import numpy as np

from ..blocks.base import Chain
from ..blocks.filters import Filter, SlewRateLimiter
from ..blocks.modulation import FmMod
from ..blocks.transform import FreqShifter, GainControl

__all__ = ["morse_audio_chain", "morse_rf_chain"]


def _lowpass(cut):
    def resp(bins, freqs):
        return np.where(np.abs(freqs) <= cut, 1.0 + 0.0j, 0.0j)
    return resp


def morse_audio_chain(tone: float = 700.0, gain: float = 0.5,
                      slew_rate: float = 100.0) -> Chain:
    """Keyer envelope -> audio tone chain."""
    return Chain(
        SlewRateLimiter(slew_rate),
        Filter.new(_lowpass(100.0)),
        GainControl(gain),
        FreqShifter.with_shift(tone),
    )


def morse_rf_chain(tone: float = 700.0, gain: float = 0.5,
                   slew_rate: float = 100.0,
                   deviation: float = 2500.0) -> Chain:
    """The morse chain feeding an FM modulator for RF transmission."""
    return Chain(
        SlewRateLimiter(slew_rate),
        Filter.new(_lowpass(100.0)),
        GainControl(gain),
        FreqShifter.with_shift(tone),
        FmMod(deviation),
    )
