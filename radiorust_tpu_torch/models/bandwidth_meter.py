"""Bandwidth meter pipeline (PyTorch port of the JAX package's
``models/bandwidth_meter.py``): tune, decimate to 102.4 kHz, low-pass to
half the largest bandwidth, overlap ``quality`` chunks, take a windowed
FFT, then meter the occupied bandwidth of each spectrum."""

from __future__ import annotations

import numpy as np

from ..blocks.analysis import Fourier
from ..blocks.base import Chain
from ..blocks.chunks import Overlapper
from ..blocks.filters import Filter
from ..blocks.resampling import Downsampler
from ..blocks.transform import FreqShifter
from ..metering import bandwidth_torch
from ..windowing import Kaiser

__all__ = ["bandwidth_meter_chain", "measure_bandwidth"]


def bandwidth_meter_chain(freq_offset: float = 0.0,
                          max_bandwidth: float = 50000.0,
                          quality: int = 4,
                          analysis_rate: float = 102400.0,
                          fuse_frontend: bool = False) -> Chain:
    """Spectrum chain: feed 1.024 Msps IQ, get overlapped Kaiser spectra.
    ``fuse_frontend=True`` replaces the shifter and the decimator with
    :class:`~radiorust_tpu_torch.blocks.frontend.MixerDecimator` (the same
    mixer tables and decimation plan in one kernel)."""

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= max_bandwidth / 2.0,
                        1.0 + 0.0j, 0.0j)

    if fuse_frontend:
        from ..blocks.frontend import MixerDecimator
        head = [MixerDecimator(freq_offset, analysis_rate, max_bandwidth)]
    else:
        head = [FreqShifter.with_shift(freq_offset),
                Downsampler(analysis_rate, max_bandwidth)]
    return Chain(
        *head,
        Filter.new(lp),
        Overlapper(quality),
        Fourier.with_window(Kaiser.with_null_at_bin(float(quality))),
    )


def measure_bandwidth(spectra, sample_rate: float,
                      double_percentile: float = 0.01):
    """Occupied bandwidth per spectrum: [..., n] -> [...] hertz."""
    return bandwidth_torch(double_percentile, sample_rate, spectra)
