"""WFM stereo receiver (PyTorch port of the JAX package's
``models/stereo.py``).

The broadcast MPX carries (L+R)/2 at 0-15 kHz, a 19 kHz pilot, and (L-R)/2
as DSB-SC on 38 kHz.  The decoder is pure dataflow, no PLL:

1. a one-sided band-pass at 18.4-19.6 kHz gives the analytic pilot
   ``p ~ A e^{j(wt+phi)}``;
2. ``p^2 / |p|^2`` is the unit 38 kHz carrier ``e^{j2(wt+phi)}``;
3. a one-sided band-pass at 23-53 kHz gives the analytic subcarrier
   ``(L-R)/2 e^{j2(wt+phi)}``;
4. ``Re(s conj(carrier)) = (L-R)/2``, matrixed with the 0-15 kHz
   low-pass (L+R)/2 into ``L + jR``.

L and R ride one complex stream, so the deemphasis filter and the 48 kHz
decimator (real impulse responses) process both ears at once.  The three
analysis bands are one :class:`FilterBank` sharing a forward transform;
the fan-in steps are :class:`Combine` nodes.  The band responses are
numpy closures (host design); the sample maps are torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks.filters import Filter, FilterBank
from ..blocks.graph import Graph, NodeRef
from ..blocks.modulation import FmDemod
from ..blocks.resampling import Downsampler
from ..blocks.transform import Combine, FreqShifter, GainControl, MapSample
from .wfm import WFM_AUDIO_RATE, _deemphasis_band, _lowpass_100k

__all__ = ["wfm_stereo_receiver", "stereo_mpx_decoder",
           "PILOT_FREQ", "MPX_RATE"]

PILOT_FREQ = 19000.0
MPX_RATE = 384000.0


def _mono_band(bins, freqs):
    return np.where(np.abs(freqs) <= 15000.0, 1.0 + 0.0j, 0.0j)


def _pilot_band(bins, freqs):
    # One-sided (positive frequencies only) -> analytic signal; the x2
    # restores the cosine's amplitude.
    keep = (freqs >= PILOT_FREQ - 600.0) & (freqs <= PILOT_FREQ + 600.0)
    return np.where(keep, 2.0 + 0.0j, 0.0j)


def _subcarrier_band(bins, freqs):
    keep = (freqs >= 23000.0) & (freqs <= 53000.0)
    return np.where(keep, 2.0 + 0.0j, 0.0j)


def _double_phase(z):
    # z^2/|z|^2 doubles the phase and normalises the amplitude; the
    # epsilon only matters while the pilot filter warms up.
    return z * z * (1.0 / (z.abs() ** 2 + 1e-12))


def _mix_subcarrier(s, c):
    return s * torch.conj(c)


def _lr_matrix(m, d):
    # m = (L+R)/2 (the real mono path), d = (L-R)/2 (the analytic mix).
    mono = m.real
    diff = d.real
    return torch.complex(mono + diff, mono - diff)


def _add_stereo_decode(g: Graph, mpx: NodeRef, separation: float,
                       volume: float, use_bank: bool = True, ir_len=None):
    """Add the MPX stereo decode nodes to ``g``; returns (stereo, pilot):
    ``L + jR`` at 48 kHz after deemphasis, and the analytic pilot at the
    MPX rate.  ``mpx`` is the real composite baseband at 384 kHz."""
    if use_bank:
        mono, pilot, sub = g.bank(
            FilterBank([_mono_band, _pilot_band, _subcarrier_band],
                       ir_len=ir_len), mpx)
    else:
        mono = g.add(Filter.new(_mono_band, ir_len=ir_len), mpx)
        pilot = g.add(Filter.new(_pilot_band, ir_len=ir_len), mpx)
        sub = g.add(Filter.new(_subcarrier_band, ir_len=ir_len), mpx)
    carrier = g.add(MapSample(_double_phase), pilot)
    diff = g.add(Combine(_mix_subcarrier), (sub, carrier))
    # Stereo separation (1 = full stereo, 0 = mono on both ears).
    diff = g.add(GainControl(separation), diff)
    stereo = g.add(Combine(_lr_matrix), (mono, diff))
    stereo = g.chain([
        Filter.new_rectangular(_deemphasis_band, ir_len=ir_len),
        Downsampler(WFM_AUDIO_RATE, 2.0 * 20000.0),
        GainControl(volume),
    ], stereo)
    return stereo, pilot


def stereo_mpx_decoder(separation: float = 1.0, volume: float = 1.0,
                       use_bank: bool = True, filter_ir_len=None) -> Graph:
    """Standalone MPX decoder: input "mpx" (real composite at 384 kHz) ->
    outputs "stereo" (L + jR at 48 kHz) and "pilot" (analytic pilot)."""
    g = Graph()
    mpx = g.input("mpx")
    stereo, pilot = _add_stereo_decode(g, mpx, separation, volume, use_bank,
                                       ir_len=filter_ir_len)
    g.output("stereo", stereo)
    g.output("pilot", pilot)
    return g


def wfm_stereo_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                        deviation: float = 150000.0,
                        separation: float = 1.0,
                        fuse_frontend: bool = False,
                        filter_ir_len=None) -> Graph:
    """Full stereo WFM receiver as one graph: IQ at 1.024 Msps -> tune ->
    decimate to 384 kHz -> +-100 kHz channel filter -> FM demod (the MPX)
    -> stereo decode.  Outputs "stereo" (L + jR at 48 kHz) and "pilot".
    ``fuse_frontend`` replaces FreqShifter + Downsampler with
    MixerDecimator, as in :func:`~radiorust_tpu_torch.models.wfm.
    wfm_receiver`."""
    g = Graph()
    iq = g.input("iq")
    if fuse_frontend:
        from ..blocks.frontend import MixerDecimator
        head = [MixerDecimator(tune_shift, MPX_RATE, 200000.0)]
    else:
        head = [FreqShifter.with_shift(tune_shift),
                Downsampler(MPX_RATE, 200000.0)]
    mpx = g.chain([*head, Filter.new(_lowpass_100k, ir_len=filter_ir_len),
                   FmDemod(deviation)], iq)
    stereo, pilot = _add_stereo_decode(g, mpx, separation, volume,
                                       ir_len=filter_ir_len)
    g.output("stereo", stereo)
    g.output("pilot", pilot)
    return g
