"""Wideband FM receive chain (PyTorch port of the JAX package's
``models/wfm.py``):

    IQ 1.024 Msps
      -> FreqShifter (tune) -> Downsampler to 384 kHz (bw 200 kHz)
         (or both fused: MixerDecimator)
      -> Filter low-pass +-100 kHz
      -> FmDemod (deviation 150 kHz)
      -> Filter rectangular: deemphasis 50 us, DC block, 20 Hz - 16 kHz
         (or both fused: FmDemodFilter; or all three from the low-pass on:
         FilterDemodFilter; or the deemphasis folded into the next FIR)
      -> Downsampler to 48 kHz (bw 40 kHz)
      -> GainControl (volume)
"""

from __future__ import annotations

import numpy as np

from ..blocks.base import Chain
from ..blocks.filters import Filter, deemphasis_factor
from ..blocks.modulation import FmDemod
from ..blocks.resampling import Downsampler
from ..blocks.transform import FreqShifter, GainControl
from ..windowing import Rectangular

__all__ = ["wfm_receiver", "wfm_receiver_graph", "wfm_transmitter",
           "WFM_INPUT_RATE", "WFM_INPUT_CHUNK", "WFM_AUDIO_RATE",
           "WFM_AUDIO_CHUNK"]

WFM_INPUT_RATE = 1024000.0
WFM_INPUT_CHUNK = 16384
WFM_AUDIO_RATE = 48000.0
WFM_AUDIO_CHUNK = 768


def _lowpass_100k(bins, freqs):
    return np.where(np.abs(freqs) <= 100000.0, 1.0 + 0.0j, 0.0j)


def _deemphasis_band(bins, freqs):
    # DC block (|bin| >= 1), 20 Hz..16 kHz band, 50 us deemphasis.
    keep = (np.abs(bins) >= 1) & (np.abs(freqs) >= 20.0) \
        & (np.abs(freqs) <= 16000.0)
    return np.where(keep, deemphasis_factor(50e-6, freqs), 0.0j)


def _preemphasis_band(bins, freqs):
    # The deemphasis inverted inside the audio band, so that transmit then
    # receive is flat over 20 Hz - 16 kHz.
    keep = (np.abs(bins) >= 1) & (np.abs(freqs) >= 20.0) \
        & (np.abs(freqs) <= 16000.0)
    return np.where(keep, 1.0 / deemphasis_factor(50e-6, freqs), 0.0j)


def wfm_transmitter(deviation: float = 150000.0,
                    gain: float = 1.0) -> Chain:
    """The WFM broadcast transmitter, the receive chain's inverse:

        audio 48 kHz [batch, 768]
          -> Filter rectangular: preemphasis 50 us, 20 Hz - 16 kHz band
          -> GainControl (modulation depth)
          -> Upsampler to 1.024 MHz (bw 40 kHz)   [chunk 16384]
          -> FmMod (deviation 150 kHz)

    Its 1.024 Msps IQ chunks fit :func:`wfm_receiver`."""
    from ..blocks.modulation import FmMod
    from ..blocks.resampling import Upsampler
    return Chain(
        Filter.new_rectangular(_preemphasis_band),
        GainControl(gain),
        Upsampler(WFM_INPUT_RATE, 2.0 * 20000.0),
        FmMod(deviation),
    )


def wfm_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                 deviation: float = 150000.0,
                 fuse_deemphasis: bool = False,
                 fuse_frontend: bool = False,
                 fuse_demod: bool = False,
                 fuse_mid: bool = False,
                 filter_ir_len=None) -> Chain:
    """The WFM receive chain as a block spec.

    ``fuse_frontend`` replaces FreqShifter + Downsampler with
    MixerDecimator; ``fuse_demod`` replaces FmDemod + the deemphasis
    Filter with FmDemodFilter; ``fuse_mid`` replaces the channel Filter,
    FmDemod and the deemphasis Filter with FilterDemodFilter;
    ``fuse_deemphasis`` folds the deemphasis filter's impulse response into
    the final decimating FIR.  ``filter_ir_len`` sets the overlap-save
    filters' IR length apart from the mid-chain chunk.
    """
    irl = filter_ir_len
    if fuse_frontend:
        from ..blocks.frontend import MixerDecimator
        head = [MixerDecimator(tune_shift, 384000.0, 200000.0)]
    else:
        head = [FreqShifter.with_shift(tune_shift),
                Downsampler(384000.0, 200000.0)]
    tail = [Downsampler(48000.0, 2.0 * 20000.0)]
    if fuse_mid:
        from ..blocks.frontend import FilterDemodFilter
        mid = [FilterDemodFilter(_lowpass_100k, deviation, _deemphasis_band,
                                 ir_len=irl)]
    elif fuse_demod:
        from ..blocks.frontend import FmDemodFilter
        mid = [Filter.new(_lowpass_100k, ir_len=irl),
               FmDemodFilter(deviation, _deemphasis_band, ir_len=irl)]
    elif fuse_deemphasis:
        mid = [Filter.new(_lowpass_100k, ir_len=irl), FmDemod(deviation)]
        tail = [Downsampler(48000.0, 2.0 * 20000.0,
                            prefilter=(_deemphasis_band, Rectangular()))]
    else:
        mid = [Filter.new(_lowpass_100k, ir_len=irl), FmDemod(deviation),
               Filter.new_rectangular(_deemphasis_band, ir_len=irl)]
    return Chain(*head, *mid, *tail, GainControl(volume))


def wfm_receiver_graph(tune_shift: float = 0.0, volume: float = 1.0,
                       deviation: float = 150000.0, quality: int = 4):
    """The WFM receiver with a spectrum tap, as one graph: the tuned,
    channel-filtered front end feeds both the audio chain and an
    analysis chain.

        iq -> shift -> decimate 384k -> LPF +-100k
               |-> demod -> deemphasis -> decimate 48k -> gain  = "audio"
               '-> Overlapper(q) -> Fourier(Kaiser)             = "spectrum"

    Returns a :class:`~radiorust_tpu_torch.blocks.graph.Graph`; bind it
    with the usual WFM input signature."""
    from ..blocks.analysis import Fourier
    from ..blocks.chunks import Overlapper
    from ..blocks.graph import Graph
    from ..windowing import Kaiser

    g = Graph()
    iq = g.input("iq")
    tuned = g.chain([FreqShifter.with_shift(tune_shift),
                     Downsampler(384000.0, 200000.0),
                     Filter.new(_lowpass_100k)], iq)
    g.output("audio", g.chain([
        FmDemod(deviation),
        Filter.new_rectangular(_deemphasis_band),
        Downsampler(48000.0, 2.0 * 20000.0),
        GainControl(volume)], tuned))
    g.output("spectrum", g.chain([
        Overlapper(quality),
        Fourier.with_window(Kaiser.with_null_at_bin(float(quality)))],
        tuned))
    return g
