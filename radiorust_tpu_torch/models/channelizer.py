"""Multi-channel wideband receiver (PyTorch port of the JAX package's
``models/channelizer.py``): one 64-way polyphase filterbank, then an FM
demod on every channel, the channels riding the batch axis."""

from __future__ import annotations

from ..blocks.base import Chain
from ..blocks.channelize import Channelizer, ChannelizerDemod
from ..blocks.modulation import FmDemod
from ..blocks.transform import GainControl

__all__ = ["channelized_receiver"]


def channelized_receiver(num_channels: int = 64,
                         taps_per_branch: int = 8,
                         deviation_fraction: float = 0.25,
                         input_rate: float = 16384000.0,
                         fuse: bool = False) -> Chain:
    """Channelize -> per-channel quadrature FM demod -> gain.

    ``deviation_fraction`` scales the FM deviation to the channel
    bandwidth (``input_rate / num_channels``).  ``fuse=True`` replaces
    Channelizer + FmDemod with :class:`ChannelizerDemod` (one kernel).
    """
    channel_rate = input_rate / num_channels
    deviation = deviation_fraction * channel_rate
    if fuse:
        return Chain(ChannelizerDemod(num_channels, deviation,
                                      taps_per_branch),
                     GainControl(1.0))
    return Chain(Channelizer(num_channels, taps_per_branch),
                 FmDemod(deviation), GainControl(1.0))
