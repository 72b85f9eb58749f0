"""Flat re-export of the port's API surface.

>>> import torch
>>> from radiorust_tpu_torch.convert import tree_to_torch
>>> sig = StreamSig(batch=1, chunk_len=16, sample_rate=48000.0)
>>> chain = Chain(GainControl(0.5), FreqShifter.with_shift(0.0)).bind(sig)
>>> params = tree_to_torch(chain.params, "cpu")
>>> state = tree_to_torch(chain.init_state(), "cpu")
>>> x = torch.ones((1, 16), dtype=torch.complex64)
>>> state, y = chain.process(params, state, x, no_reset(1))
>>> complex(y[0, 0])
(0.5+0j)
"""

from .blocks.analysis import Fourier
from .blocks.base import (Block, BoundBlock, Chain, StreamSig, jit_step,
                          make_scan, no_reset, scan)
from .blocks.chunks import Overlapper, rechunk
from .blocks.channelize import Channelizer, ChannelizerDemod
from .blocks.filters import (Filter, FilterBank, SlewRateLimiter,
                             deemphasis_factor)
from .blocks.frontend import FilterDemodFilter, FmDemodFilter, MixerDecimator
from .blocks.graph import BoundGraph, Graph, NodeRef, graph_scan
from .blocks.modulation import FmDemod, FmMod
from .blocks.morse import Keyer, Speed, encode
from .blocks.resampling import Downsampler, Upsampler
from .blocks.transform import (AgcControl, Combine, FreqShifter, GainControl,
                               MapSample, Nop, Squelch)
from .convert import tree_to_numpy, tree_to_torch
from .metering import (bandwidth, bandwidth_torch, level, level_torch,
                       rescale_energy, rescale_energy_torch)
from .signal import (BufferOverflow, Disconnection, Event, Samples,
                     SamplesLost, Warmup)
from .windowing import CustomWindow, Kaiser, Rectangular, Window

__all__ = [
    "Block", "BoundBlock", "Chain", "StreamSig", "no_reset", "scan",
    "jit_step", "make_scan", "Fourier", "Overlapper", "rechunk",
    "Channelizer", "ChannelizerDemod",
    "Filter", "FilterBank", "SlewRateLimiter", "deemphasis_factor",
    "FilterDemodFilter", "FmDemodFilter", "MixerDecimator",
    "Graph", "BoundGraph", "NodeRef", "graph_scan",
    "FmMod", "FmDemod", "Keyer", "Speed", "encode", "Downsampler",
    "Upsampler",
    "AgcControl", "FreqShifter", "GainControl", "MapSample", "Nop",
    "Combine", "Squelch",
    "tree_to_numpy", "tree_to_torch",
    "level", "bandwidth", "rescale_energy", "level_torch",
    "bandwidth_torch", "rescale_energy_torch",
    "Event", "Samples", "Disconnection", "SamplesLost", "BufferOverflow",
    "Warmup",
    "CustomWindow", "Kaiser", "Rectangular", "Window",
]
