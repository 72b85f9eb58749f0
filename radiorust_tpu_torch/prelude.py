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

from .blocks.base import (Block, BoundBlock, Chain, StreamSig, no_reset,
                          scan)
from .blocks.channelize import Channelizer, ChannelizerDemod
from .blocks.filters import Filter, FilterBank, deemphasis_factor
from .blocks.frontend import FilterDemodFilter, FmDemodFilter, MixerDecimator
from .blocks.graph import BoundGraph, Graph, NodeRef, graph_scan
from .blocks.modulation import FmDemod
from .blocks.resampling import Downsampler
from .blocks.transform import (Combine, FreqShifter, GainControl, MapSample,
                               Nop)
from .convert import tree_to_numpy, tree_to_torch
from .windowing import CustomWindow, Kaiser, Rectangular, Window

__all__ = [
    "Block", "BoundBlock", "Chain", "StreamSig", "no_reset", "scan",
    "Channelizer", "ChannelizerDemod",
    "Filter", "FilterBank", "deemphasis_factor",
    "FilterDemodFilter", "FmDemodFilter", "MixerDecimator",
    "Graph", "BoundGraph", "NodeRef", "graph_scan",
    "FmDemod", "Downsampler", "FreqShifter", "GainControl",
    "MapSample", "Nop", "Combine",
    "tree_to_numpy", "tree_to_torch",
    "CustomWindow", "Kaiser", "Rectangular", "Window",
]
