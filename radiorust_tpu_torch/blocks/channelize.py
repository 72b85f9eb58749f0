"""Channelizer blocks (PyTorch port of the JAX package's
``blocks/channelize.py``): one wideband stream -> M narrowband streams.

The M output channels fold into the batch axis, ``[batch, n]`` ->
``[batch * M, n / M]`` at ``rate / M``, so per-channel blocks compose
downstream as ordinary batched blocks.  Channel ``c`` of stream ``b`` is
row ``b * M + c``.

- :class:`Channelizer`: the polyphase filterbank alone
  (:func:`radiorust_tpu_torch.ops.channelizer.pfb_channelize`);
- :class:`ChannelizerDemod`: equals ``Chain(Channelizer(M, K),
  FmDemod(dev))`` in one kernel
  (:func:`radiorust_tpu_torch.ops.channelizer.pfb_demod_step`, which
  also writes the new history and last outputs); it raises at bind where
  the kernel does not take the geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import numbers as _nums
from ..numbers import TAU
from ..ops import channelizer as _ochan
from .base import Block, BoundBlock, StreamSig

__all__ = ["Channelizer", "ChannelizerDemod"]


class _BoundChannelizer(BoundBlock):
    def __init__(self, sig: StreamSig, m: int, k: int):
        if sig.chunk_len % m:
            raise ValueError(
                f"chunk_len {sig.chunk_len} must be divisible by "
                f"num_channels {m}")
        self.in_sig = sig
        self.m = m
        self.k = k
        self.hist_len = (k - 1) * m
        self.out_sig = StreamSig(sig.batch * m, sig.chunk_len // m,
                                 sig.sample_rate / m)
        proto = _ochan.design_prototype(m, k)
        self.params = {"taps": proto.reshape(k, m).astype(
            _nums.stream_real())}

    def init_state(self):
        return {"hist": np.zeros((self.in_sig.batch, self.hist_len),
                                 _nums.stream_complex())}

    def process(self, params, state, x, reset):
        hist = torch.where(reset[:, None], torch.zeros_like(state["hist"]),
                           state["hist"])
        xp = torch.cat([hist, x], dim=-1)
        y = _ochan.pfb_channelize(xp, params["taps"], self.m)
        y = y.reshape(x.shape[0] * self.m, self.out_sig.chunk_len)
        # hist_len 0 (K = 1): `[:, -0:]` would be the whole buffer.
        new_hist = xp[:, -self.hist_len:] if self.hist_len else state["hist"]
        return {"hist": new_hist}, y


class Channelizer(Block):
    """Critically sampled M-channel polyphase filterbank."""

    def __init__(self, num_channels: int, taps_per_branch: int = 8):
        self.num_channels = int(num_channels)
        self.taps_per_branch = int(taps_per_branch)

    def bind(self, sig: StreamSig) -> _BoundChannelizer:
        return _BoundChannelizer(sig, self.num_channels,
                                 self.taps_per_branch)


class _BoundChannelizerDemod(BoundBlock):
    """Fused PFB + per-channel FM demod.  State and semantics (continuity,
    the repeat of the last output after a break, the retunable factor) are
    the unfused blocks'.  On *empty* channels the quadrature product sits
    at the float32 noise floor, where another summation order can swing
    atan2 by about pi: such channels agree with the unfused path only in
    being finite."""

    @property
    def output_is_real(self):
        return True

    def __init__(self, sig: StreamSig, m: int, k: int, deviation: float):
        if sig.chunk_len % m:
            raise ValueError("chunk_len must be divisible by num_channels")
        if not _ochan.pfb_demod_supported(sig.chunk_len, m, k):
            raise ValueError(
                "fused PFB+demod kernel constraints unmet (needs "
                f"{_ochan.M} channels and whole frames); use "
                "Chain(Channelizer, FmDemod)")
        self.in_sig = sig
        self.m, self.k = m, k
        # (K-1)*M for the FIR window + HIST_FRAMES*M so the kernel
        # recomputes demod continuity from the raw history.
        self.hist_len = (k - 1 + _ochan.HIST_FRAMES) * m
        ch_rate = sig.sample_rate / m
        self.out_sig = StreamSig(sig.batch * m, sig.chunk_len // m, ch_rate)
        proto = _ochan.design_prototype(m, k)
        rdt = _nums.stream_real()
        self.params = {"taps": proto.reshape(k, m).astype(rdt),
                       "factor": rdt(ch_rate / deviation / TAU)}

    def init_state(self):
        b, m = self.in_sig.batch, self.m
        return {"hist": np.zeros((b, self.hist_len), _nums.stream_complex()),
                "last_out": np.zeros((b, m), _nums.stream_real()),
                "have_prev": np.zeros((b,), bool)}

    def process(self, params, state, x, reset):
        y, hist, last = _ochan.pfb_demod_step(
            state["hist"], x, reset, state["have_prev"], state["last_out"],
            params["factor"], params["taps"])
        new_state = {"hist": hist, "last_out": last,
                     "have_prev": torch.ones_like(state["have_prev"])}
        return new_state, y


class ChannelizerDemod(Block):
    """Fused channelize + FM-demodulate block."""

    def __init__(self, num_channels: int, deviation: float,
                 taps_per_branch: int = 8):
        self.num_channels = int(num_channels)
        self.taps_per_branch = int(taps_per_branch)
        self.deviation = float(deviation)

    def bind(self, sig: StreamSig) -> _BoundChannelizerDemod:
        return _BoundChannelizerDemod(sig, self.num_channels,
                                      self.taps_per_branch, self.deviation)
