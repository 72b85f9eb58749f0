"""Spectral analysis (PyTorch port of the JAX package's
``blocks/analysis.py``): :class:`Fourier` takes a windowed FFT of each
chunk.  The window is scaled so that its energy sums to the chunk length
(energy-preserving); ``center_dc`` rotates the DC bin to index ``n//2``.
The JAX package runs this block on XLA's own FFT, so the port's route is
``torch.fft`` (cuFFT on CUDA tensors)."""

from __future__ import annotations

import numpy as np
import torch

from ..numbers import stream_real
from ..windowing import Rectangular, Window, window_table
from .base import Block, BoundBlock, StreamSig

__all__ = ["Fourier"]


class _BoundFourier(BoundBlock):
    def __init__(self, sig: StreamSig, window: Window, center_dc: bool):
        self.in_sig = self.out_sig = sig
        self.center_dc = center_dc
        n = sig.chunk_len
        w = window_table(window, n)
        # Scaled so that sum(w^2) == n.
        w = w * np.sqrt(n / np.sum(w * w))
        self.window_values = np.asarray(w, stream_real())
        self.params = ()
        self._window = {}

    def _window_on(self, device) -> torch.Tensor:
        """The window table on ``device``, uploaded once (a bind-time
        constant, as in the JAX package)."""
        key = str(device)
        if key not in self._window:
            self._window[key] = torch.from_numpy(self.window_values).to(
                device)
        return self._window[key]

    def process(self, params, state, x, reset):
        y = torch.fft.fft(x * self._window_on(x.device))
        if self.center_dc:
            y = torch.roll(y, self.in_sig.chunk_len // 2, dims=-1)
        return state, y.to(x.dtype)


class Fourier(Block):
    """Windowed FFT of each chunk."""

    def __init__(self, window: Window = None, center_dc: bool = False):
        self.window = window if window is not None else Rectangular()
        self.center_dc = center_dc

    @classmethod
    def new_center_dc(cls) -> "Fourier":
        return cls(center_dc=True)

    @classmethod
    def with_window(cls, window: Window) -> "Fourier":
        return cls(window=window)

    @classmethod
    def with_window_center_dc(cls, window: Window) -> "Fourier":
        return cls(window=window, center_dc=True)

    def bind(self, sig: StreamSig) -> _BoundFourier:
        return _BoundFourier(sig, self.window, self.center_dc)
