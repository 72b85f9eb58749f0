"""Chunk reorganization (PyTorch port of the JAX package's
``blocks/chunks.py``):

- :class:`Overlapper` concatenates the last ``chunk_count`` chunks into
  one overlapping analysis window a step.  It emits every step, with a
  zero history at first, and ``valid_from`` says from which step the
  windows are whole;
- :func:`rechunk` reshapes stacked chunks to another chunk length.
"""

from __future__ import annotations

import numpy as np
import torch

from ..numbers import stream_complex
from .base import Block, BoundBlock, StreamSig

__all__ = ["Overlapper", "rechunk"]


class _BoundOverlapper(BoundBlock):
    def __init__(self, sig: StreamSig, chunk_count: int):
        self.in_sig = sig
        self.chunk_count = chunk_count
        self.out_sig = StreamSig(sig.batch, sig.chunk_len * chunk_count,
                                 sig.sample_rate)
        self.params = ()
        #: Earlier steps include the zero history.
        self.valid_from = chunk_count - 1

    def init_state(self):
        sig = self.in_sig
        return {"hist": np.zeros((sig.batch, self.chunk_count - 1,
                                  sig.chunk_len), stream_complex())}

    def process(self, params, state, x, reset):
        # Any event clears the history.
        hist = torch.where(reset[:, None, None],
                           torch.zeros_like(state["hist"]), state["hist"])
        y = torch.cat([hist.reshape(x.shape[0], -1), x], dim=-1)
        if self.chunk_count > 1:
            new_hist = torch.cat([hist[:, 1:], x[:, None, :]], dim=1)
        else:
            new_hist = hist
        return {"hist": new_hist}, y


class Overlapper(Block):
    """Concatenate successive chunks into overlapping windows."""

    def __init__(self, chunk_count: int):
        if chunk_count <= 0:
            raise ValueError("chunk count must be positive")
        self.chunk_count = int(chunk_count)

    def bind(self, sig: StreamSig) -> _BoundOverlapper:
        return _BoundOverlapper(sig, self.chunk_count)


def rechunk(xs: torch.Tensor, new_len: int) -> torch.Tensor:
    """[T, batch, n] -> [T', batch, new_len]: each stream's samples in
    order, cut anew.  T * n must be a multiple of ``new_len``."""
    t, b, n = xs.shape
    total = t * n
    if total % new_len:
        raise ValueError(f"cannot rechunk {t}x{n} samples into {new_len}")
    flat = xs.transpose(0, 1).reshape(b, total)
    return flat.reshape(b, total // new_len, new_len).transpose(0, 1)
