"""FM modulator and demodulator (PyTorch port of the JAX package's
``blocks/modulation.py``).

- :class:`FmMod`: the phase integrator ``phase += re(x) * 2*pi*dev/rate``
  as a prefix sum over the chunk (``torch.cumsum`` in float32), the
  end-of-chunk phase carried; the phase is never reset on events.
- :class:`FmDemod`: ``arg(x[n] * conj(x[n-1])) * rate/(2*pi*dev)`` with
  the previous chunk's last sample carried; after a continuity break the
  first sample repeats the last emitted value.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import numbers as _nums
from ..numbers import TAU
from .base import Block, BoundBlock, StreamSig

__all__ = ["FmMod", "FmDemod"]


class _BoundFmMod(BoundBlock):
    def __init__(self, sig: StreamSig, deviation: float):
        self.in_sig = self.out_sig = sig
        self.params = _nums.stream_real()(deviation / sig.sample_rate * TAU)

    def init_state(self):
        return {"phase": np.zeros((self.in_sig.batch,),
                                  _nums.stream_real())}

    def process(self, params, state, x, reset):
        increments = x.real * params
        theta = state["phase"][:, None] + torch.cumsum(increments, dim=-1)
        # Floor modulo, as jnp.mod: theta lands in [0, 2*pi).
        theta = torch.remainder(theta, torch.full_like(params, TAU))
        y = torch.complex(torch.cos(theta), torch.sin(theta))
        return {"phase": theta[:, -1]}, y


class FmMod(Block):
    """FM modulator with the given frequency deviation in hertz."""

    def __init__(self, deviation: float):
        self.deviation = float(deviation)

    def bind(self, sig: StreamSig) -> _BoundFmMod:
        return _BoundFmMod(sig, self.deviation)


class _BoundFmDemod(BoundBlock):
    @property
    def output_is_real(self):
        return True

    def __init__(self, sig: StreamSig, deviation: float):
        self.in_sig = self.out_sig = sig
        self.params = _nums.stream_real()(sig.sample_rate / deviation / TAU)

    def init_state(self):
        b = self.in_sig.batch
        return {"prev": np.zeros((b,), _nums.stream_complex()),
                "have_prev": np.zeros((b,), bool),
                "last_out": np.zeros((b,), _nums.stream_real())}

    def process(self, params, state, x, reset):
        have_prev = state["have_prev"] & ~reset
        shifted = torch.cat([state["prev"][:, None], x[:, :-1]], dim=1)
        prod = x * torch.conj(shifted)
        demod = torch.atan2(prod.imag, prod.real) * params
        first = torch.where(have_prev, demod[:, 0], state["last_out"])
        y = torch.cat([first[:, None], demod[:, 1:]], dim=1)
        new_state = {"prev": x[:, -1],
                     "have_prev": torch.ones_like(have_prev),
                     "last_out": y[:, -1]}
        return new_state, torch.complex(y, torch.zeros_like(y))


class FmDemod(Block):
    """Quadrature FM demodulator with the given deviation in hertz."""

    def __init__(self, deviation: float):
        self.deviation = float(deviation)

    def bind(self, sig: StreamSig) -> _BoundFmDemod:
        return _BoundFmDemod(sig, self.deviation)
