"""Gain and frequency shifting (PyTorch port of the JAX package's
``blocks/transform.py``; the mixer tables are designed on the host in
float64 exactly as there)."""

from __future__ import annotations

import numpy as np
import torch

from .. import numbers as _nums
from ..math import round_half_away
from ..numbers import TAU
from .base import Block, BoundBlock, StreamSig

__all__ = ["GainControl", "FreqShifter"]


class _BoundGain(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # real gain preserves realness

    def __init__(self, sig: StreamSig, gain: float):
        self.in_sig = self.out_sig = sig
        self.params = _nums.stream_real()(gain)

    def process(self, params, state, x, reset):
        return state, x * params.to(x.real.dtype)


class GainControl(Block):
    """Multiply every sample by a tunable gain."""

    def __init__(self, gain: float):
        self.gain = float(gain)

    def bind(self, sig: StreamSig) -> _BoundGain:
        return _BoundGain(sig, self.gain)


def _inner_block(chunk_len: int) -> int:
    """The divisor of ``chunk_len`` nearest 128 (oscillator factoring)."""
    best = 1
    for d in range(1, chunk_len + 1):
        if chunk_len % d == 0 and abs(d - 128) <= abs(best - 128):
            best = d
        if d > 512:
            break
    return best


def _shift_tables(chunk_len: int, denom: int, numer: int):
    """Exact factored phasor tables for one chunk: for sample
    ``n = a*inner + b``, ``osc[n] = A[a] * B[b]`` with integer phase
    indices mod ``denom`` (zero long-run drift).  float64 design, one
    rounding to complex64."""
    numer %= denom
    inner = _inner_block(chunk_len)
    outer = chunk_len // inner
    tau = 2.0 * np.pi
    b_idx = (np.arange(inner, dtype=np.int64) * numer) % denom
    a_idx = (np.arange(outer, dtype=np.int64) * inner * numer) % denom
    table_b = np.exp(1j * tau * b_idx.astype(np.float64) / denom)
    table_a = np.exp(1j * tau * a_idx.astype(np.float64) / denom)
    adv = (chunk_len * numer) % denom
    cdt = _nums.stream_complex()
    return (table_a.astype(cdt), table_b.astype(cdt), np.int32(adv))


def _shift_param_update(chunk_len: int, denom: int, sample_rate: float,
                        shift: float):
    """New mixer params for ``shift`` (shared by FreqShifter and
    MixerDecimator)."""
    numer = round_half_away((denom * shift / sample_rate))
    ta, tb, adv = _shift_tables(chunk_len, denom, numer)
    return {"table_a": ta, "table_b": tb, "adv": adv}


def fold_phase_state(state, denom: int):
    """Phase-continuous retune: fold the integer phase index into
    ``start_phase`` and restart it at 0.  Takes and returns numpy trees
    (convert with :mod:`radiorust_tpu_torch.convert`)."""
    k0 = np.asarray(state["k0"])
    start = np.asarray(state["start_phase"])
    new_start = (start + k0.astype(np.float64) * (TAU / denom)) % TAU
    return {**state,
            "k0": np.zeros(k0.shape, np.int32),
            "start_phase": np.asarray(new_start, start.dtype)}


def start_phasor(state, denom: int):
    """(cos, sin) of each stream's chunk-start phase, in float32."""
    theta0 = (state["start_phase"]
              + state["k0"].to(torch.float32)
              * torch.tensor(TAU / denom, dtype=torch.float32))
    return torch.cos(theta0), torch.sin(theta0)


class _BoundFreqShifter(BoundBlock):
    def __init__(self, sig: StreamSig, precision: float, shift: float):
        self.in_sig = self.out_sig = sig
        self.precision = float(precision)
        self.current_shift = float(shift)
        self.denom = round_half_away((sig.sample_rate / precision))
        if self.denom <= 0:
            raise ValueError("sample_rate / precision must round to >= 1")
        self.params = _shift_param_update(sig.chunk_len, self.denom,
                                          sig.sample_rate, shift)

    def init_state(self):
        b = self.in_sig.batch
        return {"k0": np.zeros((b,), np.int32),
                "start_phase": np.zeros((b,), _nums.stream_real())}

    def process(self, params, state, x, reset):
        c, s = start_phasor(state, self.denom)
        p0 = torch.complex(c, s)
        ta = params["table_a"]
        tb = params["table_b"]
        outer, inner = ta.shape[-1], tb.shape[-1]
        xb = x.reshape(x.shape[0], outer, inner)
        y = (xb * p0[:, None, None] * ta[None, :, None]
             * tb[None, None, :]).reshape(x.shape)
        new_state = {"k0": (state["k0"] + params["adv"]) % self.denom,
                     "start_phase": state["start_phase"]}
        # The oscillator runs on through events: ``reset`` is unused.
        return new_state, y

    def shift_params(self, shift: float):
        """Numpy params for a new shift."""
        self.current_shift = float(shift)
        return _shift_param_update(self.in_sig.chunk_len, self.denom,
                                   self.in_sig.sample_rate, shift)

    def retune(self, params, state, shift: float):
        """(params', state') for a phase-continuous retune (numpy trees)."""
        return self.shift_params(shift), fold_phase_state(state, self.denom)


class FreqShifter(Block):
    """Complex mixer shifting all frequencies by a rational fraction of the
    sample rate (``precision`` Hz), with exact integer phase indices."""

    def __init__(self, shift: float = 0.0, precision: float = 1.0):
        self.shift = float(shift)
        self.precision = float(precision)

    @classmethod
    def with_shift(cls, shift: float) -> "FreqShifter":
        return cls(shift=shift)

    @classmethod
    def with_precision(cls, precision: float) -> "FreqShifter":
        return cls(precision=precision)

    @classmethod
    def with_precision_and_shift(cls, precision: float,
                                 shift: float) -> "FreqShifter":
        return cls(shift=shift, precision=precision)

    def bind(self, sig: StreamSig) -> _BoundFreqShifter:
        return _BoundFreqShifter(sig, self.precision, self.shift)
