"""Gain, squelch, AGC, elementwise maps, fan-in and frequency shifting
(PyTorch port of the JAX package's ``blocks/transform.py``; the mixer
tables are designed on the host in float64 exactly as there).  The
functions of :class:`MapSample` and :class:`Combine` take and return torch
tensors.  :class:`Squelch` runs its per-sample recurrence as an exact
log-depth associative scan (``ops/assoc_scan.py``), as the JAX package
does.  :class:`AgcControl` calls ``ops.scan.agc_step``: on CPU tensors
the same associative scan as the JAX package's block, on CUDA tensors
one launch of the AGC kernel (``csrc/scan.cu``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import numbers as _nums
from ..math import round_half_away
from ..numbers import TAU
from ..ops.assoc_scan import associative_scan
from ..ops import scan as _oscan
from .base import Block, BoundBlock, StreamSig

__all__ = ["GainControl", "AgcControl", "Squelch", "MapSample", "Nop",
           "Combine", "FreqShifter"]


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


class _BoundSquelch(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # gating by a real mask preserves realness

    def __init__(self, sig: StreamSig, threshold: float, alpha: float):
        self.in_sig = self.out_sig = sig
        rdt = _nums.stream_real()
        self.params = {"threshold": rdt(threshold), "alpha": rdt(alpha)}

    def init_state(self):
        return {"env": np.zeros((self.in_sig.batch,), _nums.stream_real())}

    def process(self, params, state, x, reset):
        # The smoothed power e[n] = alpha e[n-1] + (1-alpha) |x[n]|^2 is a
        # first-order linear recurrence: compose its per-sample affine
        # maps (a, b) with a log-depth scan.
        alpha = params["alpha"]
        e_prev = torch.where(reset, torch.zeros_like(state["env"]),
                             state["env"])
        p = (x * torch.conj(x)).real
        a = alpha.expand(p.shape)
        b = (1.0 - alpha) * p

        def comb(earlier, later):
            a1, b1 = earlier
            a2, b2 = later
            return a1 * a2, b2 + a2 * b1

        big_a, big_b = associative_scan(comb, (a, b))
        env = big_a * e_prev[:, None] + big_b
        gate = (env > params["threshold"]).to(x.real.dtype)
        return {"env": env[:, -1]}, x * gate


class Squelch(Block):
    """Mute the stream while its smoothed power sits below a threshold.

    A one-pole power envelope ``e += (1-alpha)(|x|^2 - e)`` gates the
    samples; ``threshold`` is linear power of the unit-full-scale stream.
    A stream reset clears the envelope (the gate re-opens only after the
    smoother re-converges).
    """

    def __init__(self, threshold: float = 1e-4, alpha: float = 0.999):
        if not 0.0 < alpha < 1.0:
            raise ValueError("alpha must be in (0, 1)")
        self.threshold = float(threshold)
        self.alpha = float(alpha)

    def bind(self, sig: StreamSig) -> _BoundSquelch:
        return _BoundSquelch(sig, self.threshold, self.alpha)


class _BoundAgc(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # real gain preserves realness

    def __init__(self, sig: StreamSig, reference: float, rate: float,
                 max_gain: float):
        self.in_sig = self.out_sig = sig
        rdt = _nums.stream_real()
        self.params = {"reference": rdt(reference), "rate": rdt(rate),
                       "max_gain": rdt(max_gain)}

    def init_state(self):
        return {"gain": np.ones((self.in_sig.batch,), _nums.stream_real())}

    def process(self, params, state, x, reset):
        # y[n] = g[n] x[n];  g[n+1] = clip(g[n] + rate (ref - |y[n]|)).
        # With g >= 0, |y| = |x| g, so the update is the clamped-affine map
        # g' = clip(a g + b) with a = 1 - rate |x|, b = rate ref; such maps
        # compose (``ops/scan.py::agc_step``).  The gain is a tuning state
        # and carries across stream breaks: ``reset`` is unused.
        y, gain = _oscan.agc_step(x.contiguous(), state["gain"],
                                  params["rate"], params["reference"],
                                  params["max_gain"])
        return {"gain": gain}, y


class AgcControl(Block):
    """Automatic gain control: drives the output envelope toward
    ``reference`` with loop gain ``rate`` per sample, the gain clamped to
    ``[0, max_gain]`` (``g += rate * (reference - |g*x|)``).

    On CPU tensors the loop runs as the JAX package's exact log-depth
    scan of its clamped-affine maps; on CUDA tensors as one launch of the
    AGC kernel, which composes the maps of each lane's segment, scans them
    across the block and walks each segment with the loop's own step.
    The loop contracts, and both routes match the per-sample recurrence
    to float32, while ``rate * |x| < 2``.  Under sustained overdrive
    beyond that the recurrence is chaotic: outputs and state stay finite
    and inside ``[0, max_gain]``, but are one valid shadowing of the
    chaos, not bit-reproducible against a sequential evaluation.  A NaN
    sample makes the output and the gain NaN from that sample on.
    """

    def __init__(self, reference: float = 1.0, rate: float = 1e-3,
                 max_gain: float = 65536.0):
        self.reference = float(reference)
        self.rate = float(rate)
        self.max_gain = float(max_gain)

    def bind(self, sig: StreamSig) -> _BoundAgc:
        return _BoundAgc(sig, self.reference, self.rate, self.max_gain)


class _BoundMap(BoundBlock):
    @property
    def output_is_real(self):
        return self._real_output

    def __init__(self, sig: StreamSig, fn: Callable, fn_params=None,
                 real_output: bool = False):
        self.in_sig = self.out_sig = sig
        self.fn = fn
        self._real_output = bool(real_output)
        self._parameterized = fn_params is not None
        self.params = fn_params if self._parameterized else ()

    def process(self, params, state, x, reset):
        y = self.fn(x, params) if self._parameterized else self.fn(x)
        if self._real_output and y.is_complex():
            # Enforce the declaration: downstream real paths (pair-packed
            # filters, one-plane decimation) drop the imaginary plane.
            y = torch.complex(y.real, torch.zeros_like(y.real))
        return state, y


class MapSample(Block):
    """Apply an elementwise function of torch tensors to every sample.
    :meth:`with_params` gives the function a params tree, converted to
    tensors like every other param, so it can be tuned without
    rebinding."""

    def __init__(self, fn: Callable = lambda x: x,
                 real_output: bool = False):
        self.fn = fn
        self.fn_params = None
        # A promise that ``fn`` emits zero imaginary parts, enforced by
        # truncation so that every downstream path agrees.
        self.real_output = bool(real_output)

    @classmethod
    def with_params(cls, fn: Callable, params,
                    real_output: bool = False) -> "MapSample":
        """``fn(x, params) -> y`` with ``params`` a tree of numpy leaves."""
        self = cls.__new__(cls)
        MapSample.__init__(self, fn, real_output)
        self.fn_params = params
        return self

    def bind(self, sig: StreamSig) -> _BoundMap:
        return _BoundMap(sig, self.fn, self.fn_params, self.real_output)


class Nop(MapSample):
    """Identity block forwarding samples unchanged."""

    def __init__(self):
        super().__init__(lambda x: x)


class _BoundCombine(BoundBlock):
    def __init__(self, sigs, fn: Callable, preserves_real: bool):
        sigs = tuple(sigs)
        first = sigs[0]
        for s in sigs[1:]:
            if (s.batch, s.chunk_len, s.sample_rate) != (
                    first.batch, first.chunk_len, first.sample_rate):
                raise ValueError(
                    f"Combine inputs must share one signature; got {sigs}")
        self.in_sigs = sigs
        self.in_sig = self.out_sig = first
        self.fn = fn
        self._preserves_real = preserves_real
        #: Per-input realness flags, set by the binding graph.
        self.input_is_real_flags = [False] * len(sigs)

    @property
    def output_is_real(self):
        flags = list(self.input_is_real_flags)
        if len(flags) == 1:
            # Single-input use in a chain: realness comes through the
            # scalar ``input_is_real``.
            flags[0] = flags[0] or self.input_is_real
        return self._preserves_real and all(flags)

    def process(self, params, state, xs, reset):
        if not isinstance(xs, tuple):
            xs = (xs,)  # single-input use in a chain
        return state, self.fn(*xs)


class Combine(Block):
    """Elementwise fan-in of several equal-signature streams,
    ``fn(*chunks) -> chunk``, for a graph node with several upstream nodes
    (``g.add(Combine(fn), (a, b))``).  ``preserves_real=True`` declares that
    ``fn`` maps all-real inputs to a real output."""

    def __init__(self, fn: Callable, preserves_real: bool = False):
        self.fn = fn
        self.preserves_real = bool(preserves_real)

    def bind(self, sig: StreamSig) -> _BoundCombine:
        return self.bind_multi((sig,))

    def bind_multi(self, sigs) -> _BoundCombine:
        return _BoundCombine(sigs, self.fn, self.preserves_real)


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
    """(cos, sin) of each stream's chunk-start phase, in the dtype of
    ``start_phase`` (float32; float64 under the c128 stream mode)."""
    rdt = state["start_phase"].dtype
    theta0 = (state["start_phase"]
              + state["k0"].to(rdt) * torch.tensor(TAU / denom, dtype=rdt))
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
