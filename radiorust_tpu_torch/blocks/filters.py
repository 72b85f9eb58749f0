"""Overlap-save frequency filter, filter bank and slew-rate limiter
(PyTorch port of the JAX package's ``blocks/filters.py``).

The design pipeline is the JAX package's, on the host in float64: sample
the frequency-response closure at every DFT bin, inverse FFT, the
reference's literal half-swap (a block swap of the two floor-halves, the
last element fixed for odd n), window, rescale to the pre-window energy,
zero-pad and transform once.  The device step is one overlap-save
transform per chunk with the previous ``ir_len`` samples carried as
state; the first output chunk sees a zero history (``valid_from = 1``).
:class:`FilterBank` runs several such filters on one stream, sharing its
forward transform and its history.  :class:`SlewRateLimiter` is a
per-sample recurrence on the scan kernel (``ops/scan.py``).
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional

import numpy as np
import torch

from .. import numbers as _nums
from ..numbers import TAU
from ..ops import filter as _ofilter
from ..ops import scan as _oscan
from ..windowing import Kaiser, Rectangular, Window, window_table
from .base import Block, BoundBlock, StreamSig

__all__ = ["Filter", "FilterBank", "SlewRateLimiter", "deemphasis_factor",
           "extend_response", "design_response", "design_impulse_response"]


def deemphasis_factor(tau: float, frequency):
    """Complex gain ``1 / (1 + j*2*pi*f*tau)`` of a first-order RC
    deemphasis low-pass."""
    frequency = np.asarray(frequency, dtype=np.float64)
    return 1.0 / (1.0 + 1j * (tau * TAU * frequency))


def design_impulse_response(freq_resp: Callable, window: Window, n: int,
                            sample_rate: float) -> np.ndarray:
    """The length-n impulse response (complex128): sample the response,
    inverse FFT, literal half-swap, window, energy-renormalize."""
    max_bin = (n - 1) // 2
    bins = np.zeros(n, dtype=np.int64)
    bins[: max_bin + 1] = np.arange(max_bin + 1)
    bins[n - max_bin:] = -np.arange(max_bin, 0, -1)
    freqs = bins.astype(np.float64) * (sample_rate / n)
    gains = np.array(freq_resp(bins, freqs), dtype=np.complex128)
    if n % 2 == 0:
        gains[n // 2] = 0.0  # the Nyquist bin is never sampled
    ir = np.fft.ifft(gains)
    # Block-swap [0, half) and [half, 2*half); the last element stays for
    # odd n.  This equals fftshift for even n only.
    half = n // 2
    ir = np.concatenate([ir[half:2 * half], ir[:half], ir[2 * half:]])
    w = window_table(window, n)
    energy_pre = float(np.sum(np.abs(ir) ** 2))
    ir = ir * w
    energy_post = float(np.sum(np.abs(ir) ** 2))
    if energy_post > 0.0:
        ir = ir * np.sqrt(energy_pre / energy_post)
    return ir


def design_response(freq_resp: Callable, window: Window, n: int,
                    sample_rate: float) -> np.ndarray:
    """The extended frequency response R[2n] (complex128)."""
    ir = design_impulse_response(freq_resp, window, n, sample_rate)
    return extend_response(ir)


def extend_response(ir: np.ndarray, pad: int = None) -> np.ndarray:
    """Zero-pad an m-tap impulse response to ``pad + m`` (front zeros,
    ``pad`` defaults to m) and transform once; the complex64 round trip
    matches the reference's cast before the response FFT."""
    m = ir.shape[-1]
    if pad is None:
        pad = m
    ext = np.concatenate([np.zeros(pad, dtype=np.complex128),
                          ir.astype(_nums.stream_complex()).astype(
                              np.complex128)])
    return np.fft.fft(ext)


def _is_real_ir(ir: np.ndarray) -> bool:
    peak = max(float(np.abs(ir.real).max()), 1e-30)
    return bool(np.abs(ir.imag).max() <= 1e-9 * peak)


def _planes(z: torch.Tensor):
    return z.real.contiguous(), z.imag.contiguous()


class GridCache:
    """The response-grid planes of each response tensor a bound block is
    given, kept while that tensor lives and comes back unmodified: a step
    loop passes one params tree, so the grid is built once, and a retune
    hands in a new tensor, which builds its own.  Grids of other live
    trees stay: a captured CUDA graph (``jit_step``, ``make_scan``) holds
    its params tree and reads the grid it was captured with."""

    def __init__(self):
        self._entries = {}

    def planes(self, response: torch.Tensor):
        hit = self._entries.get(id(response))
        if (hit is None or hit[0]() is not response
                or hit[1] != response._version):
            for k in [k for k, h in self._entries.items() if h[0]() is None]:
                del self._entries[k]
            hit = (weakref.ref(response), response._version,
                   _planes(_ofilter.response_grid(response)))
            self._entries[id(response)] = hit
        return hit[2]


class _BoundFilter(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real and self._real_ir

    def __init__(self, sig: StreamSig, freq_resp: Callable, window: Window,
                 ir_len: Optional[int] = None):
        self.in_sig = self.out_sig = sig
        self.window = window
        self.valid_from = 1
        self._grid = GridCache()
        n = sig.chunk_len
        m = n if ir_len is None else int(ir_len)
        if not 0 < m <= n:
            raise ValueError(f"ir_len {m} must be in (0, chunk_len {n}]")
        self.ir_len = m
        ir = design_impulse_response(freq_resp, window, m, sig.sample_rate)
        self._real_ir = _is_real_ir(ir)
        # Whether the overlap-save kernel takes this geometry: every one
        # 32-bit sample indices reach (ops/filter.py supported).  Where it
        # does not, the block runs on CPU tensors only (the kernel's
        # wrapper raises on CUDA ones).
        self.kernel_geometry = _ofilter.supported(n, m)
        self.params = {"response":
                       extend_response(ir, pad=n).astype(
                           _nums.stream_complex())}

    def init_state(self):
        sig = self.in_sig
        return {"prev": np.zeros((sig.batch, self.ir_len),
                                 _nums.stream_complex())}

    def process(self, params, state, x, reset):
        n = self.in_sig.chunk_len
        m = self.ir_len
        prev = torch.where(reset[:, None], torch.zeros_like(state["prev"]),
                           state["prev"])
        pair_real = (self.input_is_real and self._real_ir
                     and x.shape[0] % 2 == 0)
        x_full = x
        if pair_real:
            # Two real streams share one complex transform: with a real
            # impulse response filter(a + ib) = filter(a) + i filter(b).
            x = torch.complex(x[0::2].real, x[1::2].real)
            prev = torch.complex(prev[0::2].real, prev[1::2].real)
        outr, outi = _ofilter.fused_overlap_save(
            *_planes(prev), *_planes(x),
            *self._grid.planes(params["response"]))
        y = torch.complex(outr, outi)
        if pair_real:
            yr = torch.stack([y.real, y.imag], dim=1).reshape(
                x_full.shape[0], n)
            y = torch.complex(yr, torch.zeros_like(yr))
        return {"prev": x_full[..., n - m:]}, y

    def update_params(self, freq_resp: Callable,
                      window: Optional[Window] = None):
        """Numpy params of a redesigned response (the analog of the
        reference's ``Filter::update``)."""
        w = window if window is not None else self.window
        ir = design_impulse_response(freq_resp, w, self.ir_len,
                                     self.in_sig.sample_rate)
        r = extend_response(ir, pad=self.in_sig.chunk_len)
        return {"response": r.astype(_nums.stream_complex())}


class Filter(Block):
    """Frequency filter by overlap-save fast convolution.

    ``freq_resp(bins, freqs)`` maps arrays of signed DFT bins and signed
    frequencies (Hz) to complex gains.  ``ir_len`` (default: the chunk
    length) sets the impulse-response length; each step filters a whole
    chunk against an ``ir_len`` history.
    """

    def __init__(self, freq_resp: Callable, window: Optional[Window] = None,
                 ir_len: Optional[int] = None):
        self.freq_resp = freq_resp
        self.window = (window if window is not None
                       else Kaiser.with_null_at_bin(2.0))
        self.ir_len = ir_len

    @classmethod
    def new(cls, freq_resp: Callable, ir_len: Optional[int] = None):
        return cls(freq_resp, ir_len=ir_len)

    @classmethod
    def new_rectangular(cls, freq_resp: Callable,
                        ir_len: Optional[int] = None):
        return cls(freq_resp, Rectangular(), ir_len=ir_len)

    @classmethod
    def with_window(cls, freq_resp: Callable, window: Window):
        return cls(freq_resp, window)

    def bind(self, sig: StreamSig) -> _BoundFilter:
        return _BoundFilter(sig, self.freq_resp, self.window, self.ir_len)


class _BoundFilterBank(BoundBlock):
    """K overlap-save filters sharing one forward transform and one
    history.  Each band is designed exactly as a standalone
    :class:`Filter`, so band j's output equals ``Filter(freq_resps[j])``
    on the same stream.  A graph-only multi-output block: ``process``
    returns a tuple of K chunks."""

    def __init__(self, sig: StreamSig, freq_resps, window: Window,
                 ir_len: Optional[int] = None):
        self.in_sig = self.out_sig = sig
        self.window = window
        self.valid_from = 1
        self._grid = GridCache()
        n = sig.chunk_len
        m = n if ir_len is None else int(ir_len)
        if not 0 < m <= n:
            raise ValueError(f"ir_len {m} must be in (0, chunk_len {n}]")
        self.ir_len = m
        irs = [design_impulse_response(fr, window, m, sig.sample_rate)
               for fr in freq_resps]
        self.num_outputs = len(irs)
        self.out_sigs = (sig,) * self.num_outputs
        self._real_irs = tuple(_is_real_ir(ir) for ir in irs)
        # Whether the bank kernel takes this geometry (ops/filter.py
        # bank_supported); where it does not, the block runs on CPU
        # tensors only (the kernel's wrapper raises on CUDA ones).
        self.kernel_geometry = _ofilter.bank_supported(
            n, self.num_outputs, m, sig.batch)
        self.params = {"responses": np.stack(
            [extend_response(ir, pad=n).astype(_nums.stream_complex())
             for ir in irs])}

    @property
    def outputs_real(self):
        return tuple(self.input_is_real and r for r in self._real_irs)

    def init_state(self):
        sig = self.in_sig
        return {"prev": np.zeros((sig.batch, self.ir_len),
                                 _nums.stream_complex())}

    def process(self, params, state, x, reset):
        n = self.in_sig.chunk_len
        m = self.ir_len
        prev = torch.where(reset[:, None], torch.zeros_like(state["prev"]),
                           state["prev"])
        outr, outi = _ofilter.fused_filter_bank(
            *_planes(prev), *_planes(x),
            *self._grid.planes(params["responses"]))
        ys = torch.complex(outr, outi).unbind(1)
        return {"prev": x[..., n - m:]}, tuple(ys)

    def update_params(self, freq_resps, window: Optional[Window] = None):
        """Numpy params of every band's redesigned response."""
        w = window if window is not None else self.window
        return {"responses": np.stack(
            [extend_response(
                design_impulse_response(fr, w, self.ir_len,
                                        self.in_sig.sample_rate),
                pad=self.in_sig.chunk_len).astype(_nums.stream_complex())
             for fr in freq_resps])}


class FilterBank(Block):
    """Several :class:`Filter` bands over one stream, sharing the forward
    transform: a multi-output block for
    :meth:`radiorust_tpu_torch.blocks.graph.Graph.bank`, which returns one
    node per band."""

    def __init__(self, freq_resps, window: Optional[Window] = None,
                 ir_len: Optional[int] = None):
        self.freq_resps = tuple(freq_resps)
        if not self.freq_resps:
            raise ValueError("FilterBank needs at least one band")
        self.window = (window if window is not None
                       else Kaiser.with_null_at_bin(2.0))
        self.num_outputs = len(self.freq_resps)
        self.ir_len = ir_len

    def bind(self, sig: StreamSig) -> _BoundFilterBank:
        return _BoundFilterBank(sig, self.freq_resps, self.window,
                                self.ir_len)


class _BoundSlewRateLimiter(BoundBlock):
    def __init__(self, sig: StreamSig, slew_rate: float):
        self.in_sig = self.out_sig = sig
        self.params = _nums.stream_real()(slew_rate)

    def init_state(self):
        return {"prev": np.zeros((self.in_sig.batch,), _nums.stream_complex())}

    def process(self, params, state, x, reset):
        # Each output feeds the next clamp, so the sample loop runs in the
        # scan kernel (rsqrt form); events do not reset the limiter.  The
        # divisor is a tensor: a scalar one would be a reciprocal multiply
        # on CUDA, one rounding away from the JAX package's division.
        max_diff = params / torch.full_like(params, self.in_sig.sample_rate)
        yr, yi, pr, pi = _oscan.slew_scan(
            *_planes(x), *_planes(state["prev"]), max_diff, rsqrt=True)
        return {"prev": torch.complex(pr, pi)}, torch.complex(yr, yi)


class SlewRateLimiter(Block):
    """Limits the slew rate of IQ values: each output moves at most
    ``slew_rate / sample_rate`` from the previous one."""

    def __init__(self, slew_rate: float):
        self.slew_rate = float(slew_rate)

    def bind(self, sig: StreamSig) -> _BoundSlewRateLimiter:
        return _BoundSlewRateLimiter(sig, self.slew_rate)
