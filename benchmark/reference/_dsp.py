"""Plain DSP shared by the configurations' references.

Two parts, both independent of the program under test:

- the design math of radiorust 0.5.0 as its WFM receiver binds it (a
  frozen copy: windowed-sinc prototypes for the resamplers, frequency
  sampling with the literal half-swap, window and energy renormalisation
  for the overlap-save filters), in float64 numpy;
- each stage as a direct computation over a whole stream (a mixer, a
  causal FIR, a rational decimator that picks the correlation's samples,
  the quadrature FM demodulator), in plain PyTorch on any device.

A :class:`Precision` says what the stages compute in: ``float64`` (the
reference) or ``tf32`` (the control: float32 arithmetic with every
operand of a product rounded to TF32's 10-bit mantissa first, the step a
later change could be tempted to take).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

TAU = 2.0 * math.pi


# -- design (float64 numpy) -------------------------------------------------

def round_half_away(x: float) -> int:
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


def kaiser_null_at_bin(n: float):
    """The Kaiser window with its first null ``n`` bins out, as a function
    of x in [-1, 1] (up to a constant)."""
    beta = math.sqrt(n * n - 1.0)
    return lambda x: np.i0(beta * np.sqrt(1.0 - np.asarray(x) ** 2))


def rectangular(x):
    return np.ones_like(np.asarray(x, dtype=np.float64))


def window_table(window, n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.asarray(window(2.0 * (i + 0.5) / n - 1.0), dtype=np.float64)


def design_impulse_response(gains, window, n: int,
                            sample_rate: float) -> np.ndarray:
    """The n-tap impulse response (complex128) of the gains ``gains(bins,
    freqs)``: sampled at every DFT bin (the Nyquist bin zero), inverse
    transform, the two floor-halves swapped, windowed and scaled back to
    the energy before the window."""
    max_bin = (n - 1) // 2
    bins = np.zeros(n, dtype=np.int64)
    bins[: max_bin + 1] = np.arange(max_bin + 1)
    bins[n - max_bin:] = -np.arange(max_bin, 0, -1)
    freqs = bins.astype(np.float64) * (sample_rate / n)
    g = np.array(gains(bins, freqs), dtype=np.complex128)
    if n % 2 == 0:
        g[n // 2] = 0.0
    ir = np.fft.ifft(g)
    half = n // 2
    ir = np.concatenate([ir[half:2 * half], ir[:half], ir[2 * half:]])
    pre = float(np.sum(np.abs(ir) ** 2))
    ir = ir * window_table(window, n)
    post = float(np.sum(np.abs(ir) ** 2))
    return ir * math.sqrt(pre / post) if post > 0.0 else ir


def deemphasis(tau: float, freqs):
    return 1.0 / (1.0 + 1j * (tau * TAU * np.asarray(freqs, np.float64)))


@dataclass(frozen=True)
class Decimation:
    """A rational downsampler: ``p`` inputs give ``q`` outputs; output
    ``m*q + r`` is the prototype ``taps`` correlated with the input
    window that ends at stream sample ``m*p + offsets[r]``."""

    p: int
    q: int
    taps: np.ndarray
    offsets: tuple

    @property
    def nonzero_taps(self) -> int:
        """Multiply-adds of one period (q outputs of ``len(taps)``)."""
        return self.q * int(np.count_nonzero(self.taps))

    @property
    def history(self) -> int:
        """Input samples a step carries over (the window less one)."""
        return len(self.taps) - 1


def downsampler(input_rate: float, output_rate: float, bandwidth: float,
                quality: float = 3.0) -> Decimation:
    margin = (output_rate - bandwidth) / 2.0
    n = int(math.ceil(input_rate / margin * quality))
    window = kaiser_null_at_bin(n * margin / input_rate)
    x = (np.arange(n, dtype=np.float64) + 0.5) - n / 2.0
    y = np.sinc(x * output_rate / input_rate) * window(x * 2.0 / n)
    taps = y / math.sqrt(float(np.sum(y * y)))
    r = Fraction(input_rate) / Fraction(output_rate)
    p, q = r.numerator, r.denominator
    offsets = tuple(-((-(k + 1) * p) // q) - 1 for k in range(q))
    return Decimation(p, q, taps, offsets)


# -- precision --------------------------------------------------------------

@dataclass(frozen=True)
class Precision:
    name: str

    @property
    def real(self):
        return torch.float64 if self.name == "float64" else torch.float32

    @property
    def complex(self):
        return (torch.complex128 if self.name == "float64"
                else torch.complex64)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in this precision, as an operand of a product."""
        t = t.to(self.complex if t.is_complex() else self.real)
        if self.name == "float64":
            return t
        if self.name != "tf32":
            raise ValueError(f"unknown precision {self.name!r}")
        if t.is_complex():
            return torch.complex(_tf32(t.real), _tf32(t.imag))
        return _tf32(t)


FLOAT64 = Precision("float64")
TF32 = Precision("tf32")


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


# -- stages over whole streams (torch, rows = streams) -----------------------

def mix(s: torch.Tensor, shift: float, rate: float,
        prec: Precision) -> torch.Tensor:
    """``s * exp(j*2*pi*shift*t/rate)``, the phase an exact integer ratio
    of a 1 Hz grid (a constant phase, which no later stage of an FM
    receiver sees, is left at 0)."""
    denom = round_half_away(rate)
    numer = round_half_away(denom * shift / rate) % denom
    t = torch.arange(s.shape[-1], dtype=torch.int64, device=s.device)
    ang = ((t * numer) % denom).to(torch.float64) * (TAU / denom)
    osc = torch.polar(torch.ones_like(ang), ang)
    return prec.operand(s) * prec.operand(osc)


def _fft_len(n: int) -> int:
    return 1 << (n - 1).bit_length()


def causal_fir(s: torch.Tensor, taps, prec: Precision,
               rows: int = 16) -> torch.Tensor:
    """``y[t] = sum_i taps[i] * s[t - i]`` with zeros before the stream,
    by FFT in blocks of ``rows`` streams."""
    h = torch.as_tensor(np.asarray(taps), device=s.device)
    h = prec.operand(h if h.is_complex() else h.to(torch.complex128))
    x = prec.operand(s if s.is_complex() else s.to(prec.complex))
    n = x.shape[-1]
    size = _fft_len(n + h.shape[-1] - 1)
    hf = torch.fft.fft(h, size)
    out = [torch.fft.ifft(torch.fft.fft(x[i:i + rows], size) * hf)[:, :n]
           for i in range(0, x.shape[0], rows)]
    return torch.cat(out)


def decimate(s: torch.Tensor, d: Decimation, prec: Precision) -> torch.Tensor:
    """The rational downsampler over whole streams (a length that is a
    whole number of periods)."""
    n = s.shape[-1]
    if n % d.p:
        raise ValueError(f"stream length {n} is not a multiple of {d.p}")
    # z[t] correlates the taps with the window ending at sample t.
    z = causal_fir(s, d.taps[::-1].copy(), prec)
    periods = n // d.p
    idx = (torch.arange(periods, device=s.device)[:, None] * d.p
           + torch.tensor(d.offsets, device=s.device)[None, :]).reshape(-1)
    return z[:, idx]


def fm_demod(s: torch.Tensor, rate: float, deviation: float,
             prec: Precision) -> torch.Tensor:
    """``arg(s[t] * conj(s[t-1])) * rate / (2*pi*deviation)``; the first
    sample of a stream reads 0."""
    x = prec.operand(s)
    prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    prod = x * torch.conj(prev)
    d = torch.atan2(prod.imag, prod.real) * (rate / deviation / TAU)
    d[:, 0] = 0.0
    return d


def streams(chunks: torch.Tensor) -> torch.Tensor:
    """[C, B, n] chunks as [B, C*n] streams."""
    c, b, n = chunks.shape
    return chunks.permute(1, 0, 2).reshape(b, c * n)


def chunked(s: torch.Tensor, n: int) -> torch.Tensor:
    """[B, C*n] streams as [C, B, n] chunks."""
    b = s.shape[0]
    return s.reshape(b, -1, n).permute(1, 0, 2)
