"""Rational polyphase FIR resampling (aligned mode).

Host-side plan construction is the JAX package's, verbatim in float64
(see ``radiorust_tpu/ops/polyphase.py`` for the derivation).  With input
and output rates in the reduced ratio ``p/q``, output ``m*q + r`` of a
chunk is the correlation

    y[b, m*q + r] = sum_u  xp[b, s0 + m*p + u] * W[r, u]

of the history-prepended input ``xp`` with the plan's kernel matrix
``W [q, Kw]``.  Only the aligned mode (``chunk_len % p == 0``) is ported;
the phase mode for other chunk lengths waits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from ..math import sinc
from ..windowing import Kaiser

__all__ = ["design_ir", "RationalPlan", "plan_downsample", "rational_fir"]


def design_ir(base_rate: float, other_rate: float, margin: float,
              quality: float) -> np.ndarray:
    """Windowed-sinc prototype taps (float64): length
    ``ceil(base_rate/margin*quality)``, Kaiser window with its first null
    at bin ``len*margin/base_rate``, energy-normalized."""
    ir_len = int(math.ceil(base_rate / margin * quality))
    assert ir_len > 0
    window = Kaiser.with_null_at_bin(ir_len * margin / base_rate)
    x = (np.arange(ir_len, dtype=np.float64) + 0.5) - ir_len / 2.0
    y = sinc(x * other_rate / base_rate) * window.relative_value_at(
        x * 2.0 / ir_len)
    return y / np.sqrt(np.sum(y * y))


def _exact_ratio(input_rate: float, output_rate: float) -> Tuple[int, int]:
    """Reduced (p, q) with input_rate/output_rate == p/q exactly."""
    r = Fraction(input_rate) / Fraction(output_rate)
    return r.numerator, r.denominator


@dataclass(frozen=True)
class RationalPlan:
    """Static plan for one rational resampling op (aligned mode only:
    each step consumes ``chunk_len/p`` whole periods)."""

    p: int            # input samples per period
    q: int            # output samples per period
    kernel: np.ndarray  # [q, Kw] float32 kernel matrix
    hist: int         # carried history samples (prepended to each chunk)
    s0: int           # start offset of window 0 in the padded input
    out_per_in: Fraction

    def out_len(self, chunk_len: int) -> int:
        if chunk_len % self.p:
            raise ValueError(
                f"chunk_len {chunk_len} must be a multiple of {self.p} "
                f"(rational resampling period); phase-mode resampling is "
                f"not ported yet")
        return (chunk_len // self.p) * self.q


def plan_downsample(input_rate: float, output_rate: float, bandwidth: float,
                    quality: float = 3.0,
                    prefilter_ir=None) -> RationalPlan:
    """Plan a downsampling op.  ``prefilter_ir`` (at the input rate)
    folds a preceding LTI filter into the decimating FIR."""
    assert output_rate >= 0.0 and bandwidth >= 0.0
    assert bandwidth < output_rate, "bandwidth must be below output rate"
    assert input_rate >= output_rate, "input rate must be >= output rate"
    margin = (output_rate - bandwidth) / 2.0
    ir = design_ir(input_rate, output_rate, margin, quality)
    if prefilter_ir is not None:
        pre = np.asarray(prefilter_ir)
        if np.abs(pre.imag).max() > 1e-9 * max(np.abs(pre.real).max(), 1e-30):
            raise ValueError("prefilter impulse response must be real "
                             "(conjugate-symmetric frequency response)")
        ir = np.convolve(ir, pre.real[::-1])
    L = len(ir)
    p, q = _exact_ratio(input_rate, output_rate)
    # Output k lands on input index n_k = ceil((k+1) p / q) - 1.
    n = [-((-(k + 1) * p) // q) - 1 for k in range(q)]
    Kw = L + p - 1
    W = np.zeros((q, Kw), dtype=np.float64)
    for r in range(q):
        W[r, n[r]: n[r] + L] = ir
    from ..numbers import stream_real
    return RationalPlan(p=p, q=q, kernel=W.astype(stream_real()),
                        hist=L - 1, s0=0,
                        out_per_in=Fraction(q, p))


def rational_fir(xp: torch.Tensor, kernel: torch.Tensor, p: int, q: int,
                 s0: int, out_len: int,
                 real_input: bool = False) -> torch.Tensor:
    """Plain aligned-mode rational FIR: ``xp`` [batch, hist+chunk]
    complex64 (history prepended), ``kernel`` [q, Kw] float32.  Returns
    [batch, out_len] complex64.  Re and im ride the batch axis of one
    strided ``conv1d`` (real_input: the real plane only)."""
    b = xp.shape[0]
    w = torch.as_tensor(kernel, dtype=torch.float32,
                        device=xp.device)[:, None, :]
    planes = xp.real if real_input else torch.cat([xp.real, xp.imag], dim=0)
    out = torch.nn.functional.conv1d(planes[:, None, s0:].contiguous(), w,
                                     stride=p)        # [nb, q, M']
    m = out_len // q
    y = out[:, :, :m].transpose(1, 2).reshape(-1, out_len)
    if real_input:
        return torch.complex(y, torch.zeros_like(y))
    return torch.complex(y[:b], y[b:])
