"""Rational polyphase FIR resampling.

Host-side plan construction is the JAX package's, verbatim in float64
(see ``radiorust_tpu/ops/polyphase.py`` for the derivation).  With input
and output rates in the reduced ratio ``p/q``, output ``m*q + r`` of a
chunk is the correlation

    y[b, m*q + r] = sum_u  xp[b, s0 + m*p + u] * W[r, u]

of the history-prepended input ``xp`` with the plan's kernel matrix
``W [q, Kw]``.  Two modes share a plan:

- *aligned* (``chunk_len % p == 0``): ``chunk_len/p`` whole periods a
  step, :func:`rational_fir`;
- *phase* (any other chunk length): the window grid no longer lands on
  chunk boundaries, so the step carries the grid phase ``(k*C) mod p``
  and emits a fixed ``ceil(C/p)*q`` samples whose valid prefix follows
  :meth:`RationalPlan.valid_counts`, zeros behind it,
  :func:`rational_fir_phase`.

Window ``w`` covers inputs ``[w*p + D - Kw, w*p + D)`` with ``D = s0 -
hist + Kw = p`` for the down- and up-sampling plans alike, so a window
is computable exactly when ``(w+1)*p`` input samples have been seen.
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

__all__ = ["design_ir", "RationalPlan", "plan_downsample", "plan_upsample",
           "rational_fir", "rational_fir_phase"]


def design_ir(base_rate: float, other_rate: float, margin: float,
              quality: float) -> np.ndarray:
    """Windowed-sinc prototype taps (float64): length
    ``ceil(base_rate/margin*quality)``, Kaiser window with its first null
    at bin ``len*margin/base_rate``, energy-normalized.  Downsampling
    designs at ``base=input, other=output``, upsampling the other way."""
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
    """Static plan for one rational resampling op (aligned or phase
    mode, by the chunk length it is bound at)."""

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
                f"(rational resampling period); insert a Rechunker")
        return (chunk_len // self.p) * self.q

    def aligned(self, chunk_len: int) -> bool:
        return chunk_len % self.p == 0

    @property
    def phase_hist(self) -> int:
        """History samples carried in phase mode (Kw - 1: enough to cover
        the oldest input any next-step window can reach)."""
        return int(self.kernel.shape[1]) - 1

    def windows_per_step(self, chunk_len: int) -> int:
        """Window slots a step in phase mode (>= any step's count)."""
        return -(-chunk_len // self.p)

    def advance(self, phase: int, chunk_len: int):
        """One schedule step from grid phase ``phase``: ``(valid output
        samples, next phase)``.  The one owner of the phase-mode
        schedule: ``valid_counts``, the bound block's mirror
        (``advance_schedule``), :func:`rational_fir_phase` and the
        phase-mode kernel (``rr_decimate_phase``) all follow it."""
        v = self.q * ((phase + chunk_len) // self.p)
        return v, (phase + chunk_len) % self.p

    def valid_counts(self, chunk_len: int, k0: int, nsteps: int):
        """Valid output samples per step for steps k0..k0+nsteps (the
        phase-mode schedule; in aligned mode every entry is
        chunk_len/p*q)."""
        phase = (k0 * chunk_len) % self.p
        out = []
        for _ in range(nsteps):
            v, phase = self.advance(phase, chunk_len)
            out.append(v)
        return np.array(out, np.int64)


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


def plan_upsample(input_rate: float, output_rate: float, bandwidth: float,
                  quality: float = 3.0) -> RationalPlan:
    """Plan an upsampling op: input n scatters the prototype into outputs
    ``ceil(n q / p) + j``, gathered here as the same correlation."""
    assert output_rate >= 0.0 and bandwidth >= 0.0
    assert input_rate <= output_rate, "input rate must be <= output rate"
    assert bandwidth < input_rate, "bandwidth must be below input rate"
    margin = (input_rate - bandwidth) / 2.0
    ir = design_ir(output_rate, input_rate, margin, quality)
    L = len(ir)
    p, q = _exact_ratio(input_rate, output_rate)
    # Output m sums x[n] * ir[m - o_n] over lo(m) <= n <= hi(m).
    def hi(m):
        return (m * p) // q

    def lo(m):
        return ((m - L) * p) // q + 1

    his = [hi(r) for r in range(q)]
    los = [lo(r) for r in range(q)]
    minlo = min(los)
    Kw = max(h - minlo + 1 for h in his)
    # Evaluate taps at a period far enough in that all indices are >= 0.
    C = max(0, -((minlo) // p) + 1)
    W = np.zeros((q, Kw), dtype=np.float64)
    for r in range(q):
        m = r + C * q
        base = minlo + C * p
        for u in range(Kw):
            n = base + u
            j = m - (-((-n * q) // p))  # m - ceil(n q / p)
            if los[r] + C * p <= n <= his[r] + C * p and 0 <= j < L:
                W[r, u] = ir[j]
    hist = max(0, -minlo)
    s0 = minlo + hist
    from ..numbers import stream_real
    return RationalPlan(p=p, q=q, kernel=W.astype(stream_real()),
                        hist=hist, s0=s0, out_per_in=Fraction(q, p))


def rational_fir(xp: torch.Tensor, kernel: torch.Tensor, p: int, q: int,
                 s0: int, out_len: int,
                 real_input: bool = False) -> torch.Tensor:
    """Plain aligned-mode rational FIR: ``xp`` [batch, hist+chunk]
    complex64 (history prepended), ``kernel`` [q, Kw] float32.  Returns
    [batch, out_len] complex64.  Re and im ride the batch axis of one
    strided ``conv1d`` (real_input: the real plane only)."""
    b = xp.shape[0]
    w = torch.as_tensor(kernel, dtype=xp.real.dtype,
                        device=xp.device)[:, None, :]
    planes = xp.real if real_input else torch.cat([xp.real, xp.imag], dim=0)
    out = torch.nn.functional.conv1d(planes[:, None, s0:].contiguous(), w,
                                     stride=p)        # [nb, q, M']
    m = out_len // q
    y = out[:, :, :m].transpose(1, 2).reshape(-1, out_len)
    if real_input:
        return torch.complex(y, torch.zeros_like(y))
    return torch.complex(y[:b], y[b:])


def rational_fir_phase(x: torch.Tensor, hist: torch.Tensor,
                       phase: torch.Tensor, kernel: torch.Tensor, p: int,
                       q: int, real_input: bool = False):
    """One phase-mode resampling step, the plain version of
    :func:`radiorust_tpu_torch.ops.frontend.decimate_phase_complex`.

    ``x``: [batch, C] complex64; ``hist``: [batch, Kw-1] the carried input
    tail; ``phase``: [batch] int32 grid phase ``(k*C) mod p`` (row 0
    places the windows).  Returns ``(y [batch, E*q], new_hist,
    new_phase)`` with ``E = ceil(C/p)``: window w covers ``buf[o + w*p,
    o + w*p + Kw)`` of ``buf = [hist || x || zeros]`` at ``o = p - 1 -
    phase``; the first ``v = (phase + C) // p`` windows are complete, the
    rest are written as zeros.  The offset stays a device tensor (a
    gather, no host read)."""
    b, C = x.shape
    Kw = int(kernel.shape[1])
    E = -(-C // p)
    ph = phase[0].to(torch.int64)
    buf = torch.cat([hist, x, torch.zeros((b, p - 1), dtype=x.dtype,
                                          device=x.device)], dim=-1)
    planes = buf.real if real_input else torch.cat([buf.real, buf.imag])
    w = torch.arange(E, device=x.device)
    idx = ((p - 1) - ph + w[:, None] * p
           + torch.arange(Kw, device=x.device)).reshape(-1)
    win = planes[:, idx].reshape(-1, E, Kw)               # [nb, E, Kw]
    taps = torch.as_tensor(kernel, dtype=x.real.dtype, device=x.device)
    out = torch.matmul(win, taps.t())                     # [nb, E, q]
    # A mirror of RationalPlan.advance: v whole windows complete.
    v = (ph + C) // p
    out = torch.where((w < v)[None, :, None], out, torch.zeros_like(out))
    yr = out.reshape(-1, E * q)
    if real_input:
        y = torch.complex(yr, torch.zeros_like(yr))
    else:
        y = torch.complex(yr[:b], yr[b:])
    new_hist = torch.cat([hist, x], dim=-1)[:, C:]
    new_phase = torch.remainder(phase + C, p).to(phase.dtype)
    return y, new_hist, new_phase
