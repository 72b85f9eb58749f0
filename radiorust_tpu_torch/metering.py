"""Metering: level, occupied bandwidth, energy rescaling (PyTorch port of
the JAX package's ``metering.py``).

Host versions in float64 numpy, the JAX package's verbatim:

- :func:`level`: mean squared norm of a chunk;
- :func:`bandwidth`: occupied bandwidth, walking the FFT bins inward from
  both band edges and discounting ``double_percentile/2`` of the energy
  on each side, with a fractional last bin;
- :func:`rescale_energy`: bin energies resampled to a display resolution
  by fractional overlap.

Device versions, batched over leading axes, in the stream dtype:
:func:`level_torch`, :func:`bandwidth_torch` and
:func:`rescale_energy_torch`, the counterparts of the JAX package's
``*_jax``.  Where the JAX package builds its prefix sum as a matmul
(``ops/cumsum.py``, for the TPU's matrix unit) the port takes
``torch.cumsum``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["level", "bandwidth", "rescale_energy", "level_torch",
           "bandwidth_torch", "rescale_energy_torch"]


def level(chunk) -> float:
    """Mean squared norm of a complex chunk.  A unit-circle oscillator
    meters at 0 dB:

    >>> import numpy as np
    >>> x = np.exp(1j * np.linspace(0.0, 6.0, 100))
    >>> round(float(10.0 * np.log10(level(x))), 9)
    0.0
    """
    chunk = np.asarray(chunk)
    return float(np.mean(np.abs(chunk.astype(np.complex128)) ** 2))


def _bin_walk_order(n: int) -> np.ndarray:
    # From the band edge (the most negative frequency, at index ceil(n/2)
    # of the DFT layout) on, wrapping: (wrap..n, 0..wrap).
    wrap = (n + 1) // 2
    return np.concatenate([np.arange(wrap, n), np.arange(0, wrap)])


def _discount(energies: np.ndarray, limit: float) -> float:
    # Whole bins while the running energy stays <= limit, then the
    # fraction of the first bin that crosses it.
    c = np.cumsum(energies)
    full = int(np.sum(c <= limit))
    if full >= len(energies):
        return float(full)
    prev = c[full - 1] if full > 0 else 0.0
    step = energies[full]
    return float(full) + (limit - prev) / step


def bandwidth(double_percentile: float, sample_rate: float, bins) -> float:
    """Occupied bandwidth in hertz of FFT bins."""
    bins = np.asarray(bins).astype(np.complex128)
    n = len(bins)
    e = np.abs(bins) ** 2
    limit = float(np.sum(e)) * double_percentile / 2.0
    order = _bin_walk_order(n)
    used = _discount(e[order], limit) + _discount(e[order[::-1]], limit)
    bw = (n - used) * sample_rate / n
    return max(bw, 0.0)


def _overlap_matrix(resolution: int, n: int) -> np.ndarray:
    # overlap[o, i] = measure of [i, i+1) inside [o*n/res, (o+1)*n/res)
    o = np.arange(resolution, dtype=np.float64)
    i = np.arange(n, dtype=np.float64)
    left = o[:, None] * n / resolution
    right = (o[:, None] + 1.0) * n / resolution
    lo = np.maximum(left, i[None, :])
    hi = np.minimum(right, i[None, :] + 1.0)
    return np.clip(hi - lo, 0.0, None)


def rescale_energy(resolution: int, bins) -> np.ndarray:
    """Resample |bins|^2 into ``resolution`` buckets; the spectrum is
    expected centre-shifted (no wrap mid-array)."""
    bins = np.asarray(bins).astype(np.complex128)
    e = np.abs(bins) ** 2
    return _overlap_matrix(resolution, len(bins)) @ e


def level_torch(chunks: torch.Tensor) -> torch.Tensor:
    """Mean squared norm per stream: [..., n] complex -> [...] real."""
    return torch.mean(torch.abs(chunks) ** 2, dim=-1)


def bandwidth_torch(double_percentile: float, sample_rate: float,
                    bins: torch.Tensor) -> torch.Tensor:
    """Occupied bandwidth per spectrum: [..., n] complex -> [...] hertz.

    One prefix sum serves both walks: with ``c`` the running sums of the
    walked energies and ``S`` their total, the reverse walk's running
    sums are ``S - c[n-2-k]`` (and ``S`` at k = n-1), as in the JAX
    package's ``bandwidth_jax`` (exact in real arithmetic; a bin whose
    prefix lands within an ulp of the limit may count differently from
    a literal reversed sum)."""
    n = bins.shape[-1]
    e = torch.abs(bins) ** 2
    total = torch.sum(e, dim=-1)
    limit = total * (double_percentile / 2.0)
    w = torch.roll(e, -((n + 1) // 2), dims=-1)       # the bin walk
    c = torch.cumsum(w, dim=-1)

    def take(a, idx):
        return torch.gather(a, -1, idx[..., None])[..., 0]

    def frac(full, prev, step):
        return torch.where(full >= n, torch.zeros_like(prev),
                           (limit - prev) / torch.where(
                               step == 0.0, torch.ones_like(step), step))

    zero = torch.zeros_like(limit)
    # Forward walk.
    full_f = torch.sum(c <= limit[..., None], dim=-1)
    prev_f = torch.where(full_f > 0,
                         take(c, torch.clamp(full_f - 1, min=0)), zero)
    step_f = take(w, torch.clamp(full_f, max=n - 1))
    # Reverse walk from the same sums: crev[k] <= limit (k <= n-2) <=>
    # c[n-2-k] >= S - limit, plus the k = n-1 term (crev = S).
    full_r = (torch.sum(c[..., :n - 1] >= (total - limit)[..., None], dim=-1)
              + (total <= limit).to(full_f.dtype))
    prev_r = torch.where(
        full_r > 0, total - take(c, torch.clamp(n - 1 - full_r, 0, n - 1)),
        zero)
    step_r = take(w, torch.clamp(n - 1 - torch.clamp(full_r, max=n - 1),
                                 0, n - 1))
    used = (full_f + frac(full_f, prev_f, step_f) + full_r
            + frac(full_r, prev_r, step_r)).to(e.dtype)
    bw = (n - used) * (sample_rate / n)
    return torch.clamp(bw, min=0.0)


def rescale_energy_torch(resolution: int,
                         bins: torch.Tensor) -> torch.Tensor:
    """Resample bin energies: [..., n] complex -> [..., resolution] real,
    through the dense overlap matrix (in the bins' real dtype)."""
    e = torch.abs(bins) ** 2
    n = bins.shape[-1]
    o = torch.arange(resolution, dtype=e.dtype, device=bins.device)
    i = torch.arange(n, dtype=e.dtype, device=bins.device)
    left = o[:, None] * n / resolution
    right = (o[:, None] + 1.0) * n / resolution
    lo = torch.maximum(left, i[None, :])
    hi = torch.minimum(right, i[None, :] + 1.0)
    m = torch.clamp(hi - lo, min=0.0)
    return torch.einsum("ri,...i->...r", m, e)
