"""Overlap-save filter by a four-step DFT, with or without an FM-demod
prologue.

Counterparts of ``radiorust_tpu/ops/pallas_filter.py``:

- :func:`fused_overlap_save` of ``fused_overlap_save``: one overlap-save
  step on [prev m || cur n] complex planes against a response grid;
- :func:`fused_demod_filter` of ``fused_demod_filter``: quadrature FM
  demod with its continuity state, then the overlap-save filter on the
  real demodulated streams, stream pairs packed as re/im of one
  transform (exact for a real impulse response).

Layout (as the JAX package's): time t = i2 + n2*i1 and frequency
k = k1 + n1*k2 on an n1 x n2 grid of the N = m + n point transform, with
n2 = 128; :func:`response_grid` maps a response vector R[N] to the
[n1, n2] grid with the inverse's 1/N folded in.

Each wrapper takes the JAX function's arguments as float32 tensors.  On
CUDA it launches the kernels of ``csrc/overlap_save.cu`` and counts the
launch in its ``launches`` attribute; on the CPU it runs the plain
``torch.fft`` version beside it (``*_plain``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import _build

__all__ = ["kernel_factors", "supported", "response_grid",
           "fused_overlap_save", "fused_overlap_save_plain",
           "fused_demod_filter", "fused_demod_filter_plain"]

N2 = 128          # the lane factor of the grid layout
_MAX_N1 = 768     # a 32-column strip of n1 rows must fit shared memory


def kernel_factors(n_total: int):
    """(n1, n2) with n1 * n2 = n_total and n2 = 128, or None."""
    if n_total % N2:
        return None
    return n_total // N2, N2


def supported(n: int, m: int = None) -> bool:
    """Whether the kernel takes n new samples per step against an m-tap
    history (m = n when omitted)."""
    if m is None:
        m = n
    f = kernel_factors(n + m)
    return f is not None and 0 < m and f[0] <= _MAX_N1


def response_grid(response: torch.Tensor) -> torch.Tensor:
    """Map a complex response R[N] to the [n1, n2] grid (k = k1 + n1*k2)
    with the inverse transform's 1/N folded in."""
    N = response.shape[-1]
    n1, n2 = kernel_factors(N)
    g = response.reshape(n2, n1).transpose(0, 1)
    # Divide re and im apart: torch's complex-by-real division rounds
    # differently from the JAX package's grid.
    return torch.complex(g.real / N, g.imag / N)


@functools.lru_cache(maxsize=32)
def _factor_constants(N: int, n1: int, n2: int,
                      ho: int) -> Tuple[np.ndarray, ...]:
    """DFT factor matrices designed in float64, cast to float32:
    D1 [n1, n1], D2 [n2, n2], twiddle [n1, n2], E1 = conj(D1)[:, :ho]."""
    k1 = np.arange(n1)
    d1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1)
    k2 = np.arange(n2)
    d2 = np.exp(-2j * np.pi * np.outer(k2, k2) / n2)
    tw = np.exp(-2j * np.pi * np.outer(k1, np.arange(n2)) / N)
    e1 = np.ascontiguousarray(np.conj(d1)[:, :ho])
    out = []
    for c in (d1, d2, tw, e1):
        out += [np.ascontiguousarray(c.real, np.float32),
                np.ascontiguousarray(c.imag, np.float32)]
    return tuple(out)


_device_constants = {}


def _constants(N: int, n: int, device) -> Tuple[int, int, tuple]:
    """(n1, ho, factor tensors on ``device``), uploaded once."""
    n1, n2 = kernel_factors(N)
    ho = -(-n // n2)
    key = (N, ho, str(device))
    if key not in _device_constants:
        _device_constants[key] = tuple(
            torch.from_numpy(c).to(device)
            for c in _factor_constants(N, n1, n2, ho))
    return n1, ho, _device_constants[key]


def _check_geometry(n: int, m: int):
    if not supported(n, m):
        raise ValueError(f"overlap-save geometry m={m}, n={n} is not one "
                         f"the kernel takes ((m + n) % {N2} == 0, "
                         f"(m + n) / {N2} <= {_MAX_N1})")


def fused_overlap_save_plain(prevr, previ, curr, curi, resp_gr, resp_gi):
    """Plain PyTorch version of :func:`fused_overlap_save` (``torch.fft``
    on the whole [prev || cur] buffer)."""
    n = curr.shape[-1]
    z = torch.complex(torch.cat([prevr, curr], dim=-1),
                      torch.cat([previ, curi], dim=-1))
    # Grid [k1, k2] back to the response vector at k = k1 + n1*k2.
    g = torch.complex(resp_gr, resp_gi).transpose(0, 1).reshape(-1)
    y = torch.fft.ifft(torch.fft.fft(z) * g, norm="forward")[:, :n]
    return y.real.contiguous(), y.imag.contiguous()


def fused_overlap_save(prevr, previ, curr, curi, resp_gr, resp_gi):
    """Filter one chunk step for all streams.

    ``prevr/previ``: [batch, m] overlap-save history planes;
    ``curr/curi``: [batch, n] current chunk planes; ``resp_gr/gi``:
    [n1, n2] response grid planes of the (m+n)-point response.  Returns
    (outr, outi) float32 [batch, n].
    """
    b, n = curr.shape
    m = prevr.shape[1]
    tensors = (prevr, previ, curr, curi, resp_gr, resp_gi)
    if not _build.on_cuda(*tensors):
        return fused_overlap_save_plain(*tensors)
    _check_geometry(n, m)
    dev = curr.device
    N = m + n
    n1, ho, consts = _constants(N, n, dev)
    ptr = _build.f32_ptr
    scr_r, scr_i = (torch.empty((b, N), dtype=torch.float32, device=dev)
                    for _ in range(2))
    outr, outi = (torch.empty((b, n), dtype=torch.float32, device=dev)
                  for _ in range(2))
    fused_overlap_save.launches += 1
    err = _build.lib().rr_overlap_save(
        ptr(prevr, "prevr"), ptr(previ, "previ"), m,
        ptr(curr, "curr"), ptr(curi, "curi"), n, m, n, b,
        *(c.data_ptr() for c in consts),
        ptr(resp_gr, "resp_gr"), ptr(resp_gi, "resp_gi"),
        scr_r.data_ptr(), scr_i.data_ptr(), outr.data_ptr(),
        outi.data_ptr(), n, n1, ho, _build.stream_handle(dev))
    _build.check(err, "fused_overlap_save")
    return outr, outi


fused_overlap_save.launches = 0


def _factor_vector(factor, b: int, device) -> torch.Tensor:
    return torch.as_tensor(factor, dtype=torch.float32,
                           device=device).expand(b).contiguous()


def fused_demod_filter_plain(curr, curi, prev_last_r, prev_last_i, prevd,
                             last_out, have_prev, resp_gr, resp_gi, factor):
    """Plain PyTorch version of :func:`fused_demod_filter`
    (``torch.atan2`` and ``torch.fft``)."""
    b, n = curr.shape
    m = prevd.shape[1]
    sr = torch.cat([prev_last_r[:, None], curr[:, :-1]], dim=1)
    si = torch.cat([prev_last_i[:, None], curi[:, :-1]], dim=1)
    pre = curr * sr + curi * si
    pim = curi * sr - curr * si
    d = torch.atan2(pim, pre) * _factor_vector(factor, b, curr.device)[:, None]
    d0 = torch.where(have_prev < 0.5, last_out, d[:, 0])
    d = torch.cat([d0[:, None], d[:, 1:]], dim=1)
    z = torch.cat([prevd, d], dim=-1)                  # [b, m + n]
    yr, yi = fused_overlap_save_plain(z[0::2, :m], z[1::2, :m],
                                      z[0::2, m:], z[1::2, m:],
                                      resp_gr, resp_gi)
    return torch.stack([yr, yi], dim=1).reshape(b, n), d


def fused_demod_filter(curr, curi, prev_last_r, prev_last_i, prevd,
                       last_out, have_prev, resp_gr, resp_gi, factor):
    """FM demod + overlap-save filter of one chunk step.

    ``curr/curi``: [batch, n] pre-demod planes; ``prev_last_*``: [batch]
    last sample of the previous chunk; ``prevd``: [batch, m] previous
    demodulated history; ``last_out``/``have_prev``: [batch] demod
    continuity (have_prev as 0/1 float); ``resp_gr/gi``: response grid of
    a real impulse response; ``factor``: sample_rate / deviation / 2pi,
    a scalar or [batch].  Returns (y [batch, n], d [batch, n]).  The batch
    must be even.
    """
    b, n = curr.shape
    m = prevd.shape[1]
    if b % 2:
        raise ValueError(f"batch {b} must be even (stream pairs share a "
                         f"transform)")
    tensors = (curr, curi, prev_last_r, prev_last_i, prevd, last_out,
               have_prev, resp_gr, resp_gi)
    if not _build.on_cuda(*tensors):
        return fused_demod_filter_plain(*tensors, factor)
    _check_geometry(n, m)
    dev = curr.device
    N = m + n
    n1, ho, consts = _constants(N, n, dev)
    fac = _factor_vector(factor, b, dev)
    names = ("curr", "curi", "prev_last_r", "prev_last_i", "prevd",
             "last_out", "have_prev")
    ptrs = [_build.f32_ptr(t, nm) for t, nm in zip(tensors, names)]
    dout = torch.empty((b, n), dtype=torch.float32, device=dev)
    zr, zi, scr_r, scr_i = (torch.empty((b // 2, N), dtype=torch.float32,
                                        device=dev) for _ in range(4))
    y = torch.empty((b, n), dtype=torch.float32, device=dev)
    fused_demod_filter.launches += 1
    err = _build.lib().rr_demod_filter(
        *ptrs, fac.data_ptr(), dout.data_ptr(), zr.data_ptr(),
        zi.data_ptr(), b, n, m, *(c.data_ptr() for c in consts),
        _build.f32_ptr(resp_gr, "resp_gr"), _build.f32_ptr(resp_gi, "resp_gi"),
        scr_r.data_ptr(), scr_i.data_ptr(), y.data_ptr(), n1, ho,
        _build.stream_handle(dev))
    _build.check(err, "fused_demod_filter")
    return y, dout


fused_demod_filter.launches = 0
