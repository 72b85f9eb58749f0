"""Rational FIR decimation, with or without a mixer prologue.

Counterparts of ``radiorust_tpu/ops/pallas_frontend.py``:

- :func:`decimate` of ``pallas_decimate``: p:q decimation of one real
  float32 plane or two (re, im) over ``[hist || x]``;
- :func:`fused_mix_decimate` of ``fused_mix_decimate``: the same after
  mixing x with the factored oscillator tables and a per-stream start
  phasor, with the history kept in the mixed domain.

Each wrapper takes the JAX function's arguments and float32 planes.  On
CUDA tensors it launches the hand-written kernel of ``csrc/decimate.cu``
and counts the launch in its ``launches`` attribute; on CPU tensors it
runs the plain PyTorch version beside it (``*_plain``).
"""

from __future__ import annotations

import torch

from . import _build
from .polyphase import rational_fir

__all__ = ["decimate", "decimate_plain", "fused_mix_decimate",
           "fused_mix_decimate_plain", "decimate_supported"]

# Periods per block of the kernel (kTileM in csrc/decimate.cu) and the
# shared memory one block may take on an H100.
_TILE_M = 128
_SMEM_LIMIT = 227 * 1024


def _smem_bytes(nplanes: int, p: int, q: int, kw: int) -> int:
    return 4 * (q * kw + nplanes * ((_TILE_M - 1) * p + kw))


def decimate_supported(n: int, plan) -> bool:
    """Whether the decimation kernel takes this aligned plan at chunk
    ``n`` on two planes: whole periods per chunk, a downsample layout
    (``s0 == 0``, history = window minus one period, nonzero), and a
    block's staged span and taps within shared memory."""
    kw = int(plan.kernel.shape[-1])
    return (n % plan.p == 0 and plan.s0 == 0 and plan.hist == kw - plan.p
            and plan.hist > 0
            and _smem_bytes(2, plan.p, plan.q, kw) <= _SMEM_LIMIT)


def _check_layout(n, hist, kw, p):
    # The kernel's preconditions (as pallas_frontend.py asserts them): a
    # violating call would compute misaligned windows, not fail.
    assert n % p == 0, (p, n)
    assert hist == kw - p and hist > 0, (hist, kw, p)


def decimate_plain(planes, hplanes, kernel_matrix, p: int, q: int):
    """Plain PyTorch version of :func:`decimate`, on
    :func:`~radiorust_tpu_torch.ops.polyphase.rational_fir`."""
    n = planes[0].shape[-1]
    hist = hplanes[0].shape[-1]
    bufs = [torch.cat([h, x], dim=-1) for x, h in zip(planes, hplanes)]
    new_h = tuple(buf[:, -hist:] for buf in bufs)
    real = len(bufs) == 1
    xp = torch.complex(bufs[0], torch.zeros_like(bufs[0]) if real
                       else bufs[1])
    y = rational_fir(xp, kernel_matrix, p, q, 0, (n // p) * q,
                     real_input=real)
    return ((y.real,) if real else (y.real, y.imag)), new_h


def decimate(planes, hplanes, kernel_matrix, p: int, q: int):
    """Rational p:q decimation of 1 or 2 float32 planes.

    ``planes``: tuple of [batch, n]; ``hplanes``: matching [batch, hist]
    histories; ``kernel_matrix``: [q, Kw] taps with hist = Kw - p.
    Returns (out planes [batch, (n/p)*q], new history planes).
    """
    nplanes = len(planes)
    b, n = planes[0].shape
    hist = hplanes[0].shape[-1]
    kw = kernel_matrix.shape[-1]
    _check_layout(n, hist, kw, p)
    if not _build.on_cuda(*planes, *hplanes, kernel_matrix):
        return decimate_plain(planes, hplanes, kernel_matrix, p, q)
    if nplanes not in (1, 2):
        raise ValueError(f"{nplanes} planes: the kernel takes 1 or 2")
    if _smem_bytes(nplanes, p, q, kw) > _SMEM_LIMIT:
        raise ValueError("decimation window too long for shared memory")
    dev = planes[0].device
    outs = [torch.empty((b, (n // p) * q), dtype=torch.float32, device=dev)
            for _ in planes]
    newh = [torch.empty((b, hist), dtype=torch.float32, device=dev)
            for _ in planes]
    ptr = _build.f32_ptr
    x = [ptr(t, "planes") for t in planes]
    h = [ptr(t, "hplanes") for t in hplanes]
    two = nplanes == 2
    decimate.launches += 1
    err = _build.lib().rr_decimate(
        x[0], x[1] if two else None, h[0], h[1] if two else None,
        ptr(kernel_matrix, "kernel_matrix"),
        outs[0].data_ptr(), outs[1].data_ptr() if two else None,
        newh[0].data_ptr(), newh[1].data_ptr() if two else None,
        b, n, hist, p, q, kw, nplanes, _build.stream_handle(dev))
    _build.check(err, "decimate")
    return tuple(outs), tuple(newh)


decimate.launches = 0


def _mix(xr, xi, ar, ai, br, bi, p0r, p0i):
    """x * (A[a] * B[b]) * p0, in the TPU kernel's order of operations."""
    b, n = xr.shape
    outer, inner = ar.shape[-1], br.shape[-1]
    oscr = ar[:, None] * br[None, :] - ai[:, None] * bi[None, :]
    osci = ar[:, None] * bi[None, :] + ai[:, None] * br[None, :]
    cxr = xr.reshape(b, outer, inner)
    cxi = xi.reshape(b, outer, inner)
    mr0 = cxr * oscr[None] - cxi * osci[None]
    mi0 = cxr * osci[None] + cxi * oscr[None]
    pr = p0r[:, None, None]
    pi = p0i[:, None, None]
    return ((mr0 * pr - mi0 * pi).reshape(b, n),
            (mr0 * pi + mi0 * pr).reshape(b, n))


def fused_mix_decimate_plain(xr, xi, ar, ai, br, bi, p0r, p0i, hr, hi,
                             kernel_matrix, p: int, q: int):
    """Plain PyTorch version of :func:`fused_mix_decimate`."""
    mr, mi = _mix(xr, xi, ar, ai, br, bi, p0r, p0i)
    (outr, outi), (nhr, nhi) = decimate_plain((mr, mi), (hr, hi),
                                              kernel_matrix, p, q)
    return outr, outi, nhr, nhi


def fused_mix_decimate(xr, xi, ar, ai, br, bi, p0r, p0i, hr, hi,
                       kernel_matrix, p: int, q: int):
    """Mix + decimate one chunk step.

    ``xr/xi``: [batch, n] raw input planes; ``ar..bi``: factored
    oscillator tables ([outer], [inner], outer * inner = n);
    ``p0r/p0i``: [batch] start phasor; ``hr/hi``: [batch, hist]
    mixed-domain history; ``kernel_matrix``: [q, Kw].  Returns
    (outr, outi, new_hr, new_hi).
    """
    b, n = xr.shape
    hist = hr.shape[-1]
    kw = kernel_matrix.shape[-1]
    inner = br.shape[-1]
    _check_layout(n, hist, kw, p)
    if ar.shape[-1] * inner != n:
        raise ValueError(f"oscillator tables {ar.shape[-1]}x{inner} != {n}")
    tensors = (xr, xi, ar, ai, br, bi, p0r, p0i, hr, hi, kernel_matrix)
    if not _build.on_cuda(*tensors):
        return fused_mix_decimate_plain(*tensors, p, q)
    if _smem_bytes(2, p, q, kw) > _SMEM_LIMIT:
        raise ValueError("decimation window too long for shared memory")
    dev = xr.device
    outr, outi = (torch.empty((b, (n // p) * q), dtype=torch.float32,
                              device=dev) for _ in range(2))
    nhr, nhi = (torch.empty((b, hist), dtype=torch.float32, device=dev)
                for _ in range(2))
    names = ("xr", "xi", "ar", "ai", "br", "bi", "p0r", "p0i", "hr", "hi",
             "kernel_matrix")
    ptrs = [_build.f32_ptr(t, nm) for t, nm in zip(tensors, names)]
    fused_mix_decimate.launches += 1
    err = _build.lib().rr_mix_decimate(
        *ptrs, outr.data_ptr(), outi.data_ptr(), nhr.data_ptr(),
        nhi.data_ptr(), b, n, hist, p, q, kw, inner,
        _build.stream_handle(dev))
    _build.check(err, "fused_mix_decimate")
    return outr, outi, nhr, nhi


fused_mix_decimate.launches = 0
