"""Polyphase filterbank channelizer, with or without a per-channel FM
demod.

Counterparts of the JAX package's ``ops/channelizer.py`` (plain tensor
code there too: the branch DFT is a ``torch.matmul``) and
``ops/pallas_channelizer.py``:

- :func:`pfb_channelize`: the critically sampled M-channel analysis
  filterbank, a K-tap branch FIR (:func:`branch_fir`) then an M-point DFT
  across branches (:func:`dft_channels`); channel ``c`` is centred at
  ``+c * rate / M`` (numpy bin convention);
- :func:`fused_pfb_demod` of ``fused_pfb_demod``: the same for M = 64,
  then the quadrature FM demod of every channel against its previous
  frame, in one pass, on float planes with the warm-up frames included;
- :func:`pfb_demod_step`: the same kernel as ``ChannelizerDemod``'s step,
  reading the complex64 history and chunk in place and writing the
  block's channel rows, its new history and last outputs.

On CUDA both launch the kernel of ``csrc/pfb_demod.cu`` and count the
launch in ``fused_pfb_demod.launches``; on the CPU they run their plain
versions (:func:`fused_pfb_demod_plain`, :func:`pfb_demod_step_plain`).
A counter counts where a wrapper is called: under a captured CUDA
graph (``jit_step``, ``make_scan``) that is at capture, and a replay
counts nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..math import sinc
from ..windowing import Kaiser
from . import _build
from .filter import _factor_arg, _factor_vector, fft_roots

__all__ = ["design_prototype", "branch_fir", "dft_channels",
           "pfb_channelize", "fused_pfb_demod", "fused_pfb_demod_plain",
           "pfb_demod_step", "pfb_demod_step_plain", "pfb_demod_supported",
           "HIST_FRAMES"]

M = 64            # channels of the fused kernel (kM in csrc/pfb_demod.cu)
HIST_FRAMES = 2   # warm-up frames recomputed per chunk (continuity + drop)
_TILE = 15        # output frames a block (kTile in csrc/pfb_demod.cu)
_WARPS = 4        # warps a block (kWarps)
_SMEM_LIMIT = 227 * 1024


def design_prototype(num_channels: int, taps_per_branch: int,
                     kaiser_null_bins: float = 1.3) -> np.ndarray:
    """Windowed-sinc prototype low-pass of ``M * K`` taps (float64): cutoff
    at half a channel spacing, Kaiser window, normalised so a tone at a
    channel centre keeps its amplitude through the branch DFT."""
    m, k = num_channels, taps_per_branch
    n = m * k
    window = Kaiser.with_null_at_bin(kaiser_null_bins * k)
    x = (np.arange(n, dtype=np.float64) + 0.5) - n / 2.0
    h = sinc(x / m) * window.relative_value_at(x * 2.0 / n)
    return (h / np.sum(h)).astype(np.float64)


@functools.lru_cache(maxsize=16)
def _dft_planes(m: int, dtype=np.float32):
    w = np.exp(-2j * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    return (w.real.astype(dtype), w.imag.astype(dtype))


_device_dft = {}


def _dft_tensors(m: int, device, dtype=torch.float32):
    """The DFT planes on ``device`` in ``dtype`` (float64 under the c128
    stream mode), uploaded once."""
    key = (m, str(device), dtype)
    if key not in _device_dft:
        npdt = np.float64 if dtype == torch.float64 else np.float32
        _device_dft[key] = tuple(torch.from_numpy(p).to(device)
                                 for p in _dft_planes(m, npdt))
    return _device_dft[key]


def branch_fir(fr: torch.Tensor, fi: torch.Tensor, taps: torch.Tensor,
               t_out: int):
    """K-tap polyphase branch FIR as K shifted multiply-adds: ``fr/fi``
    [b, T + K - 1, M] frame planes, ``taps`` [K, M]; returns (vr, vi)
    [b, t_out, M]."""
    k = taps.shape[0]
    b, _, m = fr.shape
    vr = torch.zeros((b, t_out, m), dtype=fr.dtype, device=fr.device)
    vi = torch.zeros_like(vr)
    for j in range(k):
        tj = taps[j][None, None, :].to(fr.dtype)
        vr = vr + fr[:, j: j + t_out, :] * tj
        vi = vi + fi[:, j: j + t_out, :] * tj
    return vr, vi


def dft_channels(vr: torch.Tensor, vi: torch.Tensor, dr: torch.Tensor,
                 di: torch.Tensor) -> torch.Tensor:
    """Branch DFT as a complex matrix product: ``vr/vi`` [b, T, M] branch
    values, ``dr/di`` [M, C] DFT columns; returns complex [b, T, C]."""
    yr = torch.matmul(vr, dr) - torch.matmul(vi, di)
    yi = torch.matmul(vr, di) + torch.matmul(vi, dr)
    return torch.complex(yr, yi)


def pfb_channelize(xp: torch.Tensor, taps: torch.Tensor,
                   num_channels: int) -> torch.Tensor:
    """Critically sampled analysis filterbank: ``xp`` [batch, hist + n]
    complex64 with ``hist = (K - 1) * M`` history samples prepended,
    ``taps`` [K, M] (``taps[k, m] = h[k*M + m]``).  Returns [batch, M,
    n / M] complex64, one decimated stream per channel."""
    b = xp.shape[0]
    k, m = taps.shape
    total = xp.shape[-1]
    t_out = total // m - (k - 1)
    frames = xp.reshape(b, total // m, m)
    vr, vi = branch_fir(frames.real, frames.imag, taps, t_out)
    dr, di = _dft_tensors(m, xp.device, vr.dtype)
    y = dft_channels(vr, vi, dr, di)                 # [b, T, M]
    return y.transpose(1, 2).contiguous()


def _smem_bytes(k: int) -> int:
    """Shared bytes of a block at k taps a branch (``smem_bytes`` in
    csrc/pfb_demod.cu): the staged frames of 72 complex samples, a
    warp's exchange tile (8 x 33 complex) and last frame (8 x 9), the
    taps."""
    return 8 * ((_TILE + k) * (M + 8) + _WARPS * 8 * (33 + 9)) + 4 * k * M


def _check_smem(k: int):
    if _smem_bytes(k) > _SMEM_LIMIT:
        raise ValueError(f"{k} taps per branch: the block's span does not "
                         f"fit shared memory")


_device_roots = {}


def _roots(device) -> torch.Tensor:
    """The kernel's float32 table of exp(-2 pi i j / 64), re then im, on
    ``device``, uploaded once."""
    key = str(device)
    if key not in _device_roots:
        _device_roots[key] = torch.from_numpy(
            np.concatenate(fft_roots(M))).to(device)
    return _device_roots[key]


def pfb_demod_supported(n: int, num_channels: int,
                        taps_per_branch: int) -> bool:
    """Whether the fused kernel takes this geometry: 64 channels, whole
    frames per chunk, and a block's staged span, exchange tiles and taps
    within shared memory (up to 256 taps a branch)."""
    return (num_channels == M and n % M == 0 and n >= M
            and taps_per_branch >= 1
            and _smem_bytes(taps_per_branch) <= _SMEM_LIMIT)


def fused_pfb_demod_plain(xr, xi, factor, taps):
    """Plain PyTorch version of :func:`fused_pfb_demod`: :func:`branch_fir`,
    :func:`dft_channels` (``torch.matmul``) and ``torch.atan2``."""
    b, total = xr.shape
    k, m = taps.shape
    frames = total // m - (k - 1)
    vr, vi = branch_fir(xr.reshape(b, total // m, m),
                        xi.reshape(b, total // m, m), taps, frames)
    dr, di = _dft_tensors(m, xr.device, vr.dtype)
    y = dft_channels(vr, vi, dr, di)                 # [b, T, M]
    prev = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], dim=1)
    pre = y.real * prev.real + y.imag * prev.imag
    pim = y.imag * prev.real - y.real * prev.imag
    fac = _factor_vector(factor, b, xr.device, xr.dtype)
    d = torch.atan2(pim, pre) * fac[:, None, None]
    return d.reshape(b, frames * m)


def fused_pfb_demod(xr, xi, factor, taps):
    """Channelize + demodulate one chunk.

    ``xr/xi``: [batch, (K + 1) * M + n] float32 planes, ``HIST_FRAMES +
    K - 1`` frames of raw-input history before the n new samples;
    ``factor``: demod factor, a scalar or [batch]; ``taps``: [K, M]
    branch-major prototype.  Returns ``d`` [batch, 2 * M + n] float32,
    frame-major (frame t, channel c at ``t * M + c``); the first
    ``HIST_FRAMES`` frames are warm-up for the caller to drop (frame 0
    has no predecessor and demodulates against 0).
    """
    b, total = xr.shape
    k, m = taps.shape
    if m != M or total % M or total // M - (k - 1) < 1:
        raise ValueError(f"fused_pfb_demod takes {M} channels and whole "
                         f"frames; got taps {tuple(taps.shape)}, "
                         f"{total} samples")
    if not _build.on_cuda(xr, xi, taps):
        return fused_pfb_demod_plain(xr, xi, factor, taps)
    _check_smem(k)
    dev = xr.device
    fac, fac_stride = _factor_arg(factor, b, dev)
    d = torch.empty((b, total - (k - 1) * M), dtype=torch.float32,
                    device=dev)
    ptr = _build.f32_ptr
    fused_pfb_demod.launches += 1
    err = _build.lib().rr_pfb_demod(
        ptr(xr, "xr"), ptr(xi, "xi"), fac.data_ptr(), fac_stride,
        ptr(taps, "taps"), _roots(dev).data_ptr(), d.data_ptr(), b, total, k,
        _build.stream_handle(dev))
    _build.check(err, "fused_pfb_demod")
    return d


fused_pfb_demod.launches = 0


def pfb_demod_step_plain(hist, x, reset, have_prev, last_out, factor, taps):
    """Plain PyTorch version of :func:`pfb_demod_step`: the block's glue
    around :func:`fused_pfb_demod_plain`."""
    b, n = x.shape
    hist = torch.where(reset[:, None], torch.zeros_like(hist), hist)
    have = have_prev & ~reset
    xp = torch.cat([hist, x], dim=-1)
    d = fused_pfb_demod_plain(xp.real.contiguous(), xp.imag.contiguous(),
                              factor, taps)
    d = d[:, HIST_FRAMES * M:]                   # drop warm-up frames
    # First output frame: channels whose stream just (re)started repeat
    # the last output instead of demodulating against zero history.
    first = torch.where(have[:, None], d[:, :M], last_out)
    d = torch.cat([first, d[:, M:]], dim=-1)
    # Frame-major [b, T*M] -> folded channel rows [b*M, T].
    y = d.reshape(b, n // M, M).transpose(1, 2).reshape(b * M, n // M)
    return (torch.complex(y, torch.zeros_like(y)), xp[:, -hist.shape[1]:],
            d[:, -M:])


def pfb_demod_step(hist, x, reset, have_prev, last_out, factor, taps):
    """One ``ChannelizerDemod`` step.

    ``hist``: [batch, (K + 1) * M] complex64 raw-input history (read as
    zeros where ``reset``); ``x``: [batch, n] complex64 chunk, n a
    multiple of M; ``reset``, ``have_prev``: [batch] bool; ``last_out``:
    [batch, M] float32 last output frame; ``factor``: demod factor, a
    scalar or [batch]; ``taps``: [K, M].  Returns (y [batch * M, n / M]
    complex64 channel rows with a zero imaginary part, the new history
    [batch, (K + 1) * M], the new last output frame [batch, M]).
    """
    b, n = x.shape
    k, m = taps.shape
    if m != M or n % M or n < M or tuple(hist.shape) != (b, (k + 1) * M):
        raise ValueError(f"pfb_demod_step takes {M} channels, whole frames "
                         f"and a history of K + 1 frames; got taps "
                         f"{tuple(taps.shape)}, chunk {n}, history "
                         f"{tuple(hist.shape)}")
    tensors = (hist, x, reset, have_prev, last_out, taps)
    if not _build.on_cuda(*tensors):
        return pfb_demod_step_plain(hist, x, reset, have_prev, last_out,
                                    factor, taps)
    _check_smem(k)
    for t, name, dtype in ((hist, "hist", torch.complex64),
                           (x, "x", torch.complex64),
                           (reset, "reset", torch.bool),
                           (have_prev, "have_prev", torch.bool)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes a contiguous {dtype} "
                             f"tensor, got {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")
    dev = x.device
    fac, fac_stride = _factor_arg(factor, b, dev)
    y = torch.empty((b * M, n // M), dtype=torch.complex64, device=dev)
    new_hist = torch.empty_like(hist)
    last = torch.empty((b, M), dtype=torch.float32, device=dev)
    ptr = _build.f32_ptr
    fused_pfb_demod.launches += 1
    err = _build.lib().rr_pfb_demod_step(
        hist.data_ptr(), x.data_ptr(), reset.data_ptr(), have_prev.data_ptr(),
        ptr(last_out, "last_out"), fac.data_ptr(), fac_stride,
        ptr(taps, "taps"), _roots(dev).data_ptr(), y.data_ptr(),
        new_hist.data_ptr(), last.data_ptr(), b, n, k,
        _build.stream_handle(dev))
    _build.check(err, "pfb_demod_step")
    return y, new_hist, last
