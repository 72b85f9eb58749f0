"""Overlap-save filter by a four-step DFT, with or without an FM-demod
prologue.

Counterparts of ``radiorust_tpu/ops/pallas_filter.py``:

- :func:`fused_overlap_save` of ``fused_overlap_save``: one overlap-save
  step on [prev m || cur n] complex planes against a response grid;
- :func:`fused_filter_bank` of ``fused_filter_bank``: K overlap-save
  filters of one stream sharing its forward transform, output
  [batch, K, n];
- :func:`fused_demod_filter` of ``fused_demod_filter``: quadrature FM
  demod with its continuity state, then the overlap-save filter on the
  real demodulated streams, stream pairs packed as re/im of one
  transform (exact for a real impulse response);
- :func:`fused_filter_demod_filter` of ``fused_filter_demod_filter``:
  the complex channel filter, then the demod and filter above, carrying
  the last *filtered* sample.

Layout (as the JAX package's): time t = i2 + n2*i1 and frequency
k = k1 + n1*k2 on an n1 x n2 grid of the N = m + n point transform.  The
plan (:func:`kernel_factors`) takes n2 a power of two dividing N: 128
where it divides (the JAX package's lane factor, so its grids and the
port's agree there), less where it does not, and 256 where that brings a
long transform's column under 768 points; :func:`response_grid` maps a
response vector R[N] to the [n1, n2] grid with the inverse's 1/N folded
in.

The kernels run the length-n1 column transforms as mixed-radix Stockham
passes (:func:`fft_radices` gives the pass order) on strips of
:func:`strip_cols` columns in shared memory (a column past a one-column
strip, n1 > 9685, one launch per pass in device memory instead), and the
n2-point row transforms in registers: a radix-n2/32 pass across a lane's
values and radix-2 passes across the lanes (a row of fewer than 32
points takes n2 lanes); every twiddle comes from the float32 root tables
of :func:`fft_roots`.

Two routes, chosen by the geometry alone.  The cluster route is one
launch, one thread block cluster a stream (#3: C = min(4, n2) blocks,
wherever :func:`filter_cluster_size` is not 0) or a stream pair (#5, #6:
C = min(8, n2), wherever :func:`cluster_size` is not 0), whose shared
memory holds the grids from the input load to the output store (no
scratch is allocated).  Elsewhere (#4 always; #3 past 96 rows, where the
stage route measured faster; #5 and #6 where a block's share is past
shared memory) the stage route runs: three launches (forward columns,
rows, inverse columns) over a device-memory scratch, after the demod
prologue for #5 and #6.

Each wrapper takes the JAX function's arguments as float32 tensors.  On
CUDA it launches the kernels of ``csrc/overlap_save.cu`` and counts the
launch in its ``launches`` attribute (#3, #5 and #6 count a launch of
the cluster route also in ``cluster_launches``); on the CPU it runs the
plain ``torch.fft`` version beside it (``*_plain``).  A counter counts where a
wrapper is called: under a captured CUDA graph (``jit_step``, ``make_scan``)
that is at capture, and a replay counts nothing.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import _build

__all__ = ["kernel_factors", "strip_cols", "supported", "bank_supported",
           "cluster_size", "cluster_bytes", "filter_cluster_size",
           "fft_radices",
           "fft_roots", "response_grid", "fused_overlap_save",
           "fused_overlap_save_plain", "fused_filter_bank",
           "fused_filter_bank_plain", "fused_demod_filter",
           "fused_demod_filter_plain", "fm_demod_planes",
           "fused_filter_demod_filter",
           "fused_filter_demod_filter_plain"]

N2 = 128          # the row length wherever it divides the transform
_MAX_N2 = 256     # the longest row: 8 values a lane
_MAX_N1 = 768     # the longest column of a 16-column strip; past it the
                  # plan takes 256-point rows where N allows
_SMEM = 232448    # shared bytes a block may use (kMaxSmem in the kernels)
_RADICES = (8, 4, 2, 3, 5)   # the kernel's specialised butterflies
_CLUSTER = 8      # blocks of #5's and #6's clusters (the portable size)
_FILTER_CLUSTER = 4   # blocks of #3's clusters, one a stream
_FILTER_CLUSTER_ROWS = 96   # #3's longest column on the cluster route


def strip_cols(n1: int, n2: int) -> int:
    """Columns of a strip in the column launches (``strip_cols`` in
    csrc/overlap_save.cu): the widest of 32, 16, ..., 1 within the row
    length whose two buffers of n1 rows (re and im each) and n1 roots fit
    shared memory; 0 where not even one column fits (the column launches
    then run their passes in device memory)."""
    for c in (32, 16, 8, 4, 2, 1):
        if c <= n2 and 4 * (4 * n1 * c + 2 * n1) <= _SMEM:
            return c
    return 0


def cluster_bytes(n1: int, n2: int, merged: bool = False) -> int:
    """Shared bytes a block of the cluster route takes (``cluster_bytes``
    in csrc/overlap_save.cu): two buffers of the block's W = n2 / C
    columns of the pair's one grid (#5) or two grids (#6, ``merged``), re
    and im planes of n1 rows each, and the n1 column and n2 row roots."""
    w = n2 // min(_CLUSTER, n2)
    return 4 * ((8 if merged else 4) * n1 * w + 2 * n1 + 2 * n2)


def cluster_size(n_total: int, merged: bool = False) -> int:
    """Blocks C of the cluster that runs #5 (#6 where ``merged``) in one
    launch on an n_total-point transform: min(8, n2), one strip of n2 / C
    columns a block; 0 where a block's share (:func:`cluster_bytes`) does
    not fit shared memory, and the kernel takes the stage route.  The rule
    is the geometry's alone: at n2 = 128, #5 up to n1 = 876 and #6 up to
    445; at n2 = 256, #5 up to 443, #6 never."""
    n1, n2 = kernel_factors(n_total)
    if cluster_bytes(n1, n2, merged) > _SMEM:
        return 0
    return min(_CLUSTER, n2)


def filter_cluster_size(n_total: int) -> int:
    """Blocks C of the cluster that runs #3 on one stream of an
    n_total-point transform in one launch: min(4, n2), one strip of n2 / C
    columns a block, up to n1 = 96 rows; 0 past them, and #3 takes the
    stage route.  The boundary is the measured crossover
    (``tools/filter_split.py --crossover``): at batch 64 the one launch is
    faster up to n1 = 96 and not from 100 on (A's 120 x 128 among them),
    where each block's passes outweigh the gaps and scratch of the stage
    route's three launches of the whole card.  The rule is the geometry's alone; a block's share at 96
    rows (50.9 KB at n2 = 128) is far within shared memory."""
    n1, n2 = kernel_factors(n_total)
    return min(_FILTER_CLUSTER, n2) if n1 <= _FILTER_CLUSTER_ROWS else 0


def kernel_factors(n_total: int):
    """(n1, n2) of the kernels' plan for an n_total-point transform (None
    for n_total < 1): n2 is the largest power of two dividing n_total up
    to 128, or 256 where n_total / 128 is past 768 and 256 divides
    n_total; n1 = n_total / n2.  A column past a one-column strip
    (:func:`strip_cols` 0, n1 > 9685) runs its passes in device memory."""
    if n_total < 1:
        return None
    n2 = 1
    while n2 < N2 and n_total % (2 * n2) == 0:
        n2 *= 2
    if n2 == N2 and n_total // N2 > _MAX_N1 and n_total % _MAX_N2 == 0:
        n2 = _MAX_N2
    return n_total // n2, n2


def supported(n: int, m: int = None) -> bool:
    """Whether the kernel takes n new samples per step against an m-tap
    history (m = n when omitted): every N = m + n that 32-bit sample
    indices reach.  Columns that fit a strip of shared memory run there,
    longer ones in device memory."""
    if m is None:
        m = n
    return 0 < m and 0 < n and n + m < 2 ** 31


def bank_supported(n: int, K: int, m: int = None, batch: int = None) -> bool:
    """Whether the bank kernel takes K bands of n new samples per step
    against an m-tap history: the transform geometry of :func:`supported`,
    and (for a known ``batch``) a band scratch of K * batch * (n + m)
    samples that 32-bit row indices reach."""
    if K < 1 or not supported(n, m):
        return False
    m = n if m is None else m
    return batch is None or K * batch * (n + m) < 2 ** 31


def response_grid(response: torch.Tensor) -> torch.Tensor:
    """Map a complex response R[..., N] to the [..., n1, n2] grid
    (k = k1 + n1*k2) with the inverse transform's 1/N folded in."""
    N = response.shape[-1]
    n1, n2 = kernel_factors(N)
    g = response.reshape(*response.shape[:-1], n2, n1).transpose(-2, -1)
    # Divide re and im apart: torch's complex-by-real division rounds
    # differently from the JAX package's grid.
    return torch.complex(g.real / N, g.imag / N)


def fft_radices(n: int) -> Tuple[int, ...]:
    """The kernel's pass order for a length-n transform: radix 8 while it
    divides, then 4 or 2, then 3s, 5s, and each other prime factor as one
    generic pass (ascending).  The product is n; n = 1 has no pass."""
    out = []
    for p in _RADICES:
        while n % p == 0:
            out.append(p)
            n //= p
    p = 7
    while n > 1:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 2
    return tuple(out)


def fft_roots(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) float32 of exp(-2 pi i j / n), j < n: every twiddle of a
    length-n transform (and, at index j * n / p, every root of its
    radix-p butterflies).  Designed in float64, cast to float32."""
    w = np.exp(-2j * np.pi * np.arange(n) / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _tables(N: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernels' float32 tables, packed: the n1 column roots (re, im),
    the n2 row roots (re, im) and the four-step twiddle exp(-2 pi i k1 i2
    / N) [n1, n2] (re, im); and the int32 column radices."""
    n1, n2 = kernel_factors(N)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / N)
    floats = np.concatenate([*fft_roots(n1), *fft_roots(n2),
                             tw.real.astype(np.float32).ravel(),
                             tw.imag.astype(np.float32).ravel()])
    return floats, np.asarray(fft_radices(n1), np.int32)


_device_tables = {}


def _constants(N: int, n: int, device) -> Tuple[int, int, tuple]:
    """(n1, ho, (tables, radices, number of passes, n2)) with the tables
    on ``device``, uploaded once per transform size and device; ho =
    ceil(n / n2) output rows."""
    n1, n2 = kernel_factors(N)
    ho = -(-n // n2)
    key = (N, str(device))
    if key not in _device_tables:
        _device_tables[key] = tuple(torch.from_numpy(c).to(device)
                                    for c in _tables(N))
    floats, radices = _device_tables[key]
    return n1, ho, (floats.data_ptr(), radices.data_ptr(), len(radices), n2)


def _check_geometry(n: int, m: int):
    if not supported(n, m):
        raise ValueError(f"overlap-save geometry m={m}, n={n} is not one "
                         f"the kernel takes: 32-bit sample indices do not "
                         f"reach its transform")


def _column_scratch(N: int, rows: int, device) -> Tuple[int, int, tuple]:
    """(re, im pointers, planes) of the column scratch [rows, N] of the
    device-memory column route, where the plan's column does not fit a
    one-column strip; (0, 0, ()) where it does."""
    if strip_cols(*kernel_factors(N)):
        return 0, 0, ()
    planes = tuple(torch.empty((rows, N), dtype=torch.float32, device=device)
                   for _ in range(2))
    return planes[0].data_ptr(), planes[1].data_ptr(), planes


def _grid_vector(resp_gr, resp_gi) -> torch.Tensor:
    """Grid planes [..., n1, n2] back to the response vector [..., N] at
    k = k1 + n1*k2."""
    g = torch.complex(resp_gr, resp_gi).transpose(-2, -1)
    return g.reshape(*g.shape[:-2], -1)


def fused_overlap_save_plain(prevr, previ, curr, curi, resp_gr, resp_gi):
    """Plain PyTorch version of :func:`fused_overlap_save` (``torch.fft``
    on the whole [prev || cur] buffer)."""
    n = curr.shape[-1]
    z = torch.complex(torch.cat([prevr, curr], dim=-1),
                      torch.cat([previ, curi], dim=-1))
    g = _grid_vector(resp_gr, resp_gi)
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
    return _overlap_save_launch(
        *tensors, cluster=bool(filter_cluster_size(m + n)))


def _overlap_save_launch(prevr, previ, curr, curi, resp_gr, resp_gi,
                         cluster: bool):
    """#3 on CUDA tensors by the cluster route (``cluster``) or the stage
    route: the wrapper's launch once its rule has picked the route, and
    the tool that times both routes against each other."""
    b, n = curr.shape
    m = prevr.shape[1]
    dev = curr.device
    N = m + n
    n1, ho, consts = _constants(N, n, dev)
    ptr = _build.f32_ptr
    outr, outi = (torch.empty((b, n), dtype=torch.float32, device=dev)
                  for _ in range(2))
    if cluster:
        fused_overlap_save.launches += 1
        fused_overlap_save.cluster_launches += 1
        err = _build.lib().rr_overlap_save_cluster(
            ptr(prevr, "prevr"), ptr(previ, "previ"), m,
            ptr(curr, "curr"), ptr(curi, "curi"), n, m, n, b, *consts,
            ptr(resp_gr, "resp_gr"), ptr(resp_gi, "resp_gi"),
            outr.data_ptr(), outi.data_ptr(), n, n1, ho,
            _build.stream_handle(dev))
        _build.check(err, "fused_overlap_save (cluster route)")
        return outr, outi
    scr_r, scr_i = (torch.empty((b, N), dtype=torch.float32, device=dev)
                    for _ in range(2))
    tr, ti, _tmp = _column_scratch(N, b, dev)
    fused_overlap_save.launches += 1
    err = _build.lib().rr_overlap_save(
        ptr(prevr, "prevr"), ptr(previ, "previ"), m,
        ptr(curr, "curr"), ptr(curi, "curi"), n, m, n, b, *consts,
        ptr(resp_gr, "resp_gr"), ptr(resp_gi, "resp_gi"),
        scr_r.data_ptr(), scr_i.data_ptr(), outr.data_ptr(),
        outi.data_ptr(), n, n1, ho, tr, ti, _build.stream_handle(dev))
    _build.check(err, "fused_overlap_save")
    return outr, outi


fused_overlap_save.launches = 0
fused_overlap_save.cluster_launches = 0


def fused_filter_bank_plain(prevr, previ, curr, curi, resp_gr, resp_gi):
    """Plain PyTorch version of :func:`fused_filter_bank` (one
    ``torch.fft`` forward, K response multiplies, K inverses)."""
    n = curr.shape[-1]
    z = torch.complex(torch.cat([prevr, curr], dim=-1),
                      torch.cat([previ, curi], dim=-1))
    g = _grid_vector(resp_gr, resp_gi)                  # [K, N]
    spec = torch.fft.fft(z)[:, None, :] * g[None]       # [b, K, N]
    y = torch.fft.ifft(spec, norm="forward")[..., :n]
    return y.real.contiguous(), y.imag.contiguous()


def fused_filter_bank(prevr, previ, curr, curi, resp_gr, resp_gi):
    """K overlap-save filters over each stream, sharing its forward
    transform.

    ``prevr/previ``: [batch, m] history planes; ``curr/curi``: [batch, n]
    chunk planes; ``resp_gr/gi``: [K, n1, n2] stacked response grids
    (:func:`response_grid` per band).  Returns (outr, outi) float32
    [batch, K, n]: band k of stream s at ``out[s, k]``.
    """
    b, n = curr.shape
    m = prevr.shape[1]
    K = resp_gr.shape[0]
    tensors = (prevr, previ, curr, curi, resp_gr, resp_gi)
    if not _build.on_cuda(*tensors):
        return fused_filter_bank_plain(*tensors)
    _check_geometry(n, m)
    if not bank_supported(n, K, m, b):
        raise ValueError(f"filter bank K={K}, batch={b}, N={n + m} is "
                         f"past the kernel's 32-bit row indices")
    dev = curr.device
    N = m + n
    n1, ho, consts = _constants(N, n, dev)
    ptr = _build.f32_ptr
    fr, fi = (torch.empty((b, N), dtype=torch.float32, device=dev)
              for _ in range(2))
    br, bi = (torch.empty((K * b, N), dtype=torch.float32, device=dev)
              for _ in range(2))
    outr, outi = (torch.empty((b, K, n), dtype=torch.float32, device=dev)
                  for _ in range(2))
    tr, ti, _tmp = _column_scratch(N, K * b, dev)
    names = ("prevr", "previ", "curr", "curi")
    fused_filter_bank.launches += 1
    err = _build.lib().rr_filter_bank(
        *(ptr(t, nm) for t, nm in zip(tensors, names)), m, n, b, K,
        *consts, ptr(resp_gr, "resp_gr"), ptr(resp_gi, "resp_gi"),
        fr.data_ptr(), fi.data_ptr(), br.data_ptr(), bi.data_ptr(),
        outr.data_ptr(), outi.data_ptr(), n1, ho, tr, ti,
        _build.stream_handle(dev))
    _build.check(err, "fused_filter_bank")
    return outr, outi


fused_filter_bank.launches = 0


def _factor_vector(factor, b: int, device,
                   dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(factor, dtype=dtype,
                           device=device).expand(b).contiguous()


def _factor_arg(factor, b: int, device) -> Tuple[torch.Tensor, int]:
    """(tensor, stride) of the demod factor for a kernel that reads
    ``fac[s * stride]`` (#5's and #6's cluster route, #7): a device scalar
    or [b] vector read in place (stride 0 or 1), else a copy."""
    f = torch.as_tensor(factor, dtype=torch.float32, device=device)
    if f.numel() == 1:
        return f.reshape(1), 0
    return f.expand(b).contiguous(), 1


def fm_demod_planes(curr, curi, prev_last_r, prev_last_i, last_out,
                    have_prev, factor):
    """The demod prologue of :func:`fused_demod_filter` in plain PyTorch:
    ``atan2(Im, Re of x * conj(x[-1])) * factor`` over [batch, n] planes,
    x[-1] of sample 0 the carried ``prev_last``, sample 0 replaced by
    ``last_out`` where ``have_prev`` < 0.5.  Also the replica a time
    shard builds of its neighbour's demodulated tail
    (``parallel/time_shard.py``)."""
    b = curr.shape[0]
    sr = torch.cat([prev_last_r[:, None], curr[:, :-1]], dim=1)
    si = torch.cat([prev_last_i[:, None], curi[:, :-1]], dim=1)
    pre = curr * sr + curi * si
    pim = curi * sr - curr * si
    d = torch.atan2(pim, pre) * _factor_vector(factor, b, curr.device,
                                               curr.dtype)[:, None]
    d0 = torch.where(have_prev < 0.5, last_out, d[:, 0])
    return torch.cat([d0[:, None], d[:, 1:]], dim=1)


def fused_demod_filter_plain(curr, curi, prev_last_r, prev_last_i, prevd,
                             last_out, have_prev, resp_gr, resp_gi, factor):
    """Plain PyTorch version of :func:`fused_demod_filter`
    (:func:`fm_demod_planes` and ``torch.fft``)."""
    b, n = curr.shape
    m = prevd.shape[1]
    d = fm_demod_planes(curr, curi, prev_last_r, prev_last_i, last_out,
                        have_prev, factor)
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
    names = ("curr", "curi", "prev_last_r", "prev_last_i", "prevd",
             "last_out", "have_prev")
    ptrs = [_build.f32_ptr(t, nm) for t, nm in zip(tensors, names)]
    grid = [_build.f32_ptr(t, nm) for t, nm in ((resp_gr, "resp_gr"),
                                                (resp_gi, "resp_gi"))]
    dout = torch.empty((b, n), dtype=torch.float32, device=dev)
    y = torch.empty((b, n), dtype=torch.float32, device=dev)
    if cluster_size(N):
        fac, stride = _factor_arg(factor, b, dev)
        fused_demod_filter.launches += 1
        fused_demod_filter.cluster_launches += 1
        err = _build.lib().rr_demod_filter_cluster(
            *ptrs, fac.data_ptr(), stride, dout.data_ptr(), b, n, m, *consts,
            *grid, y.data_ptr(), n1, ho, _build.stream_handle(dev))
        _build.check(err, "fused_demod_filter (cluster route)")
        return y, dout
    fac = _factor_vector(factor, b, dev)
    zr, zi, scr_r, scr_i = (torch.empty((b // 2, N), dtype=torch.float32,
                                        device=dev) for _ in range(4))
    tr, ti, _tmp = _column_scratch(N, b // 2, dev)
    fused_demod_filter.launches += 1
    err = _build.lib().rr_demod_filter(
        *ptrs, fac.data_ptr(), dout.data_ptr(), zr.data_ptr(),
        zi.data_ptr(), b, n, m, *consts, *grid,
        scr_r.data_ptr(), scr_i.data_ptr(), y.data_ptr(), n1, ho, tr, ti,
        _build.stream_handle(dev))
    _build.check(err, "fused_demod_filter")
    return y, dout


fused_demod_filter.launches = 0
fused_demod_filter.cluster_launches = 0


def fused_filter_demod_filter_plain(prevr, previ, curr, curi, prev_last_r,
                                    prev_last_i, prevd, last_out, have_prev,
                                    r1_gr, r1_gi, r2_gr, r2_gi, factor):
    """Plain PyTorch version of :func:`fused_filter_demod_filter`: the
    plain channel filter, then the plain demod filter on its output."""
    f1r, f1i = fused_overlap_save_plain(prevr, previ, curr, curi, r1_gr,
                                        r1_gi)
    y, d = fused_demod_filter_plain(f1r, f1i, prev_last_r, prev_last_i,
                                    prevd, last_out, have_prev, r2_gr, r2_gi,
                                    factor)
    return y, d, f1r[:, -1].contiguous(), f1i[:, -1].contiguous()


def fused_filter_demod_filter(prevr, previ, curr, curi, prev_last_r,
                              prev_last_i, prevd, last_out, have_prev,
                              r1_gr, r1_gi, r2_gr, r2_gi, factor):
    """Channel filter + FM demod + deemphasis filter of one chunk step.

    ``prevr/previ``: [batch, m] history planes of the complex input;
    ``curr/curi``: [batch, n] chunk planes; ``prev_last_*``: [batch] last
    *filtered* sample of the previous step (returned by the previous
    call); ``prevd``: [batch, m] demodulated history (the same m);
    ``last_out``/``have_prev``: [batch] demod continuity (have_prev as a
    0/1 float); ``r1_*``/``r2_*``: response grids of the channel and the
    deemphasis filter (the latter from a real impulse response);
    ``factor``: demod factor, a scalar or [batch].  Returns (y [batch, n],
    d [batch, n], flr, fli [batch] last filtered sample).  The batch must
    be even.
    """
    b, n = curr.shape
    m = prevr.shape[1]
    if prevd.shape[1] != m:
        raise ValueError("merged kernel requires equal channel/deemphasis "
                         "history lengths")
    if b % 2:
        raise ValueError(f"batch {b} must be even (stream pairs share a "
                         f"transform)")
    tensors = (prevr, previ, curr, curi, prev_last_r, prev_last_i, prevd,
               last_out, have_prev, r1_gr, r1_gi, r2_gr, r2_gi)
    if not _build.on_cuda(*tensors):
        return fused_filter_demod_filter_plain(*tensors, factor)
    _check_geometry(n, m)
    dev = curr.device
    N = m + n
    n1, ho, consts = _constants(N, n, dev)
    names = ("prevr", "previ", "curr", "curi", "prev_last_r", "prev_last_i",
             "prevd", "last_out", "have_prev")
    ptrs = [_build.f32_ptr(t, nm) for t, nm in zip(tensors, names)]
    grids = [_build.f32_ptr(t, "response grid") for t in tensors[9:]]
    dout, y = (torch.empty((b, n), dtype=torch.float32, device=dev)
               for _ in range(2))
    flr, fli = (torch.empty((b,), dtype=torch.float32, device=dev)
                for _ in range(2))
    if cluster_size(N, merged=True):
        fac, stride = _factor_arg(factor, b, dev)
        fused_filter_demod_filter.launches += 1
        fused_filter_demod_filter.cluster_launches += 1
        err = _build.lib().rr_filter_demod_filter_cluster(
            *ptrs, fac.data_ptr(), stride, dout.data_ptr(), flr.data_ptr(),
            fli.data_ptr(), b, n, m, *consts, *grids, y.data_ptr(), n1, ho,
            _build.stream_handle(dev))
        _build.check(err, "fused_filter_demod_filter (cluster route)")
        return y, dout, flr, fli
    fac = _factor_vector(factor, b, dev)
    fr, fi = (torch.empty((b, n), dtype=torch.float32, device=dev)
              for _ in range(2))
    zr, zi = (torch.empty((b // 2, N), dtype=torch.float32, device=dev)
              for _ in range(2))
    scr_r, scr_i = (torch.empty((b, N), dtype=torch.float32, device=dev)
                    for _ in range(2))
    tr, ti, _tmp = _column_scratch(N, b, dev)
    fused_filter_demod_filter.launches += 1
    err = _build.lib().rr_filter_demod_filter(
        *ptrs, fac.data_ptr(), fr.data_ptr(), fi.data_ptr(), dout.data_ptr(),
        zr.data_ptr(), zi.data_ptr(), flr.data_ptr(), fli.data_ptr(), b, n,
        m, *consts, *grids, scr_r.data_ptr(),
        scr_i.data_ptr(), y.data_ptr(), n1, ho, tr, ti,
        _build.stream_handle(dev))
    _build.check(err, "fused_filter_demod_filter")
    return y, dout, flr, fli


fused_filter_demod_filter.launches = 0
fused_filter_demod_filter.cluster_launches = 0
