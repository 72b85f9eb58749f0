"""Rational FIR decimation, with or without a mixer prologue.

Counterparts of ``radiorust_tpu/ops/pallas_frontend.py``:

- :func:`decimate` of ``pallas_decimate``: p:q decimation of one real
  float32 plane or two (re, im) over ``[hist || x]``;
- :func:`fused_mix_decimate` of ``fused_mix_decimate``: the same after
  mixing x with the factored oscillator tables and a per-stream start
  phasor, with the history kept in the mixed domain.

These two take the JAX functions' arguments, float32 planes.  The blocks
call :func:`decimate_complex` and :func:`fused_mix_decimate_complex`,
which launch the same kernels on complex64 tensors in place: the kernel
reads their (re, im) pairs at element stride 2, through pointers (no view
is made), and writes complex64 outputs and histories, so no plane is
split or merged around it.  On CUDA tensors every wrapper launches a
hand-written kernel of ``csrc/decimate.cu`` (#2's wide form:
``csrc/mix_decimate_wide.cu``) and counts the launch in
``decimate.launches`` or ``fused_mix_decimate.launches``; on CPU tensors
it runs the plain PyTorch version beside it (``*_plain``).  A counter counts
where a wrapper is called: under a captured CUDA graph (``jit_step``,
``make_scan``) that is at capture, and a replay counts nothing.

:func:`decimate_phase_complex` runs a phase-mode step (a chunk that is
not a whole number of periods) on the same kernel's wide form at an
offset it reads from the grid phase in device memory
(``rr_decimate_phase``); its plain version is
:func:`~radiorust_tpu_torch.ops.polyphase.rational_fir_phase`.

The kernel reads the taps re-laid by phase, :func:`relay_taps`, built
once per taps tensor on its device.  A plan whose phases or staged span
pass one block of that kernel (:func:`fits_block`: more than 16 output
phases, as 48 kHz -> 44.1 kHz has 147) runs :func:`decimate` on the
kernel's wide form instead (``rr_decimate_wide``), as every phase-mode
step does: the taps re-laid to their bands (:func:`wide_layout`, once
per taps tensor), one output a thread or lane group, the launch shaped
by :func:`wide_config`.  The mixer form does the same: a plan past one
block runs :func:`fused_mix_decimate` on #2's wide form
(``rr_mix_decimate_wide``, ``csrc/mix_decimate_wide.cu``), which mixes
each staged sample once and sums by the route :func:`mix_wide_route`
picks from the plan: a 3xTF32 product on the tensor cores where the
bands are dense, FMA over the bands where they are sparse
(:func:`mix_wide_layout`, once per taps tensor; the launch shaped by
:func:`mix_wide_config`).
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .polyphase import rational_fir, rational_fir_phase

__all__ = ["decimate", "decimate_plain", "fused_mix_decimate",
           "fused_mix_decimate_plain", "decimate_complex",
           "decimate_complex_plain", "decimate_phase_complex",
           "rational_fir_phase", "fused_mix_decimate_complex",
           "fused_mix_decimate_complex_plain", "mix_tail",
           "decimate_supported",
           "relay_taps", "launch_config", "fits_block", "wide_config",
           "wide_layout", "WideLayout", "mix_wide_route", "mix_wide_layout",
           "MixWideLayout", "mix_wide_config", "MixWideShape",
           "mma_fragments"]

# Shared memory one block may take and threads a block may have
# (kMaxThreads in csrc/decimate.cu) on an H100.
_SMEM_LIMIT = 227 * 1024
_MAX_THREADS = 512
# The wide form (kWideThreads, kWideNW in csrc/decimate.cuh): at most 256
# threads a block and 8 windows a thread; bands of _WIDE_LONG taps or more
# are split over lane groups of _WIDE_GROUP; a call aims at _WIDE_FILL
# blocks (two on each of the H100's 132 SMs) before it takes more windows
# a thread.
_WIDE_THREADS = 256
_WIDE_NW = 8
_WIDE_LONG = 128
_WIDE_GROUP = 8
_WIDE_FILL = 264
# #2's wide form (csrc/mix_decimate_wide.cu).  The tensor-core route takes
# a plan with one phase block, p a whole number of 8-deep k-steps, its
# (period, phase) columns within one warp's _MMA_TILES n-tiles of 8, and
# at least _MMA_USEFUL of the product's multiplies on nonzero taps (a
# threshold set between the plans timed on both routes, 43% and more on
# the tensor cores, 4% by FMA: no plan between was timed).  Its tiles
# hold 16 mt span rows (mt <= _MMA_MT), its warps one m-tile each over a
# k-range (_MMA_WARPS in all); the tile length minimises the blocks a
# wave of _SMS SMs runs times the rows each stages and multiplies (16 mt,
# plus _MMA_BLOCK_ROWS of a block's fixed work).
_MMA_TILES = 8
_MMA_USEFUL = 0.25
_MMA_MT = 4
_MMA_WARPS = 8
_MMA_BLOCK_ROWS = 8
_SMS = 132


def _apad(kw: int, p: int) -> int:
    """Taps per phase: ceil(Kw / p) rounded up to a multiple of 8."""
    a = -(-kw // p)
    return -(-a // 8) * 8


def relay_taps(kernel_matrix: torch.Tensor, p: int) -> torch.Tensor:
    """The kernel's tap layout: [q, Kw] -> [q, p, apad] float32 with
    ``out[r, c, a] = W[r, a*p + c]``, zero where ``a*p + c >= Kw``."""
    q, kw = kernel_matrix.shape
    apad = _apad(kw, p)
    w = torch.zeros((q, apad * p), dtype=torch.float32,
                    device=kernel_matrix.device)
    w[:, :kw] = kernel_matrix
    return w.reshape(q, apad, p).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def launch_config(p: int, q: int, kw: int):
    """(R, G) of a launch: R = 8 outputs per thread, so a block's tile is
    256 periods (4 and 128 where that does not fit shared memory), and G
    tap groups: one per output phase where q > 1 (the block has q warps
    already), else 8, up to 16 for long windows (the fastest of those
    measured on an H100 at the paths' geometries)."""
    ftot = p * _apad(kw, p)
    for r in (8, 4):
        g = 1 if q > 1 else min(16, max(8, ftot // 512), ftot // r)
        if _smem_bytes(2, p, q, kw, r, g) <= _SMEM_LIMIT:
            break
    return r, g


def _smem_bytes(nplanes: int, p: int, q: int, kw: int, r: int,
                g: int) -> int:
    """Shared bytes of a launch (``smem_bytes`` in csrc/decimate.cu)."""
    apad = _apad(kw, p)
    tm = 32 * r
    lx = tm + apad
    ph = lx - 1 + (lx - 1) // r + 1
    ph += (12 - ph % 8) % 8
    rs = tm - 1 + (tm - 1) // r + 1
    return 4 * (q * p * apad + max(nplanes * p * ph, nplanes * g * q * rs))


def fits_block(p: int, q: int, kw: int, nplanes: int = 2) -> bool:
    """Whether a plan runs on the polyphase kernel (``rr_decimate``): its
    q phases on at most 16 warps with :func:`launch_config`'s groups, its
    staged span and [q, p, apad] taps within shared memory, and its
    multiply-shift divisions exact.  Else it runs on the wide form."""
    r, g = launch_config(p, q, kw)
    return (32 * g * q <= _MAX_THREADS
            and _smem_bytes(nplanes, p, q, kw, r, g) <= _SMEM_LIMIT
            and (32 * r + _apad(kw, p) + 8) * p * p < 2 ** 31)


@dataclass(frozen=True, eq=False)
class WideLayout:
    """The wide form's taps, re-laid once per taps tensor: ``taps`` [U,
    ls] float32, the distinct bands of nonzero taps (each from column 0,
    zero padded; a downsample plan's rows are one prototype at q offsets,
    so U = 1), ``rows`` [q, 3] int32 (lo_r, L_r, band: the band's first
    tap in W, its length, 0 for a row of zeros, and which of ``taps``)
    and ``zband`` [ceil(q / nr), 4] int32 (a phase block's joint band:
    first tap ulo, width; the bands its rows read, [u0, u0 + un)); ``g``
    lanes an output, ``nr`` phases a block, ``un`` the most bands a
    block reads, ``wmax`` the widest joint band.  numpy arrays from
    :func:`wide_layout`, tensors on the taps' device in the wrapper."""
    taps: object
    rows: object
    zband: object
    g: int
    ls: int
    nr: int
    un: int
    wmax: int

    @property
    def shape(self):
        """What :func:`wide_config` reads: (g, ls, nr, un, wmax, blocks
        of phases)."""
        return self.g, self.ls, self.nr, self.un, self.wmax, len(self.zband)


def wide_layout(kernel_matrix: np.ndarray) -> WideLayout:
    """The wide form's band layout of a [q, Kw] taps matrix (host numpy).
    Lane groups: G = 8 where the longest band has 128 taps or more, else
    1.  Row stride ls >= L with ls = G mod 2 G, so the lanes' tap reads
    fall in distinct banks.  Equal bands are stored once.  Phases a
    block: nr <= 256 / G (fewer while the block's bands pass half of
    shared memory), spread evenly over ceil(q / nr) blocks."""
    w = np.asarray(kernel_matrix, dtype=np.float32)
    q, kw = w.shape
    nz = w != 0
    have = nz.any(axis=1)
    lo = np.where(have, nz.argmax(axis=1), 0)
    hi = np.where(have, kw - nz[:, ::-1].argmax(axis=1), 0)
    lens = hi - lo
    L = int(lens.max())
    g = _WIDE_GROUP if L >= _WIDE_LONG else 1
    ls = L + (g - L % (2 * g)) % (2 * g)
    index, bands = {}, []
    band = np.zeros(q, np.int64)
    for r in range(q):
        key = w[r, lo[r]:hi[r]].tobytes()
        if key not in index:
            index[key] = len(bands)
            bands.append(w[r, lo[r]:hi[r]])
        band[r] = index[key]
    taps = np.zeros((len(bands), ls), np.float32)
    for u, v in enumerate(bands):
        taps[u, :len(v)] = v
    nr = _WIDE_THREADS // g
    while True:
        blocks = -(-q // nr)
        nr_even = -(-q // blocks)
        zband = np.zeros((blocks, 4), np.int32)
        for z in range(blocks):
            sel = slice(z * nr_even, min(q, (z + 1) * nr_even))
            u0, u1 = int(band[sel].min()), int(band[sel].max()) + 1
            zband[z, 2:] = u0, u1 - u0
            if have[sel].any():
                ulo = int(lo[sel][have[sel]].min())
                zband[z, :2] = ulo, int(hi[sel].max()) - ulo
        un = int(zband[:, 3].max())
        if nr == 1 or 4 * un * ls <= _SMEM_LIMIT // 2:
            break
        nr //= 2
    rows = np.stack([lo, lens, band], 1).astype(np.int32)
    return WideLayout(taps, rows, zband, g, ls, nr_even, un,
                      int(zband[:, 1].max()))


def _wide_span(p: int, wmax: int, tm: int):
    """(xs, xlen) of a wide block's staged span for tm windows: one run
    at stride p where windows overlap (p <= width), else one run a window
    at a stride xs >= width of p's parity (the 16-byte shift holds for
    every run); xlen positions in all."""
    if p <= wmax:
        return p, (tm - 1) * p + wmax
    xs = wmax + ((wmax ^ p) & 1)
    return xs, tm * xs


def _wide_smem(nplanes: int, un: int, ls: int, xlen: int) -> int:
    """Shared bytes of a wide launch (``wide_smem_bytes`` in
    csrc/decimate.cu): un bands at their 16-byte phase, then xlen + 1
    positions of the span."""
    return 4 * (((un * ls + 6) & ~3) + nplanes * (xlen + 1))


def _band_tile(g: int, nr: int, zb: int, windows: int, batch: int,
               span):
    """The FMA sums' tile (#1's wide form, #2's FMA route): ws windows
    across a block's threads (nr phases of g lanes), nw in each thread's
    registers, tm = ws nw a tile; nw the largest that still gives
    :data:`_WIDE_FILL` blocks (else 1, the most blocks).  ``span(tm)``:
    the launch's fields that depend on tm, the last its shared bytes.
    (ws, nw, threads, span(tm)), or None where no tile fits a block."""
    ws = max(1, min(_WIDE_THREADS // (nr * g), windows))
    threads = -(-nr * g * ws // 32) * 32
    best = None
    for nw in range(1, _WIDE_NW + 1):
        if nw > 1 and (nw - 1) * ws >= windows:
            break
        got = span(ws * nw)
        if got[-1] > _SMEM_LIMIT:
            break
        blocks = batch * -(-windows // (ws * nw)) * zb
        if best is None or blocks >= _WIDE_FILL:
            best = (ws, nw, threads, got)
    return best


@functools.lru_cache(maxsize=None)
def wide_config(shape, p: int, windows: int, batch: int, nplanes: int):
    """(ws, nw, xs, xlen, threads, smem) of a wide launch of ``windows``
    windows a stream (n / p aligned, ceil(n / p) in phase mode) at the
    layout's ``shape`` (:attr:`WideLayout.shape`): ws windows across a
    block's threads, nw in each thread's registers (tm = ws nw a tile,
    :func:`_band_tile`), the span's stride and length, threads a block
    and shared bytes.  Raises where no shape fits a block."""
    g, ls, nr, un, wmax, zb = shape

    def span(tm):
        xs, xlen = _wide_span(p, wmax, tm)
        return xs, xlen, _wide_smem(nplanes, un, ls, xlen)

    best = _band_tile(g, nr, zb, windows, batch, span)
    if best is None:
        raise ValueError(f"wide decimation: no block fits p={p}, "
                         f"shape {shape} in shared memory")
    ws, nw, threads, (xs, xlen, smem) = best
    return ws, nw, xs, xlen, threads, smem


def _r4(floats: int) -> int:
    return (floats + 3) & ~3


def _mma_pitch(p: int) -> int:
    """Span row pitch of the tensor-core route, in (re, im) pairs: p
    rounded up to 4 mod 16, so that a warp's 8-byte A-fragment loads
    (rows g, columns t4, g < 8, t4 < 4, a half warp at a time) fall in
    distinct banks."""
    return p + (4 - p) % 16


def _mma_zpitch(nt: int) -> int:
    """Row pitch of the partial Z, in floats: 8 nt rounded up to 8 mod
    32, so that a warp's 8-byte fragment stores fall in distinct
    banks."""
    return 8 * nt + (8 - 8 * nt) % 32


def _mix_wide_smem(mma: bool, p: int, srows: int, pitch: int, xlen: int,
                   zpitch: int, ksplit: int, nt: int, inner: int,
                   tab_a: int, un: int, ls: int) -> int:
    """Shared bytes of #2's wide launch (``Regions`` in
    csrc/mix_decimate_wide.cu): the span (mma: srows rows of pitch
    pairs, the k-ranges' partial Z over it; FMA: xlen pairs) and a spare
    pair, the taps (mma: B's fragments; FMA: the bands), the B table, the
    tile's A-table entries."""
    pairs = srows * pitch if mma else xlen
    span = _r4(max(2 * (pairs + 1), ksplit * 2 * srows * zpitch))
    taps = p // 8 * nt * 64 if mma else (un * ls + 6) & ~3
    return 4 * (span + taps + _r4(2 * inner) + _r4(2 * tab_a))


def _mma_ksplit(mt: int, p: int) -> int:
    """k-ranges of the tensor-core route: one warp an m-tile and k-range,
    _MMA_WARPS in all, at most one k-range a k-step."""
    return max(1, min(_MMA_WARPS // mt, p // 8))


def mma_fragments(kernel_matrix: np.ndarray, p: int, ulo: int,
                  periods: int, nt: int) -> np.ndarray:
    """The tensor-core route's taps: B[c, a q + r] = W[r, ulo + a p + c]
    (zero past Kw and past periods q columns) in mma.m16n8k8's B-fragment
    order, [p / 8, nt, 32, 2] float32: k-step ks, n-tile j, lane l holds
    (B[8 ks + t4, 8 j + g], B[8 ks + t4 + 4, 8 j + g]), g = l / 4, t4 = l
    mod 4."""
    w = np.asarray(kernel_matrix, dtype=np.float32)
    q, kw = w.shape
    bt = np.zeros((p, 8 * nt), np.float32)
    c = np.arange(p)
    for a in range(periods):
        u = ulo + a * p + c
        ok = u < kw
        bt[ok, a * q:(a + 1) * q] = w[:, u[ok]].T
    lane = np.arange(32)
    g, t4 = lane >> 2, lane & 3
    ks = np.arange(p // 8)[:, None, None]
    j = np.arange(nt)[None, :, None]
    return np.stack([bt[8 * ks + t4, 8 * j + g],
                     bt[8 * ks + t4 + 4, 8 * j + g]], -1)


@dataclass(frozen=True, eq=False)
class MixWideLayout:
    """#2's wide form's taps, re-laid once per taps tensor: ``route``
    ("mma", the tensor cores, or "fma") by :func:`mix_wide_route`;
    ``wide`` the band layout (:func:`wide_layout`: the joint band both
    routes stage from, the FMA route's bands and rows); ``taps`` what the
    route reads (mma: :func:`mma_fragments`; fma: ``wide.taps``);
    ``periods`` span rows a window reaches, ceil(width / p); ``nt``
    n-tiles of 8 (a q + r) columns; ``useful`` the share of the
    multiplies the route runs that meet a nonzero tap, ``dense`` that of
    the tensor-core product."""
    route: str
    wide: WideLayout
    taps: object
    periods: int
    nt: int
    useful: float
    dense: float

    @property
    def shape(self):
        """What :func:`mix_wide_config` reads: (route, periods, nt, g,
        ls, nr, un, wmax, blocks of phases)."""
        return (self.route, self.periods, self.nt) + self.wide.shape


def mix_wide_route(kernel_matrix: np.ndarray, p: int,
                   lay: WideLayout | None = None):
    """(route, periods, nt, useful, dense) of #2's wide form at a plan,
    decided by the plan alone.  The tensor-core product multiplies p
    columns of a period by 8 nt (a, r) columns a window, nt = ceil(periods
    q / 8); ``dense`` is the share of those multiplies that meet a nonzero
    tap.  "mma" where the plan has one phase block, p % 8 == 0, nt <=
    8, dense >= 1/4 and :func:`_mma_tile` fits its smallest tile (one
    window, a one-entry oscillator) in shared memory (2.048 MHz -> 240
    kHz: 56%; -> 12 kHz: 90%; 1.024 MHz -> 200 kHz: 43%); else
    "fma" (48 kHz -> 44.1 kHz: 12 taps of 171 over 147 phases, 4%), whose
    ``useful`` is the nonzero taps over the band lanes a window runs."""
    w = np.asarray(kernel_matrix, dtype=np.float32)
    q = w.shape[0]
    lay = lay or wide_layout(w)
    periods = max(1, -(-lay.wmax // p))
    nt = -(-periods * q // 8)
    nnz = int(np.count_nonzero(w))
    dense = nnz / (p * 8 * nt)
    if (len(lay.zband) == 1 and p % 8 == 0 and nt <= _MMA_TILES
            and dense >= _MMA_USEFUL and _mma_tile(
                p, periods, nt, lay.wmax, 1, 1, 1, 1) is not None):
        return "mma", periods, nt, dense, dense
    lanes = int((-(-lay.rows[:, 1] // lay.g) * lay.g).sum())
    return "fma", periods, nt, nnz / max(lanes, 1), dense


def mix_wide_layout(kernel_matrix: np.ndarray, p: int) -> MixWideLayout:
    """#2's wide form's layout of a [q, Kw] taps matrix (host numpy) at
    p: the route, and the taps as that route reads them."""
    w = np.asarray(kernel_matrix, dtype=np.float32)
    lay = wide_layout(w)
    route, periods, nt, useful, dense = mix_wide_route(w, p, lay)
    taps = (mma_fragments(w, p, int(lay.zband[0, 0]), periods, nt)
            if route == "mma" else lay.taps)
    return MixWideLayout(route, lay, taps, periods, nt, useful, dense)


@dataclass(frozen=True)
class MixWideShape:
    """A launch of #2's wide form (``MixWideArgs`` of
    csrc/mix_decimate_wide.cu): ``tm`` windows a tile (``tiles`` a
    stream), the span's row ``pitch`` in pairs and ``xlen`` positions,
    ``tab_a`` A-table entries a block stages, ``threads``, ``smem``
    bytes; mma: ``srows`` = 16 ``mt`` span rows, ``ksplit`` k-ranges,
    ``zpitch``; fma: ``ws`` windows across a block's threads, ``nw`` in
    each thread's registers."""
    mma: bool
    tm: int
    tiles: int
    pitch: int
    xlen: int
    tab_a: int
    threads: int
    smem: int
    srows: int = 0
    mt: int = 0
    ksplit: int = 0
    zpitch: int = 0
    ws: int = 0
    nw: int = 0


def _tab_a(xlen: int, inner: int, outer: int) -> int:
    """A-table entries a span of xlen positions reads, at most."""
    return min(outer, (xlen - 1) // inner + 2)


def _mma_tile(p: int, periods: int, nt: int, wmax: int, windows: int,
              batch: int, inner: int, outer: int):
    """The tensor-core route's launch, or None where no tile fits shared
    memory: the tile of mt = 1 .. 4 m-tiles (16 mt span rows, at most 16
    mt - periods + 1 windows) that minimises ceil(blocks / 132) (16 mt +
    8), B's fragments and the tables in shared memory too, its windows
    spread evenly over the tiles; ksplit = min(8 / mt, p / 8) k-ranges,
    one warp an m-tile and k-range."""
    pitch, zpitch = _mma_pitch(p), _mma_zpitch(nt)
    best = None
    for mt in range(1, _MMA_MT + 1):
        tm = min(windows, 16 * mt - periods + 1)
        if tm < 1:
            continue
        tiles = -(-windows // tm)
        tm = -(-windows // tiles)   # balanced tiles
        xlen = (tm - 1) * p + wmax
        tab_a = _tab_a(xlen, inner, outer)
        ksplit = _mma_ksplit(mt, p)
        smem = _mix_wide_smem(True, p, 16 * mt, pitch, xlen, zpitch,
                              ksplit, nt, inner, tab_a, 0, 0)
        if smem > _SMEM_LIMIT:
            break
        cost = -(-batch * tiles // _SMS) * (16 * mt + _MMA_BLOCK_ROWS)
        if best is None or cost < best[0]:
            best = (cost, MixWideShape(
                True, tm, tiles, pitch, xlen, tab_a, 32 * mt * ksplit,
                smem, 16 * mt, mt, ksplit, zpitch))
        if tm == windows:
            break
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def mix_wide_config(shape, p: int, windows: int, batch: int, inner: int,
                    outer: int, hist: int) -> MixWideShape:
    """The launch of #2's wide form at the layout's ``shape``
    (:attr:`MixWideLayout.shape`) for ``windows`` = n / p windows a
    stream, ``batch`` streams, an oscillator of ``outer`` x ``inner``
    entries and a history of ``hist``.  mma: :func:`_mma_tile`.  fma:
    :func:`_band_tile`, the span one run.  Raises where no shape fits a
    block or the kernel's index divisions would not be exact."""
    route, periods, nt, g, ls, nr, un, wmax, zb = shape
    if route == "mma":
        best = _mma_tile(p, periods, nt, wmax, windows, batch, inner, outer)
    else:
        def span(tm):
            xlen = (tm - 1) * p + wmax
            tab_a = _tab_a(xlen, inner, outer)
            return xlen, tab_a, _mix_wide_smem(False, p, 0, p, xlen, 0, 0, 0,
                                               inner, tab_a, un, ls)

        tile = _band_tile(g, nr, zb, windows, batch, span)
        best = None
        if tile is not None:
            ws, nw, threads, (xlen, tab_a, smem) = tile
            best = MixWideShape(False, ws * nw, -(-windows // (ws * nw)), p,
                                xlen, tab_a, threads, smem, ws=ws, nw=nw)
    if best is None or (best.xlen + hist + p) * p >= 2 ** 31:
        raise ValueError(f"#2's wide form: no block fits p={p}, shape "
                         f"{shape}, oscillator block {inner}")
    return best


def decimate_supported(n: int, plan, mixer: bool = False,
                       inner: int = 1) -> bool:
    """Whether the decimation kernel takes this aligned plan at chunk
    ``n``: whole periods per chunk and a downsample layout (``s0 == 0``,
    history = window minus one period, nonzero).  Every such plan runs,
    on the polyphase kernel or its wide form.  The mixer form
    (``mixer=True``, an oscillator block of ``inner`` samples) takes the
    same plans where its index division is exact (n * inner < 2^31) and,
    on the wide form, a block fits shared memory; a step would raise
    where this is False."""
    kw = int(plan.kernel.shape[-1])
    p, q = plan.p, plan.q
    if not (n % p == 0 and plan.s0 == 0 and plan.hist == kw - p
            and plan.hist > 0):
        return False
    if not mixer or fits_block(p, q, kw):
        return not mixer or n * inner < 2 ** 31
    if n * inner >= 2 ** 31:
        return False
    try:
        mix_wide_config(mix_wide_layout(plan.kernel, p).shape, p, n // p, 1,
                        inner, n // inner, plan.hist)
    except ValueError:
        return False
    return True


def _check_layout(n, hist, kw, p):
    # The kernel's preconditions (as pallas_frontend.py asserts them): a
    # violating call would compute misaligned windows, not fail.
    assert n % p == 0, (p, n)
    assert hist == kw - p and hist > 0, (hist, kw, p)


_relaid = {}


def _cached(kernel_matrix: torch.Tensor, key, build) -> torch.Tensor:
    """``build(kernel_matrix)``, made once while the same taps tensor comes
    back unmodified (a step loop passes one params tree; an in-place
    write moves the tensor's version and rebuilds).  Entries live as long
    as their taps tensor, so a captured CUDA graph, which holds its params
    tree, keeps reading what it was captured with."""
    key = (id(kernel_matrix), key)
    hit = _relaid.get(key)
    if (hit is None or hit[0]() is not kernel_matrix
            or hit[1] != kernel_matrix._version):
        for k in [k for k, h in _relaid.items() if h[0]() is None]:
            del _relaid[k]
        hit = (weakref.ref(kernel_matrix), kernel_matrix._version,
               build(kernel_matrix))
        _relaid[key] = hit
    return hit[2]


def _device_taps(kernel_matrix: torch.Tensor, p: int) -> torch.Tensor:
    """:func:`relay_taps` of this taps tensor, built once per tensor."""
    return _cached(kernel_matrix, p, lambda w: relay_taps(w, p))


def _device_wide(kernel_matrix: torch.Tensor) -> WideLayout:
    """:func:`wide_layout` of this taps tensor on its device, built once
    per tensor (one read of the taps to the host, in an eager step before
    any capture)."""
    def build(w):
        lay = wide_layout(w.detach().cpu().numpy())
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            w.device)
        return WideLayout(put(lay.taps), put(lay.rows), put(lay.zband),
                          lay.g, lay.ls, lay.nr, lay.un, lay.wmax)
    return _cached(kernel_matrix, "wide", build)


def _device_mix_wide(kernel_matrix: torch.Tensor, p: int) -> MixWideLayout:
    """:func:`mix_wide_layout` of this taps tensor on its device, built
    once per tensor (one read of the taps to the host, in an eager step
    before any capture)."""
    def build(w):
        lay = mix_wide_layout(w.detach().cpu().numpy(), p)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            w.device)
        wide = WideLayout(None, put(lay.wide.rows), put(lay.wide.zband),
                          *lay.wide.shape[:-1])
        return MixWideLayout(lay.route, wide, put(lay.taps), lay.periods,
                             lay.nt, lay.useful, lay.dense)
    return _cached(kernel_matrix, ("mix wide", p), build)


_PAIR = ctypes.c_void_p * 2
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


class _WideArgs(ctypes.Structure):
    """``WideArgs`` of csrc/decimate.cu, field for field."""
    _fields_ = [("taps", ctypes.c_void_p), ("rows", ctypes.c_void_p),
                ("zband", ctypes.c_void_p), ("ls", _I32), ("g", _I32),
                ("nr", _I32), ("un", _I32), ("ws", _I32), ("nw", _I32),
                ("xs", _I32), ("xlen", _I32), ("threads", _I32)]


class _MixWideArgs(ctypes.Structure):
    """``MixWideArgs`` of csrc/mix_decimate_wide.cu, field for field."""
    _fields_ = [("taps", ctypes.c_void_p), ("rows", ctypes.c_void_p),
                ("zband", ctypes.c_void_p)] + [
                    (f, _I32) for f in (
                        "mma", "tm", "pitch", "xlen", "srows", "tab_a",
                        "threads", "mt", "ksplit", "nt", "periods", "zpitch",
                        "ls", "g", "nr", "un", "ws", "nw")]


class _Args(ctypes.Structure):
    """``DecimArgs`` of csrc/decimate.cuh, field for field."""
    _fields_ = [("x", _PAIR), ("x_row", _I64), ("x_step", _I64),
                ("h", _PAIR), ("h_row", _I64), ("h_step", _I64),
                ("y", _PAIR), ("y_row", _I64), ("y_step", _I64),
                ("nh", _PAIR), ("nh_row", _I64), ("nh_step", _I64),
                ("taps", ctypes.c_void_p),
                ("tab", ctypes.c_void_p * 4), ("tab_step", _I64 * 2),
                ("p0", _PAIR), ("p0_step", _I64),
                ("b", _I32), ("n", _I32), ("hist", _I32), ("p", _I32),
                ("q", _I32), ("apad", _I32), ("inner", _I32),
                ("nplanes", _I32)]


def _planes(ts, name, nplanes=2):
    """(pointers, row stride, element stride), in floats, of a kernel
    operand: a tuple of 1 or 2 float32 CUDA tensors sharing their strides,
    or one complex64 CUDA tensor taken in place as its first ``nplanes``
    (re, im) planes, without making views.  Tensors are [b, len] (or
    [len] vectors, row stride 0)."""
    if isinstance(ts, torch.Tensor):
        if ts.dtype != torch.complex64 or not ts.is_cuda:
            raise ValueError(f"{name}: kernel takes complex64 CUDA tensors, "
                             f"got {ts.dtype} on {ts.device}")
        t0, scale = ts, 2
        ptrs = [ts.data_ptr(), ts.data_ptr() + 4][:nplanes]
    else:
        t0, scale = ts[0], 1
        for t in ts:
            if t.dtype != torch.float32 or not t.is_cuda:
                raise ValueError(f"{name}: kernel takes float32 CUDA "
                                 f"tensors, got {t.dtype} on {t.device}")
            if t.shape != t0.shape or t.stride() != t0.stride():
                raise ValueError(f"{name}: planes differ in shape or "
                                 f"strides")
        ptrs = [t.data_ptr() for t in ts]
    st = t0.stride()
    row, step = (0, st[0]) if t0.dim() == 1 else st
    if step < 1 or (t0.dim() == 2 and row < 1):
        raise ValueError(f"{name}: strides {st} not taken")
    return _PAIR(*ptrs, *[None] * (2 - len(ptrs))), scale * row, scale * step


def _first(ts):
    return ts if isinstance(ts, torch.Tensor) else ts[0]


def _launch(xs, hs, outs, nhs, kernel_matrix, p, q, nplanes, mix=None,
            phase=None):
    """One launch of #1 or (``mix``) #2 on ``nplanes`` input planes: xs,
    hs the input and history, outs, nhs the output and the new history
    (each a tuple of float32 planes or a complex64 tensor; a real input's
    outputs may be complex, and the kernel then writes their zero
    imaginary parts); mix = (table A, table B, p0 re, p0 im), the tables
    complex64 or plane pairs; phase = (phase in, phase out), int32 [b]: a
    phase-mode step on the wide form (``rr_decimate_phase``).  A plan
    that :func:`fits_block` launches ``rr_decimate`` /
    ``rr_mix_decimate``, any other ``rr_decimate_wide`` /
    ``rr_mix_decimate_wide`` (shaped by :func:`mix_wide_config`)."""
    x0 = _first(xs)
    b, n = x0.shape
    hist = _first(hs).shape[-1]
    kw = kernel_matrix.shape[-1]
    wide = phase is not None or not fits_block(p, q, kw, nplanes)
    a = _Args()
    a.x, a.x_row, a.x_step = _planes(xs, "x", nplanes)
    a.h, a.h_row, a.h_step = _planes(hs, "hist", nplanes)
    a.y, a.y_row, a.y_step = _planes(outs, "out")
    a.nh, a.nh_row, a.nh_step = _planes(nhs, "new hist")
    a.b, a.n, a.hist, a.p, a.q = b, n, hist, p, q
    a.apad, a.inner, a.nplanes = _apad(kw, p), 1, nplanes
    if mix is not None:
        table_a, table_b, p0r, p0i = mix
        ta, _, a.tab_step[0] = _planes(table_a, "table A")
        tb, _, a.tab_step[1] = _planes(table_b, "table B")
        a.tab[:] = [ta[0], ta[1], tb[0], tb[1]]
        a.p0, _, a.p0_step = _planes((p0r, p0i), "start phasor")
        a.inner = _first(table_b).shape[-1]
    if wide and mix is not None:
        _build.f32_ptr(kernel_matrix, "kernel_matrix")   # raises on others
        lay = _device_mix_wide(kernel_matrix, p)
        sh = mix_wide_config(lay.shape, p, n // p, b, a.inner,
                             n // a.inner, hist)
        wl = lay.wide
        wa = _MixWideArgs(
            lay.taps.data_ptr(), wl.rows.data_ptr(), wl.zband.data_ptr(),
            int(sh.mma), sh.tm, sh.pitch, sh.xlen, sh.srows, sh.tab_a,
            sh.threads, sh.mt, sh.ksplit, lay.nt, lay.periods, sh.zpitch,
            wl.ls, wl.g, wl.nr, wl.un, sh.ws, sh.nw)
        err = _build.lib().rr_mix_decimate_wide(
            ctypes.addressof(a), ctypes.addressof(wa),
            _build.stream_handle(x0.device))
        _build.check(err, "rr_mix_decimate_wide")
        return
    if wide:
        _build.f32_ptr(kernel_matrix, "kernel_matrix")   # raises on others
        lay = _device_wide(kernel_matrix)
        windows = -(-n // p) if phase is not None else n // p
        ws, nw, xs, xlen, threads, _ = wide_config(lay.shape, p, windows, b,
                                                   nplanes)
        wa = _WideArgs(lay.taps.data_ptr(), lay.rows.data_ptr(),
                       lay.zband.data_ptr(), lay.ls, lay.g, lay.nr, lay.un,
                       ws, nw, xs, xlen, threads)
        stream = _build.stream_handle(x0.device)
        if phase is None:
            err = _build.lib().rr_decimate_wide(
                ctypes.addressof(a), ctypes.addressof(wa), stream)
            _build.check(err, "rr_decimate_wide")
            return
        err = _build.lib().rr_decimate_phase(
            ctypes.addressof(a), ctypes.addressof(wa), phase[0].data_ptr(),
            phase[1].data_ptr(), stream)
        _build.check(err, "rr_decimate_phase")
        return
    a.taps = _device_taps(kernel_matrix, p).data_ptr()
    r, g = launch_config(p, q, kw)
    entry = "rr_decimate" if mix is None else "rr_mix_decimate"
    err = getattr(_build.lib(), entry)(ctypes.addressof(a), r, g,
                                       _build.stream_handle(x0.device))
    _build.check(err, entry)


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
    _check_layout(n, hist, kernel_matrix.shape[-1], p)
    if not _build.on_cuda(*planes, *hplanes, kernel_matrix):
        return decimate_plain(planes, hplanes, kernel_matrix, p, q)
    if nplanes not in (1, 2):
        raise ValueError(f"{nplanes} planes: the kernel takes 1 or 2")
    dev = planes[0].device
    outs = tuple(torch.empty((b, (n // p) * q), dtype=torch.float32,
                             device=dev) for _ in planes)
    newh = tuple(torch.empty((b, hist), dtype=torch.float32, device=dev)
                 for _ in planes)
    decimate.launches += 1
    _launch(planes, hplanes, outs, newh, kernel_matrix, p, q, nplanes)
    return outs, newh


decimate.launches = 0


def decimate_complex_plain(x, hist, kernel_matrix, p: int, q: int,
                           real_input: bool = False):
    """Plain PyTorch version of :func:`decimate_complex`."""
    planes = (x.real,) if real_input else (x.real, x.imag)
    hplanes = (hist.real,) if real_input else (hist.real, hist.imag)
    outs, newh = decimate_plain(planes, hplanes, kernel_matrix, p, q)
    if real_input:
        return tuple(torch.complex(z[0], torch.zeros_like(z[0]))
                     for z in (outs, newh))
    return torch.complex(*outs), torch.complex(*newh)


def decimate_complex(x, hist, kernel_matrix, p: int, q: int,
                     real_input: bool = False):
    """:func:`decimate` of complex64 streams in place.

    ``x``: [batch, n] complex64; ``hist``: [batch, hist] complex64.
    Returns (y [batch, (n/p)*q], new history [batch, hist]), complex64.
    ``real_input``: filter the real planes only (the imaginary parts are
    zero); the outputs' imaginary parts are written as zeros."""
    b, n = x.shape
    nh_len = hist.shape[-1]
    _check_layout(n, nh_len, kernel_matrix.shape[-1], p)
    if not _build.on_cuda(x, hist, kernel_matrix):
        return decimate_complex_plain(x, hist, kernel_matrix, p, q,
                                      real_input)
    y = torch.empty((b, (n // p) * q), dtype=torch.complex64,
                    device=x.device)
    nh = torch.empty((b, nh_len), dtype=torch.complex64, device=x.device)
    decimate.launches += 1
    _launch(x, hist, y, nh, kernel_matrix, p, q, 1 if real_input else 2)
    return y, nh


def decimate_phase_complex(x, hist, phase, kernel_matrix, p: int, q: int,
                           real_input: bool = False):
    """One phase-mode step of complex64 streams in place: the chunk is not
    a whole number of periods (see
    :func:`~radiorust_tpu_torch.ops.polyphase.rational_fir_phase`, its
    plain version, for what it computes).

    ``x``: [batch, C] complex64; ``hist``: [batch, Kw - 1] complex64;
    ``phase``: [batch] int32 grid phase, read by the kernel from device
    memory (row 0 places the windows), so a captured step stays right as
    the phase walks its schedule.  Returns (y [batch, ceil(C/p) q], new
    history, new phase): the valid prefix, then exact zeros.  On CUDA
    tensors one launch of ``rr_decimate_phase`` (the wide form of #1 at an
    offset), counted on ``decimate.launches`` as every entry of #1 and on
    ``decimate_phase_complex.launches``."""
    b, n = x.shape
    kw = kernel_matrix.shape[-1]
    if hist.shape[-1] != kw - 1 or kw < 2:
        raise ValueError(f"phase mode carries Kw - 1 = {kw - 1} history "
                         f"samples, got {hist.shape[-1]}")
    if not _build.on_cuda(x, hist, phase, kernel_matrix):
        return rational_fir_phase(x, hist, phase, kernel_matrix, p, q,
                                  real_input)
    if phase.dtype != torch.int32 or not phase.is_contiguous():
        raise ValueError(f"phase: kernel takes a contiguous int32 [batch] "
                         f"tensor, got {phase.dtype}")
    y = torch.empty((b, -(-n // p) * q), dtype=torch.complex64,
                    device=x.device)
    nh = torch.empty((b, kw - 1), dtype=torch.complex64, device=x.device)
    new_phase = torch.empty_like(phase)
    decimate.launches += 1
    decimate_phase_complex.launches += 1
    _launch(x, hist, y, nh, kernel_matrix, p, q, 1 if real_input else 2,
            phase=(phase, new_phase))
    return y, nh, new_phase


decimate_phase_complex.launches = 0


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


def mix_tail(x_tail, table_a, table_b, p0r, p0i):
    """The mixed-domain planes (re, im) of the last ``h`` samples of a
    chunk, ``x_tail`` [batch, h] complex64 against the chunk's factored
    tables (complex64 [outer], [inner]) and start phasor: the history
    the kernel (either form) writes when h is at most the chunk, in its
    order of operations (every product and sum rounded on its own), so
    that it is bit for bit the kernel's.  A time shard rebuilds its left
    neighbour's history with it (``parallel/time_shard.py``)."""
    h = x_tail.shape[-1]
    ar, ai = table_a.real, table_a.imag
    br, bi = table_b.real, table_b.imag
    oscr = (ar[:, None] * br[None, :] - ai[:, None] * bi[None, :])
    osci = (ar[:, None] * bi[None, :] + ai[:, None] * br[None, :])
    oscr, osci = oscr.reshape(-1)[-h:], osci.reshape(-1)[-h:]
    xr, xi = x_tail.real, x_tail.imag
    mr0 = xr * oscr[None] - xi * osci[None]
    mi0 = xr * osci[None] + xi * oscr[None]
    pr, pi = p0r[:, None], p0i[:, None]
    return mr0 * pr - mi0 * pi, mr0 * pi + mi0 * pr


def fused_mix_decimate_plain(xr, xi, ar, ai, br, bi, p0r, p0i, hr, hi,
                             kernel_matrix, p: int, q: int):
    """Plain PyTorch version of :func:`fused_mix_decimate`."""
    mr, mi = _mix(xr, xi, ar, ai, br, bi, p0r, p0i)
    (outr, outi), (nhr, nhi) = decimate_plain((mr, mi), (hr, hi),
                                              kernel_matrix, p, q)
    return outr, outi, nhr, nhi


def _check_mix(n, hist, kw, p, ar, br):
    _check_layout(n, hist, kw, p)
    if ar.shape[-1] * br.shape[-1] != n:
        raise ValueError(f"oscillator tables {ar.shape[-1]}x"
                         f"{br.shape[-1]} != {n}")


def fused_mix_decimate(xr, xi, ar, ai, br, bi, p0r, p0i, hr, hi,
                       kernel_matrix, p: int, q: int):
    """Mix + decimate one chunk step.

    ``xr/xi``: [batch, n] raw input planes; ``ar..bi``: factored
    oscillator tables ([outer], [inner], outer * inner = n);
    ``p0r/p0i``: [batch] start phasor; ``hr/hi``: [batch, hist]
    mixed-domain history; ``kernel_matrix``: [q, Kw].  Returns
    (outr, outi, new_hr, new_hi).  On CUDA tensors one launch of
    ``rr_mix_decimate``, or of ``rr_mix_decimate_wide`` (#2's wide form,
    on the route :func:`mix_wide_route` picks) where the plan does not
    :func:`fits_block`.
    """
    b, n = xr.shape
    hist = hr.shape[-1]
    _check_mix(n, hist, kernel_matrix.shape[-1], p, ar, br)
    tensors = (xr, xi, ar, ai, br, bi, p0r, p0i, hr, hi, kernel_matrix)
    if not _build.on_cuda(*tensors):
        return fused_mix_decimate_plain(*tensors, p, q)
    dev = xr.device
    outr, outi = (torch.empty((b, (n // p) * q), dtype=torch.float32,
                              device=dev) for _ in range(2))
    nhr, nhi = (torch.empty((b, hist), dtype=torch.float32, device=dev)
                for _ in range(2))
    fused_mix_decimate.launches += 1
    _launch((xr, xi), (hr, hi), (outr, outi), (nhr, nhi), kernel_matrix, p,
            q, 2, mix=((ar, ai), (br, bi), p0r, p0i))
    return outr, outi, nhr, nhi


fused_mix_decimate.launches = 0


def fused_mix_decimate_complex_plain(x, table_a, table_b, p0r, p0i, hr, hi,
                                     kernel_matrix, p: int, q: int):
    """Plain PyTorch version of :func:`fused_mix_decimate_complex`."""
    outr, outi, nhr, nhi = fused_mix_decimate_plain(
        x.real, x.imag, table_a.real, table_a.imag, table_b.real,
        table_b.imag, p0r, p0i, hr, hi, kernel_matrix, p, q)
    return torch.complex(outr, outi), torch.complex(nhr, nhi)


def fused_mix_decimate_complex(x, table_a, table_b, p0r, p0i, hr, hi,
                               kernel_matrix, p: int, q: int):
    """:func:`fused_mix_decimate` of complex64 streams in place.

    ``x``: [batch, n] complex64; ``table_a/table_b``: complex64 [outer],
    [inner]; ``p0r/p0i``: [batch] start phasor; ``hr/hi``: [batch, hist]
    float32 history planes (any strides, e.g. the previous step's
    ``.real``/``.imag`` views).  Returns (y [batch, (n/p)*q], new history
    [batch, hist]), complex64."""
    b, n = x.shape
    hist = hr.shape[-1]
    _check_mix(n, hist, kernel_matrix.shape[-1], p, table_a, table_b)
    if not _build.on_cuda(x, table_a, table_b, p0r, p0i, hr, hi,
                          kernel_matrix):
        return fused_mix_decimate_complex_plain(
            x, table_a, table_b, p0r, p0i, hr, hi, kernel_matrix, p, q)
    y = torch.empty((b, (n // p) * q), dtype=torch.complex64,
                    device=x.device)
    nh = torch.empty((b, hist), dtype=torch.complex64, device=x.device)
    fused_mix_decimate.launches += 1
    _launch(x, (hr, hi), y, nh, kernel_matrix, p, q, 2,
            mix=(table_a, table_b, p0r, p0i))
    return y, nh
