"""A numpy model of #2's wide form, ``csrc/mix_decimate_wide.cu``
(``rr_mix_decimate_wide``), for the CPU tests.

It follows the kernel block by block (phase block z, tile, stream): the
staged span as rows of p pairs at the launch's pitch behind the 16-byte
shift (shared memory as a flat float32 array that starts as NaN, so a
read of a position nothing staged shows), the zeros past the span, the
oscillator entries staged beside it, the new history from the sources
where the span does not cover it, the mix of each staged chunk sample
once at the strided runs' multiply-shift indices, the history from the
span, and the sums by the plan's route: on the tensor cores the
polyphase product in the 3xTF32 split (each operand rounded to TF32 by
``cvt.rna``: to nearest on the low 13 mantissa bits, ties away from
zero; lo hi, hi lo, hi hi accumulated in that order, one float32
rounding an mma), the k-ranges' partial Z summed in k order and the
diagonal sum; by FMA the wide kernel's lane groups over the bands.
The B operand is read back from the fragments the wrapper lays out
(``mma_fragments``), so their order is checked too.
"""

import numpy as np

from radiorust_tpu_torch.ops import frontend as tfe

LANES = 32
# Chunk samples a lane mixes at once (kMixRun): by route.
MIX_RUN = {"mma": 8, "fma": 4}


def divm(x, d):
    """``divm`` of the C source: floor(x / d) as (x * ceil(2^32 / d)) >>
    32, asserted exact over the arguments it is given."""
    x = np.asarray(x, np.int64)
    m = ((1 << 32) + d - 1) // d
    got = np.asarray((x.astype(object) * m) >> 32).astype(np.int64)
    assert (x >= 0).all() and (got == x // d).all()
    return got


def mix(v, ar, ai, br, bi, pr, pi):
    """``mix`` of decimate.cuh on [2, k] float32 planes: x (A B) p0, every
    product and sum rounded on its own."""
    oscr = ar * br - ai * bi
    osci = ar * bi + ai * br
    mr0 = v[0] * oscr - v[1] * osci
    mi0 = v[0] * osci + v[1] * oscr
    return np.stack([mr0 * pr - mi0 * pi, mr0 * pi + mi0 * pr])


def rna_tf32(v):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest, ties away from zero (the bit pattern is sign and
    magnitude)."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v):
    """(hi, lo): hi = rna(v), lo = rna(v - hi)."""
    hi = rna_tf32(v)
    return hi, rna_tf32((v - hi).astype(np.float32))


def b_from_fragments(frags):
    """The dense B [p, 8 nt] the fragments [p / 8, nt, 32, 2] hold."""
    ks, nt = frags.shape[:2]
    b = np.full((8 * ks, 8 * nt), np.nan, np.float32)
    lane = np.arange(LANES)
    g, t4 = lane >> 2, lane & 3
    for k in range(ks):
        for j in range(nt):
            b[8 * k + t4, 8 * j + g] = frags[k, j, :, 0]
            b[8 * k + t4 + 4, 8 * j + g] = frags[k, j, :, 1]
    assert not np.isnan(b).any()
    return b


def at_span(e, p, pitch):
    """Span pair of position e (past the shift)."""
    k = divm(e, p)
    return k * pitch + e - k * p


def _mix_sites(jlo, jhi, threads, shift, run, p, pitch):
    """The mix, run by run: warp w's lane l takes j = jlo + 32 run (w + k
    warps) + l + 32 it, it < run, at span position e = j + shift (row e /
    p, column e mod p).  Yields (positions, pairs) a run step."""
    t = np.arange(threads)
    jb = (jlo + 32 * run * (t >> 5) + (t & 31))[:, None] + run * threads * \
        np.arange(-(-max(jhi - jlo, 0) // (run * threads)) + 1)[None, :]
    jb = jb[jb < jhi]
    for it in range(run):
        j = jb + 32 * it
        e = j[j < jhi] + shift
        yield e, at_span(e, p, pitch)


def mix_wide_model(xs_in, hs_in, W, p, q, osc, shape_batch=None,
                   pairs=None, shape=None, counts=None):
    """One launch of ``rr_mix_decimate_wide``: xs_in [b, 2, n], hs_in
    [b, 2, hist] float32 (hist = Kw - p), W [q, Kw], osc = (A re, A im, B
    re, B im, p0 re [b], p0 im [b]); the launch shape ``shape`` or
    ``mix_wide_config`` at batch b (at ``shape_batch`` where given: the
    paths' shape on fewer streams).  ``pairs`` = (base, row): x is a
    complex64 tensor read in place whose stream s starts at element base
    + s row of 8 bytes from a 16-byte boundary (the span then shifts one
    pair where its first sample sits at an odd phase).  ``counts``, a
    dict, gets the number of samples each block staged and mixed.
    Returns (y [b, 2, M q], new history [b, 2, hist])."""
    b, NP, n = xs_in.shape
    assert NP == 2
    hist = hs_in.shape[-1]
    kw = W.shape[-1]
    assert hist == kw - p and n % p == 0
    M = n // p
    ar, ai, br, bi, p0r, p0i = osc
    outer, inner = len(ar), len(br)
    assert outer * inner == n
    lay = tfe.mix_wide_layout(W, p)
    wl = lay.wide
    g, ls, nrc, un, wmax, zb = wl.shape
    sh_ = shape or tfe.mix_wide_config(lay.shape, p, M, shape_batch or b,
                                       inner, outer, hist)
    mma = lay.route == "mma"
    assert sh_.mma == mma and sh_.smem <= tfe._SMEM_LIMIT
    assert sh_.threads % LANES == 0 and sh_.threads <= tfe._WIDE_THREADS
    tm, pitch = sh_.tm, sh_.pitch
    tiles = -(-M // tm)
    assert tiles == sh_.tiles
    if mma:
        assert zb == 1 and sh_.srows == 16 * sh_.mt
        assert tm + lay.periods - 1 <= sh_.srows
        assert sh_.threads == LANES * sh_.mt * sh_.ksplit
        bfull = b_from_fragments(lay.taps)
        bh, bl = split_tf32(bfull)
        alloc = sh_.srows * pitch + 1
    else:
        assert pitch == p and tm == sh_.ws * sh_.nw
        alloc = sh_.xlen + 1
    y = np.full((b, 2, M * q), np.nan, np.float32)
    nh = np.full((b, 2, hist), np.nan, np.float32)
    threads = sh_.threads
    t = np.arange(threads)
    for z, tile, s in np.ndindex(zb, tiles, b):
        m0 = tile * tm
        mt = min(tm, M - m0)
        ulo, width, u0, unz = (int(c) for c in wl.zband[z])
        buf = np.concatenate([hs_in[s], xs_in[s]], axis=-1)
        P0 = m0 * p + ulo
        length = (mt - 1) * p + width if width else 0
        assert length <= sh_.xlen
        sh = 0 if pairs is None else (pairs[0] + s * pairs[1] + P0 - hist) % 2
        X = np.full((2, alloc + 1), np.nan, np.float32)
        e = np.arange(length)
        j = P0 + e
        d = sh + (at_span(e, p, pitch) if mma else e)
        assert d.max(initial=0) < alloc + sh
        X[:, d] = np.where(j < hist + n, buf[:, np.minimum(j, hist + n - 1)],
                           0.0)
        if mma:   # the rest of the rows the used Z rows read: zeros
            e = np.arange(length, (mt + lay.periods - 1) * p)
            X[:, sh + at_span(e, p, pitch)] = 0.0
        # The oscillator entries of the span's chunk samples [jlo, jhi).
        jlo, jhi = max(0, P0 - hist), min(n, P0 + length - hist)
        a_lo = int(divm(jlo, inner)) if jlo < jhi else 0
        na = int(divm(jhi - 1, inner)) - a_lo + 1 if jlo < jhi else 0
        assert na <= sh_.tab_a
        At = np.stack([ar[a_lo:a_lo + na], ai[a_lo:a_lo + na]])
        Bt = np.stack([br, bi])
        # The history outside the span, from the sources (last tile).
        hist_out = tile == tiles - 1 and z == 0
        c0 = min(hist, max(0, P0 - n))
        c1 = max(c0, min(hist, P0 + length - n))
        if hist_out:
            ih = np.concatenate([np.arange(c0), np.arange(c1, hist)])
            jj = n + ih
            nh[s][:, ih] = buf[:, jj]
            k = jj[jj >= hist] - hist
            a = divm(k, inner)
            sel = ih[jj >= hist]
            nh[s][:, sel] = mix(buf[:, hist + k], ar[a], ai[a],
                                br[k - a * inner], bi[k - a * inner],
                                p0r[s], p0i[s])
        # The mix, once a staged chunk sample.
        seen = np.zeros(max(jhi - jlo, 0), np.int64)
        for e, at in _mix_sites(jlo, jhi, threads, hist - P0,
                                MIX_RUN[lay.route], p, pitch):
            j = P0 + e - hist
            a = divm(j, inner)
            assert (a - a_lo >= 0).all() and (a - a_lo < na).all()
            X[:, sh + at] = mix(X[:, sh + at], At[0, a - a_lo],
                                At[1, a - a_lo], Bt[0, j - a * inner],
                                Bt[1, j - a * inner], p0r[s], p0i[s])
            np.add.at(seen, j - jlo, 1)
        assert (seen == 1).all()   # every staged chunk sample mixed once
        if counts is not None:
            counts[(z, tile, s)] = (length, len(seen))
        if hist_out:
            i = np.arange(c0, c1)
            e = n + i - P0
            nh[s][:, i] = X[:, sh + (at_span(e, p, pitch) if mma else e)]
        if mma:
            _sums_mma(X, sh, sh_, lay, bh, bl, p, q, mt, y[s], m0)
        else:
            _sums_fma(X, sh, sh_, wl, z, p, q, mt, t, y[s], m0)
    assert not np.isnan(y).any() and not np.isnan(nh).any()
    return y, nh


def _sums_mma(X, sh, sh_, lay, bh, bl, p, q, mt, y, m0):
    """The tensor-core route: S [2, srows, p] from the span, each k-range's
    Z by 3xTF32 mma steps (one float32 rounding an mma of 8 products),
    the partial Z summed in k order, the diagonal sum over a."""
    rows = np.arange(sh_.srows)[:, None] * sh_.pitch + np.arange(p)[None, :]
    S = X[:, sh + rows]   # [2, srows, p]; rows past the used ones may be NaN
    ks_all = p // 8
    per = -(-ks_all // sh_.ksplit)
    Z = None
    for part in range(sh_.ksplit):
        acc = np.zeros((2, sh_.srows, bh.shape[1]), np.float32)
        for ks in range(part * per, min(ks_all, part * per + per)):
            ah, al = split_tf32(S[:, :, 8 * ks:8 * ks + 8])
            kb = slice(8 * ks, 8 * ks + 8)
            for a_, b_ in ((al, bh[kb]), (ah, bl[kb]), (ah, bh[kb])):
                acc = (acc.astype(np.float64)
                       + a_.astype(np.float64) @ b_.astype(np.float64)
                       ).astype(np.float32)
        Z = acc if Z is None else (Z + acc).astype(np.float32)
    used = mt + lay.periods - 1
    assert not np.isnan(Z[:, :used]).any()
    m = np.arange(mt)[:, None]
    r = np.arange(q)[None, :]
    out = np.zeros((2, mt, q), np.float32)
    for a in range(lay.periods):
        out = (out + Z[:, m + a, a * q + r]).astype(np.float32)
    y[:, m0 * q:(m0 + mt) * q] = out.reshape(2, mt * q)


def _sums_fma(X, sh, sh_, wl, z, p, q, mt, t, y, m0):
    """The FMA route: each thread's lane g, phase and windows over its
    band (fmaf, one rounding), the lane group's shuffle tree, the stores
    of lane 0."""
    g, ls, nrc = wl.g, wl.ls, wl.nr
    ws_n, nw = sh_.ws, sh_.nw
    gl, rr, wsl = t % g, (t // g) % nrc, t // (g * nrc)
    r0 = z * nrc
    nr = min(nrc, q - r0)
    ulo, _, u0, unz = (int(c) for c in wl.zband[z])
    T = wl.taps.reshape(-1)[u0 * ls:(u0 + unz) * ls]
    k_of = wsl[:, None] + np.arange(nw)[None, :] * ws_n
    live = (rr < nr) & (wsl < ws_n) & (wsl < mt)
    r = np.minimum(r0 + rr, q - 1)
    off = np.where(live, wl.rows[r, 0] - ulo, 0)
    ln = np.where(live, wl.rows[r, 1], 0)
    tb = np.where(live, wl.rows[r, 2] - u0, 0)
    acc = np.zeros((2, len(t), nw), np.float32)
    xo = sh + np.minimum(k_of, mt - 1) * p + off[:, None]
    for u0_ in range(0, int(ln.max(initial=0)), g):
        u = u0_ + gl
        act = u < ln
        w = np.where(act, T[np.where(act, tb * ls + u, 0)], 0.0)
        xv = X[:, np.where(act[:, None], xo + u[:, None], 0)]
        assert not np.isnan(xv[:, act]).any()
        fma = (w[None, :, None].astype(np.float64) * xv
               + acc).astype(np.float32)
        acc = np.where(act[None, :, None], fma, acc)
    o = g >> 1
    while o:
        acc = (acc + acc[:, t ^ o]).astype(np.float32)
        o >>= 1
    for tt in np.flatnonzero(live & (gl == 0)):
        for j in range(nw):
            k = k_of[tt, j]
            if k < mt:
                y[:, (m0 + k) * q + r0 + rr[tt]] = acc[:, tt, j]
