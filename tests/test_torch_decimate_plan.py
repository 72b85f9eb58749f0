"""The decimation kernels' index arithmetic, on the CPU.

``csrc/decimate.cu`` stages each block's span of ``[hist || x]`` by phase
into skewed shared-memory rows, slides a register window over them with
the taps re-laid by :func:`~radiorust_tpu_torch.ops.frontend.relay_taps`,
splits the (phase, tap) range over warp groups, sums the groups in shared
memory and writes the new history from the staged values.  The numpy
model below follows that arithmetic step for step (thread loops
vectorised over threads and blocks, shared memory as flat float32 arrays
that start as NaN, so a read of a position nothing staged shows), fed the
same re-laid taps, and is held against the plain versions
``decimate_plain`` / ``fused_mix_decimate_plain`` at every plan the port
binds.  ``wide_model`` does the same for #1's wide form and phase mode
(``decimate_wide_kernel``: band taps from
:func:`~radiorust_tpu_torch.ops.frontend.wide_layout`, one output a
thread or lane group, the launch shape of ``wide_config``) against
``decimate_plain`` and ``rational_fir_phase``, and ``mix_wide_model``
(``tests/torch_mix_wide.py``) for #2's wide form
(``csrc/mix_decimate_wide.cu``) against ``fused_mix_decimate_plain``.
Nothing here needs a GPU.
"""

import numpy as np
import pytest
import torch

from radiorust_tpu_torch.blocks.base import StreamSig
from radiorust_tpu_torch.blocks.transform import _shift_tables
from radiorust_tpu_torch.models.analog import am_receiver
from radiorust_tpu_torch.models.stereo import wfm_stereo_receiver
from radiorust_tpu_torch.models.wfm import wfm_receiver
from radiorust_tpu_torch.ops import frontend as tfe
from radiorust_tpu_torch.ops.polyphase import (plan_downsample,
                                               plan_upsample)
from torch_mix_wide import mix_wide_model

REL = 1e-5          # model vs plain, max |diff| / max |ref| (FIR_BOUND)
LANES = 32


def _plans():
    """(name, plan, chunk) of every decimation the port's models bind at
    the paths' geometries."""
    sig = StreamSig(2, 24576, 1.024e6)
    a = wfm_receiver(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
                     filter_ir_len=6144).bind(sig)
    fold = wfm_receiver(tune_shift=100e3, fuse_frontend=True,
                        fuse_deemphasis=True, filter_ir_len=6144).bind(sig)
    st = wfm_stereo_receiver(tune_shift=100e3, fuse_frontend=True,
                             filter_ir_len=6144).bind({"iq": sig})
    f = am_receiver(tune_shift=-30e3, agc=True).bind(
        StreamSig(2, 8192, 256000.0))
    out = [("A head", a.blocks[0].plan, 24576),
           ("A tail", a.blocks[3].plan, 9216),
           ("fold", fold.blocks[3].plan, 9216),
           ("F", f.blocks[1].plan, 8192)]
    for blk in st.bound:
        if hasattr(blk, "plan"):
            out.append((f"C {type(blk).__name__}", blk.plan,
                        blk.in_sig.chunk_len))
    return out


PLANS = {name: (plan, n) for name, plan, n in _plans()}


def _skew(k, r):
    return k + k // r


def _geometry(p, q, kw, r, g):
    """(apad, TM, lx, ph, rs, L) as the kernel derives them."""
    apad = tfe._apad(kw, p)
    tm = LANES * r
    lx = tm + apad
    ph = _skew(lx - 1, r) + 1
    ph += (12 - ph % 8) % 8
    rs = _skew(tm - 1, r) + 1
    blocks = p * apad // r
    L = -(-blocks // g) * r
    return apad, tm, lx, ph, rs, L


def load_mode(aligned, adjacent, np_, row, step, count):
    """``load_mode`` of the C source: how a source's quads are read."""
    if row % 4 or count % 4:
        return 0
    if step == 1 and aligned:
        return 1
    if step == 2 and aligned and (np_ == 1 or adjacent):
        return 2
    return 0


def _mix(v, a, b, osc):
    """The kernel's ``mix``: float32, each product and sum rounded."""
    ar, ai, br, bi, pr, pi = osc
    ar, ai, br, bi = ar[a], ai[a], br[b], bi[b]
    oscr = ar * br - ai * bi
    osci = ar * bi + ai * br
    mr0 = v[:, 0] * oscr - v[:, 1] * osci
    mi0 = v[:, 0] * osci + v[:, 1] * oscr
    return np.stack([mr0 * pr - mi0 * pi, mr0 * pi + mi0 * pr], axis=1)


def divm(x, d):
    """``divm`` of the C source: floor(x / d) as (x * ceil(2^32 / d)) >>
    32, asserted exact over the arguments it is given."""
    x = np.asarray(x, np.int64)
    m = ((1 << 32) + d - 1) // d
    got = ((x.astype(object) * m) >> 32).astype(np.int64)
    assert (x >= 0).all() and (got == x // d).all()
    return got


def stage(xs, nh, hs_in, hlo, hhi, xs_in, xlo, xhi, hist, J0, stream, last,
          p, ph, r, n, modes, osc=None):
    """``stage``: the quads of the history samples [hlo, hhi) (position i)
    and of the input samples [xlo, xhi) (position hist + i) as one
    sequence per block.  The order in which threads take them changes no
    value (each position is written once), so every quad runs at once.
    xs [blocks, NP, p * ph]; nh [streams, NP, hist]; hs_in, xs_in
    [streams, NP, count]; hlo .. xhi, J0, stream, last: per tile;
    modes = (history, input) load modes; osc = (A re, A im, B re, B im,
    p0 re [b], p0 im [b])."""
    qh0 = hlo >> 2
    nhq = np.where(hlo < hhi, ((hhi + 3) >> 2) - qh0, 0)
    qx0 = xlo >> 2
    nxq = np.where(xlo < xhi, ((xhi + 3) >> 2) - qx0, 0)
    total = nhq + nxq
    w = np.arange(total.max())[None, :]
    live = w < total[:, None]
    in_x = w >= nhq[:, None]
    quad = np.where(in_x, qx0[:, None] + w - nhq[:, None], qh0[:, None] + w)
    i0 = 4 * quad
    lo = np.where(in_x, xlo[:, None], hlo[:, None])
    hi = np.where(in_x, xhi[:, None], hhi[:, None])
    off = np.where(in_x, hist, 0)
    jb = i0 + off - J0[:, None] + 4 * p
    k = np.where(live, divm(np.where(live, jb, 0), p), 0)
    c = jb - k * p
    k = k - 4
    for src, sel, mode in ((hs_in, ~in_x, modes[0]), (xs_in, in_x, modes[1])):
        if mode:   # float4 loads never leave the row
            assert (i0[live & sel] + 3 < src.shape[-1]).all()
    if osc is not None:   # the oscillator's indices, once per quad
        inner = len(osc[2])
        xi0 = np.where(live & in_x, i0, 0)
        a = divm(xi0, inner)
        b = xi0 - a * inner
        if inner % 4 == 0:   # B read as float4: a quad never wraps it
            assert (b[live & in_x] + 3 < inner).all()
    blk = np.broadcast_to(np.arange(xs.shape[0])[:, None], i0.shape)
    planes = np.arange(xs.shape[1])[None, :]
    for e in range(4):
        i = i0 + e
        ok = live & (i >= lo) & (i < hi)
        for src, sel in ((hs_in, ok & ~in_x), (xs_in, ok & in_x)):
            bi, ii = blk[sel], i[sel]
            sb = stream[bi]
            v = src[sb[:, None], planes, ii[:, None]]
            if osc is not None and src is xs_in:
                v = _mix(v, a[sel], b[sel], (*osc[:4], osc[4][sb],
                                             osc[5][sb]))
            pos = c[sel] * ph + _skew(k[sel], r)
            assert (k[sel] >= 0).all() and (c[sel] < p).all()
            assert (pos < (c[sel] + 1) * ph).all()
            xs[bi[:, None], planes, pos[:, None]] = v
            j = ii + off[sel]
            hw = last[bi] & (j >= n)
            nh[sb[hw][:, None], planes, (j[hw] - n)[:, None]] = v[hw]
        c = c + 1
        wrap = c == p
        c[wrap] = 0
        k[wrap] += 1
        if osc is not None:
            b = b + 1
            wrap = b == inner
            b[wrap] = 0
            a[wrap] += 1


def kernel_model(xs_in, hs_in, W, p, q, r, g, osc=None, xmode=0, hmode=0):
    """One launch of ``decimate_kernel``: xs_in [b, NP, n], hs_in [b, NP,
    hist] float32, W [q, Kw]; osc = (A re, A im, B re, B im, p0 re [b],
    p0 im [b]) for the mixer form.  Every block (stream, tile) is
    modelled at once.  Returns (y [b, NP, M q], new hist)."""
    b, NP, n = xs_in.shape
    hist = hs_in.shape[-1]
    kw = W.shape[-1]
    M = n // p
    apad, tm, lx, ph, rs, L = _geometry(p, q, kw, r, g)
    nt = LANES * g * q
    assert nt <= tfe._MAX_THREADS
    ftot = p * apad
    taps = tfe.relay_taps(torch.from_numpy(W), p).numpy().reshape(-1)
    smem = q * ftot + max(NP * p * ph, NP * g * q * rs)
    assert 4 * smem == tfe._smem_bytes(NP, p, q, kw, r, g)
    assert 4 * smem <= tfe._SMEM_LIMIT
    tiles = -(-M // tm)
    stream = np.repeat(np.arange(b), tiles)
    tile = np.tile(np.arange(tiles), b)
    nblk = b * tiles
    m0 = tile * tm
    J0 = m0 * p
    J1 = J0 + lx * p
    last = tile == tiles - 1
    xs = np.full((nblk, NP, p * ph), np.nan, np.float32)
    nh = np.full((b, NP, hist), np.nan, np.float32)
    stage(xs, nh, hs_in, J0, np.minimum(J1, hist), xs_in,
          np.maximum(J0 - hist, 0), np.minimum(J1 - hist, n), hist, J0,
          stream, last, p, ph, r, n, (hmode, xmode), osc)
    for bk in range(nblk):   # past the end of buf: zeros
        for j in range(max(J0[bk], hist + n), J1[bk]):
            k, c = divmod(j - J0[bk], p)
            xs[bk, :, c * ph + _skew(k, r)] = 0.0

    # Each warp (g, r) over its (phase, tap) range, lanes vectorised.
    xflat = xs.reshape(nblk, -1)
    lane = np.arange(LANES)
    red = np.full((nblk, NP * g * q * rs), np.nan, np.float32)
    for warp in range(g * q):
        rr, gg = warp % q, warp // q
        acc = np.zeros((nblk, NP, LANES, r), np.float32)
        f_lo, f_hi = gg * L, min(gg * L + L, ftot)
        c, a0 = divmod(f_lo, apad)
        for f0 in range(f_lo, f_hi, r):
            if f0 == f_lo or a0 == 0:
                xb = ((np.arange(NP)[:, None] * p + c) * ph
                      + (lane[None, :] + a0 // r) * (r + 1))      # [NP, 32]
                win = xflat[:, xb[..., None] + np.arange(r)]    # slot j
                row_end = (np.arange(NP)[:, None] * p + c + 1) * ph
            w = taps[rr * ftot + f0: rr * ftot + f0 + r]
            for da in range(r):
                for j in range(r):   # fmaf: one rounding of w * x + acc
                    acc[..., j] = (np.float64(w[da])
                                   * win[..., (j + da) % r].astype(np.float64)
                                   + acc[..., j]).astype(np.float32)
                at = xb + r + 1 + da
                assert (at < row_end).all()
                win[..., da] = xflat[:, at]
            xb = xb + r + 1
            a0 += r
            if a0 == apad:
                a0, c = 0, c + 1
        assert not np.isnan(acc).any()
        for pl in range(NP):
            base = ((pl * g + gg) * q + rr) * rs
            for j in range(r):
                red[:, base + lane * (r + 1) + j] = acc[:, pl, :, j]

    y = np.full((b, NP, M * q), np.nan, np.float32)
    for bk in range(nblk):
        mt = min(tm, M - m0[bk])
        o = np.arange(mt * q)
        m, rr = o // q, o % q
        for pl in range(NP):
            v = np.zeros(len(o), np.float32)
            for gg in range(g):
                v = v + red[bk, ((pl * g + gg) * q + rr) * rs + _skew(m, r)]
            y[stream[bk], pl, m0[bk] * q + o] = v
    return y, nh


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plain(xs, hs, W, p, q, osc=None):
    t = torch.from_numpy
    if osc is None:
        out, nh = tfe.decimate_plain(tuple(t(xs[:, i]) for i in range(
            xs.shape[1])), tuple(t(hs[:, i]) for i in range(hs.shape[1])),
            t(W), p, q)
        return np.stack([o.numpy() for o in out], 1), np.stack(
            [h.numpy() for h in nh], 1)
    ar, ai, br, bi, pr, pi = (t(np.ascontiguousarray(v)) for v in osc)
    yr, yi, hr, hi = tfe.fused_mix_decimate_plain(
        t(xs[:, 0]), t(xs[:, 1]), ar, ai, br, bi, pr, pi, t(hs[:, 0]),
        t(hs[:, 1]), t(W), p, q)
    return (np.stack([yr.numpy(), yi.numpy()], 1),
            np.stack([hr.numpy(), hi.numpy()], 1))


def _oscillator(n, b, rng):
    ta, tb, _ = _shift_tables(n, 1024000, 100000)
    ph = rng.standard_normal(b)
    return (ta.real.copy(), ta.imag.copy(), tb.real.copy(), tb.imag.copy(),
            np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32))


# (plan, chunk, planes, mixer, (R, G) or None for launch_config, x load
# mode): every geometry the port runs the kernels at, a ragged
# last tile at both R, and the scalar loads of misaligned sources.
CASES = {
    "A head, mixer, complex64 in place": ("A head", None, 2, True, None, 2),
    "A tail, real input from complex64": ("A tail", None, 1, False, None, 2),
    "fuse_deemphasis fold": ("fold", None, 1, False, None, 1),
    "F, two planes": ("F", None, 2, False, None, 2),
    "C tail, two planes": ("C _BoundResampler", None, 2, False, None, 2),
    "ragged tile, R 4": ("F", 8 * 1000, 2, False, (4, 4), 1),
    "ragged tile, R 8, mixer": ("A head", 8 * 700, 2, True, (8, 1), 2),
    "ragged tile, R 8, G 3": ("A tail", 8 * 600, 1, False, (8, 3), 1),
    "mixer, B wrapping inside quads": ("A head", 8 * 127, 2, True, None, 0),
    "misaligned x and history": ("F", None, 2, False, None, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_plain(case):
    name, n, NP, mixer, cfg, xmode = CASES[case]
    plan, chunk = PLANS[name]
    n = n or chunk
    p, q, W = plan.p, plan.q, plan.kernel
    kw = W.shape[-1]
    r, g = cfg or tfe.launch_config(p, q, kw)
    b = 2 if kw < 1000 else 1
    rng = np.random.default_rng(n + kw + NP)
    xs = rng.standard_normal((b, NP, n)).astype(np.float32)
    hs = rng.standard_normal((b, NP, plan.hist)).astype(np.float32)
    osc = _oscillator(n, b, rng) if mixer else None
    got, got_h = kernel_model(xs, hs, W, p, q, r, g, osc, xmode=xmode)
    want, want_h = _plain(xs, hs, W, p, q, osc)
    assert got.shape == want.shape
    assert _rel(got, want) <= REL, case
    np.testing.assert_array_equal(got_h, want_h)


def test_launch_configs_at_the_paths():
    """The tile and groups launch_config picks at the paths' plans, and
    that every bound plan fits a block."""
    want = {"A head": (8, 1), "A tail": (8, 8), "fold": (8, 16),
            "F": (8, 8)}
    for name, (plan, n) in PLANS.items():
        kw = plan.kernel.shape[-1]
        assert tfe.decimate_supported(n, plan), name
        r, g = tfe.launch_config(plan.p, plan.q, kw)
        if name in want:
            assert (r, g) == want[name], name
        assert 32 * g * plan.q <= tfe._MAX_THREADS
        assert tfe._smem_bytes(2, plan.p, plan.q, kw, r, g) <= tfe._SMEM_LIMIT


def test_load_modes():
    """Which sources the kernel reads with 16-byte loads: a float plane
    (step 1) or a complex64 tensor's (re, im) pairs (step 2), aligned,
    whole quads per row; anything else four scalar loads."""
    n = 24576
    assert load_mode(True, True, 2, 2 * n, 2, n) == 2      # x.real / x.imag
    assert load_mode(True, False, 1, 2 * n, 2, n) == 2     # x.real alone
    assert load_mode(True, False, 2, n, 1, n) == 1         # float planes
    assert load_mode(False, False, 2, n, 1, n) == 0        # offset pointer
    assert load_mode(True, True, 2, 2 * 33, 2, 33) == 0    # a history row
    assert load_mode(True, False, 2, 2 * n, 2, n) == 0     # planes apart


@pytest.mark.parametrize("r", [4, 8])
def test_window_reads_hit_distinct_banks(r):
    """The 32 lanes' window reads (lane + const) * (R + 1) + da, and the
    partial-sum stores lane * (R + 1) + j, fall in 32 distinct banks."""
    lane = np.arange(LANES)
    for base in range(3):
        for da in range(r):
            banks = ((lane + base) * (r + 1) + da) % 32
            assert len(set(banks.tolist())) == LANES


@pytest.mark.parametrize("q,kw,p", [(1, 295, 8), (3, 41, 8), (1, 9510, 8),
                                    (2, 13, 5), (1, 8, 8), (4, 3, 2)])
def test_relay_taps_is_a_padded_permutation(q, kw, p):
    rng = np.random.default_rng(kw)
    W = rng.permutation(q * kw).reshape(q, kw).astype(np.float32) + 1.0
    got = tfe.relay_taps(torch.from_numpy(W), p).numpy()
    apad = tfe._apad(kw, p)
    assert got.shape == (q, p, apad) and apad % 8 == 0
    assert apad * p >= kw > (apad - 8) * p
    for rr in range(q):
        for c in range(p):
            for a in range(apad):
                u = a * p + c
                assert got[rr, c, a] == (W[rr, u] if u < kw else 0.0)
    # Every tap exactly once, the rest zero padding.
    assert sorted(got[got != 0].tolist()) == sorted(W.ravel().tolist())
    assert (got == 0).sum() == q * (p * apad - kw)


def test_plan_downsample_tail_matches_chain():
    """The tail plan the cases use is the JAX tests' 384k -> 48k plan."""
    plan = plan_downsample(384000.0, 48000.0, 40000.0)
    assert np.array_equal(plan.kernel, PLANS["A tail"][0].kernel)



@pytest.mark.parametrize("form", ["complex", "real input", "mixer"])
def test_complex_wrappers_match_plane_wrappers(form):
    """The blocks' complex64 calls equal the float-plane calls of the JAX
    signatures on the same samples (on CPU tensors: the plain versions),
    with zero imaginary parts for a real input."""
    name = "A head" if form == "mixer" else "F"
    plan, n = PLANS[name]
    W = torch.from_numpy(plan.kernel)
    rng = np.random.default_rng(len(form))
    z = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) + 1j * rng.standard_normal(s))
        .astype(np.complex64))
    x, h = z(2, n), z(2, plan.hist)
    if form == "mixer":
        ta, tb, _ = _shift_tables(n, 1024000, 100000)
        ta, tb = torch.from_numpy(ta), torch.from_numpy(tb)
        p0 = torch.from_numpy(rng.standard_normal(2).astype(np.float32))
        c, s = torch.cos(p0), torch.sin(p0)
        y, nh = tfe.fused_mix_decimate_complex(x, ta, tb, c, s, h.real,
                                               h.imag, W, plan.p, plan.q)
        yr, yi, hr, hi = tfe.fused_mix_decimate(
            x.real, x.imag, ta.real, ta.imag, tb.real, tb.imag, c, s,
            h.real, h.imag, W, plan.p, plan.q)
        want_y, want_h = torch.complex(yr, yi), torch.complex(hr, hi)
    else:
        real = form == "real input"
        y, nh = tfe.decimate_complex(x, h, W, plan.p, plan.q,
                                     real_input=real)
        part = (lambda t: (t.real,)) if real else (lambda t: (t.real,
                                                               t.imag))
        outs, newh = tfe.decimate(part(x), part(h), W, plan.p, plan.q)
        zero = torch.zeros_like
        want_y = torch.complex(outs[0], zero(outs[0]) if real else outs[1])
        want_h = torch.complex(newh[0], zero(newh[0]) if real else newh[1])
    assert y.dtype == nh.dtype == torch.complex64
    assert torch.equal(y, want_y) and torch.equal(nh, want_h)


# The plans past one block of the polyphase kernel: (maker, chunk).
# 48 kHz -> 44.1 kHz has p = 160, q = 147, Kw = 171 (path I); 384 kHz ->
# 44.1 kHz p = 1280, q = 147, Kw = 1361; 1.024 MHz -> 44.1 kHz p = 10240,
# q = 441, Kw = 10458; path J's upsample 48 kHz -> 1.024 MHz p = 3, q =
# 64, Kw = 38 (wfm_transmitter's, 256 periods a 768-sample chunk).
WIDE_PLANS = {
    "48k to 44.1k": (lambda: plan_downsample(48000.0, 44100.0, 20000.0),
                     1600),
    "384k to 44.1k": (lambda: plan_downsample(384000.0, 44100.0, 16000.0),
                      12800),
    "1.024M to 44.1k": (lambda: plan_downsample(1024000.0, 44100.0,
                                                16000.0), 20480),
    "J 3:64": (lambda: plan_upsample(48000.0, 1024000.0, 40000.0), 768),
}


def _wide_plan(name):
    make, n = WIDE_PLANS[name]
    return make(), n


def wide_model(xs_in, hs_in, W, p, q, cfg=None, phase=None,
               shape_batch=None):
    """One launch of ``decimate_wide_kernel``: xs_in [b, NP, n], hs_in
    [b, NP, hist] float32, W [q, Kw]; cfg = (ws, nw, xs, xlen, threads,
    smem) or None for the wrapper's ``wide_config`` at batch b (at
    ``shape_batch`` where given: the paths' launch shape on fewer
    streams).  Block by block
    (phase block z, tile, stream): the rows' band taps as re-laid by
    ``wide_layout``, the staged span (one run or one a window, NaN where
    nothing is staged, zeros past the chunk), each thread's lane g, phase
    and windows (clamped to the tile), its fmaf sums over its share of
    the band, the lane group's shuffle tree, the masked stores, and each
    block's share of the history copy.  ``phase`` [b] int32: phase mode
    (``rr_decimate_phase``), hist = Kw - 1, M = ceil(n / p) windows from
    p - 1 - phase[0], windows from v = (phase[0] + n) // p on written as
    zeros.  Returns (y [b, NP, M q], new hist), and in phase mode the
    new phase too."""
    b, NP, n = xs_in.shape
    hist = hs_in.shape[-1]
    kw = W.shape[-1]
    if phase is None:
        M, start, v = n // p, 0, n // p
        assert hist == kw - p
    else:
        M = -(-n // p)
        start, v = p - 1 - int(phase[0]), (int(phase[0]) + n) // p
        assert hist == kw - 1
    lay = tfe.wide_layout(W)
    g, ls, nrc, un, wmax, zb = lay.shape
    ws_n, nw, xs, xlen, threads, smem = cfg or tfe.wide_config(
        lay.shape, p, M, shape_batch or b, NP)
    assert smem == tfe._wide_smem(NP, un, ls, xlen) <= tfe._SMEM_LIMIT
    assert g * nrc * ws_n <= threads <= tfe._WIDE_THREADS
    assert threads % LANES == 0 and LANES % g == 0 and nw <= tfe._WIDE_NW
    tm = ws_n * nw
    tiles = -(-M // tm)
    taps = lay.taps.reshape(-1)
    y = np.full((b, NP, M * q), np.nan, np.float32)
    nh = np.full((b, NP, hist), np.nan, np.float32)
    t = np.arange(threads)
    gl, rr, wsl = t % g, (t // g) % nrc, t // (g * nrc)
    for z, tile, s in np.ndindex(zb, tiles, b):
        m0, r0 = tile * tm, z * nrc
        mt, nr = min(tm, M - m0), min(nrc, q - r0)
        ulo, width, u0, unz = (int(c) for c in lay.zband[z])
        assert width <= wmax and unz <= un
        T = taps[u0 * ls:(u0 + unz) * ls]
        # The span: buf[P0 + k p + i] to X[sh + k xs + i].
        buf = np.concatenate([hs_in[s], xs_in[s]], axis=-1)
        X = np.full((NP, xlen + 1), np.nan, np.float32)
        P0 = start + m0 * p + ulo
        one_run = xs == p
        runs = (1 if one_run else mt) if width else 0
        rlen = (mt - 1) * p + width if one_run else width
        for k in range(runs):
            j = P0 + k * p + np.arange(rlen)
            assert phase is not None or (j < hist + n).all()
            at = k * xs + np.arange(rlen)
            assert at.max() < xlen
            X[:, at] = np.where(j < hist + n,
                                buf[:, np.minimum(j, hist + n - 1)], 0.0)
        # [threads, nw]: each thread's windows.
        k_of = wsl[:, None] + np.arange(nw)[None, :] * ws_n
        live = (rr < nr) & (wsl < ws_n) & (wsl < mt)
        r = np.minimum(r0 + rr, q - 1)
        off = np.where(live, lay.rows[r, 0] - ulo, 0)
        ln = np.where(live, lay.rows[r, 1], 0)
        tb = np.where(live, lay.rows[r, 2] - u0, 0)
        assert (tb >= 0).all() and (tb < unz).all()
        acc = np.zeros((NP, threads, nw), np.float32)
        xo = np.minimum(k_of, mt - 1) * xs + off[:, None]
        for u0 in range(0, int(ln.max(initial=0)), g):
            u = u0 + gl
            act = u < ln
            w = np.where(act, T[np.where(act, tb * ls + u, 0)], 0.0)
            xv = X[:, np.where(act[:, None], xo + u[:, None], 0)]
            assert not np.isnan(xv[:, act]).any()
            fma = (w[None, :, None].astype(np.float64) * xv
                   + acc).astype(np.float32)   # fmaf: one rounding
            acc = np.where(act[None, :, None], fma, acc)
        o = g >> 1
        while o:   # __shfl_xor_sync within the lane group
            acc = (acc + acc[:, t ^ o]).astype(np.float32)
            o >>= 1
        for tt in np.flatnonzero(live & (gl == 0)):
            for j in range(nw):
                k = k_of[tt, j]
                if k < mt:
                    m = m0 + k
                    y[s, :, m * q + r0 + rr[tt]] = (acc[:, tt, j] if m < v
                                                    else 0.0)
        # This block's share of the new history buf[n, n + hist).
        nb, bi = tiles * zb, tile * zb + z
        per = -(-hist // nb)
        i = np.arange(bi * per, min(hist, (bi + 1) * per))
        nh[s][:, i] = buf[:, n + i]
    assert not np.isnan(y).any() and not np.isnan(nh).any()
    if phase is None:
        return y, nh
    return y, nh, ((phase + n) % p).astype(np.int32)


def _ragged_tiles(name):
    """A launch of 3 windows a tile (10 windows: a last tile of 1) at
    one window a thread slot."""
    plan, _ = _wide_plan(name)
    lay = tfe.wide_layout(plan.kernel)
    xs, xlen = tfe._wide_span(plan.p, lay.wmax, 3)
    threads = -(-lay.nr * lay.g // LANES) * LANES
    return (1, 3, xs, xlen, threads,
            tfe._wide_smem(2, lay.un, lay.ls, xlen))


# (plan, planes, batch, launch shape): the plans as the wrapper launches
# them at the paths' batch of 64 ("paths": its windows a thread) on fewer
# streams, a real input, batch 1 and odd batches at their own shape
# (None), and a launch with a ragged last tile.
WIDE_CASES = {
    "48k to 44.1k, two planes": ("48k to 44.1k", 2, 2, "paths"),
    "384k to 44.1k, two planes": ("384k to 44.1k", 2, 1, "paths"),
    "1.024M to 44.1k, two planes": ("1.024M to 44.1k", 2, 1, "paths"),
    "48k to 44.1k, real input": ("48k to 44.1k", 1, 2, "paths"),
    "384k to 44.1k, chunked, ragged": ("384k to 44.1k", 2, 1,
                                       _ragged_tiles),
    "J 3:64, two planes": ("J 3:64", 2, 2, "paths"),
    "J 3:64, real input, batch 3": ("J 3:64", 1, 3, None),
    "48k to 44.1k, batch 1": ("48k to 44.1k", 2, 1, None),
    "48k to 44.1k, batch 5": ("48k to 44.1k", 2, 5, None),
}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_model_matches_plain(case):
    name, NP, b, cfg = WIDE_CASES[case]
    plan, n = _wide_plan(name)
    p, q, W = plan.p, plan.q, plan.kernel
    kw = W.shape[-1]
    assert tfe.decimate_supported(n, plan)
    assert not tfe.fits_block(p, q, kw, NP)
    # The mixer form takes the plan too, on its own wide kernel.
    assert tfe.decimate_supported(n, plan, mixer=True)
    rng = np.random.default_rng(n + kw + NP + b)
    xs = rng.standard_normal((b, NP, n)).astype(np.float32)
    hs = rng.standard_normal((b, NP, plan.hist)).astype(np.float32)
    got, got_h = wide_model(xs, hs, W, p, q,
                            cfg(name) if callable(cfg) else None,
                            shape_batch=64 if cfg == "paths" else None)
    want, want_h = _plain(xs, hs, W, p, q)
    assert got.shape == want.shape
    assert _rel(got, want) <= REL, case
    np.testing.assert_array_equal(got_h, want_h)


# The mixer form's plans past one block (rr_mix_decimate_wide): (input
# rate, output rate, bandwidth), chunk, streams, the launch shape's batch
# (None: the streams' own), pairs = (base, row) of the complex64 chunk
# read in place.  U1-U3 of chip_smoke.py (2.048 MHz -> 240 kHz: p = 128,
# q = 15, Kw = 435, and -> 12 kHz: p = 512, q = 3, Kw = 6655, on the
# tensor cores; 48 kHz -> 44.1 kHz at 1600, a 100-sample oscillator
# block, by FMA), the other
# plans of the JAX package's MixerDecimator the polyphase form does not
# take, a chunk shorter than the history (6143 samples, partly the old
# mixed history), an oscillator block of 110 (not a multiple of 4), and
# a chunk whose rows sit at an odd 8-byte phase (the 16-byte shift).
WIDE_MIX_CASES = {
    "U1: 2.048M to 240k at 16384": ((2.048e6, 240e3, 200e3), 16384, 1, 64,
                                    (0, 16384)),
    "U2: 2.048M to 12k at 16384": ((2.048e6, 12e3, 10e3), 16384, 1, 64,
                                   (0, 16384)),
    "U3: 48k to 44.1k at 1600": ((48e3, 44100.0, 20e3), 1600, 2, 64,
                                 (0, 1600)),
    "1.024M to 200k at 16384": ((1.024e6, 200e3, 150e3), 16384, 1, 64,
                                (0, 16384)),
    "2.048M to 8k at 16384": ((2.048e6, 8e3, 6e3), 16384, 1, 64,
                              (0, 16384)),
    "96k to 44.1k at 1280": ((96e3, 44100.0, 20e3), 1280, 2, 64, (0, 1280)),
    "192k to 44.1k at 1280": ((192e3, 44100.0, 20e3), 1280, 2, None,
                              (0, 1280)),
    "short chunk: 2.048M to 12k at 1024": ((2.048e6, 12e3, 10e3), 1024, 2,
                                           64, (0, 1024)),
    "inner 110: 48k to 44.1k at 1760": ((48e3, 44100.0, 20e3), 1760, 3,
                                        None, (0, 1760)),
    "odd 8-byte phase: 48k to 44.1k at 1600": ((48e3, 44100.0, 20e3), 1600,
                                               3, 64, (1, 1601)),
}


def _mix_oscillator(n, b, rng):
    """Tables of a shift at 2.048 MHz (the block's factoring of n) and a
    random start phasor a stream."""
    from radiorust_tpu_torch.blocks.transform import _inner_block
    ta, tb, _ = _shift_tables(n, 2048000, -300000)
    assert len(tb) == _inner_block(n)
    ph = rng.standard_normal(b)
    return (ta.real.copy(), ta.imag.copy(), tb.real.copy(), tb.imag.copy(),
            np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32))


@pytest.mark.parametrize("case", list(WIDE_MIX_CASES))
def test_wide_mixer_model_matches_plain(case):
    """#2's wide form (``mix_wide_model``: the span in rows of a period,
    each staged chunk sample mixed once through the 16-byte shift at the
    strided runs' multiply-shift indices, the history from the span,
    the sums on the plan's route, 3xTF32 on the tensor cores or FMA)
    against ``fused_mix_decimate_plain``; the new history bit for bit.
    The wrapper takes the plan (``decimate_supported``) and, on CPU
    tensors, is the plain version (no launch)."""
    rates, n, b, shape_batch, pairs = WIDE_MIX_CASES[case]
    plan = plan_downsample(*rates)
    p, q, W = plan.p, plan.q, plan.kernel
    kw = W.shape[-1]
    rng = np.random.default_rng(n + kw + b)
    osc = _mix_oscillator(n, b, rng)
    assert not tfe.fits_block(p, q, kw)
    assert tfe.decimate_supported(n, plan, mixer=True, inner=len(osc[2]))
    xs = rng.standard_normal((b, 2, n)).astype(np.float32)
    hs = rng.standard_normal((b, 2, plan.hist)).astype(np.float32)
    got, got_h = mix_wide_model(xs, hs, W, p, q, osc,
                                shape_batch=shape_batch, pairs=pairs)
    want, want_h = _plain(xs, hs, W, p, q, osc)
    assert got.shape == want.shape == (b, 2, n // p * q)
    assert _rel(got, want) <= REL, case
    np.testing.assert_array_equal(got_h, want_h)
    t = torch.from_numpy
    before = tfe.fused_mix_decimate.launches
    y, nh = tfe.fused_mix_decimate_complex(
        t(xs[:, 0] + 1j * xs[:, 1]), t(osc[0] + 1j * osc[1]),
        t(osc[2] + 1j * osc[3]), t(osc[4]), t(osc[5]), t(hs[:, 0]),
        t(hs[:, 1]), t(W), p, q)
    assert tfe.fused_mix_decimate.launches == before
    np.testing.assert_array_equal(np.stack([y.real, y.imag], 1), want)
    np.testing.assert_array_equal(np.stack([nh.real, nh.imag], 1), want_h)


def test_mixer_limits_refuse_at_bind():
    """The mixer form's limits are the wrapper's rule at bind: the
    oscillator index division exact (n inner < 2^31) on either form; a
    chunk that is not a whole number of periods on neither."""
    wide = plan_downsample(2.048e6, 240e3, 200e3)
    poly = PLANS["A head"][0]
    for plan in (wide, poly):
        n = plan.p * 2 ** 14
        assert tfe.decimate_supported(n, plan, mixer=True, inner=128)
        assert not tfe.decimate_supported(n, plan, mixer=True,
                                          inner=2 ** 31 // n + 1)
        assert not tfe.decimate_supported(n + 1, plan, mixer=True)


def _all_wide_geometries():
    """(label, plan, windows a stream) of every geometry the wide kernel
    runs at on the paths and in chip_smoke.py's checks."""
    out = [(name, *_wide_plan(name)) for name in WIDE_PLANS]
    out = [(name, plan, n // plan.p) for name, plan, n in out]
    for name, (make, n, _) in PHASE_PLANS.items():
        plan = make()
        out.append((name, plan, -(-n // plan.p)))
    return out


@pytest.mark.parametrize("name", list(WIDE_PLANS))
def test_wide_configs_and_bands(name):
    """The band layout of each wide plan: row r's re-laid band is W's
    nonzero taps from lo_r, L_r of them, zero padded to ls = G mod 2 G,
    each distinct band stored once (a downsample plan's rows are one
    prototype at q offsets: one band; the upsample's rows are q
    different phases: q bands); each phase block's joint band covers its
    rows' bands and nothing past them, and names the bands they read; a
    row of zeros has an empty band."""
    plan, n = _wide_plan(name)
    p, q, W = plan.p, plan.q, plan.kernel
    lay = tfe.wide_layout(W)
    g, ls, nr, un, wmax, zb = lay.shape
    assert ls % (2 * g) == g and zb == -(-q // nr)
    for r in range(q):
        lo, ln, band = lay.rows[r]
        nz = np.flatnonzero(W[r])
        assert lo == nz[0] and lo + ln == nz[-1] + 1 and ln <= ls
        np.testing.assert_array_equal(lay.taps[band, :ln], W[r, lo:lo + ln])
        assert not lay.taps[band, ln:].any()
    assert len(lay.taps) == (q if name.startswith("J") else 1)
    assert len({lay.taps[u].tobytes() for u in range(len(lay.taps))}) == \
        len(lay.taps)
    for z in range(zb):
        rows = lay.rows[z * nr:(z + 1) * nr]
        ulo, width, u0, unz = lay.zband[z]
        assert ulo == rows[:, 0].min()
        assert ulo + width == (rows[:, 0] + rows[:, 1]).max() <= W.shape[1]
        assert u0 == rows[:, 2].min() and u0 + unz == rows[:, 2].max() + 1
        assert unz <= un
    assert wmax == lay.zband[:, 1].max() and un == lay.zband[:, 3].max()
    zero = np.zeros((3, 5), np.float32)
    zero[1, 2] = 1.0
    zl = tfe.wide_layout(zero)
    assert zl.rows.tolist() == [[0, 0, 0], [2, 1, 1], [0, 0, 0]]
    assert zl.zband.tolist() == [[2, 1, 0, 2]] and zl.taps.shape == (2, 1)


@pytest.mark.parametrize("batch", [64, 3, 1])
def test_wide_launch_shapes_fit(batch):
    """At every geometry the wide kernel runs (batch 64, an odd batch,
    batch 1): a block within 227 KB of shared memory and 1024 threads
    (the kernel's own 256; past 48 KB only at the fold's 9510 taps),
    lane groups inside a warp, every output thread placed, the tile within the kernel's 8 register windows and
    the grid within CUDA's limits; and at batch 64 the blocks the shape
    aims at, two an SM."""
    for label, plan, windows in _all_wide_geometries():
        lay = tfe.wide_layout(plan.kernel)
        g, ls, nr, un, wmax, zb = lay.shape
        for NP in (1, 2):
            ws, nw, xs, xlen, threads, smem = tfe.wide_config(
                lay.shape, plan.p, windows, batch, NP)
            assert smem <= tfe._SMEM_LIMIT == 232448, label
            assert threads <= tfe._WIDE_THREADS <= 1024, label
            assert threads % LANES == 0 and LANES % g == 0
            assert g * nr * ws <= threads and 1 <= nw <= tfe._WIDE_NW
            assert (nw - 1) * ws < windows
            tiles = -(-windows // (ws * nw))
            assert tiles <= 65535 and batch <= 65535
            span = ((ws * nw - 1) * plan.p + wmax if xs == plan.p
                    else ws * nw * xs)
            assert span <= xlen and (xs == plan.p or xs >= wmax)
            blocks = batch * tiles * zb
            if batch == 64 and windows > 1:
                assert blocks >= tfe._WIDE_FILL or nw == 1, label
            # The fold's block opts in past 48 KB of shared memory.
            assert (smem > 48 * 1024) == label.startswith("fuse_"), label


@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_wide_tap_reads_hit_distinct_banks(g):
    """A warp's tap reads T[rr ls + u0 + lane % G], rr = lane / G + c, at
    ls = G mod 2 G, fall in 32 distinct banks."""
    lane = np.arange(LANES)
    for L in (12, 36, 82, 233, 285, 465):
        ls = L + (g - L % (2 * g)) % (2 * g)
        assert ls % (2 * g) == g
        for c in range(3):
            for u0 in range(0, 2 * g, g):
                banks = (((lane // g) + c) * ls + u0 + lane % g) % 32
                assert len(set(banks.tolist())) == LANES
# (maker of the plan, chunk, steps): every phase-mode plan the port binds
# on the paths and the JAX tests, chained chunk after chunk.  384 kHz ->
# 44.1 kHz at 6144 (the 44.1 kHz receiver's tail: p = 1280, q = 147, a
# schedule of 5 steps, 588 or 735 valid samples), 8:3 at 60, 100 and 7
# (7 is shorter than a period: the history is longer than the chunk),
# the upsample 384 -> 1024 at 64, 1.024 MHz -> 44.1 kHz and 22.05 kHz
# at 16384 (p = 10240, 20480: at 22.05 kHz some steps have no window),
# and the fuse_deemphasis fold (8:1, 9510 taps) at 1001, whose block
# takes shared memory past 48 KB.
PHASE_PLANS = {
    "384k to 44.1k at 6144": (lambda: plan_downsample(384000.0, 44100.0,
                                                      36000.0), 6144, 4),
    "8:3 at 60": (lambda: plan_downsample(1024.0, 384.0, 200.0), 60, 8),
    "8:3 at 100": (lambda: plan_downsample(1024.0, 384.0, 200.0), 100, 8),
    "8:3 at 7": (lambda: plan_downsample(1024.0, 384.0, 200.0), 7, 8),
    "384 to 1024 at 64": (lambda: plan_upsample(384.0, 1024.0, 300.0), 64,
                          6),
    "1.024M to 44.1k at 16384": (lambda: plan_downsample(
        1024000.0, 44100.0, 17640.0), 16384, 3),
    "1.024M to 22.05k at 16384": (lambda: plan_downsample(
        1024000.0, 22050.0, 8820.0), 16384, 3),
    "fuse_deemphasis fold at 1001": (lambda: PLANS["fold"][0], 1001, 2),
}


def _phase_chain(name, b, shape_batch=None):
    """The phase-mode model chained over the plan's steps at batch b (at
    the launch shape of ``shape_batch`` where given), on two planes and
    on one (a real input), against ``rational_fir_phase``
    with the history and phase handed on: the valid prefix within REL,
    exact zeros behind it, the history and phase bit for bit."""
    make, n, steps = PHASE_PLANS[name]
    plan = make()
    p, q, W = plan.p, plan.q, plan.kernel
    kw = W.shape[-1]
    assert not plan.aligned(n)
    rng = np.random.default_rng(n + kw + b)
    for NP in (2, 1):
        xs = rng.standard_normal((steps, b, 2, n)).astype(np.float32)
        if NP == 1:
            xs[:, :, 1] = 0.0
        h = rng.standard_normal((b, 2, kw - 1)).astype(np.float32)
        if NP == 1:
            h[:, 1] = 0.0
        ph = np.zeros(b, np.int32)
        th, tph = torch.from_numpy(h[:, 0] + 1j * h[:, 1]), torch.zeros(
            b, dtype=torch.int32)
        valid = plan.valid_counts(n, 0, steps)
        for k in range(steps):
            got, nh, nph = wide_model(xs[k, :, :NP], h[:, :NP], W, p, q,
                                      phase=ph, shape_batch=shape_batch)
            x = torch.from_numpy(xs[k, :, 0] + 1j * xs[k, :, 1])
            y, th, tph = tfe.rational_fir_phase(
                x, th, tph, torch.from_numpy(W), p, q, real_input=NP == 1)
            want = np.stack([y.real.numpy(), y.imag.numpy()], 1)[:, :NP]
            assert got.shape == want.shape == (b, NP, -(-n // p) * q)
            assert np.all(got[..., valid[k]:] == 0)
            if valid[k]:
                assert _rel(got[..., :valid[k]], want[..., :valid[k]]) <= REL
            want_h = np.stack([th.real.numpy(), th.imag.numpy()], 1)[:, :NP]
            np.testing.assert_array_equal(nh, want_h)
            np.testing.assert_array_equal(nph, tph.numpy())
            h[:, :NP], ph = nh, nph
        assert int(ph[0]) == (steps * n) % p


@pytest.mark.parametrize("name", list(PHASE_PLANS))
def test_phase_model_matches_rational_fir_phase(name):
    """The phase-mode kernel's index arithmetic (the offset read from the
    phase, zeros past the chunk, windows masked from v on, the history
    reaching back into the old one) against ``rational_fir_phase``, step
    after step with the history and phase handed on, on two planes and
    on one (a real input); the masked windows exact zeros, the history
    and phase equal bit for bit; at the launch shape of the paths' batch
    of 64."""
    _phase_chain(name, 2, shape_batch=64)


@pytest.mark.parametrize("name,b", [("384k to 44.1k at 6144", 1),
                                    ("384k to 44.1k at 6144", 3),
                                    ("8:3 at 7", 1),
                                    ("384 to 1024 at 64", 5)])
def test_phase_model_at_batch_1_and_odd_batches(name, b):
    """The same chain at batch 1 (path O's examples) and odd batches:
    another launch shape (fewer blocks, one window a thread) over the
    same arithmetic."""
    _phase_chain(name, b)


@pytest.mark.parametrize("name", list(PHASE_PLANS))
def test_phase_wrapper_on_cpu_is_the_plain_version(name):
    """``decimate_phase_complex`` on CPU tensors is ``rational_fir_phase``
    (no launch), and the launch shape it would take fits shared memory."""
    make, n, _ = PHASE_PLANS[name]
    plan = make()
    p, q, W = plan.p, plan.q, torch.from_numpy(plan.kernel)
    kw = W.shape[-1]
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((2, n))
                          + 1j * rng.standard_normal((2, n))).astype(
                              np.complex64))
    h = torch.zeros((2, kw - 1), dtype=torch.complex64)
    ph = torch.tensor([p - 1, p - 1], dtype=torch.int32)
    before = tfe.decimate_phase_complex.launches
    got = tfe.decimate_phase_complex(x, h, ph, W, p, q)
    want = tfe.rational_fir_phase(x, h, ph, W, p, q)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tfe.decimate_phase_complex.launches == before
    lay = tfe.wide_layout(plan.kernel)
    ws, nw, xs, xlen, threads, smem = tfe.wide_config(
        lay.shape, p, -(-n // p), 2, 2)
    assert smem == tfe._wide_smem(2, lay.un, lay.ls, xlen) <= tfe._SMEM_LIMIT
    assert threads <= tfe._WIDE_THREADS and ws * nw >= 1
    with pytest.raises(ValueError):
        tfe.decimate_phase_complex(x, h[:, 1:], ph, W, p, q)


def test_decimate_split_runs_the_plain_versions_on_the_cpu(capsys):
    """``tools/decimate_split.py`` on the CPU: every geometry of #1's wide
    form and phase-mode entry, #1's polyphase form and #2 at A, and #2's
    wide form at path U's plans and its other checks, each held against
    its plain version (here the wrapper is the plain version: no launch,
    no time), one JSON line each and the card line last."""
    import json

    from radiorust_tpu_torch.tools import decimate_split
    rows = decimate_split.main(["--device", "cpu", "--batch", "2"])
    assert len(rows) == 18
    assert [r["geometry"].split(":")[0] for r in rows[12:15]] == [
        "mixer wide (#2)"] * 3
    assert {r["launches"] for r in rows} == {0}
    assert all(r["rel"] == 0.0 and r["us_graph_10"] is None for r in rows)
    kinds = [r["geometry"].split(":")[0] for r in rows]
    assert kinds[:3] == ["I", "384 kHz -> 44.1 kHz at 12800", "J"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"card": "cpu"}
