"""The FFT plan of the overlap-save kernels, on the CPU.

``radiorust_tpu_torch/ops/filter.py`` factors the column length n1 into
the kernels' passes (:func:`fft_radices`) and designs their float32 root
tables (:func:`fft_roots`).  The numpy models below follow the pass order
and index arithmetic of ``csrc/overlap_save.cu`` (``column_fft``,
``row_fft``, ``row_ifft`` and the three launches), in complex64, fed the
same float32 tables, and are held against ``np.fft`` and against the
wrappers' plain ``torch.fft`` versions, at the row length n2 and the
strip width each plan takes (:func:`kernel_factors`, :func:`strip_cols`),
and, past a one-column strip, through the passes of the device-memory
column route (``column_passes``).  Nothing here needs a GPU.
"""

import numpy as np
import pytest
import torch

from radiorust_tpu_torch.ops import filter as tfl

REL = 1e-5        # model vs np.fft, max |diff| / max |ref|
PLAIN_REL = 2.4e-5   # four-step model vs the plain version (FILTER_BOUND)
GEOMETRIES = (16, 64, 120, 77, 761, 768)   # F/G, E, A/C, 7*11, prime, max
# (m, n): the transforms the JAX package runs where the 128-point rows
# alone did not divide N or left n1 past 768: Filter at chunk 1000 and 1001,
# at chunk 65536, wfm_receiver() at input chunk 262144 (mid chunk 98304),
# and with a 6144-tap response there.
WIDE = ((1000, 1000), (1001, 1001), (65536, 65536), (98304, 98304),
        (6144, 98304))
# (m, n) whose column passes a one-column strip (n1 > 9685): Filter at
# chunk 10001 (20002 = 10001 x 2, two generic passes of 73 and 137), a
# prime N = 19373 (one 19373-point generic pass), N = 38746 = 19373 x 2,
# and chunk 10003 (20006 = 2 x 7 x 1429: a generic pass of 7).
PAST_STRIP = ((10001, 10001), (9686, 9687), (19373, 19373), (10003, 10003))


def _roots(n, inverse=False):
    re, im = tfl.fft_roots(n)
    w = (re + 1j * im).astype(np.complex64)
    return np.conj(w) if inverse else w


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _brev5(lane):
    return int(f"{lane:05b}"[::-1], 2)


def _brev(lane, bits):
    return int(f"{lane:0{bits}b}"[::-1], 2) if bits else 0


def _row_shape(n2):
    """(V, LR): values a lane and lanes of a row of n2 points."""
    lr = min(32, n2)
    return n2 // lr, lr


def column_fft(x, inverse=False):
    """``column_fft``: Stockham passes down axis 0 of x [n1, cols].  Pass
    (radix p, m = n / p, stride s): butterfly (k < s, q < m) reads
    x[k + s (q + m j)], j < p, and writes DFT_p[r] times w^(q r (n1 / n))
    to y[k + s (p q + r)]; the roots of DFT_p are w^((j r mod p) n1 / p)."""
    n1 = x.shape[0]
    w = _roots(n1, inverse)
    x = x.astype(np.complex64)
    n, s = n1, 1
    for p in tfl.fft_radices(n1):
        m = n // p
        j = np.arange(p)
        k = np.arange(s)[None, :, None]
        q = np.arange(m)[None, None, :]
        a = x[k + s * (q + m * j[:, None, None])]            # [p, s, m, cols]
        dft = w[(np.outer(j, j) % p) * (n1 // p)]            # [r, j]
        b = np.tensordot(dft, a, axes=(1, 0)).astype(np.complex64)
        r = j[:, None, None]
        y = np.empty_like(x)
        y[k + s * (p * q + r)] = b * w[q * r * (n1 // n)][..., None]
        x, n, s = y, m, s * p
    return x


def row_fft(x):
    """``row_fft`` on rows x [..., n2] held by LR = min(32, n2) lanes of V
    = n2 / LR values: lane l holds x[l + LR j] in slot j; a radix-V pass
    across the slots with twiddle w^(l j), then log2(LR) radix-2
    decimation-in-frequency passes across the lanes (partner l ^ h, h =
    LR / 2 .. 1, twiddle w^((l & (h - 1)) n2 / 2h)).  Returns v[..., j, l]
    = X[V brev(l) + j]."""
    n2 = x.shape[-1]
    V, LR = _row_shape(n2)
    w = _roots(n2)
    lane = np.arange(LR)
    v = x.astype(np.complex64).reshape(*x.shape[:-1], V, LR)
    j = np.arange(V)
    v = np.tensordot(v, w[(np.outer(j, j) % V) * LR], axes=(-2, 1))
    v = np.moveaxis(v, -1, -2) * w[np.outer(j, lane)]
    h = LR // 2
    while h >= 1:
        part = v[..., lane ^ h]
        tw = w[(lane & (h - 1)) * (n2 // (2 * h))]
        v = np.where(lane & h, (part - v) * tw, v + part)
        h //= 2
    return v


def row_ifft(v):
    """``row_ifft``: the inverse of :func:`row_fft` (unnormalised), from
    v[..., j, l] = X[V brev(l) + j] back to x[..., l + LR j] as [..., n2]:
    radix-2 decimation-in-time passes across the lanes (h = 1 .. LR / 2),
    the conjugate twiddle, and an inverse radix-V pass across the slots."""
    V, LR = v.shape[-2:]
    n2 = V * LR
    w = _roots(n2, inverse=True)
    lane = np.arange(LR)
    h = 1
    while h < LR:
        v = np.where(lane & h, v * w[(lane & (h - 1)) * (n2 // (2 * h))], v)
        part = v[..., lane ^ h]
        v = np.where(lane & h, part - v, v + part)
        h *= 2
    j = np.arange(V)
    v = v * w[np.outer(j, lane)]
    v = np.tensordot(w[(np.outer(j, j) % V) * LR], v, axes=(1, -2))
    return np.moveaxis(v, 0, -2).reshape(*v.shape[1:-1], n2)


def device_column_passes(x, inverse=False):
    """``column_passes``: the passes of :func:`column_fft` over every
    column of a grid x [n1, n2] at once, one launch per pass; each block of
    up to 256 outputs r of a pass computed as its threads do, one output
    per thread and column."""
    n1, n2 = x.shape
    w = _roots(n1, inverse)
    x = x.astype(np.complex64)
    n, s = n1, 1
    for p in tfl.fft_radices(n1):
        m = n // p
        # The launch's threads a grid row: one a butterfly of a specialised
        # radix (P outputs each), one an output of a generic prime.
        special = p in (2, 3, 4, 5, 8)
        threads = (m * s if special else n1) * n2
        assert threads * (p if special else 1) == n1 * n2
        j = np.arange(p)
        k = np.arange(s)[None, :, None]
        q = np.arange(m)[None, None, :]
        a = x[k + s * (q + m * j[:, None, None])]            # [p, s, m, cols]
        y = np.empty_like(x)
        for r0 in range(0, p, 256):
            r = np.arange(r0, min(p, r0 + 256))
            dft = w[(np.outer(r, j) % p) * (n1 // p)]        # [r, j]
            b = np.tensordot(dft, a, axes=(1, 0)).astype(np.complex64)
            rr = r[:, None, None]
            y[k + s * (p * q + rr)] = b * w[q * rr * (n1 // n)][..., None]
        x, n, s = y, m, s * p
    return x


def device_pass_buffers(npass, inverse):
    """(read, written) buffers of each pass of ``column_passes`` as
    ``run_stages`` hands it them: the forward passes from the input through
    the column scratch ("tmp") and the forward scratch ("fwd"), the last
    writing "fwd" (twiddled); the inverse ones from the band scratch
    ("bands") through "tmp" and "bands", the last writing "out"."""
    if inverse:
        src, last = "bands", "out"
        near, far = (("tmp", "bands") if (npass - 1) % 2
                     else ("bands", "tmp"))
    else:
        src, last, near, far = "input", "fwd", "tmp", "fwd"
    out = []
    for ps in range(npass):
        dst = last if ps == npass - 1 else near if (npass - 1 - ps) % 2 \
            else far
        out.append((src, dst))
        src = dst
    return out


def column_strips(z, inverse=False):
    """Launches 1 and 3's column FFT of one stream's grid z [n1, n2], by
    the route ``run_stages`` takes: strip by strip of ``strip_cols(n1,
    n2)`` columns (block x of the launch's grid), as the kernel stages
    them, or, past a one-column strip, in device memory."""
    n1, n2 = z.shape
    cols = tfl.strip_cols(n1, n2)
    if not cols:
        return device_column_passes(z, inverse)
    assert n2 % cols == 0
    return np.concatenate([column_fft(z[:, c0:c0 + cols], inverse)
                           for c0 in range(0, n2, cols)], axis=1)


def four_step(prev, cur, responses):
    """The three launches of ``run_stages`` on complex streams prev [X, m],
    cur [X, n] against grid responses [K, n1, n2]: output [X, K, n]."""
    X, n = cur.shape
    K, n1, n2 = responses.shape
    N = n1 * n2
    V, LR = _row_shape(n2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / N)
    tw = tw.astype(np.complex64)
    z = np.concatenate([prev, cur], axis=1).reshape(X, n1, n2)
    # Launch 1: column FFT down i1 of each stream, then the twiddle.
    u = np.stack([column_strips(zs) for zs in z]) * tw          # [X, k1, i2]
    # Launch 2: row FFT, each band's response at k2 = V brev(l) + j,
    # inverse row FFT, conjugate twiddle.
    v = row_fft(u)                                               # [X, k1, j, l]
    bits = LR.bit_length() - 1
    k2 = V * np.array([_brev(lane, bits) for lane in range(LR)])[None, :] \
        + np.arange(V)[:, None]                                  # [j, l]
    out = np.empty((X, K, n), np.complex64)
    for band in range(K):
        g = responses[band][:, k2].astype(np.complex64)          # [k1, j, l]
        s = row_ifft(v * g) * np.conj(tw)                        # [X, k1, i2]
        # Launch 3: inverse column FFT, rows i1 < ho, t < n.
        ho = -(-n // n2)
        y = np.stack([column_strips(ss, inverse=True) for ss in s])
        out[:, band] = y[:, :ho].reshape(X, -1)[:, :n]
    return out


def test_radices_factor_every_supported_n1():
    for n1 in range(1, tfl._MAX_N1 + 1):
        radices = tfl.fft_radices(n1)
        assert int(np.prod(radices, dtype=np.int64)) == n1, n1
        for p in radices:
            assert p in (2, 3, 4, 5, 8) or all(p % d for d in range(2, p)), p
        # 8 first, at most one 4 or 2 after it, then 3s, 5s and primes.
        twos = [p for p in radices if p in (2, 4, 8)]
        assert twos == sorted(twos, reverse=True) and len(
            [p for p in twos if p < 8]) <= 1, radices
        assert radices == tuple(twos) + tuple(sorted(radices[len(twos):]))


@pytest.mark.parametrize("n", [1, 16, 77, 128, 761, 768])
def test_roots_are_float32_of_float64_design(n):
    re, im = tfl.fft_roots(n)
    assert re.dtype == im.dtype == np.float32 and re.shape == (n,)
    want = np.exp(-2j * np.pi * np.arange(n) / n)
    assert np.array_equal(re, want.real.astype(np.float32))
    assert np.array_equal(im, want.imag.astype(np.float32))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n1", GEOMETRIES)
def test_column_passes_match_numpy_fft(n1, inverse):
    rng = np.random.default_rng(n1)
    x = (rng.standard_normal((n1, 8))
         + 1j * rng.standard_normal((n1, 8))).astype(np.complex64)
    got = column_fft(x, inverse)
    x64 = x.astype(np.complex128)
    want = np.fft.ifft(x64, axis=0) * n1 if inverse else np.fft.fft(x64,
                                                                   axis=0)
    assert _rel(got, want) <= REL


def test_row_passes_match_numpy_fft():
    rng = np.random.default_rng(128)
    x = (rng.standard_normal((6, 128))
         + 1j * rng.standard_normal((6, 128))).astype(np.complex64)
    v = row_fft(x)
    order = np.array([[4 * _brev5(lane) + j for lane in range(32)]
                      for j in range(4)])
    spectrum = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel(v, spectrum[:, order]) <= REL
    assert _rel(row_ifft(v), 128 * x) <= REL


@pytest.mark.parametrize("n2", [1, 2, 4, 8, 16, 32, 64, 256])
def test_row_passes_of_every_length_match_numpy_fft(n2):
    """The other row lengths a plan takes: n2 < 32 on n2 lanes of one
    value, 64 and 256 on 32 lanes of 2 and 8 values."""
    rng = np.random.default_rng(n2)
    x = (rng.standard_normal((5, n2))
         + 1j * rng.standard_normal((5, n2))).astype(np.complex64)
    v = row_fft(x)
    V, LR = _row_shape(n2)
    bits = LR.bit_length() - 1
    order = np.array([[V * _brev(lane, bits) + j for lane in range(LR)]
                      for j in range(V)])
    spectrum = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel(v, spectrum[:, order]) <= REL
    assert _rel(row_ifft(v), n2 * x) <= REL


@pytest.mark.parametrize("n1, m, n, K", [(1, 64, 64, 1), (12, 768, 768, 1),
                                         (16, 1024, 1024, 2),
                                         (77, 4928, 4928, 2),
                                         (120, 6144, 9216, 3)])
def test_four_step_model_matches_plain(n1, m, n, K):
    """The launches' data flow, with the same tables, against the plain
    torch.fft version of the filter (K = 1) and of the bank."""
    assert tfl.kernel_factors(m + n)[0] == n1 and tfl.bank_supported(n, K, m)
    rng = np.random.default_rng(n1)
    X = 2

    def c64(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    prev, cur = c64(X, m), c64(X, n)
    resp = tfl.response_grid(torch.from_numpy(c64(K, m + n)))
    got = four_step(prev, cur, resp.numpy())
    planes = [torch.from_numpy(np.ascontiguousarray(p)) for p in
              (prev.real, prev.imag, cur.real, cur.imag)]
    if K == 1:
        yr, yi = tfl.fused_overlap_save_plain(*planes, resp[0].real,
                                              resp[0].imag)
        want = (yr + 1j * yi).numpy()[:, None]
    else:
        yr, yi = tfl.fused_filter_bank_plain(*planes, resp.real, resp.imag)
        want = (yr + 1j * yi).numpy()
    assert _rel(got, want) <= PLAIN_REL


@pytest.mark.parametrize("m, n", WIDE)
@pytest.mark.parametrize("K", [1, 3], ids=["filter", "bank K=3"])
def test_four_step_model_at_wide_plans_matches_numpy_fft(m, n, K):
    """The launches at the plans of the wider geometries, against an
    np.fft overlap-save step in float64, and the wrappers' plain versions
    against the same."""
    assert tfl.supported(n, m) and tfl.bank_supported(n, K, m, 2)
    n1, n2 = tfl.kernel_factors(m + n)
    rng = np.random.default_rng(m + n + K)
    X = 2

    def c64(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    prev, cur = c64(X, m), c64(X, n)
    resp = c64(K, m + n)
    grid = tfl.response_grid(torch.from_numpy(resp))
    assert grid.shape == (K, n1, n2)
    got = four_step(prev, cur, grid.numpy())
    z = np.concatenate([prev, cur], axis=1).astype(np.complex128)
    want = np.fft.ifft(np.fft.fft(z)[:, None] * resp[None].astype(
        np.complex128))[..., :n]
    assert _rel(got, want) <= PLAIN_REL
    planes = [torch.from_numpy(np.ascontiguousarray(p)) for p in
              (prev.real, prev.imag, cur.real, cur.imag)]
    if K == 1:
        yr, yi = tfl.fused_overlap_save_plain(*planes, grid[0].real,
                                              grid[0].imag)
        plain = (yr + 1j * yi).numpy()[:, None]
    else:
        yr, yi = tfl.fused_filter_bank_plain(*planes, grid.real, grid.imag)
        plain = (yr + 1j * yi).numpy()
    assert _rel(plain, want) <= PLAIN_REL


@pytest.mark.parametrize("m, n, plan, cols", [
    (1000, 1000, (125, 16), 16), (1001, 1001, (1001, 2), 2),
    (65536, 65536, (512, 256), 16), (98304, 98304, (768, 256), 16),
    (6144, 98304, (408, 256), 32), (6144, 9216, (120, 128), 32),
    (4096, 4096, (64, 128), 32), (49152, 49152, (768, 128), 16),
    (600, 1000, (25, 64), 32), (9685, 9685, (9685, 2), 1),
    (4004, 4004, (1001, 8), 8)])
def test_plan_and_strips(m, n, plan, cols):
    """The plan each geometry takes (n2 = 128 wherever 128 divides N and
    n1 stays within 768, as the JAX package's grids; less where it does
    not divide, 256 for a long N), and the strip width its column length
    leaves in shared memory."""
    assert tfl.kernel_factors(m + n) == plan
    n1, n2 = plan
    assert tfl.strip_cols(n1, n2) == cols and n2 % cols == 0
    assert 4 * (4 * n1 * cols + 2 * n1) <= tfl._SMEM
    assert tfl.supported(n, m)


@pytest.mark.parametrize("m, n", [(10001, 10001), (9686, 9687), (1, 19373)])
def test_columns_past_one_column_strip_are_refused(m, n):
    """Columns longer than a one-column strip holds (odd N past 9685,
    N = 2 x odd past 19370) were refused before the device-memory route:
    now they get a plan with no strip, and both kernels take them."""
    n1, n2 = tfl.kernel_factors(m + n)
    assert n1 * n2 == m + n and n1 > 9685 and tfl.strip_cols(n1, n2) == 0
    assert tfl.supported(n, m) and tfl.bank_supported(n, 2, m, 64)


@pytest.mark.parametrize("m, n, K", [(*g, 1) for g in PAST_STRIP]
                         + [(10001, 10001, 3)])
def test_device_column_route_matches_numpy_fft(m, n, K):
    """The launches with the device-memory column route, against an np.fft
    overlap-save step in float64 (and the plain version, at N = 20002)."""
    n1, n2 = tfl.kernel_factors(m + n)
    assert tfl.strip_cols(n1, n2) == 0
    rng = np.random.default_rng(m + n + K)
    X = 1

    def c64(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    prev, cur = c64(X, m), c64(X, n)
    resp = c64(K, m + n)
    grid = tfl.response_grid(torch.from_numpy(resp))
    got = four_step(prev, cur, grid.numpy())
    z = np.concatenate([prev, cur], axis=1).astype(np.complex128)
    want = np.fft.ifft(np.fft.fft(z)[:, None] * resp[None].astype(
        np.complex128))[..., :n]
    assert _rel(got, want) <= PLAIN_REL
    if m + n == 20002:
        planes = [torch.from_numpy(np.ascontiguousarray(p)) for p in
                  (prev.real, prev.imag, cur.real, cur.imag)]
        yr, yi = tfl.fused_filter_bank_plain(*planes, grid.real, grid.imag)
        assert _rel((yr + 1j * yi).numpy(), want) <= PLAIN_REL


@pytest.mark.parametrize("npass", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_device_route_passes_never_run_in_place(npass, inverse):
    """Each pass reads one buffer and writes another; the first inverse
    pass leaves the band scratch it reads whole until it is done."""
    passes = device_pass_buffers(npass, inverse)
    assert passes[0][0] == ("bands" if inverse else "input")
    assert passes[-1][1] == ("out" if inverse else "fwd")
    assert all(src != dst for src, dst in passes)
    if inverse and npass > 1:
        assert passes[0][1] == "tmp"


@pytest.mark.parametrize("n1", [125, 408, 512, 816, 1001, 1536, 9685])
def test_radices_factor_wide_columns(n1):
    radices = tfl.fft_radices(n1)
    assert int(np.prod(radices, dtype=np.int64)) == n1
    for p in radices:
        assert p in (2, 3, 4, 5, 8) or all(p % d for d in range(2, p)), p


@pytest.mark.parametrize("n1", [125, 1001])
def test_wide_column_passes_match_numpy_fft(n1):
    rng = np.random.default_rng(n1)
    x = (rng.standard_normal((n1, 2))
         + 1j * rng.standard_normal((n1, 2))).astype(np.complex64)
    x64 = x.astype(np.complex128)
    assert _rel(column_fft(x), np.fft.fft(x64, axis=0)) <= REL
    assert _rel(column_fft(x, True), np.fft.ifft(x64, axis=0) * n1) <= REL


def test_tables_layout():
    n1 = 77
    floats, radices = tfl._tables(n1 * 128)
    assert floats.dtype == np.float32 and radices.dtype == np.int32
    assert floats.shape == (2 * n1 + 2 * 128 + 2 * n1 * 128,)
    assert tuple(radices) == tfl.fft_radices(n1) == (7, 11)
    re, im = tfl.fft_roots(128)
    assert np.array_equal(floats[2 * n1:2 * n1 + 128], re)
    tw_im = floats[2 * n1 + 256 + n1 * 128:].reshape(n1, 128)
    assert tw_im[3, 5] == np.float32(np.sin(-2 * np.pi * 15 / (n1 * 128)))
    # A 16-point row plan: the n2 row roots after the column roots.
    floats, radices = tfl._tables(2000)
    assert floats.shape == (2 * 125 + 2 * 16 + 2 * 2000,)
    assert np.array_equal(floats[250:266], tfl.fft_roots(16)[0])
