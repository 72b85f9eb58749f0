"""The FFT plan of the overlap-save kernels, on the CPU.

``radiorust_tpu_torch/ops/filter.py`` factors the column length n1 into
the kernels' passes (:func:`fft_radices`) and designs their float32 root
tables (:func:`fft_roots`).  The numpy models below follow the pass order
and index arithmetic of ``csrc/overlap_save.cu`` (``column_fft``,
``row_fft``, ``row_ifft`` and the three launches), in complex64, fed the
same float32 tables, and are held against ``np.fft`` and against the
wrappers' plain ``torch.fft`` versions.  Nothing here needs a GPU.
"""

import numpy as np
import pytest
import torch

from radiorust_tpu_torch.ops import filter as tfl

REL = 1e-5        # model vs np.fft, max |diff| / max |ref|
PLAIN_REL = 2.4e-5   # four-step model vs the plain version (FILTER_BOUND)
GEOMETRIES = (16, 64, 120, 77, 761, 768)   # F/G, E, A/C, 7*11, prime, max


def _roots(n, inverse=False):
    re, im = tfl.fft_roots(n)
    w = (re + 1j * im).astype(np.complex64)
    return np.conj(w) if inverse else w


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _brev5(lane):
    return int(f"{lane:05b}"[::-1], 2)


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
    """``row_fft`` on rows x [..., 128]: lane l holds x[l + 32 j] in slot
    j; a radix-4 pass across the slots with twiddle w^(l j), then five
    radix-2 decimation-in-frequency passes across the lanes (partner
    l ^ h).  Returns v[..., j, l] = X[4 brev5(l) + j]."""
    w = _roots(128)
    lane = np.arange(32)
    v = x.astype(np.complex64).reshape(*x.shape[:-1], 4, 32)
    j = np.arange(4)
    v = np.tensordot(v, w[(np.outer(j, j) % 4) * 32], axes=(-2, 1))
    v = np.moveaxis(v, -1, -2) * w[np.outer(j, lane)]
    for h in (16, 8, 4, 2, 1):
        part = v[..., lane ^ h]
        tw = w[(lane & (h - 1)) * (64 // h)]
        v = np.where(lane & h, (part - v) * tw, v + part)
    return v


def row_ifft(v):
    """``row_ifft``: the inverse of :func:`row_fft` (unnormalised), from
    v[..., j, l] = X[4 brev5(l) + j] back to x[..., l + 32 j] as [..., 128]:
    five radix-2 decimation-in-time passes across the lanes, the conjugate
    twiddle, and an inverse radix-4 pass across the slots."""
    w = _roots(128, inverse=True)
    lane = np.arange(32)
    for h in (1, 2, 4, 8, 16):
        v = np.where(lane & h, v * w[(lane & (h - 1)) * (64 // h)], v)
        part = v[..., lane ^ h]
        v = np.where(lane & h, part - v, v + part)
    j = np.arange(4)
    v = v * w[np.outer(j, lane)]
    v = np.tensordot(w[(np.outer(j, j) % 4) * 32], v, axes=(1, -2))
    return np.moveaxis(v, 0, -2).reshape(*v.shape[1:-1], 128)


def four_step(prev, cur, responses):
    """The three launches of ``run_stages`` on complex streams prev [X, m],
    cur [X, n] against grid responses [K, n1, 128]: output [X, K, n]."""
    X, n = cur.shape
    K, n1, _ = responses.shape
    N = n1 * 128
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(128)) / N)
    tw = tw.astype(np.complex64)
    z = np.concatenate([prev, cur], axis=1).reshape(X, n1, 128)
    # Launch 1: column FFT down i1 of each stream, then the twiddle.
    u = np.stack([column_fft(zs) for zs in z]) * tw              # [X, k1, i2]
    # Launch 2: row FFT, each band's response at k2 = 4 brev5(l) + j,
    # inverse row FFT, conjugate twiddle.
    v = row_fft(u)                                               # [X, k1, j, l]
    k2 = 4 * np.array([_brev5(lane) for lane in range(32)])[None, :] \
        + np.arange(4)[:, None]                                  # [j, l]
    out = np.empty((X, K, n), np.complex64)
    for band in range(K):
        g = responses[band][:, k2].astype(np.complex64)          # [k1, j, l]
        s = row_ifft(v * g) * np.conj(tw)                        # [X, k1, i2]
        # Launch 3: inverse column FFT, rows i1 < ho, t < n.
        ho = -(-n // 128)
        y = np.stack([column_fft(ss, inverse=True) for ss in s])
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
