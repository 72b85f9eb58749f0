"""The cluster route of #5 and #6 (``os_cluster`` in
``radiorust_tpu_torch/csrc/overlap_save.cu``), on the CPU.

One launch runs a stream pair's whole function on a thread block cluster
of C = min(8, n2) blocks; block r owns the strip of W = n2 / C columns
r W .. r W + W - 1 of every grid of the pair and keeps it in its shared
memory.  The numpy model below moves the data as the kernel does: each
block's strips (#6: both streams' complex grids side by side, then the
packed grid in the free buffer), the demod on load from the chunk (#5) or
from the filtered strips of the owning blocks (#6, the neighbour t - 1
across strip and row edges), the column FFTs per strip, the rows taken by
warps across the cluster (gathered from and scattered back to their
owners), the output-row map and ``flr/fli``.  It runs the passes of
``tests/test_torch_fft_plan.py`` (the kernels' own pass order and float32
tables) and is held against ``fused_demod_filter_plain`` /
``fused_filter_demod_filter_plain`` within the kernel checks' 2.4e-5.
The route-choice rule (:func:`cluster_size`) is checked on both sides of
its boundary.  Nothing here needs a GPU.
"""

import numpy as np
import pytest
import torch

from test_torch_fft_plan import _brev, _row_shape, column_fft, row_fft, \
    row_ifft

from radiorust_tpu_torch.blocks.base import StreamSig
from radiorust_tpu_torch.blocks.frontend import FilterDemodFilter, \
    FmDemodFilter
from radiorust_tpu_torch.models.wfm import _deemphasis_band, _lowpass_100k
from radiorust_tpu_torch.ops import filter as tfl

PLAIN_REL = 2.4e-5   # the kernel checks' FILTER_BOUND
THREADS, WARPS = 256, 8   # kClusterThreads: a block's threads and warps
RATE, DEVIATION = 384000.0, 150e3
# (m, n, batch): A's (N = 15360 = 120 x 128), a history not on whole rows
# (m % 128 = 64), an odd n1 (the transform of T1's time shards, 7296 = 57
# x 128: a generic pass of 19), a short row (2002 = 1001 x 2: C = 2, one
# column a block), and the largest N each kernel's cluster route takes.
A = (6144, 9216, 4)
DECOUPLED = (6080, 9280, 2)
ODD_N1 = (3648, 3648, 2)
SHORT_ROWS = (1001, 1001, 2)
LARGEST_5 = (56704, 56704, 2)    # 113408 = 443 x 256
LARGEST_6 = (28480, 28480, 2)    # 56960 = 445 x 128


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


class Cluster:
    """The blocks of one cluster: ``strips[r]`` is block r's buffer, rows
    of ``streams * W`` columns (stream s at s W), as complex64 (the
    kernel's re and im planes); C = min(``most``, n2) blocks (8 for #5's
    and #6's stream pairs, 4 for #3's single streams)."""

    def __init__(self, n1, n2, streams, most=8):
        self.n1, self.n2, self.streams = n1, n2, streams
        self.C = min(most, n2)
        self.W = n2 // self.C
        self.strips = [np.zeros((n1, streams * self.W), np.complex64)
                       for _ in range(self.C)]

    def owner(self, i2):
        """(block, column in its strip row) of grid column i2."""
        return i2 // self.W, i2 % self.W

    def load(self, value):
        """Each block fills its strip: element (i1, c) of stream s from
        ``value(s, t)`` at t = i1 n2 + c0 + c."""
        n1, n2, W = self.n1, self.n2, self.W
        for r, strip in enumerate(self.strips):
            for s in range(self.streams):
                t = (np.arange(n1)[:, None] * n2 + r * W
                     + np.arange(W)[None, :])
                strip[:, s * W:(s + 1) * W] = value(s, t)

    def columns(self, inverse=False):
        for r, strip in enumerate(self.strips):
            self.strips[r] = column_fft(strip, inverse)

    def warp_rows(self):
        """The rows (stream, k1) each warp of each block takes: warp w of
        block r starts at (r WARPS + w) (32 / LR) and strides over the
        cluster's C WARPS warps; lane l of a warp serves row first + l //
        LR."""
        _, LR = _row_shape(self.n2)
        per_warp = 32 // LR
        rows = self.streams * self.n1
        out = {}
        for r in range(self.C):
            for w in range(WARPS):
                first = (r * WARPS + w) * per_warp
                while first < rows:
                    out.setdefault((r, w), []).extend(
                        row for row in range(first, first + per_warp)
                        if row < rows)
                    first += self.C * WARPS * per_warp
        return out

    def rows(self, grid_resp, tw):
        """The row phase: each row gathered from its owners with the
        twiddle, row FFT, the response at k2 = V brev(l) + j, inverse row
        FFT, conjugate twiddle, scattered back in place (all rows at once:
        no two warps share a row)."""
        n1, n2, W = self.n1, self.n2, self.W
        V, LR = _row_shape(n2)
        bits = LR.bit_length() - 1
        k2 = (V * np.array([_brev(lane, bits) for lane in range(LR)])[None, :]
              + np.arange(V)[:, None])                         # [j, l]
        taken = [row for rows in self.warp_rows().values() for row in rows]
        assert sorted(taken) == list(range(self.streams * n1))
        s, k1 = np.divmod(np.asarray(taken), n1)
        x = np.empty((len(taken), n2), np.complex64)
        for i2 in range(n2):
            b, c = self.owner(i2)
            x[:, i2] = self.strips[b][k1, s * W + c]
        v = row_fft(x * tw[k1])
        y = row_ifft(v * grid_resp[k1][:, k2]) * np.conj(tw[k1])
        for i2 in range(n2):
            b, c = self.owner(i2)
            self.strips[b][k1, s * W + c] = y[:, i2]

    def filter(self, grid_resp, tw):
        self.columns()
        self.rows(grid_resp, tw)
        self.columns(inverse=True)

    def at(self, s, t):
        """Samples t of stream s's grid, each read from the block owning
        its column (the kernel's map_shared_rank)."""
        b, c = self.owner(t % self.n2)
        out = np.empty(t.shape, np.complex64)
        for r in range(self.C):
            mine = b == r
            out[mine] = self.strips[r][t[mine] // self.n2,
                                       s * self.W + c[mine]]
        return out

    def output(self, n):
        """Rows i1 < ho where t < n, stream 0 from the real and 1 from the
        imaginary part, block by block."""
        ho = -(-n // self.n2)
        y = np.zeros((2, n), np.float32)
        for r, strip in enumerate(self.strips):
            t = (np.arange(ho)[:, None] * self.n2 + r * self.W
                 + np.arange(self.W)[None, :])
            keep = t < n
            y[0, t[keep]] = strip[:ho].real[keep]
            y[1, t[keep]] = strip[:ho].imag[keep]
        return y


def fm_sample(x, p, i, fac, have, last):
    """The kernel's ``fm_sample`` in float32, over arrays of samples i."""
    f32 = np.float32
    re = x.real * p.real + x.imag * p.imag
    im = x.imag * p.real - x.real * p.imag
    v = (np.arctan2(im.astype(f32), re.astype(f32)) * f32(fac)).astype(f32)
    return np.where((i == 0) & (have < 0.5), f32(last), v)


def demod_grid(t, m, prevd, sample, plr, pli, fac, have, last, d):
    """The real filter's input at grid positions t of one stream: prevd
    for t < m, else the demod of sample i = t - m against sample i - 1
    (``sample``: the stream's samples at an index array), or the carried
    last sample at i = 0; each demodulated value also written to d."""
    out = np.empty(t.shape, np.float32)
    old = t < m
    out[old] = prevd[t[old]]
    i = t[~old] - m
    x = sample(i)
    p = np.where(i > 0, sample(np.maximum(i - 1, 0)),
                 np.complex64(plr + 1j * pli))
    v = fm_sample(x, p, i, fac, have, last)
    out[~old] = v
    d[i] = v
    return out


def _twiddle(n1, n2):
    floats, _ = tfl._tables(n1 * n2)
    tw = floats[2 * n1 + 2 * n2:]
    return (tw[:n1 * n2] + 1j * tw[n1 * n2:]).reshape(n1, n2).astype(
        np.complex64)


def demod_filter_model(cur, plr, pli, prevd, last_out, have, grid, fac):
    """#5 on the cluster route, pair by pair: (y [b, n], d [b, n])."""
    b, n = cur.shape
    m = prevd.shape[1]
    n1, n2 = tfl.kernel_factors(m + n)
    tw = _twiddle(n1, n2)
    y = np.zeros((b, n), np.float32)
    d = np.full((b, n), np.nan, np.float32)
    for pair in range(b // 2):
        ss = (2 * pair, 2 * pair + 1)
        cl = Cluster(n1, n2, 1)

        def value(_, t):
            re, im = (demod_grid(t, m, prevd[s], lambda i, s=s: cur[s, i],
                                 plr[s], pli[s], fac[s], have[s],
                                 last_out[s], d[s]) for s in ss)
            return re + 1j * im

        cl.load(value)
        cl.filter(grid, tw)
        y[list(ss)] = cl.output(n)
    return y, d


def filter_demod_filter_model(prev, cur, plr, pli, prevd, last_out, have,
                              grid1, grid2, fac):
    """#6 on the cluster route: (y, d, flr, fli)."""
    b, n = cur.shape
    m = prev.shape[1]
    n1, n2 = tfl.kernel_factors(m + n)
    tw = _twiddle(n1, n2)
    y = np.zeros((b, n), np.float32)
    d = np.full((b, n), np.nan, np.float32)
    flr, fli = np.zeros(b, np.float32), np.zeros(b, np.float32)
    z = np.concatenate([prev, cur], axis=1)
    for pair in range(b // 2):
        ss = (2 * pair, 2 * pair + 1)
        cl = Cluster(n1, n2, 2)
        cl.load(lambda s, t: z[ss[s]][t])
        cl.filter(grid1, tw)
        # The packed grid lands in each block's free buffer: the demod of
        # filtered sample i reads i and i - 1 from their owning blocks.
        packed = Cluster(n1, n2, 1)

        def value(_, t):
            re, im = (demod_grid(t, m, prevd[s],
                                 lambda i, k=k: cl.at(k, i), plr[s], pli[s],
                                 fac[s], have[s], last_out[s], d[s])
                      for k, s in enumerate(ss))
            return re + 1j * im

        packed.load(value)
        for k, s in enumerate(ss):
            last = cl.at(k, np.array([n - 1]))[0]
            flr[s], fli[s] = last.real, last.imag
        packed.filter(grid2, tw)
        y[list(ss)] = packed.output(n)
    return y, d, flr, fli


def _inputs(m, n, b, seed):
    rng = np.random.default_rng(seed)
    phase = np.cumsum(0.3 * rng.standard_normal((b, m + n)), axis=1)
    fm = np.exp(1j * phase).astype(np.complex64)
    have = (np.arange(b) % 3 > 0).astype(np.float32)
    last = np.exp(1j * rng.standard_normal(b)).astype(np.complex64)
    return (fm, have, last, rng.standard_normal((b, m)).astype(np.float32),
            rng.standard_normal(b).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid(response):
    g = tfl.response_grid(torch.from_numpy(response))
    return g.numpy().astype(np.complex64), g.real.contiguous(), \
        g.imag.contiguous()


@pytest.mark.parametrize("m, n, b", [A, DECOUPLED, ODD_N1, SHORT_ROWS,
                                     LARGEST_5],
                         ids=["A", "decoupled m", "odd n1", "short rows",
                              "largest N"])
def test_demod_filter_cluster_model_matches_plain(m, n, b):
    N = m + n
    n1, n2 = tfl.kernel_factors(N)
    assert tfl.cluster_size(N) == min(8, n2)
    if (m, n, b) == LARGEST_5:
        assert not tfl.cluster_size(N + 256) and (n1, n2) == (443, 256)
    blk = FmDemodFilter(DEVIATION, _deemphasis_band, ir_len=m).bind(
        StreamSig(b, n, RATE))
    fm, have, last, prevd, last_out = _inputs(m, n, b, N)
    cur = fm[:, m:]
    g, gr, gi = _grid(blk.params["response"])
    fac = np.full(b, blk.params["factor"], np.float32)
    y, d = demod_filter_model(cur, last.real, last.imag, prevd, last_out,
                              have, g, fac)
    want_y, want_d = tfl.fused_demod_filter_plain(
        _t(cur.real), _t(cur.imag), _t(last.real), _t(last.imag), _t(prevd),
        _t(last_out), _t(have), gr, gi, torch.tensor(blk.params["factor"]))
    assert _rel(d, want_d.numpy()) <= PLAIN_REL
    assert _rel(y, want_y.numpy()) <= PLAIN_REL


@pytest.mark.parametrize("m, n, b", [A, DECOUPLED, ODD_N1, SHORT_ROWS,
                                     LARGEST_6],
                         ids=["A", "decoupled m", "odd n1", "short rows",
                              "largest N"])
def test_filter_demod_filter_cluster_model_matches_plain(m, n, b):
    N = m + n
    n1, n2 = tfl.kernel_factors(N)
    assert tfl.cluster_size(N, merged=True) == min(8, n2)
    if (m, n, b) == LARGEST_6:
        assert not tfl.cluster_size(N + 128, merged=True)
    blk = FilterDemodFilter(_lowpass_100k, DEVIATION, _deemphasis_band,
                            ir_len=m).bind(StreamSig(b, n, RATE))
    fm, have, last, prevd, last_out = _inputs(m, n, b, N + 1)
    g1, g1r, g1i = _grid(blk.params["response1"])
    g2, g2r, g2i = _grid(blk.params["response2"])
    fac = np.full(b, blk.params["factor"], np.float32)
    prev, cur = fm[:, :m], fm[:, m:]
    y, d, flr, fli = filter_demod_filter_model(
        prev, cur, last.real, last.imag, prevd, last_out, have, g1, g2, fac)
    want = tfl.fused_filter_demod_filter_plain(
        _t(prev.real), _t(prev.imag), _t(cur.real), _t(cur.imag),
        _t(last.real), _t(last.imag), _t(prevd), _t(last_out), _t(have),
        g1r, g1i, g2r, g2i, torch.tensor(blk.params["factor"]))
    want_y, want_d, want_flr, want_fli = (w.numpy() for w in want)
    assert _rel(flr + 1j * fli, want_flr + 1j * want_fli) <= PLAIN_REL
    assert _rel(d, want_d) <= PLAIN_REL
    assert _rel(y, want_y) <= PLAIN_REL


@pytest.mark.parametrize("n2", [1, 2, 4, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("streams", [1, 2], ids=["#5", "#6 stage 1"])
def test_rows_are_taken_once_across_the_cluster(n2, streams):
    """Every row (stream, k1) of every plan's grid goes to exactly one
    lane group of one warp of one block, and every grid column to one
    block's strip."""
    for n1 in (1, 57, 120, 443):
        cl = Cluster(n1, n2, streams)
        taken = [r for rows in cl.warp_rows().values() for r in rows]
        assert sorted(taken) == list(range(streams * n1))
        owners = [cl.owner(i2) for i2 in range(n2)]
        assert len(set(owners)) == n2 and all(b < cl.C and c < cl.W
                                              for b, c in owners)


def test_strip_layout_fits_the_block():
    """A block's threads tile its strip's columns: the strip row (W, 2W
    for #6's first filter) divides the block, as ``Lanes`` needs."""
    for n2 in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        W = n2 // min(8, n2)
        assert THREADS % W == 0 and THREADS % (2 * W) == 0


@pytest.mark.parametrize("n1, n2, merged, fits", [
    (875, 128, False, True), (877, 128, False, False),
    (443, 256, False, True), (444, 256, False, False),
    (445, 128, True, True), (446, 128, True, False),
    (877, 64, True, True), (879, 64, True, False),
    (120, 128, True, True), (10001, 2, False, False),
    (9685, 1, False, True), (9687, 1, False, False)])
def test_route_choice_on_both_sides_of_its_boundary(n1, n2, merged, fits):
    """``cluster_size``: C = min(8, n2) where a block's share of the
    pair's grids fits the 227 KB of shared memory, 0 (the stage route)
    one row past it."""
    N = n1 * n2
    assert tfl.kernel_factors(N) == (n1, n2)
    nbytes = tfl.cluster_bytes(n1, n2, merged)
    W = n2 // min(8, n2)
    assert nbytes == 4 * ((8 if merged else 4) * n1 * W + 2 * n1 + 2 * n2)
    assert (nbytes <= tfl._SMEM) == fits
    assert tfl.cluster_size(N, merged) == (min(8, n2) if fits else 0)


@pytest.mark.parametrize("m, n", [(6144, 9216), (6144, 6144), (6144, 4608),
                                  (6144, 2304), (6144, 1152)],
                         ids=["A, B, N, P wfm_wide, Q, R, T5", "P wfm_fused",
                              "T2 (t = 2)", "Q1 (t = 4)", "T1 (t = 8)"])
def test_the_paths_geometries_take_the_cluster_route(m, n):
    """The receive chains' geometries, whole and time-sharded, run #5 and
    #6 in one cluster launch."""
    assert tfl.cluster_size(m + n) == 8
    assert tfl.cluster_size(m + n, merged=True) == 8


def test_filter_split_runs_the_plain_versions_on_the_cpu(capsys):
    """``tools/filter_split.py`` on the CPU: #3, #5 and #6 at A's geometry
    (here batch 4), #4 at C's and G's, #3 at E's, F's, J's, K's and M's,
    H's and past a one-column strip (#4 there too) through their
    wrappers, which run the plain versions: no launch counted, no route,
    no device time."""
    from radiorust_tpu_torch.tools import filter_split
    rows = filter_split.main(["--device", "cpu", "--batch", "4"])
    assert [r["kernel"].split()[0] for r in rows] == [
        "fused_overlap_save", "fused_demod_filter",
        "fused_filter_demod_filter", "fused_filter_bank",
        "fused_filter_bank"] + ["fused_overlap_save"] * 6 + [
        "fused_filter_bank"]
    for r in rows:
        assert r["rel"] == 0.0 and r["device_us"] is None
        assert set(r["counters"].values()) == {0} and r["route"] is None
    for r in rows:   # #4 has one route and no cluster counter
        assert set(r["counters"]) == (
            {"launches"} if r["kernel"].startswith("fused_filter_bank")
            else {"launches", "cluster_launches"})
    assert "(2 x 1024 + 1024)" in rows[6]["kernel"]   # F: batch / 2
    assert "(8 x 98304 + 98304)" in rows[9]["kernel"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        '{"card": "cpu"}'
