"""#2's wide form (``csrc/mix_decimate_wide.cu``, ``rr_mix_decimate_wide``)
on the CPU: its route rule, its tensor-core taps layout, its launch
shapes, the banks its shared-memory accesses fall in, the 3xTF32 split,
and its numpy model (``tests/torch_mix_wide.py``) against
``fused_mix_decimate_plain`` at cases beside ``WIDE_MIX_CASES`` of
``test_torch_decimate_plan.py``: an odd 8-byte phase on the tensor-core
route, batch 1 and odd batches, and a history the span does not cover.
Nothing here needs a GPU."""

import numpy as np
import pytest
import torch

from radiorust_tpu_torch.blocks.transform import _inner_block, _shift_tables
from radiorust_tpu_torch.ops import frontend as tfe
from radiorust_tpu_torch.ops.polyphase import plan_downsample
from torch_mix_wide import (LANES, b_from_fragments, divm, mix_wide_model,
                            rna_tf32, split_tf32)

REL = 1e-5   # model vs plain, max |diff| / max |ref| (FIR_BOUND)

# (input rate, output rate, bandwidth), chunk, route: the six geometries
# chip_smoke.py checks (U1-U3 of path U, then MIX_WIDE_CHECKS) and the
# other plans of WIDE_MIX_CASES.
GEOMETRIES = {
    "U1: 2.048M to 240k at 16384": ((2.048e6, 240e3, 200e3), 16384, "mma"),
    "U2: 2.048M to 12k at 16384": ((2.048e6, 12e3, 10e3), 16384, "mma"),
    "U3: 48k to 44.1k at 1600": ((48e3, 44100.0, 20e3), 1600, "fma"),
    "1.024M to 200k at 16384": ((1.024e6, 200e3, 150e3), 16384, "mma"),
    "short chunk: 2.048M to 12k at 1024": ((2.048e6, 12e3, 10e3), 1024,
                                           "mma"),
    "inner 110: 48k to 44.1k at 1760": ((48e3, 44100.0, 20e3), 1760, "fma"),
    "2.048M to 8k at 16384": ((2.048e6, 8e3, 6e3), 16384, "mma"),
    "96k to 44.1k at 1280": ((96e3, 44100.0, 20e3), 1280, "fma"),
    "192k to 44.1k at 1280": ((192e3, 44100.0, 20e3), 1280, "fma"),
    "1.024M to 44.1k at 20480": ((1.024e6, 44100.0, 16e3), 20480, "fma"),
}


def _geometry(name):
    rates, n, route = GEOMETRIES[name]
    return plan_downsample(*rates), n, route


def _oscillator(n, b, rng):
    ta, tb, _ = _shift_tables(n, 2048000, -300000)
    ph = rng.standard_normal(b)
    return (ta.real.copy(), ta.imag.copy(), tb.real.copy(), tb.imag.copy(),
            np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32))


def _plain(xs, hs, W, p, q, osc):
    t = torch.from_numpy
    ar, ai, br, bi, pr, pi = (t(np.ascontiguousarray(v)) for v in osc)
    yr, yi, hr, hi = tfe.fused_mix_decimate_plain(
        t(xs[:, 0]), t(xs[:, 1]), ar, ai, br, bi, pr, pi, t(hs[:, 0]),
        t(hs[:, 1]), t(W), p, q)
    return (np.stack([yr.numpy(), yi.numpy()], 1),
            np.stack([hr.numpy(), hi.numpy()], 1))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_route_rule(name):
    """The route is a rule of the plan: the tensor cores where the plan has
    one phase block, p % 8 == 0, at most 8 n-tiles of (a, r) columns and
    a quarter or more of the product's multiplies on nonzero taps (2.048
    MHz -> 240 kHz 56%, -> 12 kHz 90%, -> 8 kHz 100%, 1.024 MHz -> 200 kHz
    43%); FMA over the bands where they are sparse (48 / 96 / 192 kHz ->
    44.1 kHz: 4%; 1.024 MHz -> 44.1 kHz: 441 phases).  The chunk plays no
    part, and the plan binds either way."""
    plan, n, route = _geometry(name)
    W, p, q = plan.kernel, plan.p, plan.q
    got, periods, nt, _, dense = tfe.mix_wide_route(W, p)
    assert got == route
    assert periods == -(-tfe.wide_layout(W).wmax // p)
    assert nt == -(-periods * q // 8)
    nnz = np.count_nonzero(W)
    assert dense == pytest.approx(nnz / (p * 8 * nt))
    assert (dense >= tfe._MMA_USEFUL) == (route == "mma") or nt > 8
    assert not tfe.fits_block(p, q, W.shape[-1])
    assert tfe.decimate_supported(n, plan, mixer=True, inner=_inner_block(n))
    lay = tfe.mix_wide_layout(W, p)
    assert lay.route == route and lay.shape[:3] == (route, periods, nt)
    assert 0 < lay.useful <= 1
    assert route == "fma" or lay.useful == dense
    if route == "fma":
        assert lay.taps is lay.wide.taps
    else:
        assert lay.taps.shape == (p // 8, nt, LANES, 2)


# Plans made up to sit on either side of the route's quarter: (q, Kw, p,
# route).  Every tap nonzero, one period or two, one n-tile of columns.
THRESHOLD = {
    "q 2, one period, dense 1/4": (2, 64, 64, "mma"),
    "q 2, one period, dense under 1/4": (2, 63, 64, "fma"),
    "q 1, two periods, dense under 1/4": (1, 120, 64, "fma"),
    "q 2, two periods, dense 47%": (2, 120, 64, "mma"),
    "q 1, p 4096, dense 1/4, no tile fits": (1, 8192, 4096, "fma"),
}


@pytest.mark.parametrize("name", list(THRESHOLD))
def test_route_threshold(name):
    """The route's own limits, where they alone decide: a quarter of the
    product's multiplies on nonzero taps takes the tensor cores, less
    takes FMA; a plan whose smallest tensor-core tile (one window, a
    one-entry oscillator) does not fit shared memory takes FMA."""
    q, kw, p, route = THRESHOLD[name]
    W = np.random.default_rng(7).uniform(0.5, 1.0, (q, kw)).astype(
        np.float32)
    got, periods, nt, _, dense = tfe.mix_wide_route(W, p)
    assert got == route
    assert nt == 1 and periods == -(-kw // p)
    assert dense == pytest.approx(q * kw / (p * 8))
    fits = tfe._mma_tile(p, periods, nt, kw, 1, 1, 1, 1) is not None
    assert (dense >= tfe._MMA_USEFUL and fits) == (route == "mma")


@pytest.mark.parametrize("name", [k for k, v in GEOMETRIES.items()
                                  if v[2] == "mma"])
def test_mma_fragments_hold_each_tap_once(name):
    """The B fragments are the polyphase taps B[c, a q + r] = W[r, ulo +
    a p + c]: every nonzero tap of W once, zeros elsewhere, in the
    m16n8k8 B layout (lane l: k = l mod 4 and + 4, n = l / 4)."""
    plan, _, _ = _geometry(name)
    W, p, q = plan.kernel, plan.p, plan.q
    lay = tfe.mix_wide_layout(W, p)
    ulo = int(lay.wide.zband[0, 0])
    b = b_from_fragments(lay.taps)
    assert b.shape == (p, 8 * lay.nt)
    for a in range(lay.periods):
        for r in range(q):
            u = ulo + a * p + np.arange(p)
            want = np.where(u < W.shape[1], W[r, np.minimum(u, W.shape[1]
                                                            - 1)], 0)
            np.testing.assert_array_equal(b[:, a * q + r], want)
    assert not b[:, lay.periods * q:].any()
    assert np.count_nonzero(b) == np.count_nonzero(W)
    assert not W[:, :ulo].any()


def _all_shapes(batch):
    for name in GEOMETRIES:
        plan, n, _ = _geometry(name)
        lay = tfe.mix_wide_layout(plan.kernel, plan.p)
        inner = _inner_block(n)
        yield name, plan, n, lay, tfe.mix_wide_config(
            lay.shape, plan.p, n // plan.p, batch, inner, n // inner,
            plan.hist)


@pytest.mark.parametrize("batch", [64, 1, 3])
def test_launch_shapes_fit(batch):
    """Every geometry's launch at batch 64, 1 and 3: within 227 KB of
    shared memory, 256 threads, CUDA's grid limits and the kernel's own
    checks (rr_mix_decimate_wide): the tensor-core tile's rows within 16
    mt and its Z columns within nt n-tiles, one m-tile x k-range a warp;
    the FMA tile ws x nw windows in lane groups inside a warp; the span's
    positions within the rows, the index divisions exact."""
    for name, plan, n, lay, sh in _all_shapes(batch):
        p, q, M = plan.p, plan.q, n // plan.p
        g, ls, nr, un, wmax, zb = lay.wide.shape
        assert sh.smem <= tfe._SMEM_LIMIT == 232448, name
        assert LANES <= sh.threads <= tfe._WIDE_THREADS, name
        assert sh.threads % LANES == 0
        assert sh.tab_a >= min(-(-n // _inner_block(n)),
                               (sh.xlen - 1) // _inner_block(n) + 2)
        assert sh.tiles == -(-M // sh.tm) <= 65535 and batch <= 65535
        assert sh.xlen >= (sh.tm - 1) * p + wmax
        assert (sh.xlen + plan.hist + p) * p < 2 ** 31
        assert n * _inner_block(n) < 2 ** 31
        if sh.mma:
            assert zb == 1 and nr == q and p % 8 == 0
            assert 1 <= lay.nt <= 8 and lay.periods * q <= 8 * lay.nt
            assert sh.srows == 16 * sh.mt and 1 <= sh.mt <= tfe._MMA_MT
            assert sh.tm + lay.periods - 1 <= sh.srows
            assert sh.xlen <= sh.srows * p
            assert sh.threads == LANES * sh.mt * sh.ksplit
            assert sh.pitch >= p and sh.pitch % 16 == 4
            assert sh.zpitch >= 8 * lay.nt and sh.zpitch % 32 == 8
        else:
            assert sh.pitch == p and sh.tm == sh.ws * sh.nw
            assert g * nr * sh.ws <= sh.threads and LANES % g == 0
            assert 1 <= sh.nw <= tfe._WIDE_NW
        assert sh.smem == tfe._mix_wide_smem(
            sh.mma, p, sh.srows, sh.pitch, sh.xlen, sh.zpitch, sh.ksplit,
            lay.nt, _inner_block(n), sh.tab_a, un, ls)


def test_mma_tile_length_rule():
    """The tensor-core tile length: the mt (16 mt span rows) that
    minimises the blocks a wave of 132 SMs runs times the rows each
    stages and multiplies, its windows spread evenly over the tiles.  At
    batch 64: 2.048 MHz -> 240 kHz 43 windows a tile (3 tiles, 192
    blocks), -> 12 kHz 16 (2 tiles, 128 blocks), the short chunk its 2
    windows in one tile."""
    want = {"U1: 2.048M to 240k at 16384": (3, 43, 3),
            "U2: 2.048M to 12k at 16384": (2, 16, 2),
            "short chunk: 2.048M to 12k at 1024": (1, 2, 1)}
    for name, plan, n, lay, sh in _all_shapes(64):
        if name in want:
            assert (sh.mt, sh.tm, sh.tiles) == want[name], name


def _banks(words):
    return np.asarray(words) % 32


@pytest.mark.parametrize("name", [k for k, v in GEOMETRIES.items()
                                  if v[2] == "mma"])
def test_fragment_reads_hit_distinct_banks(name):
    """The tensor-core route's shared-memory accesses, at the launch's
    pitches and either 16-byte shift: a warp's 8-byte A-fragment loads
    (rows g and g + 8, columns t4 and t4 + 4 of its m-tile, a half warp
    at a time) and its 8-byte partial-Z stores (row g, columns 8 j + 2
    t4) each fall in 32 distinct banks; so do the mix's 8-byte loads and
    stores of 16 consecutive lanes within a row."""
    plan, n, _ = _geometry(name)
    lay = tfe.mix_wide_layout(plan.kernel, plan.p)
    inner = _inner_block(n)
    sh_ = tfe.mix_wide_config(lay.shape, plan.p, n // plan.p, 64, inner,
                              n // inner, plan.hist)
    pitch, zpitch = sh_.pitch, sh_.zpitch
    for half in (0, 1):
        lane = np.arange(16) + 16 * half
        g, t4 = lane >> 2, lane & 3
        for sh in (0, 1):
            for i in range(sh_.mt):
                for dr, dc in ((0, 0), (8, 0), (0, 4), (8, 4)):
                    for ks in (0, 1, plan.p // 8 - 1):
                        pair = sh + (16 * i + g + dr) * pitch + 8 * ks + t4 \
                            + dc
                        words = np.concatenate([2 * pair, 2 * pair + 1])
                        assert len(set(_banks(words))) == 32
        for j in range(lay.nt):
            for dr in (0, 8):
                f = (g + dr) * zpitch + 8 * j + 2 * t4
                assert len(set(_banks(np.concatenate([f, f + 1])))) == 32
    for sh in (0, 1):
        for c0 in (0, 16, plan.p - 16):
            pair = sh + 3 * pitch + c0 + np.arange(16)
            assert len(set(_banks(np.concatenate([2 * pair,
                                                  2 * pair + 1])))) == 32


def test_tf32_split():
    """``cvt.rna.tf32.f32`` as the model rounds it: 10 mantissa bits, to
    nearest, ties away from zero; hi + lo within 2^-21 of v relative,
    the dropped lo lo product below 2^-22 of |v w|."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11],
                   np.float32)
    np.testing.assert_array_equal(rna_tf32(tie), [one + ulp, -(one + ulp),
                                                  one + 2 * ulp])
    assert rna_tf32(np.float32(1 + 2.0 ** -12)) == one
    rng = np.random.default_rng(3)
    v = rng.standard_normal(10000).astype(np.float32)
    hi, lo = split_tf32(v)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    err = np.abs((hi.astype(np.float64) + lo) - v) / np.abs(v)
    assert err.max() < 2.0 ** -21
    w = rng.standard_normal(10000).astype(np.float32)
    wh, wl = split_tf32(w)
    three = (lo.astype(np.float64) * wh + hi.astype(np.float64) * wl
             + hi.astype(np.float64) * wh)
    exact = v.astype(np.float64) * w
    assert (np.abs(three - exact) / np.abs(exact)).max() < 2.0 ** -19


def _model_case(W, p, q, hist, n, b, shape_batch=None, pairs=None,
                seed=0):
    rng = np.random.default_rng(seed + n + b)
    osc = _oscillator(n, b, rng)
    xs = rng.standard_normal((b, 2, n)).astype(np.float32)
    hs = rng.standard_normal((b, 2, hist)).astype(np.float32)
    counts = {}
    got, got_h = mix_wide_model(xs, hs, W, p, q, osc,
                                shape_batch=shape_batch, pairs=pairs,
                                counts=counts)
    want, want_h = _plain(xs, hs, W, p, q, osc)
    assert got.shape == want.shape == (b, 2, n // p * q)
    assert _rel(got, want) <= REL
    np.testing.assert_array_equal(got_h, want_h)
    return counts


# (geometry, streams, the launch shape's batch, pairs): the tensor-core
# route at an odd 8-byte phase (the span shifted one pair; the history's
# 8-byte copies), batch 1 and an odd batch at their own shapes.
MODEL_CASES = {
    "U1, odd 8-byte phase": ("U1: 2.048M to 240k at 16384", 2, 64,
                             (1, 16385)),
    "U2, odd 8-byte phase": ("U2: 2.048M to 12k at 16384", 1, 64,
                             (1, 16385)),
    "short chunk, odd 8-byte phase": ("short chunk: 2.048M to 12k at 1024",
                                      3, 64, (1, 1025)),
    "U2, batch 1": ("U2: 2.048M to 12k at 16384", 1, None, None),
    "1.024M to 200k, batch 3": ("1.024M to 200k at 16384", 3, None, None),
    "U3, batch 1": ("U3: 48k to 44.1k at 1600", 1, None, None),
    "inner 110, batch 5": ("inner 110: 48k to 44.1k at 1760", 5, None,
                           (0, 1761)),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_matches_plain(case):
    """The model against ``fused_mix_decimate_plain``, the new history bit
    for bit; each block stages its span's samples once (its staged
    positions are the tile's windows' reach and no more) and mixes each
    staged chunk sample once."""
    name, b, shape_batch, pairs = MODEL_CASES[case]
    plan, n, _ = _geometry(name)
    counts = _model_case(plan.kernel, plan.p, plan.q, plan.hist, n, b,
                         shape_batch, pairs)
    lay = tfe.mix_wide_layout(plan.kernel, plan.p)
    inner = _inner_block(n)
    sh = tfe.mix_wide_config(lay.shape, plan.p, n // plan.p,
                             shape_batch or b, inner, n // inner, plan.hist)
    for (z, tile, s), (staged, mixed) in counts.items():
        mt = min(sh.tm, n // plan.p - tile * sh.tm)
        assert staged == (mt - 1) * plan.p + lay.wide.zband[z, 1]
        assert mixed <= staged


def test_history_outside_the_span():
    """A plan whose bands leave taps unused at both ends (2.048 MHz -> 12
    kHz with zeros before tap 1100 and in the last 50): the last tile's
    span then covers neither the first samples of the new history (old
    history, at a chunk of 1024) nor its last 50 (chunk samples, mixed on
    their way out): the block writes those from the sources, the rest
    from the span, bit for bit either way."""
    plan = plan_downsample(2.048e6, 12e3, 10e3)
    W = plan.kernel.copy()
    W[:, :1100] = 0.0
    W[:, -50:] = 0.0
    p, q, hist = plan.p, plan.q, plan.hist
    lay = tfe.mix_wide_layout(W, p)
    ulo, width = (int(v) for v in lay.wide.zband[0, :2])
    assert lay.route == "mma" and ulo > 1024 and ulo + width == W.shape[1] - 50
    for n in (1024, 16384):
        _model_case(W, p, q, hist, n, 2, shape_batch=64)


def test_mix_indices_are_the_multiply_shift_divisions():
    """The strided runs' oscillator and span indices: one division a
    lane for eight samples 32 apart, then steps that wrap B (inner 100,
    110, 128) and the span's rows (p 128, 160, 512), equal to plain
    division at every sample of a chunk."""
    for inner, p in ((128, 128), (100, 160), (110, 160), (128, 512)):
        jb = np.arange(0, 16384, 8 * 256)[:, None] + np.arange(256)[None, :]
        jb = jb.reshape(-1)
        a = divm(jb, inner)
        b = jb - a * inner
        k = divm(jb, p)
        c = jb - k * p
        for it in range(8):
            j = jb + 32 * it
            assert (a == j // inner).all() and (b == j % inner).all()
            assert (k == j // p).all() and (c == j % p).all()
            b = b + 32
            while (b >= inner).any():
                w = b >= inner
                a, b = a + w, b - inner * w
            c = c + 32
            while (c >= p).any():
                w = c >= p
                k, c = k + w, c - p * w


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors both of #2's wrappers run the plain version at a
    wide plan of each route (no launch)."""
    for name in ("U1: 2.048M to 240k at 16384", "U3: 48k to 44.1k at 1600"):
        plan, n, _ = _geometry(name)
        rng = np.random.default_rng(5)
        osc = _oscillator(n, 2, rng)
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
        xs = rng.standard_normal((2, 2, n)).astype(np.float32)
        hs = rng.standard_normal((2, 2, plan.hist)).astype(np.float32)
        before = tfe.fused_mix_decimate.launches
        got = tfe.fused_mix_decimate(
            t(xs[:, 0]), t(xs[:, 1]), *(t(v) for v in osc), t(hs[:, 0]),
            t(hs[:, 1]), t(plan.kernel), plan.p, plan.q)
        want = tfe.fused_mix_decimate_plain(
            t(xs[:, 0]), t(xs[:, 1]), *(t(v) for v in osc), t(hs[:, 0]),
            t(hs[:, 1]), t(plan.kernel), plan.p, plan.q)
        assert tfe.fused_mix_decimate.launches == before
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
