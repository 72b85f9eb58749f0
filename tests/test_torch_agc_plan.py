"""The AGC kernel's segments, fold, combine, entry gains and walk, on the
CPU.

``csrc/scan.cu`` (``agc_segments``) runs one block of ``lanes`` threads
per stream.  The block stages a tile of ``lanes * L`` samples into two
shared planes, sample t at slot ``(t // L) * (L | 1) + t % L``, with
16-byte copies where the tile's rows are 16-byte aligned and one sample a
thread for the rest.  Lane k folds the clamped-affine maps
``g -> clip(a g + b, 0, max_gain)`` of its L samples into one (the JAX
package's ``_agc_compose``); five shuffle rounds give each lane the
composition of its warp's maps up to it, and the warp totals, applied in
turn to the gain entering the tile, give each warp's entering gain.  A
lane applies the map before its own to that gain and walks its samples
with the loop's own step, writing y; the lane owning the tile's last
sample hands its gain to the next tile.  Clamps keep NaN.

The model below follows that order step for step in numpy float32 (each
operation rounded as the kernel's ``__fmul_rn`` / ``__fadd_rn``), at
every geometry ``agc_geometry`` picks and at those of the sweep in
``chip_smoke.py``, and is held against ``oracles.oracle_agc``,
``agc_scan_plain``, ``agc_step_plain``, the JAX package's Pallas
``agc_scan`` (interpret mode) and its ``AgcControl`` (``highest``): atol
2e-4 on outputs and 2e-3 on the gain in the contracting regime, 3e-4
where the gain clamps (the JAX package's AGC bounds); finite and clamped
under sustained overdrive; NaN from a NaN sample on, where the JAX
package puts it.  Nothing here needs a GPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import oracles
from radiorust_tpu import config
from radiorust_tpu.blocks import base as jbase
from radiorust_tpu.blocks import transform as jtr
from radiorust_tpu.ops import pallas_scan
from radiorust_tpu_torch.ops import scan as tscan

F32 = np.float32
CAP = F32(1e18)                     # kAgcCap
WARP = 32
MAX_LANES = 256                     # kAgcMaxThreads
PLANE = tscan._AGC_TILE + MAX_LANES   # floats of a shared plane
SWEEP = ((32, 32), (64, 16), (128, 8), (256, 4))   # (lanes, L) at T = 1024
AGC_ATOL, GAIN_ATOL, CLAMP_ATOL = 2e-4, 2e-3, 3e-4
CONTRACTING = (5e-3, 1.0, 100.0)    # rate, reference, max_gain
CLAMPING = (0.3, 1.0, 2.5)
F_KNOBS = (1e-2, 1.0, 65536.0)      # path F's AgcControl(rate=1e-2)


@pytest.fixture(autouse=True)
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


# -- the model ---------------------------------------------------------------

def nan_min(p, q):
    return np.where((p < q) | np.isnan(p), p, q)


def nan_max(p, q):
    return np.where((p > q) | np.isnan(p), p, q)


def nan_clip(v, lo, hi):
    return nan_min(nan_max(v, lo), hi)


def compose(f1, f2):
    """``compose``: (f2 . f1), f1 the earlier map."""
    a1, b1, l1, h1 = f1
    a2, b2, l2, h2 = f2
    p, q = a2 * l1, a2 * h1
    return (nan_clip(a1 * a2, -CAP, CAP), nan_clip(a2 * b1 + b2, -CAP, CAP),
            nan_clip(nan_min(p, q) + b2, l2, h2),
            nan_clip(nan_max(p, q) + b2, l2, h2))


def apply(f, g):
    a, b, lo, hi = f
    return nan_clip(a * g + b, lo, hi)


def sample_map(xr, xi, rate, rb, max_gain):
    absx = np.sqrt(xr * xr + xi * xi)
    a = nan_clip(F32(1) - rate * absx, -CAP, CAP)
    return (a, np.full_like(a, rb), np.zeros_like(a),
            np.full_like(a, max_gain))


def walk_step(g, xr, xi, rate, ref, max_gain, complex_out):
    """``agc_walk_step``: (new g, y re, y im)."""
    yr, yi = xr * g, xi * g
    env = np.sqrt(yr * yr + yi * yi)
    ng = g + rate * (ref - env)
    ng = np.where(ng < 0, F32(0), ng)
    ng = np.where(ng > max_gain, max_gain, ng)
    if complex_out:
        return ng, yr - xi * F32(0), xr * F32(0) + yi
    return ng, yr, yi


def slot(t, seg):
    """``agc_slot``: tile sample t's float in a shared plane."""
    return (t // seg) * (seg | 1) + t % seg


def pack(re, im):
    """complex64 from two planes, each kept as it is (``re + 1j * im``
    would spread a NaN of ``im`` into the real part)."""
    z = np.empty(np.shape(re), np.complex64)
    z.real, z.imag = re, im
    return z


def copy_order(n, per, aligned):
    """The samples ``agc_copy`` moves: 16-byte accesses of ``per``
    samples (where aligned), then one sample a thread."""
    nv = n // per * per if aligned else 0
    vec = [per * v + e for v in range(nv // per) for e in range(per)]
    return vec + list(range(nv, n))


def kernel(x, gain, rate, ref, max_gain, lanes, seg, complex_out):
    """``agc_segments`` on [B, T] complex64 rows (``complex_out``: y as
    ``rr_agc_step`` writes it, else per plane as ``rr_agc_scan``).
    Returns (y complex64, new gain)."""
    rate, ref, max_gain = F32(rate), F32(ref), F32(max_gain)
    rb = rate * ref
    xr = np.ascontiguousarray(x.real, F32)
    xi = np.ascontiguousarray(x.imag, F32)
    B, T = xr.shape
    tile = lanes * seg
    k = np.arange(lanes)
    lane, warp = k % WARP, k // WARP
    yr, yi = np.empty((B, T), F32), np.empty((B, T), F32)
    g = np.asarray(gain, F32).copy()
    with np.errstate(all="ignore"):
        for t0 in range(0, T, tile):
            n = min(tile, T - t0)
            # Staging: unwritten floats are NaN, so a read of one shows.
            sr = np.full((B, PLANE), np.nan, F32)
            si = np.full((B, PLANE), np.nan, F32)
            slots = slot(np.arange(n), seg)
            sr[:, slots] = xr[:, t0:t0 + n]
            si[:, slots] = xi[:, t0:t0 + n]
            length = np.clip(n - k * seg, 0, seg)
            # Fold; lanes without samples hold the identity.
            f = (np.ones((B, lanes), F32), np.zeros((B, lanes), F32),
                 np.full((B, lanes), -np.inf, F32),
                 np.full((B, lanes), np.inf, F32))
            for i in range(seg):
                s = k * (seg | 1) + i
                e = sample_map(sr[:, s], si[:, s], rate, rb, max_gain)
                new = e if i == 0 else compose(f, e)
                f = tuple(np.where(i < length, nv, fv)
                          for nv, fv in zip(new, f))
            # Combine: shuffle rounds, the map before each lane, totals.
            for d in (1, 2, 4, 8, 16):
                o = tuple(c[:, np.maximum(k - d, 0)] for c in f)
                new = compose(o, f)
                f = tuple(np.where(lane >= d, nv, fv)
                          for nv, fv in zip(new, f))
            before = tuple(c[:, np.maximum(k - 1, 0)] for c in f)
            entering = [g]
            for w in range(1, lanes // WARP):
                total = tuple(c[:, w * WARP - 1] for c in f)
                entering.append(apply(total, entering[-1]))
            gl = np.stack(entering, axis=1)[:, warp]
            gl = np.where(lane > 0, apply(before, gl), gl)
            # Walk, y over x in the shared planes.
            for i in range(seg):
                live = i < length
                s = (k * (seg | 1) + i)[live]
                ng, orr, oi = walk_step(gl[:, live], sr[:, s], si[:, s],
                                        rate, ref, max_gain, complex_out)
                sr[:, s], si[:, s] = orr, oi
                gl[:, live] = ng
            g = gl[:, (n - 1) // seg]
            yr[:, t0:t0 + n] = sr[:, slots]
            yi[:, t0:t0 + n] = si[:, slots]
    return pack(yr, yi), g


# -- references --------------------------------------------------------------

def cplx(rng, shape, scale):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def references(x, gain, knobs):
    """y and the new gain from the per-sample oracle, ``agc_scan_plain``,
    ``agc_step_plain``, the JAX Pallas ``agc_scan`` and the JAX
    ``AgcControl``."""
    rate, ref, max_gain = knobs
    B, T = x.shape
    out = {}
    ys, gs = zip(*(oracles.oracle_agc(x[b], ref, rate, max_gain,
                                      gain0=gain[b]) for b in range(B)))
    out["oracle"] = np.stack(ys), np.asarray(gs, F32)
    tr, ti = (torch.from_numpy(np.ascontiguousarray(p, F32))
              for p in (x.real, x.imag))
    yr, yi, g = tscan.agc_scan_plain(tr, ti, torch.from_numpy(gain), *knobs)
    out["agc_scan_plain"] = pack(yr.numpy(), yi.numpy()), g.numpy()
    y, g = tscan.agc_step_plain(torch.from_numpy(x), torch.from_numpy(gain),
                                *knobs)
    out["agc_step_plain"] = y.numpy(), g.numpy()
    jr, ji, jg = pallas_scan.agc_scan(
        jnp.asarray(x.real, jnp.float32), jnp.asarray(x.imag, jnp.float32),
        jnp.asarray(gain), *(F32(v) for v in knobs))
    out["jax agc_scan"] = pack(np.asarray(jr), np.asarray(ji)), np.asarray(jg)
    blk = jtr.AgcControl(reference=ref, rate=rate, max_gain=max_gain).bind(
        jbase.StreamSig(B, T, 1000.0))
    st, y = jax.jit(blk.process)(
        {k: jnp.asarray(v) for k, v in blk.params.items()},
        {"gain": jnp.asarray(gain)}, jnp.asarray(x), jnp.zeros((B,), bool))
    out["jax AgcControl"] = np.asarray(y), np.asarray(st["gain"])
    return out


def assert_close(got, refs, atol, gain_atol=GAIN_ATOL):
    y, g = got
    for name, (wy, wg) in refs.items():
        np.testing.assert_allclose(y, wy, atol=atol, err_msg=name)
        np.testing.assert_allclose(g, wg, atol=gain_atol, err_msg=name)


def gains(rng, b):
    return rng.uniform(0.5, 2.0, b).astype(F32)


# Each case's references are computed once per process (the JAX ones
# compile for each shape); streams are independent in every reference,
# so a case of fewer rows takes the first rows of one.

@functools.lru_cache(maxsize=None)
def case_f():
    """Path F's AGC shape and knobs: 64 x 1024 audio-level rows."""
    rng = np.random.default_rng(64)
    x = cplx(rng, (64, 1024), 0.2)
    gain = gains(rng, 64)
    return x, gain, references(x, gain, F_KNOBS)


@functools.lru_cache(maxsize=None)
def case_contracting(T):
    rng = np.random.default_rng(T)
    x = cplx(rng, (3, T), 0.2)
    gain = gains(rng, 3)
    return x, gain, references(x, gain, CONTRACTING)


@functools.lru_cache(maxsize=None)
def case_clamping():
    """Bursts at rate * |x| ~ 1 between quiet stretches."""
    rng = np.random.default_rng(8)
    B, T = 2, 256
    amp = np.where((np.arange(T) // 40) % 2 == 0, 0.02, 3.0)
    x = (amp * (rng.standard_normal((B, T))
                + 1j * rng.standard_normal((B, T)))).astype(np.complex64)
    gain = np.ones(B, F32)
    return x, gain, references(x, gain, CLAMPING)


@functools.lru_cache(maxsize=None)
def case_nan():
    """NaN in the real plane of row 0 at 250, the imaginary of row 2 at
    37."""
    rng = np.random.default_rng(5)
    x = cplx(rng, (3, 600), 0.2)
    x.real[0, 250] = np.nan
    x.imag[2, 37] = np.nan
    gain = np.ones(3, F32)
    return x, gain, references(x, gain, CONTRACTING)


# -- tests -------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, 7, 1000, 1024, 4097])
def test_contracting_matches_every_reference(T, B):
    """At the geometry the wrapper picks (one lane, a ragged last segment,
    a whole tile, two tiles), through both signatures."""
    x, gain, refs = case_contracting(T)
    x, gain = x[:B], gain[:B]
    refs = {k: (y[:B], g[:B]) for k, (y, g) in refs.items()}
    lanes, seg = tscan.agc_geometry(T)
    for complex_out in (True, False):
        assert_close(kernel(x, gain, *CONTRACTING, lanes, seg, complex_out),
                     refs, AGC_ATOL)


@pytest.mark.parametrize("lanes, seg", SWEEP)
def test_path_f_shape_at_every_swept_geometry(lanes, seg):
    x, gain, refs = case_f()
    assert tscan.agc_geometry(1024, lanes) == (lanes, seg)
    for complex_out in (True, False):
        assert_close(kernel(x, gain, *F_KNOBS, lanes, seg, complex_out),
                     refs, AGC_ATOL)


@pytest.mark.parametrize("lanes, seg", [(128, 2), (32, 4), (32, 1)])
def test_clamping_at_both_bounds(lanes, seg):
    """The gain clamps at 0 and at max_gain; (32, 4) and (32, 1) go
    through 2 and 8 tiles."""
    x, gain, refs = case_clamping()
    for complex_out in (True, False):
        assert_close(kernel(x, gain, *CLAMPING, lanes, seg, complex_out),
                     refs, CLAMP_ATOL)
    oy, _ = refs["oracle"]
    g_exc = np.abs(oy) / np.abs(x)      # the gain each sample met
    assert abs(g_exc.max() - 2.5) < 1e-5 and g_exc.min() == 0.0


@pytest.mark.parametrize("lanes, seg", [(128, 16), (32, 4)])
def test_sustained_overdrive_finite_and_clamped(lanes, seg):
    """rate * |x| = 5 at every sample: the loop is chaotic and composed
    slopes grow as 4^n; the capped maps keep every number finite, the gain
    in [0, max_gain] and |y| <= max_gain |x|."""
    B, T = 2, 2048
    x = (10.0 * np.exp(1j * 0.3 * np.arange(B * T)).reshape(B, T)
         ).astype(np.complex64)
    for complex_out in (True, False):
        y, g = kernel(x, np.ones(B, F32), 0.5, 1.0, 4.0, lanes, seg,
                      complex_out)
        assert np.isfinite(y).all() and np.isfinite(g).all()
        assert (g >= 0.0).all() and (g <= 4.0).all()
        assert (np.abs(y) <= 4.0 * np.abs(x) * (1 + 1e-6)).all()


@pytest.mark.parametrize("lanes, seg", [(128, 5), (32, 2)])
def test_nan_from_the_nan_sample_on(lanes, seg):
    """A NaN in one plane makes y and the gain NaN from that sample on, in
    the JAX package's positions: both planes in the complex signature
    (AgcControl's x * g), that plane at the sample and both after it in
    the plane signature (the Pallas kernel's g x per plane)."""
    x, gain, refs = case_nan()
    for complex_out, names in (
            (True, ("agc_step_plain", "jax AgcControl")),
            (False, ("agc_scan_plain", "jax agc_scan"))):
        y, g = kernel(x, gain, *CONTRACTING, lanes, seg, complex_out)
        for name in names:
            wy, wg = refs[name]
            for part in (np.real, np.imag):
                assert np.array_equal(np.isnan(part(y)), np.isnan(part(wy))), \
                    name
            assert np.array_equal(np.isnan(g), np.isnan(wg)), name
            ok = ~np.isnan(y)
            np.testing.assert_allclose(y[ok], wy[ok], atol=AGC_ATOL)
        assert np.isnan(y[0, 250:]).all() and not np.isnan(y[0, :250]).any()
        assert np.isnan(g[[0, 2]]).all() and not np.isnan(g[1])
        assert np.isnan(y.imag[2, 37:]).all()
        assert np.isnan(y.real[2, 37]) == complex_out


def test_geometry():
    """Whole warps, at most 256 lanes, tiles of at most 4096 samples; F's
    64 x 1024 takes 256 lanes of 4 samples in one tile."""
    assert tscan.agc_geometry(1024) == (256, 4)
    assert tscan.agc_geometry(1) == (32, 1)
    assert tscan.agc_geometry(7) == (32, 1)
    assert tscan.agc_geometry(33) == (64, 1)
    assert tscan.agc_geometry(4097) == (256, 16)
    for t in (1, 7, 31, 32, 33, 100, 1000, 1024, 4096, 4097, 10 ** 6):
        for threads in (32, 64, 128, 256):
            lanes, seg = tscan.agc_geometry(t, threads)
            assert lanes % WARP == 0 and WARP <= lanes <= threads
            assert lanes <= MAX_LANES
            assert 1 <= seg and lanes * seg <= tscan._AGC_TILE
            assert lanes * seg >= min(t, tscan._AGC_TILE - lanes + 1)


@pytest.mark.parametrize("lanes, seg", SWEEP + ((32, 1), (128, 32),
                                                (256, 16), (64, 5)))
def test_shared_slots_distinct_and_conflict_free(lanes, seg):
    """Every tile sample has its own float of a plane, inside the plane;
    at each walk step a warp's 32 lanes read 32 distinct banks."""
    s = slot(np.arange(lanes * seg), seg)
    assert len(set(s.tolist())) == lanes * seg and s.max() < PLANE
    k = np.arange(WARP)
    for i in range(seg):
        assert len(set(((k * (seg | 1) + i) % 32).tolist())) == WARP


@pytest.mark.parametrize("per", [2, 4], ids=["complex", "planes"])
@pytest.mark.parametrize("n", [1, 3, 7, 1000, 1025, 4096])
def test_copy_moves_every_sample_once(n, per):
    for aligned in (True, False):
        order = copy_order(n, per, aligned)
        assert sorted(order) == list(range(n))
