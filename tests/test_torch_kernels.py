"""The port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode, on
the same numpy inputs.

Tolerances: FIR outputs atol 5e-5 and histories atol 1e-6 (as the JAX
package's own decimator tests); filters max |diff| / max |ref| <= 2.4e-5,
the transform budget of the JAX package's precision study; the
channelizer's demod atol 2e-5 on channels carrying a tone (the JAX
package's fused-vs-unfused channelizer bound), finiteness elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_channelizer as pch
import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu.ops.channelizer import design_prototype
from radiorust_tpu.blocks.filters import design_impulse_response, extend_response
from radiorust_tpu.blocks.transform import _shift_tables
from radiorust_tpu.models.wfm import _deemphasis_band
from radiorust_tpu.ops.polyphase import plan_downsample
from radiorust_tpu.windowing import Kaiser, Rectangular
from radiorust_tpu_torch.ops import channelizer as tch
from radiorust_tpu_torch.ops import filter as tfl
from radiorust_tpu_torch.ops import frontend as tfe

FIR_ATOL = 5e-5
HIST_ATOL = 1e-6
FILTER_MAX_REL = 2.4e-5


@pytest.fixture(autouse=True)
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pfe.pl, "pallas_call", interp)
    monkeypatch.setattr(pfl.pl, "pallas_call", interp)
    monkeypatch.setattr(pch.pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


def t(a):
    return torch.from_numpy(np.array(a))


def max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("rates,n,nplanes", [
    ((384000.0, 48000.0, 40000.0), 6144, 1),     # WFM tail: p=8, q=1
    ((1024000.0, 384000.0, 200000.0), 2048, 2),  # WFM head: p=8, q=3
])
def test_decimate_plain_matches_pallas(rates, n, nplanes):
    plan = plan_downsample(*rates)
    rng = np.random.default_rng(10 + nplanes)
    batch = 3
    x = rng.standard_normal((nplanes, batch, n)).astype(np.float32)
    h = rng.standard_normal((nplanes, batch, plan.hist)).astype(np.float32)
    want, want_h = pfe.pallas_decimate(
        tuple(jnp.asarray(v) for v in x), tuple(jnp.asarray(v) for v in h),
        jnp.asarray(plan.kernel), plan.p, plan.q)
    got, got_h = tfe.decimate(tuple(t(v) for v in x), tuple(t(v) for v in h),
                              t(plan.kernel), plan.p, plan.q)
    assert len(got) == nplanes
    for g, w in zip(got, want):
        assert g.shape == (batch, (n // plan.p) * plan.q)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FIR_ATOL)
    for g, w in zip(got_h, want_h):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=HIST_ATOL)
    assert tfe.decimate.launches == 0


def test_fused_mix_decimate_plain_matches_pallas():
    n, batch = 2048, 4
    plan = plan_downsample(1024000.0, 384000.0, 200000.0)
    ta, tb, _ = _shift_tables(n, 1024000, 100000)
    rng = np.random.default_rng(20)
    x = cplx(rng, batch, n)
    h = cplx(rng, batch, plan.hist)
    p0 = np.exp(1j * rng.standard_normal(batch)).astype(np.complex64)
    planes = [v for z in (x, ta, tb, p0, h) for v in (z.real, z.imag)]
    want = pfe.fused_mix_decimate(*(jnp.asarray(v) for v in planes),
                                  jnp.asarray(plan.kernel), plan.p, plan.q)
    got = tfe.fused_mix_decimate(*(t(v) for v in planes), t(plan.kernel),
                                 plan.p, plan.q)
    for g, w, tol in zip(got, want, (FIR_ATOL,) * 2 + (HIST_ATOL,) * 2):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    assert tfe.fused_mix_decimate.launches == 0


@pytest.mark.parametrize("m,n,batch", [(1536, 1536, 4), (6144, 9216, 2)])
def test_fused_overlap_save_plain_matches_pallas(m, n, batch):
    rng = np.random.default_rng(m + n)
    prev = cplx(rng, batch, m)
    cur = cplx(rng, batch, n)
    resp = cplx(rng, m + n)
    grid = np.asarray(pfl.response_grid(jnp.asarray(resp)))
    want = pfl.fused_overlap_save(
        *(jnp.asarray(v) for v in (prev.real, prev.imag, cur.real, cur.imag,
                                   grid.real, grid.imag)))
    tgrid = tfl.response_grid(t(resp))
    np.testing.assert_array_equal(tgrid.numpy(), grid)
    got = tfl.fused_overlap_save(
        t(prev.real), t(prev.imag), t(cur.real), t(cur.imag),
        tgrid.real.contiguous(), tgrid.imag.contiguous())
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    g = got[0].numpy() + 1j * got[1].numpy()
    assert max_rel(g, w) <= FILTER_MAX_REL
    assert tfl.fused_overlap_save.launches == 0


def test_fused_demod_filter_plain_matches_pallas():
    m = n = 1536
    batch, rate, dev = 4, 384000.0, 150000.0
    factor = np.float32(rate / dev / (2 * np.pi))
    ir = design_impulse_response(_deemphasis_band, Rectangular(), m, rate)
    resp = extend_response(ir, pad=n).astype(np.complex64)
    grid = np.asarray(pfl.response_grid(jnp.asarray(resp)))
    gr, gi = grid.real.copy(), grid.imag.copy()
    rng = np.random.default_rng(30)
    ph = np.cumsum(rng.standard_normal((batch, 4 * n)) * 0.3, axis=-1)
    chunks = np.exp(1j * ph).astype(np.complex64).reshape(batch, 4, n)
    state = dict(plr=np.zeros(batch, np.float32),
                 pli=np.zeros(batch, np.float32),
                 prevd=np.zeros((batch, m), np.float32),
                 last=np.zeros(batch, np.float32),
                 have=np.zeros(batch, np.float32))
    for step in range(4):
        cur = chunks[:, step]
        if step == 3:
            state["have"] = np.zeros(batch, np.float32)  # continuity break
        args = (cur.real, cur.imag, state["plr"], state["pli"],
                state["prevd"], state["last"], state["have"], gr, gi)
        wy, wd = pfl.fused_demod_filter(*(jnp.asarray(a) for a in args),
                                        factor)
        gy, gd = tfl.fused_demod_filter(*(t(a) for a in args),
                                        torch.tensor(factor))
        wy, wd = np.asarray(wy), np.asarray(wd)
        assert max_rel(gy.numpy(), wy) <= FILTER_MAX_REL, step
        np.testing.assert_allclose(gd.numpy(), wd, atol=HIST_ATOL)
        state.update(plr=cur.real[:, -1].copy(), pli=cur.imag[:, -1].copy(),
                     prevd=wd[:, n - m:], last=wd[:, -1].copy(),
                     have=np.ones(batch, np.float32))
    assert tfl.fused_demod_filter.launches == 0


@pytest.mark.parametrize("m,n", [(256, 768), (512, 512)])
def test_fused_filter_bank_plain_matches_pallas(m, n):
    K, batch = 3, 2
    rng = np.random.default_rng(40 + m)
    prev = cplx(rng, batch, m)
    cur = cplx(rng, batch, n)
    resps = cplx(rng, K, m + n)
    grids = np.stack([np.asarray(pfl.response_grid(jnp.asarray(r)))
                      for r in resps])
    want = pfl.fused_filter_bank(
        *(jnp.asarray(v) for v in (prev.real, prev.imag, cur.real, cur.imag,
                                   grids.real, grids.imag)))
    tgrid = tfl.response_grid(t(resps))
    np.testing.assert_array_equal(tgrid.numpy(), grids)
    got = tfl.fused_filter_bank(
        t(prev.real), t(prev.imag), t(cur.real), t(cur.imag),
        tgrid.real.contiguous(), tgrid.imag.contiguous())
    assert got[0].shape == (batch, K, n)
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    g = got[0].numpy() + 1j * got[1].numpy()
    for k in range(K):
        assert max_rel(g[:, k], w[:, k]) <= FILTER_MAX_REL, k
    assert tfl.fused_filter_bank.launches == 0


def test_fused_filter_demod_filter_plain_matches_pallas():
    m = n = 1024
    batch, rate, dev = 4, 384000.0, 150000.0
    factor = np.float32(rate / dev / (2 * np.pi))
    lp = lambda bins, freqs: np.where(np.abs(freqs) <= 100000.0, 1.0 + 0j,
                                      0j)
    grids = []
    for resp, win in ((lp, Kaiser.with_null_at_bin(2.0)),
                      (_deemphasis_band, Rectangular())):
        ir = design_impulse_response(resp, win, m, rate)
        g = np.asarray(pfl.response_grid(jnp.asarray(
            extend_response(ir, pad=n).astype(np.complex64))))
        grids += [g.real.copy(), g.imag.copy()]
    rng = np.random.default_rng(50)
    ph = np.cumsum(rng.standard_normal((batch, 5 * n)) * 0.3, axis=-1)
    chunks = np.exp(1j * ph).astype(np.complex64).reshape(batch, 5, n)
    # The channel filter's history starts as the signal's own past: from a
    # zero history the filtered samples ramp up from near zero, where the
    # FM phase is chaotic in the last bits.
    state = dict(prevr=chunks[:, 0, n - m:].real.copy(),
                 previ=chunks[:, 0, n - m:].imag.copy(),
                 plr=np.zeros(batch, np.float32),
                 pli=np.zeros(batch, np.float32),
                 prevd=np.zeros((batch, m), np.float32),
                 last=np.zeros(batch, np.float32),
                 have=np.zeros(batch, np.float32))
    for step in range(4):
        cur = chunks[:, step + 1]
        if step == 3:
            state["have"] = np.zeros(batch, np.float32)  # continuity break
        args = (state["prevr"], state["previ"], cur.real, cur.imag,
                state["plr"], state["pli"], state["prevd"], state["last"],
                state["have"], *grids)
        want = pfl.fused_filter_demod_filter(
            *(jnp.asarray(a) for a in args), factor)
        wy, wd, wfr, wfi = (np.asarray(v) for v in want)
        gy, gd, gfr, gfi = tfl.fused_filter_demod_filter(
            *(t(a) for a in args), torch.tensor(factor))
        assert max_rel(gy.numpy(), wy) <= FILTER_MAX_REL, step
        assert max_rel(gd.numpy(), wd) <= FILTER_MAX_REL, step
        np.testing.assert_allclose(gfr.numpy(), wfr, atol=HIST_ATOL)
        np.testing.assert_allclose(gfi.numpy(), wfi, atol=HIST_ATOL)
        state.update(prevr=cur.real[:, n - m:].copy(),
                     previ=cur.imag[:, n - m:].copy(), plr=wfr, pli=wfi,
                     prevd=wd[:, n - m:], last=wd[:, -1].copy(),
                     have=np.ones(batch, np.float32))
    assert tfl.fused_filter_demod_filter.launches == 0


def test_fused_pfb_demod_plain_matches_pallas():
    batch, k, n, m = 2, 8, 1024, 64
    taps = design_prototype(m, k).reshape(k, m).astype(np.float32)
    total = (k + 1) * m + n
    tt = np.arange(total)
    occupied = (3, 10, 50)
    x = np.zeros((batch, total), np.complex128)
    for c in occupied:   # an FM tone near each occupied channel's centre
        x += np.exp(1j * (2 * np.pi * c * tt / m
                          + 0.8 * np.sin(2 * np.pi * tt / 97.0 + c)))
    x = x.astype(np.complex64)
    factor = np.float32(0.7)
    want = np.asarray(pch.fused_pfb_demod(jnp.asarray(x.real),
                                          jnp.asarray(x.imag), factor,
                                          jnp.asarray(taps)))
    got = tch.fused_pfb_demod(t(x.real), t(x.imag), torch.tensor(factor),
                              t(taps)).numpy()
    assert got.shape == want.shape == (batch, n + 2 * m)
    h = tch.HIST_FRAMES * m
    g = got[:, h:].reshape(batch, -1, m)
    w = want[:, h:].reshape(batch, -1, m)
    np.testing.assert_allclose(g[..., occupied], w[..., occupied],
                               atol=2e-5)
    assert np.isfinite(got).all()
    assert tch.fused_pfb_demod.launches == 0


def test_wrappers_dispatch_by_device_only():
    x = torch.zeros((2, 2048))
    h = torch.zeros((2, 33))
    w = torch.zeros((3, 41))
    with pytest.raises(ValueError, match="meta"):
        tfe.decimate((x.to("meta"),), (h.to("meta"),), w.to("meta"), 8, 3)
    with pytest.raises(ValueError, match="tensors on"):
        tfe.decimate((x,), (h.to("meta"),), w, 8, 3)
    with pytest.raises(ValueError, match="even"):
        z = torch.zeros((3, 1536))
        v = torch.zeros(3)
        tfl.fused_demod_filter(z, z, v, v, z, v, v, torch.zeros((24, 128)),
                               torch.zeros((24, 128)), 1.0)
    with pytest.raises(ValueError, match="equal"):
        z = torch.zeros((2, 1536))
        v = torch.zeros(2)
        g = torch.zeros((24, 128))
        tfl.fused_filter_demod_filter(z, z, z, z, v, v, torch.zeros((2, 512)),
                                      v, v, g, g, g, g, 1.0)
    with pytest.raises(ValueError, match="64 channels"):
        x = torch.zeros((1, 9 * 32 + 256))
        tch.fused_pfb_demod(x, x, 1.0, torch.zeros((8, 32)))
