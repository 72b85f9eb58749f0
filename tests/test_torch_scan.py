"""The port's scan wrappers on CPU tensors (their plain per-sample loops)
against the JAX package's Pallas scan kernels in interpret mode and the
per-sample oracles, on the same numpy inputs.

Tolerances are the JAX package's own (``tests/test_pallas_scan.py``):
slew outputs and carry atol 1e-5; AGC outputs atol 2e-4 and the carried
gain atol 2e-3, in the loop's contracting regime (rate * |x| well below 2).
A NaN sample puts NaN where the JAX package puts it, exactly.
"""

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

SLEW_ATOL = 1e-5
AGC_ATOL, GAIN_ATOL = 2e-4, 2e-3


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


def t(a):
    return torch.from_numpy(np.array(a))


def cplx(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def planes(z):
    return z.real.astype(np.float32), z.imag.astype(np.float32)


@pytest.mark.parametrize("rsqrt", [False, True])
def test_slew_plain_matches_pallas_and_oracle(rsqrt):
    rng = np.random.default_rng(3)
    B, T = 5, 256
    x = cplx(rng, B, T)
    md = np.float32(0.4)
    zeros = np.zeros(B, np.float32)
    want = pallas_scan.slew_scan(*(jnp.asarray(v) for v in planes(x)),
                                 jnp.asarray(zeros), jnp.asarray(zeros), md,
                                 rsqrt=rsqrt)
    got = tscan.slew_scan(*(t(v) for v in planes(x)), t(zeros), t(zeros),
                          md, rsqrt=rsqrt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SLEW_ATOL)
    y = got[0].numpy() + 1j * got[1].numpy()
    for b in range(B):
        oy, oprev = oracles.oracle_slew_rate_limiter(x[b], 1.0, 0.4)
        np.testing.assert_allclose(y[b], oy, atol=SLEW_ATOL)
        np.testing.assert_allclose(complex(got[2][b], got[3][b]), oprev,
                                   atol=SLEW_ATOL)
    assert tscan.slew_scan.launches == 0


def test_slew_plain_carries_across_chunks():
    # Chunk by chunk with the carry handed on equals one oracle pass over
    # the whole stream, from a nonzero initial sample.
    rng = np.random.default_rng(4)
    B, T, chunks = 3, 1536, 3
    x = cplx(rng, B, T)
    prev0 = cplx(rng, B)
    md = np.float32(0.3)
    pr, pi = t(prev0.real), t(prev0.imag)
    ys = []
    for c in np.split(x, chunks, axis=-1):
        yr, yi, pr, pi = tscan.slew_scan(*(t(v) for v in planes(c)), pr, pi,
                                         md, rsqrt=True)
        ys.append(yr.numpy() + 1j * yi.numpy())
    y = np.concatenate(ys, axis=-1)
    for b in range(B):
        want, prev = oracles.oracle_slew_rate_limiter(x[b], 1.0, 0.3,
                                                      prev=prev0[b])
        np.testing.assert_allclose(y[b], want, atol=SLEW_ATOL)
        np.testing.assert_allclose(complex(pr[b], pi[b]), prev,
                                   atol=SLEW_ATOL)


@pytest.mark.parametrize("chunks", [1, 3])
def test_agc_plain_matches_pallas_and_oracle(chunks):
    rng = np.random.default_rng(7)
    B, T = 3, 192
    x = cplx(rng, B, T, scale=0.2)
    knobs = (np.float32(5e-3), np.float32(1.0), np.float32(100.0))
    g_jax = jnp.ones(B, jnp.float32)
    g_port = torch.ones(B)
    for c in np.split(x, chunks, axis=-1):
        wr, wi, g_jax = pallas_scan.agc_scan(
            *(jnp.asarray(v) for v in planes(c)), g_jax, *knobs)
        gr, gi, g_port = tscan.agc_scan(*(t(v) for v in planes(c)), g_port,
                                        *knobs)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=AGC_ATOL)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=AGC_ATOL)
    np.testing.assert_allclose(g_port.numpy(), np.asarray(g_jax),
                               atol=GAIN_ATOL)
    g_port = torch.ones(B)
    ys = []
    for c in np.split(x, chunks, axis=-1):
        yr, yi, g_port = tscan.agc_scan(*(t(v) for v in planes(c)), g_port,
                                        *knobs)
        ys.append(yr.numpy() + 1j * yi.numpy())
    y = np.concatenate(ys, axis=-1)
    for b in range(B):
        want, gw = oracles.oracle_agc(x[b], 1.0, 5e-3, 100.0)
        np.testing.assert_allclose(y[b], want, atol=AGC_ATOL)
        np.testing.assert_allclose(float(g_port[b]), gw, atol=GAIN_ATOL)
    assert tscan.agc_scan.launches == 0


def test_agc_step_plain_matches_jax_agc_control():
    # agc_step_plain is the JAX package's AgcControl route: its clamped-
    # affine maps composed by an associative scan.
    rng = np.random.default_rng(9)
    B, T = 3, 300
    x = cplx(rng, B, T, scale=0.2)
    gain = rng.uniform(0.5, 2.0, B).astype(np.float32)
    knobs = (np.float32(5e-3), np.float32(1.0), np.float32(100.0))
    blk = jtr.AgcControl(reference=1.0, rate=5e-3, max_gain=100.0).bind(
        jbase.StreamSig(B, T, 1000.0))
    params = {k: jnp.asarray(v) for k, v in blk.params.items()}
    st, want = jax.jit(blk.process)(params, {"gain": jnp.asarray(gain)},
                                    jnp.asarray(x), jnp.zeros((B,), bool))
    y, g = tscan.agc_step(t(x), t(gain), *knobs)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=AGC_ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(st["gain"]),
                               atol=GAIN_ATOL)
    for b in range(B):
        oy, og = oracles.oracle_agc(x[b], 1.0, 5e-3, 100.0, gain0=gain[b])
        np.testing.assert_allclose(y[b].numpy(), oy, atol=AGC_ATOL)
        np.testing.assert_allclose(float(g[b]), og, atol=GAIN_ATOL)
    assert tscan.agc_scan.launches == 0


def test_agc_plain_versions_put_nan_where_jax_does():
    # A NaN in one plane of a sample: from that sample on y and the gain
    # are NaN in both packages.  The plane signature scales each plane (the
    # other plane stays finite at that sample), the complex one multiplies
    # complex numbers (both planes NaN there), as the JAX package does.
    rng = np.random.default_rng(10)
    B, T = 3, 200
    x = cplx(rng, B, T, scale=0.2)
    x.real[0, 120] = np.nan
    x.imag[2, 7] = np.nan
    gain = np.ones(B, np.float32)
    knobs = (np.float32(5e-3), np.float32(1.0), np.float32(100.0))
    xr, xi = planes(x)
    wr, wi, wg = pallas_scan.agc_scan(jnp.asarray(xr), jnp.asarray(xi),
                                      jnp.asarray(gain), *knobs)
    gr, gi, gg = tscan.agc_scan_plain(t(xr), t(xi), t(gain), *knobs)
    blk = jtr.AgcControl(reference=1.0, rate=5e-3, max_gain=100.0).bind(
        jbase.StreamSig(B, T, 1000.0))
    params = {k: jnp.asarray(v) for k, v in blk.params.items()}
    st, wy = jax.jit(blk.process)(params, {"gain": jnp.asarray(gain)},
                                  jnp.asarray(x), jnp.zeros((B,), bool))
    y, g = tscan.agc_step_plain(t(x), t(gain), *knobs)
    pairs = [(gr.numpy(), np.asarray(wr)), (gi.numpy(), np.asarray(wi)),
             (gg.numpy(), np.asarray(wg)),
             (y.numpy().real, np.asarray(wy).real),
             (y.numpy().imag, np.asarray(wy).imag),
             (g.numpy(), np.asarray(st["gain"]))]
    for got, want in pairs:
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(got)
        np.testing.assert_allclose(got[ok], want[ok], atol=GAIN_ATOL)
    assert np.isnan(gr.numpy()[0, 120:]).all()
    assert not np.isnan(gr.numpy()[0, :120]).any()
    assert not np.isnan(gr.numpy()[2, 7]) and np.isnan(y.numpy().real[2, 7])
    assert np.isnan(gg.numpy()[[0, 2]]).all() and not np.isnan(gg.numpy()[1])


def test_scan_wrappers_dispatch_by_device_only():
    x = torch.zeros((2, 64))
    c = torch.zeros(2)
    with pytest.raises(ValueError, match="meta"):
        tscan.slew_scan(x.to("meta"), x.to("meta"), c.to("meta"),
                        c.to("meta"), 0.1)
    with pytest.raises(ValueError, match="tensors on"):
        tscan.agc_scan(x, x, c.to("meta"), 1e-3, 1.0, 10.0)
    with pytest.raises(ValueError, match="empty"):
        tscan.slew_scan(x[:, :0], x[:, :0], c, c, 0.1)
    with pytest.raises(ValueError, match="empty"):
        tscan.agc_scan(x[:0], x[:0], c[:0], 1e-3, 1.0, 10.0)
    with pytest.raises(ValueError, match="carry"):
        tscan.agc_scan(x, x, torch.zeros(3), 1e-3, 1.0, 10.0)
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        tscan.slew_scan(x, x[:, :32], c, c, 0.1)
    z = torch.zeros((2, 64), dtype=torch.complex64)
    with pytest.raises(ValueError, match="tensors on"):
        tscan.agc_step(z, c.to("meta"), 1e-3, 1.0, 10.0)
    with pytest.raises(ValueError, match="meta"):
        tscan.agc_step(z.to("meta"), c.to("meta"), 1e-3, 1.0, 10.0)
    with pytest.raises(ValueError, match="empty"):
        tscan.agc_step(z[:, :0], c, 1e-3, 1.0, 10.0)
    with pytest.raises(ValueError, match="carry"):
        tscan.agc_step(z, torch.zeros(3), 1e-3, 1.0, 10.0)
    with pytest.raises(ValueError, match="complex"):
        tscan.agc_step(x, c, 1e-3, 1.0, 10.0)
    with pytest.raises(ValueError, match="complex"):
        tscan.agc_step(z[0], c, 1e-3, 1.0, 10.0)
    # On CPU tensors no kernel is launched, whatever the inputs.
    tscan.slew_scan(x, x, c, c, torch.tensor(0.1))
    tscan.agc_scan(x, x, c, torch.tensor(1e-3), 1.0, 10.0)
    tscan.agc_step(z, c, torch.tensor(1e-3), 1.0, 10.0)
    tscan.agc_step(z[:, ::2], c, 1e-3, 1.0, 10.0)
    assert tscan.slew_scan.launches == tscan.agc_scan.launches == 0
