"""The port's ``Squelch``, ``AgcControl`` and AM/SSB/ISB receivers
(``models/analog.py``) against the JAX package's and the per-sample
oracles, on the same numpy inputs.

Tolerances: ``Squelch`` outputs atol 1e-5 and envelope rtol 1e-4 (the
JAX package's squelch-vs-oracle bounds); ``AgcControl`` atol 2e-4 and
gain atol 2e-3 in its contracting regime, atol 3e-4 where the gain clamps
at both bounds (the JAX package's AGC bounds); under sustained overdrive
the loop is chaotic, so only finiteness and the clamp are checked; on CPU
tensors ``AgcControl`` gives the scan it ran inline before it called
``ops.scan.agc_step``, bit for bit; the receivers from ``valid_from`` at
1e-3 (``tools/validate_tpu.py:351``, am, ssb and isb).
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import oracles
from radiorust_tpu import config
from radiorust_tpu.blocks import base as jbase
from radiorust_tpu.blocks import transform as jtr
from radiorust_tpu.blocks.graph import graph_scan as jgraph_scan
from radiorust_tpu.models import analog as janalog
from radiorust_tpu_torch.blocks import base as tbase
from radiorust_tpu_torch.blocks import transform as ttr
from radiorust_tpu_torch.blocks.graph import graph_scan
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.models import analog as tanalog
from radiorust_tpu_torch.ops.assoc_scan import associative_scan

RX_ATOL = 1e-3
RATE = tanalog.ANALOG_INPUT_RATE
N = tanalog.ANALOG_INPUT_CHUNK


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


def run_both(jspec, tspec, sig, xs, resets=None):
    jb = jspec.bind(jbase.StreamSig(*sig))
    tb = tspec.bind(tbase.StreamSig(*sig))
    if resets is None:
        resets = np.zeros(xs.shape[:2], bool)
    jstate, want = jbase.scan(jb, jb.params, jb.init_state(),
                              jnp.asarray(xs), jnp.asarray(resets))
    tstate, got = tbase.scan(tb, tree_to_torch(jb.params, "cpu"),
                             tree_to_torch(jb.init_state(), "cpu"),
                             torch.from_numpy(xs), torch.from_numpy(resets))
    return jb, tb, (jstate, np.asarray(want)), (tstate, got.numpy())


def test_associative_scan_is_inclusive_and_ordered():
    # A non-commutative combine (affine-map composition) over lengths that
    # are and are not powers of two equals the sequential fold.
    rng = np.random.default_rng(1)
    for n in (1, 7, 64, 100):
        a = rng.uniform(0.5, 1.0, (3, n))
        b = rng.standard_normal((3, n))

        def comb(earlier, later):
            return earlier[0] * later[0], later[1] + later[0] * earlier[1]

        big_a, big_b = associative_scan(comb, (torch.from_numpy(a),
                                               torch.from_numpy(b)))
        want_a, want_b = a.copy(), b.copy()
        for i in range(1, n):
            want_a[:, i], want_b[:, i] = comb((want_a[:, i - 1],
                                               want_b[:, i - 1]),
                                              (a[:, i], b[:, i]))
        np.testing.assert_allclose(big_a.numpy(), want_a, rtol=1e-12)
        np.testing.assert_allclose(big_b.numpy(), want_b, rtol=1e-12,
                                   atol=1e-12)


def test_squelch_matches_jax_and_oracle():
    rng = np.random.default_rng(12)
    n = 64
    loud = rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n)
    quiet = 1e-3 * (rng.standard_normal(2 * n)
                    + 1j * rng.standard_normal(2 * n))
    x = np.concatenate([loud, quiet]).astype(np.complex64)
    xs = np.stack([x, x[::-1]]).reshape(2, 4, n).transpose(1, 0, 2).copy()
    jb, tb, (jstate, want), (tstate, got) = run_both(
        jtr.Squelch(threshold=1e-2, alpha=0.9),
        ttr.Squelch(threshold=1e-2, alpha=0.9), (2, n, 1000.0), xs)
    np.testing.assert_allclose(got, want, atol=1e-5)
    for s in range(2):
        oy, env = oracles.oracle_squelch(xs[:, s].reshape(-1), 1e-2, 0.9)
        np.testing.assert_allclose(got[:, s].reshape(-1), oy, atol=1e-5)
        np.testing.assert_allclose(float(tstate["env"][s]), env, rtol=1e-4)
    # A reset clears the envelope of stream 0 at step 1.
    resets = np.zeros((4, 2), bool)
    resets[1, 0] = True
    _, _, (_, want), (_, got) = run_both(
        jtr.Squelch(threshold=1e-2, alpha=0.9),
        ttr.Squelch(threshold=1e-2, alpha=0.9), (2, n, 1000.0), xs, resets)
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="alpha"):
        ttr.Squelch(alpha=1.0)


def test_agc_matches_jax_and_oracle():
    rng = np.random.default_rng(11)
    n = 64
    x = (0.2 * (rng.standard_normal((2, 4 * n))
                + 1j * rng.standard_normal((2, 4 * n)))).astype(np.complex64)
    xs = x.reshape(2, 4, n).transpose(1, 0, 2).copy()
    spec = dict(reference=1.0, rate=5e-3, max_gain=100.0)
    jb, tb, (jstate, want), (tstate, got) = run_both(
        jtr.AgcControl(**spec), ttr.AgcControl(**spec), (2, n, 1000.0), xs)
    np.testing.assert_allclose(got, want, atol=2e-4)
    for s in range(2):
        oy, g = oracles.oracle_agc(x[s], 1.0, 5e-3, 100.0)
        np.testing.assert_allclose(got[:, s].reshape(-1), oy, atol=2e-4)
        np.testing.assert_allclose(float(tstate["gain"][s]), g, atol=2e-3)
    # Params and state keys, shapes and dtypes are the JAX package's.
    for k, v in tb.params.items():
        assert v.dtype == jb.params[k].dtype and v == jb.params[k], k
    assert {k: (v.shape, v.dtype) for k, v in tb.init_state().items()} == \
        {k: (v.shape, v.dtype) for k, v in jb.init_state().items()}


def test_agc_clamps_like_oracle():
    # Active clamping at both bounds: the clamped-affine composition
    # reproduces the sequential trajectory, and a reset leaves the gain.
    rng = np.random.default_rng(8)
    B, T = 2, 256
    amp = np.where((np.arange(T) // 40) % 2 == 0, 0.02, 3.0)
    x = (amp * (rng.standard_normal((B, T))
                + 1j * rng.standard_normal((B, T)))).astype(np.complex64)
    xs = x.reshape(B, 2, T // 2).transpose(1, 0, 2).copy()
    resets = np.array([[False, False], [True, False]])
    spec = dict(reference=1.0, rate=0.3, max_gain=2.5)
    jb, tb, (jstate, want), (tstate, got) = run_both(
        jtr.AgcControl(**spec), ttr.AgcControl(**spec), (B, T // 2, 1000.0),
        xs, resets)
    np.testing.assert_allclose(got, want, atol=3e-4)
    for b in range(B):
        oy, gw = oracles.oracle_agc(x[b], 1.0, 0.3, 2.5)
        np.testing.assert_allclose(got[:, b].reshape(-1), oy, atol=3e-4)
    np.testing.assert_allclose(float(tstate["gain"][-1]), gw, atol=2e-3)


def test_agc_survives_sustained_overdrive():
    # rate * |x| = 5 every sample: the loop is chaotic and composed slope
    # products grow as 4^n; the capped scan stays finite and clamped.
    B, n = 2, 2048
    x = (10.0 * np.exp(1j * 0.3 * np.arange(B * n)).reshape(B, n)
         ).astype(np.complex64)
    b = ttr.AgcControl(reference=1.0, rate=0.5, max_gain=4.0).bind(
        tbase.StreamSig(B, n, 1000.0))
    st, y = b.process(tree_to_torch(b.params, "cpu"),
                      tree_to_torch(b.init_state(), "cpu"),
                      torch.from_numpy(x), tbase.no_reset(B))
    y, g = y.numpy(), st["gain"].numpy()
    assert np.isfinite(y).all() and np.isfinite(g).all()
    assert (g >= 0.0).all() and (g <= 4.0).all()
    assert np.abs(y).max() <= 4.0 * 10.0 + 1e-3


def _old_agc_process(params, state, x):
    """``_BoundAgc.process`` as it was before it called
    ``ops.scan.agc_step``: the clamped-affine scan inline."""
    cap = 1e18
    absx = torch.abs(x)
    a = torch.clamp(1.0 - params["rate"] * absx, -cap, cap)
    b = (params["rate"] * params["reference"]).expand(a.shape)
    elems = (a, b, torch.zeros_like(a), params["max_gain"].expand(a.shape))

    def compose(e1, e2):
        a1, b1, l1, h1 = e1
        a2, b2, l2, h2 = e2
        lo = torch.minimum(a2 * l1, a2 * h1) + b2
        hi = torch.maximum(a2 * l1, a2 * h1) + b2
        return (torch.clamp(a1 * a2, -cap, cap),
                torch.clamp(a2 * b1 + b2, -cap, cap),
                torch.clamp(lo, l2, h2), torch.clamp(hi, l2, h2))

    pa, pb, plo, phi = associative_scan(compose, elems)
    g0 = state["gain"]
    g_inc = torch.clamp(pa * g0[:, None] + pb, plo, phi)
    g_exc = torch.cat([g0[:, None], g_inc[:, :-1]], dim=-1)
    return {"gain": g_inc[:, -1]}, x * g_exc


@pytest.mark.parametrize("amp, spec", [
    (0.2, dict(reference=1.0, rate=5e-3, max_gain=100.0)),
    (3.0, dict(reference=1.0, rate=0.3, max_gain=2.5)),
    (10.0, dict(reference=1.0, rate=0.5, max_gain=4.0)),
], ids=["contracting", "clamping", "overdrive"])
def test_agc_cpu_output_unchanged_bit_for_bit(amp, spec):
    # AgcControl on CPU tensors now goes through ops.scan.agc_step; its
    # output and gain are the inline scan's bit for bit, NaNs included.
    rng = np.random.default_rng(13)
    B, n = 3, 777
    x = (amp * (rng.standard_normal((B, n))
                + 1j * rng.standard_normal((B, n)))).astype(np.complex64)
    x.real[1, 400] = np.nan
    b = ttr.AgcControl(**spec).bind(tbase.StreamSig(B, n, 1000.0))
    params = tree_to_torch(b.params, "cpu")
    state = {"gain": torch.tensor([1.0, 0.5, 2.0])}
    st, y = b.process(params, state, torch.from_numpy(x), tbase.no_reset(B))
    want_st, want = _old_agc_process(params, state, torch.from_numpy(x))
    assert torch.equal(torch.view_as_real(y).view(torch.int32),
                       torch.view_as_real(want).view(torch.int32))
    assert torch.equal(st["gain"].view(torch.int32),
                       want_st["gain"].view(torch.int32))
    assert bool(torch.isnan(y[1, 400:]).all())
    assert not bool(torch.isnan(y[1, :400]).any())


def synth(t_chunks, streams, offset=30000.0):
    """[T, 2, N] complex64: stream 0 AM (tone 1000 Hz, carrier fading
    6 dB halfway), stream 1 a USB tone at 1500 Hz plus an LSB tone at
    700 Hz, both around the carrier at ``offset`` Hz."""
    t = np.arange(t_chunks * N) / RATE
    car = np.exp(2j * np.pi * offset * t)
    fade = np.where(t < t[-1] / 2, 0.8, 0.4)
    am = fade * (1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)) * car
    isb = 0.5 * (np.exp(2j * np.pi * 1500.0 * t)
                 + np.exp(-2j * np.pi * 700.0 * t)) * car
    x = np.stack([am, isb][:streams]).astype(np.complex64)
    return x.reshape(streams, t_chunks, N).transpose(1, 0, 2).copy()


@pytest.mark.parametrize("maker,kw", [
    ("am_receiver", {}),
    ("am_receiver", {"agc": True}),
    ("ssb_receiver", {}),
    ("ssb_receiver", {"lsb": True, "agc": True}),
])
def test_receivers_match_jax(maker, kw):
    xs = synth(5, 2)
    jb, tb, (jstate, want), (tstate, got) = run_both(
        getattr(janalog, maker)(tune_shift=-30000.0, **kw),
        getattr(tanalog, maker)(tune_shift=-30000.0, **kw), (2, N, RATE),
        xs)
    assert tb.valid_from == jb.valid_from == 1
    assert tb.output_is_real and jb.output_is_real
    assert tb.out_sig.sample_rate == tanalog.ANALOG_AUDIO_RATE
    assert got.shape == (5, 2, tanalog.ANALOG_AUDIO_CHUNK)
    v = tb.valid_from
    np.testing.assert_allclose(got[v:], want[v:], atol=RX_ATOL)
    assert np.abs(got[v:]).max() > 0.1
    assert np.all(got.imag == 0)
    back = tree_to_numpy(tstate)
    assert len(back) == len(jstate)
    for tnode, jnode in zip(back, jstate):
        assert set(tnode) == set(jnode)


def test_isb_receiver_matches_jax():
    xs = {"iq": synth(5, 2)}
    jg = janalog.isb_receiver(tune_shift=-30000.0, agc=True).bind(
        {"iq": jbase.StreamSig(2, N, RATE)})
    tg = tanalog.isb_receiver(tune_shift=-30000.0, agc=True).bind(
        {"iq": tbase.StreamSig(2, N, RATE)})
    assert tg.valid_from == jg.valid_from == {"usb": 1, "lsb": 1}
    _, want = jgraph_scan(jg, jg.params, jg.init_state(),
                          {"iq": jnp.asarray(xs["iq"])})
    _, got = graph_scan(tg, tree_to_torch(jg.params, "cpu"),
                        tree_to_torch(jg.init_state(), "cpu"),
                        {"iq": torch.from_numpy(xs["iq"])})
    for k in ("usb", "lsb"):
        g, w = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_allclose(g[1:], w[1:], atol=RX_ATOL, err_msg=k)
    # Stream 1 carries 1500 Hz on the upper and 700 Hz on the lower
    # sideband; each output peaks at its own tone.
    for k, tone in (("usb", 1500.0), ("lsb", 700.0)):
        audio = got[k].numpy()[2:, 1].real.reshape(-1)
        spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
        freqs = np.fft.rfftfreq(len(audio), 1.0 / tanalog.ANALOG_AUDIO_RATE)
        assert abs(freqs[np.argmax(spec)] - tone) < 40.0, k
