"""The port's morse modules (``blocks/morse.py``, ``SlewRateLimiter``,
``FmMod``, ``models/morse_tx.py``) against the JAX package's on the same
numpy inputs.

Tolerances: the keyer, the encoder and the bound params are equal
exactly; ``SlewRateLimiter`` atol 1e-5 (the JAX package's slew bound);
``FmMod`` atol 1e-4 (its phase integrator sums in another order: the JAX
package's triangular-matmul cumsum against ``torch.cumsum``, a float32
phase of a few radians); the chains from ``valid_from`` at the per-model
bounds of ``tools/validate_tpu.py:351-355``: morse 1e-3, morse_rf 1e-2
(FmMod's carried phase across chunks).
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import oracles
from radiorust_tpu import config
from radiorust_tpu.blocks import base as jbase
from radiorust_tpu.blocks import filters as jfilters
from radiorust_tpu.blocks import modulation as jmod
from radiorust_tpu.blocks import morse as jmorse
from radiorust_tpu.models import morse_tx as jmorse_tx
from radiorust_tpu_torch.blocks import base as tbase
from radiorust_tpu_torch.blocks import filters as tfilters
from radiorust_tpu_torch.blocks import modulation as tmod
from radiorust_tpu_torch.blocks import morse as tmorse
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.models import morse_tx as tmorse_tx
from radiorust_tpu_torch.ops import scan as tscan

TOL = {"morse": 1e-3, "morse_rf": 1e-2}


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
    """Bind both blocks at ``sig`` and scan ``xs`` [T, batch, n]; the port
    gets the JAX package's params and initial state."""
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


def keyed(n, rate, t_chunks, wpms, message="CQ CQ DE K1ABC K"):
    """[T, len(wpms), n] keyer envelopes, one speed per stream."""
    return np.stack([tmorse.Keyer(n, rate, tmorse.Speed.from_paris_wpm(w),
                                  message).envelope(t_chunks)
                     for w in wpms], axis=1)


@pytest.mark.parametrize("text", ["CQ CQ DE K1ABC", "<SK> 73", "sos?/=",
                                  "A<AR>B", "", "<BT>"])
def test_encode_matches_jax(text):
    got = [u.value for u in tmorse.encode(text)]
    want = [u.value for u in jmorse.encode(text)]
    assert got == want


@pytest.mark.parametrize("text", ["<<A>", "A>", "<A B>", "é", "\x07", "#"])
def test_encode_refuses_what_jax_refuses(text):
    with pytest.raises(jmorse.EncodeError) as want:
        jmorse.encode(text)
    with pytest.raises(tmorse.EncodeError, match=str(want.value)):
        tmorse.encode(text)


def test_speed_and_units_match_jax():
    for t_speed, j_speed in (
            (tmorse.Speed.from_paris_wpm(20), jmorse.Speed.from_paris_wpm(20)),
            (tmorse.Speed.from_codex_cpm(77), jmorse.Speed.from_codex_cpm(77)),
            (tmorse.Speed.from_dits_per_minute(1536.0),
             jmorse.Speed.from_dits_per_minute(1536.0))):
        for name in ("paris_cpm", "codex_cpm", "paris_wpm", "codex_wpm",
                     "dits_per_minute", "seconds_per_dit"):
            assert getattr(t_speed, name)() == getattr(j_speed, name)()
        assert t_speed.samples_per_dit(8000.0) == \
            j_speed.samples_per_dit(8000.0)
        for tu, ju in zip(tmorse.Unit, jmorse.Unit):
            assert (tu.value, tu.on) == (ju.value, ju.on)
            assert tu.samples(48000.0, t_speed) == ju.samples(48000.0,
                                                              j_speed)
    # The .5 tie: samples_per_dit = 312.5 gives a 313-sample DIT.
    speed = tmorse.Speed.from_dits_per_minute(1536.0)
    env = tmorse.units_to_envelope([tmorse.Unit.DIT], 8000.0, speed)
    assert env.size == 313
    np.testing.assert_array_equal(
        env, jmorse.units_to_envelope([jmorse.Unit.DIT], 8000.0,
                                      jmorse.Speed.from_dits_per_minute(
                                          1536.0)))


@pytest.mark.parametrize("dpm,rate,n", [(1536.0, 8000.0, 1000),
                                        (1000.0, 48000.0, 4096)])
def test_keyer_chunks_and_events_match_jax(dpm, rate, n):
    tk = tmorse.Keyer(n, rate, tmorse.Speed.from_dits_per_minute(dpm), "E T")
    jk = jmorse.Keyer(n, rate, jmorse.Speed.from_dits_per_minute(dpm), "E T")
    for step in range(12):
        if step == 9:   # a second burst after the first drained
            tk.send("<SK>")
            jk.send("<SK>")
        (tc, tev), = tk.chunks(1)
        (jc, jev), = jk.chunks(1)
        np.testing.assert_array_equal(tc, jc)
        assert tc.dtype == jc.dtype == np.complex64
        assert [type(e).__name__ for e in tev] == \
            [type(e).__name__ for e in jev]
    np.testing.assert_array_equal(tk.envelope(3), jk.envelope(3))


def test_slew_rate_limiter_matches_jax_and_oracle():
    rng = np.random.default_rng(5)
    B, n, steps = 3, 512, 4
    x = (rng.standard_normal((B, steps * n))
         + 1j * rng.standard_normal((B, steps * n))).astype(np.complex64)
    xs = x.reshape(B, steps, n).transpose(1, 0, 2).copy()
    jb, tb, (jstate, want), (tstate, got) = run_both(
        jfilters.SlewRateLimiter(300.0), tfilters.SlewRateLimiter(300.0),
        (B, n, 1000.0), xs)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(tstate["prev"].numpy(),
                               np.asarray(jstate["prev"]), atol=1e-5)
    for b in range(B):
        oy, _ = oracles.oracle_slew_rate_limiter(x[b], 1000.0, 300.0)
        np.testing.assert_allclose(got[:, b].reshape(-1), oy, atol=1e-5)
    assert tscan.slew_scan.launches == 0


def test_fm_mod_matches_jax_and_oracle():
    B, n, steps, rate, dev = 2, 1024, 4, 48000.0, 2500.0
    tt = np.arange(steps * n) / rate
    audio = np.stack([np.cos(2 * np.pi * 700.0 * tt),
                      0.5 * np.sin(2 * np.pi * 1300.0 * tt)])
    xs = audio.astype(np.complex64).reshape(B, steps, n).transpose(1, 0, 2)
    xs = xs.copy()
    jb, tb, (jstate, want), (tstate, got) = run_both(
        jmod.FmMod(dev), tmod.FmMod(dev), (B, n, rate), xs)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(tstate["phase"].numpy(),
                               np.asarray(jstate["phase"]), atol=1e-4)
    for b in range(B):
        oy, _ = oracles.oracle_fm_mod(xs[:, b].reshape(-1), rate, dev)
        np.testing.assert_allclose(got[:, b].reshape(-1), oy, atol=1e-4)


@pytest.mark.parametrize("name,rate", [("morse", 48000.0),
                                       ("morse_rf", 128000.0)])
def test_morse_chain_matches_jax(name, rate):
    maker = "morse_audio_chain" if name == "morse" else "morse_rf_chain"
    n = 4096
    xs = keyed(n, rate, 4, (30, 25))
    jb, tb, (jstate, want), (tstate, got) = run_both(
        getattr(jmorse_tx, maker)(), getattr(tmorse_tx, maker)(),
        (2, n, rate), xs)
    assert tb.valid_from == jb.valid_from == 1
    v = tb.valid_from
    np.testing.assert_allclose(got[v:], want[v:], atol=TOL[name])
    # Keying made it through: the envelope is not silent.
    assert np.abs(got[v:]).max() > 0.4
    # The params and the state come back with the JAX package's keys,
    # shapes, dtypes and (for the params) values.
    for tree_t, tree_j, exact in ((tb.params, jb.params, True),
                                  (tstate, jstate, False)):
        leaves_t = _leaves(tree_to_numpy(tree_t))
        leaves_j = _leaves(tree_j)
        assert [k for k, _ in leaves_t] == [k for k, _ in leaves_j]
        for (k, a), (_, b) in zip(leaves_t, leaves_j):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=k)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k],
                                                           f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, f"{path}/{i}")]
    return [(path, np.asarray(tree))]
