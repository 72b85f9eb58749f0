"""The port's WFM receive chain on CPU tensors against the JAX package's on
the same FM-tone input and the same params, compared from ``valid_from``
on with atol 3e-4 (the JAX package's own fused-vs-unfused WFM bound)."""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu.blocks.base import StreamSig as JSig
from radiorust_tpu.blocks.base import scan as jscan
from radiorust_tpu.models.wfm import wfm_receiver as jwfm_receiver
from radiorust_tpu_torch.blocks.base import StreamSig, scan
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.models.wfm import wfm_receiver

ATOL = 3e-4
RATE = 1024000.0
BENCH = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
             filter_ir_len=6144)


@pytest.fixture(autouse=True)
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pfe.pl, "pallas_call", interp)
    monkeypatch.setattr(pfl.pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


def fm_tones(tones, t_chunks, n, offset=0.0, deviation=150000.0):
    """[T, len(tones), n] complex64: one FM-modulated audio tone per
    stream, carrier at ``offset`` Hz, synthesized in float64."""
    t = np.arange(t_chunks * n) / RATE
    rows = []
    for f in tones:
        audio = 0.5 * np.sin(2 * np.pi * f * t)
        phase = (2 * np.pi * deviation / RATE * np.cumsum(audio)
                 + 2 * np.pi * offset * t)
        rows.append(np.exp(1j * phase).astype(np.complex64))
    return np.stack(rows).reshape(len(tones), t_chunks, n).transpose(1, 0, 2)


def run_jax(kw, sig, xs, state=None):
    b = jwfm_receiver(**kw).bind(JSig(*sig))
    state = b.init_state() if state is None else state
    state, ys = jscan(b, b.params, state, jnp.asarray(xs))
    return b, state, np.asarray(ys)


def run_port(kw, sig, xs, params=None, state=None):
    b = wfm_receiver(**kw).bind(StreamSig(*sig))
    params = tree_to_torch(b.params if params is None else params, "cpu")
    state = tree_to_torch(b.init_state() if state is None else state, "cpu")
    state, ys = scan(b, params, state, torch.from_numpy(xs))
    return b, state, ys.numpy()


@pytest.mark.parametrize("kw,sig,offset", [
    (BENCH, (2, 24576, RATE), -100e3),
    ({}, (2, 16384, RATE), 0.0),
])
def test_wfm_port_matches_jax(kw, sig, offset):
    xs = fm_tones([900.0, 2100.0], 4, sig[1], offset)
    jb, _, want = run_jax(kw, sig, xs)
    # The JAX package's bound params, carried across.
    tb, _, got = run_port(kw, sig, xs, params=jb.params)
    v = tb.valid_from
    assert v == jb.valid_from == 2
    assert got.shape == want.shape
    np.testing.assert_allclose(got[v:], want[v:], atol=ATOL)
    assert np.abs(want[v:]).max() > 0.1   # the tones carry signal


def test_wfm_state_handoff_from_jax():
    sig = (2, 24576, RATE)
    xs = fm_tones([1000.0, 3000.0], 4, sig[1], -100e3)
    _, _, want = run_jax(BENCH, sig, xs)
    _, jstate, _ = run_jax(BENCH, sig, xs[:2])
    _, tstate, got = run_port(BENCH, sig, xs[2:], state=jstate)
    np.testing.assert_allclose(got, want[2:], atol=ATOL)
    # The state comes back with the JAX package's keys, shapes and dtypes.
    jb = jwfm_receiver(**BENCH).bind(JSig(*sig))
    back = tree_to_numpy(tstate)
    for tblk, jblk in zip(back, jb.init_state()):
        assert set(tblk) == set(jblk)
        for k in jblk:
            assert tblk[k].shape == jblk[k].shape, k
            assert tblk[k].dtype == jblk[k].dtype, k


def test_wfm_port_fused_equals_unfused():
    sig = (2, 24576, RATE)
    xs = fm_tones([900.0, 2100.0], 4, sig[1], -100e3)
    unfused = dict(BENCH, fuse_frontend=False, fuse_demod=False)
    b, _, fused = run_port(BENCH, sig, xs)
    _, _, plain = run_port(unfused, sig, xs)
    v = b.valid_from
    np.testing.assert_allclose(fused[v:], plain[v:], atol=ATOL)


def test_wfm_fuse_mid_not_ported():
    # Both flags are ported now: they bind to the fused blocks.
    sig = StreamSig(2, 24576, RATE)
    mid = wfm_receiver(fuse_mid=True, filter_ir_len=6144).bind(sig)
    assert [type(b).__name__ for b in mid.blocks] == [
        "_BoundFreqShifter", "_BoundResampler", "_BoundFilterDemodFilter",
        "_BoundResampler", "_BoundGain"]
    assert mid.valid_from == 2
    deemph = wfm_receiver(fuse_deemphasis=True).bind(sig)
    assert len(deemph.blocks) == 6
    assert deemph.blocks[4].plan.kernel.shape == (1, 288 + 9216 - 1 + 7)


FUSE_MID = dict(BENCH, fuse_demod=False, fuse_mid=True)


def test_wfm_fuse_mid_matches_jax_and_unfused():
    sig = (2, 24576, RATE)
    xs = fm_tones([900.0, 2100.0], 4, sig[1], -100e3)
    jb, _, want = run_jax(FUSE_MID, sig, xs)
    tb, _, got = run_port(FUSE_MID, sig, xs, params=jb.params)
    _, _, unfused = run_port(dict(FUSE_MID, fuse_mid=False), sig, xs)
    v = tb.valid_from
    assert v == jb.valid_from == 2
    np.testing.assert_allclose(got[v:], want[v:], atol=ATOL)
    np.testing.assert_allclose(got[v:], unfused[v:], atol=ATOL)
    assert np.abs(want[v:]).max() > 0.1


def test_wfm_fuse_mid_state_handoff_and_update():
    sig = (2, 24576, RATE)
    xs = fm_tones([1000.0, 3000.0], 4, sig[1], -100e3)
    _, _, want = run_jax(FUSE_MID, sig, xs)
    _, jstate, _ = run_jax(FUSE_MID, sig, xs[:2])
    tb, tstate, got = run_port(FUSE_MID, sig, xs[2:], state=jstate)
    np.testing.assert_allclose(got, want[2:], atol=ATOL)
    assert set(tree_to_numpy(tstate)[1]) == {
        "prev", "plr", "pli", "prevd", "last_out", "have_prev"}
    # update_filter_params redesigns the channel response only, as JAX's.
    from radiorust_tpu.models.wfm import _lowpass_100k
    narrow = lambda bins, freqs: np.where(np.abs(freqs) <= 80000.0, 1 + 0j,
                                          0j)
    jb = jwfm_receiver(**FUSE_MID).bind(JSig(*sig))
    want_p = jb.blocks[1].update_filter_params(narrow)
    got_p = tb.blocks[1].update_filter_params(narrow)
    for k in ("response1", "response2", "factor"):
        np.testing.assert_array_equal(got_p[k], want_p[k])
    assert not np.array_equal(got_p["response1"],
                              tb.blocks[1].update_filter_params(
                                  _lowpass_100k)["response1"])


def test_wfm_fuse_deemphasis_matches_unfused_and_jax():
    sig = (1, 16384, RATE)
    xs = fm_tones([1000.0], 4, sig[1])
    _, _, plain = run_port({}, sig, xs)
    jb, _, want = run_jax(dict(fuse_deemphasis=True), sig, xs)
    tb, _, got = run_port(dict(fuse_deemphasis=True), sig, xs,
                          params=jb.params)
    np.testing.assert_array_equal(tb.blocks[4].plan.kernel,
                                  jb.blocks[4].plan.kernel)
    np.testing.assert_allclose(got[1:], plain[1:], atol=2e-4)
    # Across packages from valid_from + 1: chunk 1's 6438-tap decimation
    # window still reaches into chunk 0's demod of the channel filter's
    # warm-up, which is chaotic in the last bits.
    v = tb.valid_from
    assert v == jb.valid_from == 1
    np.testing.assert_allclose(got[v + 1:], want[v + 1:], atol=ATOL)
