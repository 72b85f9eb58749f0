"""The port's ``Upsampler`` and phase-mode resampling on CPU tensors
against the JAX package on the same numpy inputs: every resampler within
atol 2e-4 (the JAX package's own resampler tests), exact zeros behind
each valid prefix, the schedule equal to the JAX package's; and
``wfm_transmitter`` within 1e-2 from ``valid_from`` (``TOL["wfm_tx"]`` of
``tools/validate_tpu.py``: FmMod's carried phase sums in another order on
each backend), with its transmit -> receive round trip."""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu.blocks.base import Chain as JChain
from radiorust_tpu.blocks.base import StreamSig as JSig
from radiorust_tpu.blocks.base import scan as jscan
from radiorust_tpu.blocks.resampling import Downsampler as JDown
from radiorust_tpu.blocks.resampling import Upsampler as JUp
from radiorust_tpu.blocks.transform import GainControl as JGain
from radiorust_tpu.models.wfm import wfm_transmitter as jwfm_transmitter
from radiorust_tpu.ops.polyphase import plan_upsample as jplan_upsample
from radiorust_tpu_torch.blocks.base import Chain, StreamSig, scan
from radiorust_tpu_torch.blocks.chunks import rechunk
from radiorust_tpu_torch.blocks.resampling import Downsampler, Upsampler
from radiorust_tpu_torch.blocks.transform import GainControl
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.models.wfm import (WFM_AUDIO_CHUNK, WFM_AUDIO_RATE,
                                            WFM_INPUT_CHUNK, WFM_INPUT_RATE,
                                            wfm_receiver, wfm_transmitter)
from radiorust_tpu_torch.ops import frontend as tfe
from radiorust_tpu_torch.ops.polyphase import (plan_downsample,
                                               plan_upsample)

ATOL = 2e-4
TX_TOL = 1e-2


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


def make_input(t, n, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, batch, n))
            + 1j * rng.standard_normal((t, batch, n))).astype(np.complex64)


def run_both(jblock, tblock, xs, rate, jstate=None, tstate=None):
    """Scan the JAX and the port block over xs [T, b, n]: (JAX bound, its
    state, ys; port bound, its state, ys)."""
    sig = (xs.shape[1], xs.shape[2], rate)
    jb = jblock.bind(JSig(*sig))
    tb = tblock.bind(StreamSig(*sig))
    js, jy = jscan(jb, jb.params, jb.init_state() if jstate is None
                   else jstate, jnp.asarray(xs))
    ts, ty = scan(tb, tree_to_torch(tb.params, "cpu"),
                  tree_to_torch(tb.init_state() if tstate is None
                                else tstate, "cpu"), torch.from_numpy(xs))
    return jb, js, np.asarray(jy), tb, ts, ty.numpy()


def trimmed(b, ys, k0=0):
    """The schedule-valid prefix of each chunk, concatenated, after
    checking that the padding behind it is exact zeros."""
    vc = b.valid_counts(k0, ys.shape[0])
    for k, v in enumerate(vc):
        assert np.all(ys[k, :, v:] == 0)
    return np.concatenate([ys[k, :, :v] for k, v in enumerate(vc)], axis=-1)


@pytest.mark.parametrize("in_rate,out_rate,bw,n", [
    (48.0, 384.0, 40.0, 64),      # 1/8 integer upsample
    (384.0, 1024.0, 300.0, 63),   # 3/8 fractional upsample
    (400.0, 1000.0, 350.0, 64),   # 2/5
])
def test_upsampler_matches_jax(in_rate, out_rate, bw, n):
    xs = make_input(3, n, batch=2, seed=int(out_rate))
    jb, _, want, tb, _, got = run_both(JUp(out_rate, bw), Upsampler(out_rate,
                                                                    bw),
                                       xs, in_rate)
    assert not tb.phase_mode
    assert (tb.out_sig.chunk_len, tb.out_sig.sample_rate) == (
        jb.out_sig.chunk_len, jb.out_sig.sample_rate)
    np.testing.assert_allclose(got, want, atol=ATOL)


# (block maker, input rate, chunk): 8:3 at chunks that are no multiple of
# 8 (7 is shorter than a period, and the history is longer than the
# chunk), 1.024 MHz to the audio rates at 16384 (p = 10240, 20480, 40960
# per 441: steps without a valid window), the upsample 384 -> 1024 at 64.
PHASE_CASES = {
    "8:3 at 60": (lambda m: m.Downsampler(384.0, 200.0), 1024.0, 60, 8),
    "8:3 at 100": (lambda m: m.Downsampler(384.0, 200.0), 1024.0, 100, 8),
    "8:3 at 7": (lambda m: m.Downsampler(384.0, 200.0), 1024.0, 7, 8),
    "1.024M to 44.1k": (lambda m: m.Downsampler(44100.0, 17640.0),
                        1024000.0, 16384, 4),
    "1.024M to 22.05k": (lambda m: m.Downsampler(22050.0, 8820.0),
                         1024000.0, 16384, 4),
    "1.024M to 11.025k": (lambda m: m.Downsampler(11025.0, 4410.0),
                          1024000.0, 16384, 4),
    "384 to 1024 at 64": (lambda m: m.Upsampler(1024.0, 300.0), 384.0, 64,
                          5),
}


class _J:
    Downsampler, Upsampler = JDown, JUp


class _T:
    Downsampler, Upsampler = Downsampler, Upsampler


@pytest.mark.parametrize("case", list(PHASE_CASES))
def test_phase_mode_matches_jax(case):
    make, rate, n, t = PHASE_CASES[case]
    xs = make_input(t, n, batch=2, seed=n)
    jb, js, want, tb, ts, got = run_both(make(_J), make(_T), xs, rate)
    assert tb.phase_mode and tb.ragged_output and jb.phase_mode
    assert tb.out_sig.chunk_len == jb.out_sig.chunk_len
    np.testing.assert_array_equal(tb.valid_counts(0, 3 * t),
                                  jb.valid_counts(0, 3 * t))
    trimmed(jb, want)
    np.testing.assert_allclose(trimmed(tb, got), trimmed(jb, want), atol=ATOL)
    np.testing.assert_array_equal(ts["phase"].numpy(), np.asarray(js["phase"]))
    np.testing.assert_allclose(ts["hist"].numpy(), np.asarray(js["hist"]))
    assert tb.schedule_phase(ts) == jb.schedule_phase(js)


def test_phase_mode_equals_aligned_rechunked():
    """One stream through phase mode (chunk 60) and aligned mode (chunk
    64, the same samples re-chunked): the same output stream."""
    x = make_input(16, 60, seed=9)
    xs = torch.from_numpy(x)
    outs = []
    for chunks in (xs, rechunk(xs, 64)):
        b = Downsampler(384.0, 200.0).bind(StreamSig(1, chunks.shape[-1],
                                                     1024.0))
        _, ys = scan(b, tree_to_torch(b.params, "cpu"),
                     tree_to_torch(b.init_state(), "cpu"), chunks)
        outs.append((b, ys.numpy()))
    (bp, yp), (ba, ya) = outs
    assert bp.phase_mode and not ba.phase_mode
    got_p = trimmed(bp, yp)[0]
    got_a = ya[:, 0].reshape(-1)
    np.testing.assert_allclose(got_p, got_a[:len(got_p)], atol=1e-6)


def test_schedule_equals_jax():
    """valid_counts, advance and the chain's schedule mirror against the
    JAX package's, from every phase of one period."""
    for p_in, chunk in ((1024.0, 60), (1024000.0, 16384), (384.0, 64)):
        for make in (lambda m: m.Downsampler(384.0, 200.0),
                     lambda m: m.Upsampler(1024.0, 300.0)):
            try:
                jb = make(_J).bind(JSig(1, chunk, p_in))
            except AssertionError:
                continue    # a downsampler above its input rate, and so on
            tb = make(_T).bind(StreamSig(1, chunk, p_in))
            for k0 in range(0, 12, 5):
                np.testing.assert_array_equal(tb.valid_counts(k0, 7),
                                              jb.valid_counts(k0, 7))
            for ph in range(tb.plan.p):
                assert tb.advance_schedule(ph) == jb.advance_schedule(ph)
    jc = JChain(JGain(0.5), JDown(384.0, 200.0)).bind(JSig(1, 100, 1024.0))
    tc = Chain(GainControl(0.5), Downsampler(384.0, 200.0)).bind(
        StreamSig(1, 100, 1024.0))
    assert tc.ragged_output and jc.ragged_output
    np.testing.assert_array_equal(tc.valid_counts(3, 9), jc.valid_counts(3, 9))
    st = tree_to_torch(tc.init_state(), "cpu")
    assert tc.schedule_phase(st) == jc.schedule_phase(jc.init_state()) == 0
    assert tc.advance_schedule(5) == jc.advance_schedule(5)


def test_phase_mode_must_be_last_in_chain():
    with pytest.raises(ValueError, match="LAST block"):
        Chain(Downsampler(384.0, 200.0),
              GainControl(0.5)).bind(StreamSig(1, 100, 1024.0))
    Chain(GainControl(0.5),
          Downsampler(384.0, 200.0)).bind(StreamSig(1, 100, 1024.0))


def test_jax_state_carries_mid_schedule():
    """The JAX package's state after k chunks of phase mode, handed to the
    port, continues exactly where the JAX run does."""
    xs = make_input(9, 100, batch=2, seed=3)
    k = 3
    jb, js, _, _, _, _ = run_both(JDown(384.0, 200.0),
                                  Downsampler(384.0, 200.0), xs[:k], 1024.0)
    assert int(np.asarray(js["phase"])[0]) != 0
    _, _, want, tb, ts, got = run_both(
        JDown(384.0, 200.0), Downsampler(384.0, 200.0), xs[k:], 1024.0,
        jstate=js, tstate=tree_to_numpy(js))
    np.testing.assert_allclose(trimmed(tb, got, k), trimmed(jb, want, k),
                               atol=ATOL)
    np.testing.assert_array_equal(ts["phase"].numpy(), np.asarray(js["phase"]))


# The plans the JAX tests and models bind, with their layout: window 0
# at the buffer's start (s0 = 0) and history = window minus one period.
UPSAMPLE_PLANS = {"48 -> 384": (48.0, 384.0, 40.0, 64, 1, 8),
                  "384 -> 1024": (384.0, 1024.0, 300.0, 63, 3, 8),
                  "400 -> 1000": (400.0, 1000.0, 350.0, 64, 2, 5),
                  "8 k -> 16 k": (8000.0, 16000.0, 3000.0, 64, 1, 2),
                  "48 k -> 1.024 M": (48000.0, 1024000.0, 40000.0, 768, 3,
                                      64)}


@pytest.mark.parametrize("name", list(UPSAMPLE_PLANS))
def test_upsample_plans_run_on_the_decimation_kernel(name):
    """Each plan equals the JAX package's, has the downsampler's layout,
    passes ``decimate_supported``, and takes the polyphase form for q <=
    16 and the wide form past it."""
    rin, rout, bw, n, p, q = UPSAMPLE_PLANS[name]
    plan = plan_upsample(rin, rout, bw)
    jplan = jplan_upsample(rin, rout, bw)
    np.testing.assert_array_equal(plan.kernel, jplan.kernel)
    assert (plan.p, plan.q, plan.hist, plan.s0) == (jplan.p, jplan.q,
                                                    jplan.hist, jplan.s0)
    kw = plan.kernel.shape[1]
    assert (plan.p, plan.q) == (p, q)
    assert plan.s0 == 0 and plan.hist == kw - p
    assert tfe.decimate_supported(n, plan)
    assert tfe.fits_block(p, q, kw) == (q <= 16)


def test_wfm_transmitter_matches_jax():
    """validate's wfm_tx setup (two-tone audio, 1 kHz + 3 kHz, per-stream
    amplitude 0.6-1.0) at batch 2, within TOL 1e-2 from valid_from."""
    t, n, batch = 4, WFM_AUDIO_CHUNK, 2
    idx = np.arange(t * n)
    a = (0.4 * np.sin(2 * np.pi * (idx % 48) / 48.0)
         + 0.2 * np.sin(2 * np.pi * (idx % 16) / 16.0)).astype(np.float32)
    amp = np.linspace(0.6, 1.0, batch).astype(np.float32)
    xs = (amp[:, None] * a[None, :]).astype(np.complex64).reshape(
        batch, t, n).transpose(1, 0, 2)
    jb, _, want, tb, _, got = run_both(jwfm_transmitter(), wfm_transmitter(),
                                       xs, WFM_AUDIO_RATE)
    assert tb.out_sig.chunk_len == WFM_INPUT_CHUNK == jb.out_sig.chunk_len
    assert tb.out_sig.sample_rate == WFM_INPUT_RATE
    v = tb.valid_from
    assert v == jb.valid_from
    np.testing.assert_allclose(got[v:], want[v:], atol=TX_TOL)
    np.testing.assert_allclose(np.abs(got[v + 1:]), 1.0, atol=1e-3)


def test_wfm_tx_rx_roundtrip():
    """wfm_transmitter -> wfm_receiver recovers a 1 kHz audio tone (the
    JAX package's round trip, tests/test_models.py)."""
    t_chunks, n = 8, WFM_AUDIO_CHUNK
    t = np.arange(t_chunks * n) / WFM_AUDIO_RATE
    amp = 0.3
    chunks = (amp * np.sin(2 * np.pi * 1000.0 * t)).astype(
        np.complex64).reshape(t_chunks, 1, n)
    tx = wfm_transmitter().bind(StreamSig(1, n, WFM_AUDIO_RATE))
    _, iq = scan(tx, tree_to_torch(tx.params, "cpu"),
                 tree_to_torch(tx.init_state(), "cpu"),
                 torch.from_numpy(chunks))
    np.testing.assert_allclose(iq[2:].abs().numpy(), 1.0, atol=1e-3)
    rx = wfm_receiver().bind(StreamSig(1, WFM_INPUT_CHUNK, WFM_INPUT_RATE))
    _, ys = scan(rx, tree_to_torch(rx.params, "cpu"),
                 tree_to_torch(rx.init_state(), "cpu"), iq)
    settled = ys[:, 0, :].reshape(-1).real.numpy()[3 * n:]
    win = np.hanning(len(settled))
    spec = np.abs(np.fft.rfft(settled * win))
    freqs = np.fft.rfftfreq(len(settled), 1 / WFM_AUDIO_RATE)
    assert abs(freqs[np.argmax(spec)] - 1000.0) < 30.0
    assert spec[np.abs(freqs - 1000.0) > 100.0].max() < 0.1 * spec.max()
    tone_amp = 2 * spec.max() / np.sum(win)
    assert 0.05 < tone_amp / amp < 20.0
