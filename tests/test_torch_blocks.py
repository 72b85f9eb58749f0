"""Block-level parity of the port's slice blocks on CPU tensors against the
JAX package's, on the same numpy inputs and params, including interrupt
resets, realness propagation and geometries the kernels do not take.

Tolerances: 1e-6 for the mixer (float32 products in the same order),
5e-5 for FIR outputs and 2e-5 for filters, as the JAX package's own
block tests."""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu.blocks import base as jbase
from radiorust_tpu.blocks import filters as jfilters
from radiorust_tpu.blocks import frontend as jfrontend
from radiorust_tpu.blocks import modulation as jmod
from radiorust_tpu.blocks import resampling as jres
from radiorust_tpu.blocks import transform as jtr
from radiorust_tpu.models.wfm import _deemphasis_band, _lowpass_100k
from radiorust_tpu_torch.blocks import base as tbase
from radiorust_tpu_torch.blocks import filters as tfilters
from radiorust_tpu_torch.blocks import frontend as tfrontend
from radiorust_tpu_torch.blocks import modulation as tmod
from radiorust_tpu_torch.blocks import resampling as tres
from radiorust_tpu_torch.blocks import transform as ttr
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.ops import _build
from radiorust_tpu_torch.ops import frontend as _ofront


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


def fm_chunks(batch, t_chunks, n, seed):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(rng.standard_normal((batch, t_chunks * n)) * 0.3, axis=-1)
    x = np.exp(1j * ph).astype(np.complex64)
    return x.reshape(batch, t_chunks, n).transpose(1, 0, 2).copy()


def run_both(jspecs, tspecs, sig, xs, resets=None, real_input=False):
    jb = jbase.Chain(*jspecs).bind(jbase.StreamSig(*sig))
    tb = tbase.Chain(*tspecs).bind(tbase.StreamSig(*sig))
    if real_input:
        jb.input_is_real = tb.input_is_real = True
    if resets is None:
        resets = np.zeros(xs.shape[:2], bool)
    _, want = jbase.scan(jb, jb.params, jb.init_state(), jnp.asarray(xs),
                         jnp.asarray(resets))
    _, got = tbase.scan(tb, tree_to_torch(jb.params, "cpu"),
                        tree_to_torch(jb.init_state(), "cpu"),
                        torch.from_numpy(xs), torch.from_numpy(resets))
    return tb, got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n,shift", [(1000, 12345.0), (24576, -100e3)])
def test_freq_shifter_matches(n, shift):
    xs = fm_chunks(2, 3, n, 1)
    _, got, want = run_both([jtr.FreqShifter.with_shift(shift)],
                            [ttr.FreqShifter.with_shift(shift)],
                            (2, n, 1024000.0), xs)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("rates,n,real", [
    ((1024000.0, 384000.0, 200000.0), 2048, False),
    ((384000.0, 48000.0, 40000.0), 6144, True),
    # p = 160, q = 147: the decimation kernel's wide form on CUDA.
    ((48000.0, 44100.0, 20000.0), 1600, False),
    ((48000.0, 44100.0, 20000.0), 1600, True),
])
def test_downsampler_and_gain_match(rates, n, real):
    xs = fm_chunks(2, 3, n, 2)
    if real:
        xs = (xs.real + 0j).astype(np.complex64)
    tb, got, want = run_both(
        [jres.Downsampler(*rates[1:]), jtr.GainControl(0.7)],
        [tres.Downsampler(*rates[1:]), ttr.GainControl(0.7)],
        (2, n, rates[0]), xs, real_input=real)
    assert tb.output_is_real == real
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("n,ir_len", [
    (1536, None),   # kernel geometry: 3072 = 24 x 128
    (2048, 512),    # decoupled kernel geometry
    (1000, None),   # 2000 = 125 x 16: 16-point rows
    (1001, None),   # 2002 = 1001 x 2: 2-point rows, 1001-point columns
    (10001, None),  # 20002 = 10001 x 2: columns past a one-column strip
])
def test_filter_matches(n, ir_len):
    xs = fm_chunks(4, 3, n, 3)
    tb, got, want = run_both([jfilters.Filter.new(_lowpass_100k,
                                                  ir_len=ir_len)],
                             [tfilters.Filter.new(_lowpass_100k,
                                                  ir_len=ir_len)],
                             (4, n, 384000.0), xs)
    assert tb.blocks[0].kernel_geometry
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-5 * peak)


def test_filter_update_params_matches_jax_and_retunes():
    # The redesigned response is the JAX package's bit for bit, and a step
    # with the new params tensor uses it (the response-grid cache follows
    # the tensor it is handed).
    n = 1536
    sig = (2, n, 384000.0)
    narrow = lambda bins, freqs: np.where(np.abs(freqs) <= 50000.0, 1 + 0j,
                                          0j)
    jb = jfilters.Filter.new(_lowpass_100k).bind(jbase.StreamSig(*sig))
    tb = tfilters.Filter.new(_lowpass_100k).bind(tbase.StreamSig(*sig))
    want = jb.update_params(narrow)
    got = tb.update_params(narrow)
    np.testing.assert_array_equal(got["response"], want["response"])
    fresh = tfilters.Filter.new(narrow).bind(tbase.StreamSig(*sig))
    np.testing.assert_array_equal(got["response"], fresh.params["response"])
    x = torch.from_numpy(fm_chunks(2, 1, n, 5)[0])
    state = tree_to_torch(tb.init_state(), "cpu")
    reset = tbase.no_reset(2)
    _, y_wide = tb.process(tree_to_torch(tb.params, "cpu"), state, x, reset)
    _, y_narrow = tb.process(tree_to_torch(got, "cpu"), state, x, reset)
    _, y_fresh = fresh.process(tree_to_torch(fresh.params, "cpu"), state, x,
                               reset)
    np.testing.assert_array_equal(y_narrow.numpy(), y_fresh.numpy())
    assert np.abs(y_narrow.numpy() - y_wide.numpy()).max() > 1e-2


def test_demod_then_filter_with_resets_matches():
    # FmDemod makes the stream real, so the Filter pair-packs; a reset at
    # step 2 on stream 1 exercises both blocks' interrupt handling.
    n = 1536
    xs = fm_chunks(2, 4, n, 4)
    resets = np.zeros((4, 2), bool)
    resets[2, 1] = True
    tb, got, want = run_both(
        [jmod.FmDemod(150000.0),
         jfilters.Filter.new_rectangular(_deemphasis_band)],
        [tmod.FmDemod(150000.0),
         tfilters.Filter.new_rectangular(_deemphasis_band)],
        (2, n, 384000.0), xs, resets)
    assert tb.blocks[1].input_is_real and tb.output_is_real
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_fm_demod_filter_with_resets_matches():
    n = 1536
    xs = fm_chunks(4, 4, n, 5)
    resets = np.zeros((4, 4), bool)
    resets[2, 1] = resets[3, 2] = True
    _, got, want = run_both(
        [jfrontend.FmDemodFilter(150000.0, _deemphasis_band)],
        [tfrontend.FmDemodFilter(150000.0, _deemphasis_band)],
        (4, n, 384000.0), xs, resets)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_mixer_decimator_matches_and_retunes():
    n = 2048
    xs = fm_chunks(2, 3, n, 6)
    sig = (2, n, 1024000.0)
    tb, got, want = run_both(
        [jfrontend.MixerDecimator(100e3, 384000.0, 200000.0)],
        [tfrontend.MixerDecimator(100e3, 384000.0, 200000.0)], sig, xs)
    np.testing.assert_allclose(got, want, atol=5e-5)
    # Retune: numpy params and a folded phase state, as the JAX package's.
    jb = jfrontend.MixerDecimator(100e3, 384000.0, 200000.0).bind(
        jbase.StreamSig(*sig))
    state = {**jb.init_state(), "k0": np.array([5, 7], np.int32)}
    jp, js = jb.retune(jb.params, state, 55e3)
    tp, ts = tb.blocks[0].retune(tb.params[0], state, 55e3)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])


# The JAX package's MixerDecimator plans that the port runs on the wide
# form of its mixer kernel: (output rate, bandwidth, input rate, chunk),
# each at a chunk the JAX package takes (a 128-sample oscillator block and
# its super-row rule).  2.048 Msps -> 12 and 8 kHz carry 6143 history
# samples, more than a chunk of 1024.
WIDE_MIXER_PLANS = {
    "2.048 Msps to 240 kHz": (240e3, 200e3, 2.048e6, 2048),
    "1.024 Msps to 200 kHz": (200e3, 150e3, 1.024e6, 2048),
    "2.048 Msps to 12 kHz": (12e3, 10e3, 2.048e6, 1024),
    "2.048 Msps to 8 kHz": (8e3, 6e3, 2.048e6, 1024),
    "48 kHz to 44.1 kHz": (44100.0, 20e3, 48e3, 1280),
    "96 kHz to 44.1 kHz": (44100.0, 20e3, 96e3, 1280),
    "192 kHz to 44.1 kHz": (44100.0, 20e3, 192e3, 1280),
}


def _retuned_run(lib, chain, xs, params, state, new_shift):
    """Two chunks, a phase-continuous retune of every block that has one
    (numpy trees), then the third chunk; the outputs stacked."""
    from radiorust_tpu_torch.convert import tree_to_numpy
    if lib is jbase:
        run = lambda p, s, x: jbase.scan(chain, p, s, jnp.asarray(x))
        host = lambda t: jax.tree.map(np.asarray, t)
    else:
        run = lambda p, s, x: tbase.scan(chain, tree_to_torch(p, "cpu"),
                                         tree_to_torch(s, "cpu"),
                                         torch.from_numpy(x))
        host = tree_to_numpy
    st, y1 = run(params, state, xs[:2])
    ps, ss = list(params), list(host(st))
    for i, blk in enumerate(chain.blocks):
        if hasattr(blk, "retune"):
            ps[i], ss[i] = blk.retune(ps[i], ss[i], new_shift)
    _, y2 = run(tuple(ps), tuple(ss), xs[2:])
    return np.concatenate([np.asarray(y1), np.asarray(y2)])


@pytest.mark.parametrize("name,tail", [
    *((name, False) for name in WIDE_MIXER_PLANS),
    ("2.048 Msps to 240 kHz", True), ("2.048 Msps to 12 kHz", True),
    ("48 kHz to 44.1 kHz", True)])
def test_mixer_decimator_wide_plans_match_and_retune(name, tail):
    """The plans the port's mixer runs on its wide form bind in both
    packages and agree (the port's plain version, the JAX package's
    Pallas kernel in interpret mode) over 3 chunks at batch 2 with a
    retune after the second, within the FIR outputs' 5e-5; with
    ``tail`` the slice as a whole, ``Chain(MixerDecimator,
    GainControl)``.  The input is a narrow FM walk at ``bw / 40`` a
    sample, shifted by an eighth of the bandwidth (then by 3/16): it
    stays in the passband, so the output carries the signal."""
    out, bw, rate, n = WIDE_MIXER_PLANS[name]
    shift, sig = bw / 8, (2, n, rate)
    rng = np.random.default_rng(11)
    walk = rng.standard_normal((2, 3 * n)) * (2 * np.pi * bw / 40 / rate)
    xs = np.exp(1j * np.cumsum(walk, -1)).astype(np.complex64).reshape(
        2, 3, n).transpose(1, 0, 2).copy()
    specs = lambda L, T: [L.MixerDecimator(shift, out, bw)] + (
        [T.GainControl(0.5)] if tail else [])
    jb = jbase.Chain(*specs(jfrontend, jtr)).bind(jbase.StreamSig(*sig))
    tb = tbase.Chain(*specs(tfrontend, ttr)).bind(tbase.StreamSig(*sig))
    mix = tb.blocks[0]
    assert not _ofront.fits_block(mix.plan.p, mix.plan.q,
                                  mix.plan.kernel.shape[-1])
    sig_of = lambda s: (s.batch, s.chunk_len, s.sample_rate)
    assert sig_of(tb.out_sig) == sig_of(jb.out_sig)
    want = _retuned_run(jbase, jb, xs, jb.params, jb.init_state(),
                        1.5 * shift)
    got = _retuned_run(tbase, tb, xs, jb.params, jb.init_state(),
                       1.5 * shift)
    assert got.shape == want.shape == (3, 2, mix.out_sig.chunk_len)
    assert np.abs(want[1:]).mean() > 0.2     # the signal passed
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_fused_blocks_reject_geometries_their_kernel_does_not_take():
    with pytest.raises(ValueError, match="even batch"):
        tfrontend.FmDemodFilter(150000.0, _deemphasis_band).bind(
            tbase.StreamSig(3, 1536, 384000.0))
    # 20002 = 10001 x 2: a column past a one-column strip, which the
    # device-memory column route takes (the JAX package refuses chunk
    # 10001 for its lane rule: a known divergence).
    bound = tfrontend.FmDemodFilter(150000.0, _deemphasis_band).bind(
        tbase.StreamSig(2, 10001, 384000.0))
    assert bound.params["response"].shape == (20002,)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfrontend.MixerDecimator(0.0, 384000.0, 200000.0).bind(
            tbase.StreamSig(2, 1001, 1024000.0))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert _build.build_dir().parent.name == "radiorust_tpu_torch"
