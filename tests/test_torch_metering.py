"""The port's analysis, chunk and metering pieces on CPU tensors against
the JAX package on the same numpy inputs: ``Fourier`` (three windows and
layouts), ``Overlapper`` (with its reset) and ``rechunk``, the six
metering functions, the bandwidth meter (both front ends) within
``TOL["bw_meter"]`` 9e-3 of ``tools/validate_tpu.py`` against the JAX
package in ``highest`` matmul precision, and ``wfm_receiver_graph`` from
each output's ``valid_from`` within 3e-4 (the WFM bound)."""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu import metering as jmeter
from radiorust_tpu.blocks.analysis import Fourier as JFourier
from radiorust_tpu.blocks.base import StreamSig as JSig
from radiorust_tpu.blocks.base import scan as jscan
from radiorust_tpu.blocks.chunks import Overlapper as JOverlapper
from radiorust_tpu.blocks.chunks import rechunk as jrechunk
from radiorust_tpu.blocks.graph import graph_scan as jgraph_scan
from radiorust_tpu.models.bandwidth_meter import \
    bandwidth_meter_chain as jbw_chain
from radiorust_tpu.models.bandwidth_meter import \
    measure_bandwidth as jmeasure
from radiorust_tpu.models.wfm import wfm_receiver_graph as jwfm_graph
from radiorust_tpu.windowing import Kaiser as JKaiser
from radiorust_tpu_torch import metering as tmeter
from radiorust_tpu_torch.blocks.analysis import Fourier
from radiorust_tpu_torch.blocks.base import StreamSig, scan
from radiorust_tpu_torch.blocks.chunks import Overlapper, rechunk
from radiorust_tpu_torch.blocks.graph import graph_scan
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.models.bandwidth_meter import (
    bandwidth_meter_chain, measure_bandwidth)
from radiorust_tpu_torch.models.wfm import wfm_receiver_graph
from radiorust_tpu_torch.windowing import Kaiser

BW_TOL = 9e-3
WFM_ATOL = 3e-4
RATE = 1024000.0


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


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def scan_both(jbound, tbound, xs, resets=None):
    js, jy = jscan(jbound, jbound.params, jbound.init_state(),
                   jnp.asarray(xs),
                   None if resets is None else jnp.asarray(resets))
    ts, ty = scan(tbound, tree_to_torch(tbound.params, "cpu"),
                  tree_to_torch(tbound.init_state(), "cpu"),
                  torch.from_numpy(xs),
                  None if resets is None else torch.from_numpy(resets))
    return np.asarray(jy), ty.numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("form", ["plain", "window", "center_dc",
                                  "window_center_dc"])
def test_fourier_matches_jax(form):
    n = 257 if form == "center_dc" else 256
    makers = {"plain": lambda m, w: m(),
              "window": lambda m, w: m.with_window(w),
              "center_dc": lambda m, w: m.new_center_dc(),
              "window_center_dc": lambda m, w: m.with_window_center_dc(w)}
    jb = makers[form](JFourier, JKaiser.with_null_at_bin(3.0)).bind(
        JSig(3, n, 1000.0))
    tb = makers[form](Fourier, Kaiser.with_null_at_bin(3.0)).bind(
        StreamSig(3, n, 1000.0))
    np.testing.assert_array_equal(tb.window_values, np.asarray(
        jb.window_values))
    xs = noise((2, 3, n), seed=n)
    want, got = scan_both(jb, tb, xs)
    assert got.dtype == np.complex64
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("count", [1, 3])
def test_overlapper_matches_jax(count):
    xs = noise((6, 2, 16), seed=count)
    resets = np.zeros((6, 2), bool)
    resets[3, 1] = True    # an event clears stream 1's history
    jb = JOverlapper(count).bind(JSig(2, 16, 1.0))
    tb = Overlapper(count).bind(StreamSig(2, 16, 1.0))
    assert tb.valid_from == jb.valid_from == count - 1
    assert tb.out_sig.chunk_len == jb.out_sig.chunk_len == 16 * count
    want, got = scan_both(jb, tb, xs, resets)
    np.testing.assert_array_equal(got, want)
    if count > 1:
        assert np.all(got[3, 1, :16 * (count - 1)] == 0)
    with pytest.raises(ValueError):
        Overlapper(0)


def test_rechunk_matches_jax():
    xs = noise((6, 2, 10), seed=1)
    np.testing.assert_array_equal(rechunk(torch.from_numpy(xs), 15).numpy(),
                                  np.asarray(jrechunk(jnp.asarray(xs), 15)))
    with pytest.raises(ValueError):
        rechunk(torch.from_numpy(xs), 7)


BINS = [np.zeros(8, complex),
        np.array([1, 1, 1, 1, 1, 1, -1, np.sqrt(0.5) - 1j * np.sqrt(0.5)]),
        np.r_[np.zeros(6), 2.1, 0.0].astype(complex),
        np.array([1.5, 0, 0, 0, 0, 0, 1.5, 0], complex),
        np.array([7.4 - 2.1j] * 3)]


def test_host_metering_equals_jax():
    for bins in BINS + [noise(37, seed=2)]:
        assert tmeter.level(bins) == jmeter.level(bins)
        assert (tmeter.bandwidth(0.01, 48000.0, bins)
                == jmeter.bandwidth(0.01, 48000.0, bins))
        for res in (3, 7, 40):
            np.testing.assert_array_equal(tmeter.rescale_energy(res, bins),
                                          jmeter.rescale_energy(res, bins))


def test_device_metering_matches_jax():
    x = noise((4, 64), seed=3)
    x[:, 20:28] *= 40.0     # the walks end mid-array
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tmeter.level_torch(t).numpy(),
                               np.asarray(jmeter.level_jax(x)), rtol=1e-6)
    for n in (64, 257, 1024):
        bins = noise((5, n), seed=n)
        bins[:, n // 3: n // 3 + 8] *= 40.0
        got = tmeter.bandwidth_torch(0.01, 48000.0, torch.from_numpy(bins))
        want = np.asarray(jmeter.bandwidth_jax(0.01, 48000.0, bins))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    batch = np.stack(BINS[:4]).astype(np.complex64)
    got = tmeter.bandwidth_torch(0.01, 48000.0, torch.from_numpy(batch))
    np.testing.assert_allclose(
        got.numpy(), [tmeter.bandwidth(0.01, 48000.0, b) for b in BINS[:4]],
        rtol=1e-5, atol=1e-2)
    for res in (7, 16, 40):
        np.testing.assert_allclose(
            tmeter.rescale_energy_torch(res, t).numpy(),
            np.asarray(jmeter.rescale_energy_jax(res, x)), rtol=1e-5)


def bw_meter_input(t_chunks, batch, n):
    """validate's bw_meter input: FM tones at +5 and -4 kHz (exact
    integer carrier phases), one phase offset per stream."""
    idx = np.arange(t_chunks * n)
    t = idx.astype(np.float32) / np.float32(RATE)
    x = np.zeros(t_chunks * n, np.complex64)
    for k, audio, amp in ((5, 150.0, 1.0), (1024 - 4, 230.0, 0.7)):
        carrier = ((idx * k) % 1024).astype(np.float32) / 1024.0
        fm = (np.float32(0.3 * 1000.0 / audio)
              * (1.0 - np.cos(2 * np.pi * np.float32(audio) * t)))
        th = (2 * np.pi * carrier + fm).astype(np.float32)
        x = x + amp * np.exp(1j * th).astype(np.complex64)
    ph = np.exp(1j * np.linspace(0.0, 0.5, batch)).astype(np.complex64)
    return (x[None, :] * ph[:, None]).reshape(batch, t_chunks, n).transpose(
        1, 0, 2)


@pytest.mark.parametrize("fuse_frontend", [False, True])
def test_bandwidth_meter_matches_jax(fuse_frontend):
    """validate's bw_meter at batch 2: the spectra from valid_from and the
    bandwidth in hertz within TOL 9e-3 of the JAX package's."""
    t_chunks, batch, n = 6, 2, 10240
    xs = bw_meter_input(t_chunks, batch, n)
    jb = jbw_chain(fuse_frontend=fuse_frontend).bind(JSig(batch, n, RATE))
    tb = bandwidth_meter_chain(fuse_frontend=fuse_frontend).bind(
        StreamSig(batch, n, RATE))
    assert tb.valid_from == jb.valid_from
    assert tb.out_sig.chunk_len == jb.out_sig.chunk_len
    want, got = scan_both(jb, tb, xs)
    v = tb.valid_from
    assert _rel(got[v:], want[v:]) <= BW_TOL
    rate = tb.out_sig.sample_rate
    bw_t = measure_bandwidth(torch.from_numpy(got[v:]), rate).numpy()
    bw_j = np.asarray(jmeasure(jnp.asarray(want[v:]), rate))
    assert np.all(bw_j > 0)
    np.testing.assert_allclose(bw_t, bw_j, rtol=BW_TOL)


def test_wfm_receiver_graph_matches_jax():
    t_chunks, n = 6, 16384
    t = np.arange(t_chunks * n) / RATE
    rows = []
    for f in (900.0, 2100.0):
        audio = 0.5 * np.sin(2 * np.pi * f * t)
        phase = (2 * np.pi * 150000.0 / RATE * np.cumsum(audio)
                 + 2 * np.pi * 100e3 * t)
        rows.append(np.exp(1j * phase).astype(np.complex64))
    xs = np.stack(rows).reshape(2, t_chunks, n).transpose(1, 0, 2)
    jg = jwfm_graph(tune_shift=-100e3).bind({"iq": JSig(2, n, RATE)})
    tg = wfm_receiver_graph(tune_shift=-100e3).bind(
        {"iq": StreamSig(2, n, RATE)})
    assert tg.valid_from == jg.valid_from
    _, want = jgraph_scan(jg, jg.params, jg.init_state(),
                          {"iq": jnp.asarray(xs)})
    _, got = graph_scan(tg, tree_to_torch(tg.params, "cpu"),
                        tree_to_torch(tg.init_state(), "cpu"),
                        {"iq": torch.from_numpy(xs)})
    for name, v in tg.valid_from.items():
        g, w = got[name].numpy()[v:], np.asarray(want[name])[v:]
        assert g.shape == w.shape
        scale = 1.0 if name == "audio" else np.abs(w).max()
        np.testing.assert_allclose(g / scale, w / scale, atol=WFM_ATOL)
    # The spectrum tap: the tuned FM carrier spreads around DC; the
    # +-150 kHz band holds the energy.
    spec = np.abs(got["spectrum"].numpy()[-1, 0]) ** 2
    freqs = np.fft.fftfreq(spec.shape[-1], 1.0 / 384000.0)
    assert (spec[np.abs(freqs) <= 150000.0].sum()
            > 50.0 * spec[np.abs(freqs) > 150000.0].sum())
