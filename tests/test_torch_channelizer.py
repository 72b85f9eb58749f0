"""The port's channelizer (design, filterbank, the fused PFB + demod block
and ``channelized_receiver``) on CPU tensors against the JAX package's on
the same numpy inputs.

Tolerances: the filterbank atol 1e-5 relative to unit-amplitude tones;
the demodulated channels atol 2e-5 on channels carrying a tone (the JAX
package's fused-vs-unfused channelizer bound).  Empty channels
demodulate float32 noise, which is chaotic in any implementation
(``blocks/channelize.py``): there only finiteness is checked.
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_channelizer as pch
from radiorust_tpu import config
from radiorust_tpu.blocks.base import StreamSig as JSig
from radiorust_tpu.blocks.base import scan as jscan
from radiorust_tpu.models.channelizer import \
    channelized_receiver as jchannelized_receiver
from radiorust_tpu.ops.channelizer import design_prototype as jdesign
from radiorust_tpu.ops.channelizer import pfb_channelize as jpfb
from radiorust_tpu_torch.blocks.base import StreamSig, scan
from radiorust_tpu_torch.blocks.channelize import ChannelizerDemod
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.models.channelizer import channelized_receiver
from radiorust_tpu_torch.ops import channelizer as tch

RATE = 16384000.0
M = 64
OCCUPIED = (1, 5, 20, 41)
ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pch.pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


def fm_channels(t_chunks, batch, n, channels=OCCUPIED):
    """[T, batch, n] complex64: an FM tone at the centre of each occupied
    channel (its own audio rate and phase per stream), float64 synthesis."""
    tt = np.arange(t_chunks * n)
    x = np.zeros((batch, t_chunks * n), np.complex128)
    for s in range(batch):
        for c in channels:
            audio = np.sin(2 * np.pi * (3 + c + s) * tt / n + s)
            x[s] += np.exp(1j * (2 * np.pi * c * tt / M
                                 + 0.05 * np.cumsum(audio)))
    return (x.astype(np.complex64).reshape(batch, t_chunks, n)
            .transpose(1, 0, 2))


def test_design_prototype_is_jax_exactly():
    for m, k in ((64, 8), (16, 4), (8, 1)):
        np.testing.assert_array_equal(tch.design_prototype(m, k),
                                      jdesign(m, k))


def test_pfb_channelize_matches_jax():
    k, n = 8, 2048
    rng = np.random.default_rng(70)
    xp = (rng.standard_normal((2, (k - 1) * M + n))
          + 1j * rng.standard_normal((2, (k - 1) * M + n))).astype(
              np.complex64)
    taps = jdesign(M, k).reshape(k, M).astype(np.float32)
    want = np.asarray(jpfb(jnp.asarray(xp), jnp.asarray(taps), M))
    got = tch.pfb_channelize(torch.from_numpy(xp), torch.from_numpy(taps), M)
    assert got.shape == want.shape == (2, M, n // M)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _run(fuse, resets, xs, params=None, jax=False):
    sig = (2, xs.shape[-1], RATE)
    if jax:
        b = jchannelized_receiver(fuse=fuse).bind(JSig(*sig))
        _, ys = jscan(b, b.params, b.init_state(), jnp.asarray(xs),
                      jnp.asarray(resets))
        return b, np.asarray(ys)
    b = channelized_receiver(fuse=fuse).bind(StreamSig(*sig))
    params = tree_to_torch(b.params if params is None else params, "cpu")
    _, ys = scan(b, params, tree_to_torch(b.init_state(), "cpu"),
                 torch.from_numpy(xs), torch.from_numpy(resets))
    return b, ys.numpy()


def _occupied(ys):
    """[T, b*M, t] -> the occupied channels' rows [T, b, len(OCCUPIED), t]."""
    t_, rows, n = ys.shape
    return ys.reshape(t_, rows // M, M, n)[:, :, list(OCCUPIED)]


@pytest.mark.parametrize("fuse", [False, True])
def test_channelized_receiver_matches_jax(fuse):
    xs = fm_channels(3, 2, 8192)
    resets = np.zeros((3, 2), bool)
    resets[2, 0] = True                      # a break on stream 0
    jb, want = _run(fuse, resets, xs, jax=True)
    tb, got = _run(fuse, resets, xs, params=jb.params)
    assert got.shape == want.shape == (3, 2 * M, 8192 // M)
    assert tb.out_sig.sample_rate == jb.out_sig.sample_rate
    np.testing.assert_allclose(_occupied(got), _occupied(want), atol=ATOL)
    assert np.abs(_occupied(want)).max() > 0.01   # the tones carry signal
    assert np.isfinite(got).all() and np.all(got.imag == 0)


def test_channelizer_fused_equals_unfused():
    xs = fm_channels(3, 2, 8192)
    resets = np.zeros((3, 2), bool)
    resets[1, 1] = True
    _, fused = _run(True, resets, xs)
    _, plain = _run(False, resets, xs)
    np.testing.assert_allclose(_occupied(fused), _occupied(plain),
                               atol=ATOL)


def test_channelizer_demod_refuses_at_bind():
    with pytest.raises(ValueError, match="constraints"):
        ChannelizerDemod(32, 1000.0).bind(StreamSig(1, 4096, RATE))
    with pytest.raises(ValueError, match="divisible"):
        ChannelizerDemod(64, 1000.0).bind(StreamSig(1, 4000, RATE))
