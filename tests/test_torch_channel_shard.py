"""The port's channel sharding (``parallel/channel_shard.py``) on CPU
tensors against the JAX package's ``ChannelShardedChain`` on its virtual
CPU devices, and against the port's own sequential scan, on the same
seeded inputs, at the JAX tests' tolerance (``tests/test_channel_shard.py``:
atol 5e-4, on rows with signal energy where the chain demodulates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parallel import (CPU, J, P, interpret_pallas_highest,  # noqa: F401
                            lowpass, make_iq, seq_port)
from radiorust_tpu.parallel.channel_shard import \
    ChannelShardedChain as JChannelShardedChain
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.parallel.channel_shard import ChannelShardedChain
from radiorust_tpu_torch.parallel.mesh import make_mesh

ATOL = 5e-4


def drive_port(cs, xs, resets=None):
    state = tree_to_torch(cs.init_state(), CPU)
    params = tree_to_torch(cs.params, CPU)
    outs = []
    for s in range(xs.shape[0]):
        r = None if resets is None else torch.from_numpy(resets[s])
        state, y = cs.process(params, state, torch.from_numpy(xs[s]), r)
        outs.append(y.numpy())
    return np.stack(outs), state


def drive_jax(cs, xs, resets=None):
    state = cs.init_state()
    outs = []
    for s in range(xs.shape[0]):
        r = None if resets is None else resets[s]
        state, y = cs.process(cs.params, state, jnp.asarray(xs[s]), r)
        outs.append(np.asarray(y))
    return np.stack(outs)


def _pair(make, sig, xs, ndev=4, resets=None, stream_axis=None):
    """(port sharded, JAX sharded, port sequential)."""
    pb = make(P).bind(P.StreamSig(*sig))
    jb = make(J).bind(J.StreamSig(*sig))
    if stream_axis:
        pm = make_mesh((2, ndev), ("s", "c"), "cpu")
        jm = JMesh(np.array(jax.devices()[:2 * ndev]).reshape(2, ndev),
                   ("s", "c"))
    else:
        pm = make_mesh((ndev,), ("c",), "cpu")
        jm = JMesh(np.array(jax.devices()[:ndev]), ("c",))
    got, _ = drive_port(ChannelShardedChain(pb, pm, axis="c",
                                            stream_axis=stream_axis), xs,
                        resets)
    want = drive_jax(JChannelShardedChain(jb, jm, axis="c",
                                          stream_axis=stream_axis), xs,
                     resets)
    return got, want, seq_port(pb, xs, resets)


def _rx(L):
    return L.channelized_receiver(num_channels=64, input_rate=1024000.0)


def _energetic(want):
    # Demod of a near-empty channel is atan2 noise: rows with energy only.
    return np.abs(want).mean(axis=(0, 2)) > 1e-3


@pytest.mark.parametrize("ndev", [8, 4])
def test_channel_sharded_receiver(ndev):
    """PFB -> per-channel FM demod -> gain over a channel mesh."""
    xs = make_iq(3, 2, 1024, seed=1)
    got, want, seq = _pair(_rx, (2, 1024, 1024000.0), xs, ndev)
    assert got.shape == want.shape == (3, 2 * 64, 16)
    rows = _energetic(seq)
    np.testing.assert_allclose(got[:, rows], want[:, rows], atol=ATOL)
    np.testing.assert_allclose(got[:, rows], seq[:, rows], atol=ATOL)


@pytest.mark.parametrize("stream_axis", [None, "s"], ids=["1d", "2d"])
def test_channel_sharded_reset_mask(stream_axis):
    """Per-stream resets reach the sharded channel rows as in the chain;
    ``stream_axis`` splits the streams over a second mesh axis (a 2 x 4
    streams x channels tile)."""
    xs = make_iq(3, 4, 1024, seed=2 if stream_axis is None else 4)
    resets = np.zeros((3, 4), bool)
    resets[1, 0] = True
    resets[2, 3] = True
    got, want, seq = _pair(_rx, (4, 1024, 1024000.0), xs, resets=resets,
                           stream_axis=stream_axis)
    rows = _energetic(seq)
    np.testing.assert_allclose(got[:, rows], want[:, rows], atol=ATOL)
    np.testing.assert_allclose(got[:, rows], seq[:, rows], atol=ATOL)


def _random_downstream(L, rng, ch_rate, ch_n):
    """A random batch-preserving per-channel composition after the PFB
    (test_channel_shard.py's)."""
    specs, n_down = [], 0
    rate, n = ch_rate, ch_n
    for _ in range(int(rng.integers(2, 5))):
        kind = rng.choice(["shift", "filter", "gain", "demod", "mod",
                           "down"])
        if kind == "shift":
            specs.append(L.FreqShifter.with_shift(float(rate) / 16.0))
        elif kind == "filter":
            specs.append(L.Filter.new(lowpass(rate / 4.0)))
        elif kind == "gain":
            specs.append(L.GainControl(1.5))
        elif kind == "demod":
            specs.append(L.FmDemod(rate / 8.0))
        elif kind == "mod":
            specs.append(L.FmMod(rate / 8.0))
        elif n_down >= 1 or n < 32:
            specs.append(L.GainControl(0.5))
        else:
            specs.append(L.Downsampler(rate / 2.0, rate / 4.0))
            rate, n = rate / 2.0, n // 2
            n_down += 1
    return specs


@pytest.mark.parametrize("seed", ["shift_gain", 0, 1, 2, 3])
def test_channel_sharded_downstream_state(seed):
    """Stateful per-channel blocks after the PFB keep their sharded state
    aligned with their channel rows across steps: a FreqShifter's phase
    index, and random compositions (filters, resamplers, mod/demod)."""
    m, n, rate = 16, 1024, 16000.0
    if seed == "shift_gain":
        n, rate = 256, 16000.0

        def make(L):
            return L.Chain(L.Channelizer(m, taps_per_branch=4),
                           L.FreqShifter.with_shift(100.0),
                           L.GainControl(0.5))
    else:
        def make(L):
            rng = np.random.default_rng(seed)
            return L.Chain(L.Channelizer(m, taps_per_branch=4),
                           *_random_downstream(L, rng, rate / m, n // m))
    xs = make_iq(3, 1, n, seed=3 if seed == "shift_gain" else seed + 30)
    got, want, seq = _pair(make, (1, n, rate), xs, ndev=8)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, seq, atol=ATOL)


def test_channel_sharded_state_layout():
    """The executor's state keeps the per-channel leaves ``[batch, M,
    ...]``; ``state_to_chain`` / ``state_from_chain`` convert to the
    chain's layout and back, and the converted final state equals the
    sequential scan's."""
    bound = _rx(P).bind(P.StreamSig(2, 1024, 1024000.0))
    cs = ChannelShardedChain(bound, make_mesh((4,), ("c",), "cpu"))
    xs = make_iq(2, 2, 1024, seed=5)
    _, state = drive_port(cs, xs)
    chain_state = cs.state_to_chain(state)
    ref_state, _ = P.scan(bound, tree_to_torch(bound.params, CPU),
                          tree_to_torch(bound.init_state(), CPU),
                          torch.from_numpy(xs))
    for a, b in zip(jax.tree.leaves(chain_state),
                    jax.tree.leaves(tree_to_numpy(ref_state))):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)
    back = cs.state_from_chain(chain_state)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(tree_to_numpy(state))):
        np.testing.assert_array_equal(a, b)
    assert tree_to_numpy(state)[1]["prev"].shape == (2, 64)


def test_channel_sharded_validation():
    mesh = make_mesh((8,), ("c",), "cpu")
    sig = P.StreamSig(1, 256, 16000.0)
    plain = P.Chain(P.GainControl(1.0), P.FmDemod(1000.0)).bind(sig)
    with pytest.raises(ValueError, match="first block is a Channelizer"):
        ChannelShardedChain(plain, mesh, axis="c")
    small = P.Chain(P.Channelizer(4, taps_per_branch=2)).bind(
        P.StreamSig(1, 64, 8000.0))
    with pytest.raises(ValueError, match="not divisible"):
        ChannelShardedChain(small, mesh, axis="c")
    with pytest.raises(ValueError, match="stream batch"):
        ChannelShardedChain(
            _rx(P).bind(P.StreamSig(3, 1024, 1024000.0)),
            make_mesh((2, 4), ("s", "c"), "cpu"), axis="c", stream_axis="s")
