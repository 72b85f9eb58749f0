"""What the parallel layer's tests share: both packages' blocks by name,
seeded inputs, and the time-sharded executors of both driven over the
same groups of chunks (the JAX package's on the conftest's virtual CPU
devices, the port's on a mesh of repeated ``cpu`` entries)."""

import importlib
from types import SimpleNamespace

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.parallel.mesh import make_mesh

RATE = 1024000.0
CPU = torch.device("cpu")
ATOL = 2e-4           # tests/test_parallel.py's bounds: any chain,
FM_ATOL = 5e-4        # and FM chains from chunk 2
D, STEPS = 4, 3       # shards, group steps

_NAMES = {
    "blocks.base": ("Chain", "StreamSig", "scan"),
    "blocks.analysis": ("Fourier",),
    "blocks.chunks": ("Overlapper",),
    "blocks.channelize": ("Channelizer",),
    "blocks.filters": ("Filter", "SlewRateLimiter"),
    "blocks.frontend": ("MixerDecimator", "FmDemodFilter"),
    "blocks.graph": ("Graph", "graph_scan"),
    "blocks.modulation": ("FmDemod", "FmMod"),
    "blocks.resampling": ("Downsampler", "Upsampler"),
    "blocks.transform": ("FreqShifter", "GainControl", "MapSample",
                         "Squelch", "AgcControl"),
    "models.analog": ("_envelope", "am_receiver"),
    "models.channelizer": ("channelized_receiver",),
    "models.morse_tx": ("morse_audio_chain",),
    "models.wfm": ("wfm_receiver", "wfm_receiver_graph",
                   "_deemphasis_band"),
}


def lib(pkg: str) -> SimpleNamespace:
    """The names of ``_NAMES`` from ``radiorust_tpu`` or
    ``radiorust_tpu_torch``."""
    ns = {}
    for mod, names in _NAMES.items():
        m = importlib.import_module(f"{pkg}.{mod}")
        ns.update({n.lstrip("_"): getattr(m, n) for n in names})
    return SimpleNamespace(**ns)


J = lib("radiorust_tpu")
P = lib("radiorust_tpu_torch")


@pytest.fixture(autouse=True)
def interpret_pallas_highest(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode and its matmuls
    at full float32 precision (its default 'high' mode is a TPU bf16
    split)."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pfe.pl, "pallas_call", interp)
    monkeypatch.setattr(pfl.pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


def lowpass(cut):
    def resp(bins, freqs):
        return np.where(np.abs(freqs) <= cut, 1.0 + 0.0j, 0.0j)
    return resp


def make_iq(t, batch, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, batch, n))
            + 1j * rng.standard_normal((t, batch, n))).astype(np.complex64)


def fm_iq(t_chunks, n, streams=2, rate=RATE):
    """[T, streams, n] FM of a 1 kHz tone at 150 kHz deviation (smooth
    input: the demod of noise is chaotic through the warm-up)."""
    t = np.arange(t_chunks * n) / rate
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / rate * np.cumsum(audio)))
    xs = np.stack([iq * np.exp(0.5j * k) for k in range(streams)])
    return np.moveaxis(xs.astype(np.complex64).reshape(streams, t_chunks, n),
                       1, 0)


def group(xs, s, d):
    """Group step s of chunks [T, b, n]: [b, d*n]."""
    g = xs[s * d:(s + 1) * d]
    return np.ascontiguousarray(np.moveaxis(g, 0, 1).reshape(
        g.shape[1], -1))


def ungroup(y, d, out_b, out_n):
    """[out_b, d*out_n] -> [d, out_b, out_n]."""
    return np.moveaxis(np.asarray(y).reshape(out_b, d, out_n), 1, 0)


def port_mesh(shape=(4,), names=("t",)):
    return make_mesh(shape, names, "cpu")


def run_port(bound, xs, d, steps, mesh=None, ch_axis=None, overlap=1,
             between=None):
    """The port's TimeShardedChain over ``steps`` groups of ``d`` chunks:
    [T, b, n] numpy.  ``between(s, ts, state) -> state`` runs before
    group s (a live retune)."""
    from radiorust_tpu_torch.parallel.time_shard import TimeShardedChain
    mesh = port_mesh() if mesh is None else mesh
    ts = TimeShardedChain(bound, mesh, ch_axis=ch_axis, overlap=overlap)
    state = tree_to_torch(ts.init_state(), CPU)
    outs = []
    for s in range(steps):
        if between is not None:
            state = tree_to_torch(between(s, ts, state), CPU)
        x = torch.from_numpy(group(xs, s, d))
        state, y = ts.process(tree_to_torch(ts.params, CPU), state, x)
        outs.append(ungroup(y.numpy(), d, bound.out_sig.batch,
                            bound.out_sig.chunk_len))
    return np.concatenate(outs)


def run_jax(bound, xs, d, steps, mesh=None, ch_axis=None, overlap=1,
            between=None):
    """The JAX package's TimeShardedChain on its virtual CPU devices."""
    from radiorust_tpu.parallel.time_shard import TimeShardedChain
    mesh = jax.make_mesh((d,), ("t",)) if mesh is None else mesh
    ts = TimeShardedChain(bound, mesh, ch_axis=ch_axis, overlap=overlap)
    state = ts.init_state()
    outs = []
    for s in range(steps):
        if between is not None:
            state = between(s, ts, state)
        state, y = ts.process(ts.params, state, jnp.asarray(group(xs, s, d)))
        outs.append(ungroup(y, d, bound.out_sig.batch,
                            bound.out_sig.chunk_len))
    return np.concatenate(outs)


def seq_port(bound, xs, resets=None):
    """The port's sequential scan of the bound chain: [T, b, n] numpy."""
    _, ys = P.scan(bound, tree_to_torch(bound.params, CPU),
                   tree_to_torch(bound.init_state(), CPU),
                   torch.from_numpy(xs),
                   None if resets is None else torch.from_numpy(resets))
    return ys.numpy()


def both(make, sig, xs, d=D, steps=STEPS, **kw):
    """(port sharded, JAX sharded, port sequential) of one chain built by
    ``make(package names)``."""
    pb = make(P).bind(P.StreamSig(*sig))
    jb = make(J).bind(J.StreamSig(*sig))
    got = run_port(pb, xs, d, steps, **kw)
    want = run_jax(jb, xs, d, steps, **{k: v for k, v in kw.items()
                                        if k != "mesh"})
    return got, want, seq_port(pb, xs)
