"""The port's time sharding (``parallel/time_shard.py``) and sharded steps
(``blocks/base.py::jit_step_sharded``) on CPU tensors, against the JAX
package's on the same seeded inputs: the JAX executors on the conftest's
8 virtual CPU devices, the port's on a mesh of repeated ``cpu`` entries.

Every case is held against the JAX package's executor and against the
port's own sequential scan, at the JAX tests' tolerances
(``tests/test_parallel.py``): atol 2e-4, or 5e-4 from chunk 2 for the FM
chains, whose demod of the zero-primed warm-up is chaotic.  Where the
port's time sharding rebuilds its halos with the plain versions' own
arithmetic it equals its sequential scan bit for bit on the CPU, and
that is held too."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parallel import (ATOL, CPU, D, FM_ATOL, J, P, RATE, STEPS, both,
                            group, interpret_pallas_highest,  # noqa: F401
                            lowpass, make_iq, port_mesh, run_port)
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.parallel.mesh import make_mesh
from radiorust_tpu_torch.parallel.time_shard import TimeShardedChain

SIG = (2, 64, 8000.0)


def _am_band(bins, freqs):
    return np.where((np.abs(bins) >= 1) & (np.abs(freqs) <= 700.0),
                    1.0 + 0.0j, 0.0j)


# The CASES of tests/test_parallel.py, built in either package.
CASES = {
    "shift": lambda L: L.Chain(L.FreqShifter.with_shift(1000.0)),
    "filter": lambda L: L.Chain(L.Filter.new(lowpass(2000.0))),
    "downsample": lambda L: L.Chain(L.Downsampler(1000.0, 400.0)),
    "upsample": lambda L: L.Chain(L.Upsampler(16000.0, 3000.0)),
    "up_then_down": lambda L: L.Chain(L.Upsampler(16000.0, 3000.0),
                                      L.Downsampler(4000.0, 1500.0)),
    "demod": lambda L: L.Chain(L.FmDemod(1000.0)),
    "fmmod": lambda L: L.Chain(L.FmMod(1000.0)),
    "gain": lambda L: L.Chain(L.GainControl(0.5)),
    "mixed": lambda L: L.Chain(L.FreqShifter.with_shift(500.0),
                               L.Filter.new(lowpass(2000.0)),
                               L.FmDemod(1000.0), L.GainControl(2.0)),
    # A multi-hop halo: chunk_count 4 spans 3 neighbour chunks.
    "overlap_fourier": lambda L: L.Chain(L.Overlapper(4), L.Fourier()),
    "overlap_deep": lambda L: L.Chain(L.Overlapper(6)),
    # The envelope's real_output promise survives sharding (the filter
    # after it pair-packs).
    "am_envelope": lambda L: L.Chain(
        L.FreqShifter.with_shift(500.0), L.Downsampler(2000.0, 700.0),
        L.MapSample(L.envelope, real_output=True),
        L.Filter.new_rectangular(_am_band), L.GainControl(0.7)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_time_sharded_matches_jax_and_sequential(name):
    xs = make_iq(STEPS * D, 2, 64, seed=sum(map(ord, name)) % 100)
    got, want, seq = both(CASES[name], SIG, xs)
    assert got.shape == want.shape == seq.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, seq, atol=ATOL)


@pytest.mark.parametrize("overlap", [2, 4])
def test_time_sharded_overlap_sub_batches(overlap):
    """``overlap=S`` walks S sub-batches: bit for bit the overlap=1 run
    (rows never couple), and the JAX package's."""
    sig = (4, 64, 8000.0)
    make = CASES["mixed"]
    xs = make_iq(STEPS * D, 4, 64, seed=7)
    bound = make(P).bind(P.StreamSig(*sig))
    base = run_port(bound, xs, D, STEPS)
    got, want, seq = both(make, sig, xs, overlap=overlap)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, seq, atol=ATOL)


def test_time_sharded_phase_mode_resampler():
    """A phase-mode resampler (chunk 100, not whole periods): each shard's
    grid phase in closed form; the padded layout equals sequential
    stepping."""
    sig = (2, 100, 1024.0)
    xs = make_iq(STEPS * D, 2, 100, seed=31)
    got, want, seq = both(lambda L: L.Chain(L.Downsampler(384.0, 200.0)),
                           sig, xs)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, seq)


def _squelch_input():
    n, t_total = 64, STEPS * D
    t = np.arange(t_total * n)
    on = ((t // 96) % 2 == 0)  # bursts not aligned to chunk/shard edges
    x = on * np.exp(2j * np.pi * 0.03 * t) + 0.01 * np.exp(1j * 0.1 * t)
    xs = np.stack([x, 0.7 * x]).astype(np.complex64)
    return np.moveaxis(xs.reshape(2, t_total, n), 1, 0)


def _agc_input():
    n, t_total = 64, STEPS * D
    t = np.arange(t_total * n)
    # Weak (the gain rises and clamps at max_gain), then loud bursts.
    amp = np.where((t // 160) % 2 == 0, 0.05, 2.0)
    x = (amp * np.exp(2j * np.pi * 0.03 * t)).astype(np.complex64)
    xs = np.stack([x, 0.5 * x]).astype(np.complex64)
    return np.moveaxis(xs.reshape(2, t_total, n), 1, 0)


@pytest.mark.parametrize("name,make,inputs", [
    ("squelch", lambda L: L.Chain(L.Squelch(threshold=0.25, alpha=0.8)),
     _squelch_input),
    ("agc", lambda L: L.Chain(L.AgcControl(reference=1.0, rate=5e-2,
                                           max_gain=4.0)), _agc_input),
], ids=["squelch", "agc"])
def test_time_sharded_prefix_handlers(name, make, inputs):
    """Squelch's affine and AGC's clamped-affine carries shard through an
    exclusive prefix of per-shard maps: the gate and the adapting gain
    match the sequential scan across shard edges."""
    got, want, seq = both(make, SIG, inputs())
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, seq, atol=ATOL)


def _random_chain(L, rng):
    """A random composition with tracked (rate, chunk_len): halo handlers
    composed in orders the fixed cases do not take (test_parallel.py's)."""
    rate, n = 8000.0, 64
    specs, n_down = [], 0
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
    return L.Chain(*specs)


@pytest.mark.parametrize("seed", range(6))
def test_time_sharded_random_chains(seed):
    xs = make_iq(STEPS * D, 2, 64, seed=seed + 50)
    got, want, seq = both(
        lambda L: _random_chain(L, np.random.default_rng(seed)), SIG, xs)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, seq, atol=ATOL)


# -- live retunes (the retuned chains: test_torch_parallel_wfm.py) -----------

def test_time_sharded_retune_requires_shifter():
    ts = TimeShardedChain(P.Chain(P.GainControl(1.0)).bind(
        P.StreamSig(*SIG)), port_mesh())
    with pytest.raises(ValueError, match="no FreqShifter"):
        ts.set_shift(ts.init_state(), 100.0)


# -- rejections ---------------------------------------------------------------

def test_time_sharded_rejections():
    """Kept from the JAX package: the slew limiter's sequential clamp, a
    decimator history longer than the chunk (at construction here; the
    JAX package raises at its first trace), and an overlap that does not
    divide the batch (at the step, as the JAX package's)."""
    mesh = port_mesh()
    with pytest.raises(NotImplementedError, match="time sharding"):
        TimeShardedChain(P.Chain(P.SlewRateLimiter(1000.0)).bind(
            P.StreamSig(*SIG)), mesh)
    # 8:3 to 384 kHz has a 21-sample history: longer than a chunk of 16.
    short = P.Chain(P.MixerDecimator(0.0, 384000.0, 100000.0)).bind(
        P.StreamSig(2, 16, RATE))
    assert short.blocks[0].plan.hist > 16
    with pytest.raises(NotImplementedError, match="history exceeds"):
        TimeShardedChain(short, mesh)
    ts = TimeShardedChain(P.Chain(P.GainControl(1.0)).bind(
        P.StreamSig(3, 64, 8000.0)), mesh, overlap=2)
    x = torch.zeros((3, 4 * 64), dtype=torch.complex64)
    with pytest.raises(ValueError, match="not divisible by overlap"):
        ts.process(tree_to_torch(ts.params, CPU),
                   tree_to_torch(ts.init_state(), CPU), x)


# -- the compiled group step and the data-parallel step -----------------------

def test_time_sharded_jit_step_and_reset():
    """``TimeShardedChain.jit_step`` (the actor's group step: eager on CPU
    tensors) equals ``process``; any reset flag restarts every stream's
    carry, as the JAX package's group step does."""
    make = CASES["mixed"]
    bound = make(P).bind(P.StreamSig(*SIG))
    ts = TimeShardedChain(bound, port_mesh())
    step = ts.jit_step()
    xs = make_iq(STEPS * D, 2, 64, seed=3)
    params = tree_to_torch(ts.params, CPU)
    state = tree_to_torch(ts.init_state(), CPU)
    no, one = (torch.tensor([False, False]), torch.tensor([False, True]))
    for s in range(STEPS):
        x = torch.from_numpy(group(xs, s, D))
        state, y = step(params, state, x, no)
    want = run_port(bound, xs, D, STEPS)
    np.testing.assert_array_equal(
        y.numpy().reshape(2, D, -1), np.moveaxis(want[-D:], 0, 1))
    _, y_reset = step(params, state, torch.from_numpy(group(xs, 0, D)), one)
    np.testing.assert_array_equal(y_reset.numpy().reshape(2, D, -1),
                                  np.moveaxis(want[:D], 0, 1))


def _jit_pair(make, sig, x, ndev):
    """(single-device step, stream-sharded step) outputs and states, the
    port's and the JAX package's."""
    from radiorust_tpu.blocks.base import (jit_step_sharded as jsharded,
                                           pack_wire, unpack_wire)
    from radiorust_tpu_torch.blocks.base import jit_step, jit_step_sharded
    pb = make(P).bind(P.StreamSig(*sig))
    mesh = make_mesh((ndev,), ("streams",), "cpu")
    params = tree_to_torch(pb.params, CPU)
    state = tree_to_torch(pb.init_state(), CPU)
    xt = torch.from_numpy(x)
    one = jit_step(pb)(params, state, xt)
    many = jit_step_sharded(pb, mesh, "streams")(params, state, xt)
    jb = make(J).bind(J.StreamSig(*sig))
    jmesh = JMesh(np.array(jax.devices()[:ndev]), ("streams",))
    reset = np.zeros((sig[0],), bool)
    _, jy = jsharded(jb, jmesh, "streams")(
        pack_wire(jb.params), pack_wire(jb.init_state()), pack_wire(x),
        reset)
    return one, many, np.asarray(unpack_wire(jax.tree.map(np.asarray, jy)))


@pytest.mark.parametrize("name,make,sig,scale", [
    ("wfm_chain", lambda L: L.Chain(
        L.FreqShifter.with_shift(1000.0),
        L.Filter.new(lambda b, f: np.where(np.abs(f) <= 2000.0, 1.0, 0.0)),
        L.FmDemod(1500.0), L.GainControl(0.5)), (8, 256, 8000.0), 1.0),
    ("conditioning", lambda L: L.Chain(L.Squelch(threshold=1e-3, alpha=0.9),
                                       L.AgcControl(reference=0.5,
                                                    rate=5e-2)),
     (8, 128, 8000.0), 0.2),
    ("phase_mode", lambda L: L.Chain(L.GainControl(0.5),
                                     L.Downsampler(384.0, 200.0)),
     (8, 100, 1024.0), 1.0),
], ids=["wfm_chain", "conditioning", "phase_mode"])
def test_jit_step_sharded_matches_single_device(name, make, sig, scale):
    """The data-parallel step over 4 stream shards equals the port's
    single-device step bit for bit (rows never couple) and the JAX
    package's sharded step within 5e-4."""
    rng = np.random.default_rng(11)
    x = (scale * (rng.standard_normal(sig[:2])
                  + 1j * rng.standard_normal(sig[:2]))).astype(np.complex64)
    if name == "conditioning":
        x[1::2] *= 1e-3                 # gates differ per stream
    (s1, y1), (s2, y2), jy = _jit_pair(make, sig, x, 4)
    np.testing.assert_array_equal(y2.numpy(), y1.numpy())
    for a, b in zip(tree_to_numpy(s1), tree_to_numpy(s2)):
        for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(la, lb)
    np.testing.assert_allclose(y2.numpy(), jy, atol=FM_ATOL)


def test_sharded_pair_packed_local_batch_constraint():
    """Pair-packed FmDemodFilter needs an even *local* batch: a split to
    odd local batches is refused, one that keeps pairs is taken."""
    from radiorust_tpu_torch.blocks.base import jit_step_sharded
    spec = P.Chain(P.FreqShifter.with_shift(1000.0),
                   P.FmDemodFilter(150000.0, P.deemphasis_band))
    bound = spec.bind(P.StreamSig(8, 512, 384000.0))
    assert not bound.shard_batch_ok(8) and bound.shard_batch_ok(4)
    with pytest.raises(ValueError, match="per-shard constraint"):
        jit_step_sharded(bound, make_mesh((8,), ("streams",), "cpu"),
                         "streams")
    with pytest.raises(ValueError, match="cannot shard"):
        jit_step_sharded(spec.bind(P.StreamSig(6, 512, 384000.0)),
                         make_mesh((4,), ("streams",), "cpu"), "streams")
    x = make_iq(1, 8, 512, seed=7)[0]
    (_, y1), (_, y2), jy = _jit_pair(
        lambda L: L.Chain(L.FreqShifter.with_shift(1000.0),
                          L.FmDemodFilter(150000.0, L.deemphasis_band)),
        (8, 512, 384000.0), x, 4)
    np.testing.assert_array_equal(y2.numpy(), y1.numpy())
    np.testing.assert_allclose(y2.numpy(), jy, atol=FM_ATOL)


def test_mesh_and_collectives():
    """The mesh's shape and lines, and the collectives over a list of
    shards: the cyclic shift, the gather, the sum."""
    from radiorust_tpu_torch.parallel.mesh import (Mesh, all_gather, psum,
                                                   ring_left)
    mesh = make_mesh((2, 4), ("ch", "t"), "cpu")
    assert mesh.shape == {"ch": 2, "t": 4} and mesh.size == 8
    assert mesh.single_device and mesh.home == CPU
    assert mesh.line("t", ch=1) == [CPU] * 4 and len(mesh.line("ch")) == 2
    with pytest.raises(ValueError, match="not an axis"):
        mesh.line("x")
    with pytest.raises(ValueError, match="devices for a mesh"):
        make_mesh((4,), ("t",), ["cpu"] * 3)
    with pytest.raises(ValueError):
        Mesh([["cpu"] * 2], ("t",))
    vals = [torch.full((2,), float(i)) for i in range(4)]
    devs = mesh.line("t")
    assert [float(v[0]) for v in ring_left(vals, devs)] == [3.0, 0.0, 1.0,
                                                             2.0]
    g = all_gather(vals, devs)
    assert len(g) == 4 and g[0].shape == (4, 2) and g[0] is g[3]
    assert all(float(s[0]) == 6.0 for s in psum(vals, devs))
