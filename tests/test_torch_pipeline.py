"""The port's pipeline (``parallel/pipeline.py``) on CPU tensors against
the JAX package's ``PipelinedChain`` on its virtual CPU devices and
against the port's own sequential scan, on the same seeded inputs, at the
JAX tests' tolerance (``tests/test_pipeline.py``: atol 2e-4).  The stages
run each block's own step on their chunk, so the port's pipeline equals
its sequential scan bit for bit; that is held too.  Chains time sharding
rejects (the slew limiter) and batch-growing stages (the channelizer)
included, and a checkpoint taken mid-stream with chunks in flight."""

import jax
import numpy as np
import pytest
import torch

from torch_parallel import (J, P, interpret_pallas_highest,  # noqa: F401
                            lowpass, make_iq, seq_port)
from radiorust_tpu.blocks.base import unpack_wire
from radiorust_tpu.parallel.pipeline import PipelinedChain as JPipelinedChain
from radiorust_tpu_torch.parallel.pipeline import (PipelinedChain,
                                                   balance_partition)

ATOL = 2e-4


def test_balance_partition():
    assert balance_partition(7, 3) == [3, 2, 2]
    assert balance_partition(4, 4) == [1, 1, 1, 1]
    assert balance_partition(5, 1) == [5]
    with pytest.raises(ValueError):
        balance_partition(2, 3)
    with pytest.raises(ValueError):
        balance_partition(2, 0)


def _slew_chain(L):
    return L.Chain(L.SlewRateLimiter(16000.0), L.Filter.new(lowpass(2000.0)),
                   L.GainControl(0.5), L.FreqShifter.with_shift(700.0))


def _mixed(L):
    return L.Chain(L.FreqShifter.with_shift(500.0),
                   L.Filter.new(lowpass(2000.0)), L.FmDemod(1000.0),
                   L.GainControl(2.0))


# (chain, signature, stages or None for one per block, seed)
CASES = {
    "wfm_one_per_block": (lambda L: L.wfm_receiver(), (2, 2048, 1024000.0),
                          None, 1),
    # The slew limiter's recurrence cannot time-shard: the pipeline is its
    # multi-device axis.
    "slew_chain": (_slew_chain, (2, 64, 8000.0), None, 2),
    "explicit_partition": (_mixed, (2, 64, 8000.0), [3, 1], 3),
    # A batch-growing stage: the reset mask widens across the boundary.
    "channelizer": (lambda L: L.Chain(L.Channelizer(64), L.GainControl(0.5)),
                    (1, 1024, 1024000.0), [1, 1], 5),
    "fuse_mid": (lambda L: L.wfm_receiver(fuse_frontend=True, fuse_mid=True),
                 (2, 4096, 1024000.0), [1, 1, 2], 6),
}


def _run_jax(make, sig, xs, partition, resets=None):
    jb = make(J).bind(J.StreamSig(*sig))
    devs = None if partition is None else jax.devices()[:len(partition)]
    return np.asarray(JPipelinedChain(jb, devices=devs,
                                      partition=partition).run(xs, resets))


def _port(make, sig, partition):
    pb = make(P).bind(P.StreamSig(*sig))
    stages = len(pb.blocks) if partition is None else len(partition)
    return pb, PipelinedChain(pb, devices=["cpu"] * stages,
                              partition=partition)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax_and_sequential(name):
    make, sig, partition, seed = CASES[name]
    xs = make_iq(5, sig[0], sig[1], seed=seed)
    pb, pl = _port(make, sig, partition)
    assert pl.depth == (len(pb.blocks) if partition is None
                        else len(partition))
    got = pl.run(xs).numpy()
    np.testing.assert_array_equal(got, seq_port(pb, xs))
    want = _run_jax(make, sig, xs, partition)
    # Random IQ through the FM chains: their warm-up chunks' demod is
    # chaotic, compared from valid_from on.
    v = pb.valid_from if "wfm" in name or "mid" in name else 0
    np.testing.assert_allclose(got[v:], want[v:], atol=ATOL)


def test_pipeline_reset_propagates():
    """A mid-stream reset reaches each stage with its chunk."""
    sig = (2, 64, 8000.0)
    make = lambda L: L.Chain(L.Filter.new(lowpass(2000.0)),  # noqa: E731
                             L.FmDemod(1000.0))
    xs = make_iq(6, 2, 64, seed=4)
    resets = np.zeros((6, 2), dtype=bool)
    resets[3, 0] = True
    pb, pl = _port(make, sig, [1, 1])
    got = pl.run(xs, resets).numpy()
    np.testing.assert_array_equal(got, seq_port(pb, xs, resets))
    np.testing.assert_allclose(got, _run_jax(make, sig, xs, [1, 1], resets),
                               atol=ATOL)


def test_pipeline_push_drain_reset_and_checkpoint(tmp_path):
    """push/drain: outputs after ``depth`` pushes; ``reset()`` restarts
    the stream identically; a checkpoint taken with chunks in flight
    resumes bit for bit in a fresh pipeline."""
    sig = (2, 64, 8000.0)
    make = lambda L: L.Chain(L.Filter.new(lowpass(2000.0)),  # noqa: E731
                             L.GainControl(0.5), L.FmDemod(900.0))
    xs = make_iq(5, 2, 64, seed=6)
    pb, pl = _port(make, sig, [1, 1, 1])
    want = seq_port(pb, xs)

    def stream_all(p, chunks):
        outs = [y for y in (p.push(torch.from_numpy(x)) for x in chunks)
                if y is not None]
        while len(outs) < len(chunks):
            y = p.push(None)
            if y is not None:
                outs.append(y)
        return torch.stack(outs).numpy()

    assert pl.push(torch.from_numpy(xs[0])) is None
    pl.reset()
    got1 = stream_all(pl, xs)
    np.testing.assert_array_equal(got1, want)
    pl.reset()
    np.testing.assert_array_equal(stream_all(pl, xs), got1)

    # Two chunks in flight at the checkpoint.
    pl.reset()
    first = [pl.push(torch.from_numpy(x)) for x in xs[:3]]
    assert first[:2] == [None, None]
    path = str(tmp_path / "pipe.ckpt.npz")
    pl.save_checkpoint(path)
    _, fresh = _port(make, sig, [1, 1, 1])
    fresh.load_checkpoint(path)
    rest = [fresh.push(torch.from_numpy(x)) for x in xs[3:]]
    rest += [fresh.push(None) for _ in range(2)]
    got = torch.stack([first[2]] + rest).numpy()
    np.testing.assert_array_equal(got, want)
    # The JAX package reads the same file: its stages resume from it.
    jb = make(J).bind(J.StreamSig(*sig))
    jpl = JPipelinedChain(jb, devices=jax.devices()[:3], partition=[1, 1, 1])
    jpl.load_checkpoint(path)
    jrest = [jpl.push(x) for x in xs[3:]] + [jpl.push(None)
                                             for _ in range(2)]
    jgot = np.stack([np.asarray(unpack_wire(jax.device_get(y)))
                     for y in jrest])
    np.testing.assert_allclose(jgot, want[1:], atol=ATOL)
    with pytest.raises(ValueError, match="partition must match"):
        _port(make, sig, [2, 1])[1].load_checkpoint(path)


def test_pipeline_partition_validation():
    pb = _mixed(P).bind(P.StreamSig(2, 64, 8000.0))
    with pytest.raises(ValueError, match="length mismatch"):
        PipelinedChain(pb, devices=["cpu"] * 2, partition=[4])
    with pytest.raises(ValueError, match="does not cover"):
        PipelinedChain(pb, devices=["cpu"] * 2, partition=[1, 1])
