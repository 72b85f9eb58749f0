"""The port's time sharding of the WFM and channelizer chains on CPU
tensors, against the JAX package's executors on its virtual CPU devices
and against the port's own sequential scan on the same seeded inputs
(``tests/test_parallel.py``'s fused, decoupled, merged, front-end,
channelizer, stream x time and live-retune cases; atol 2e-4, 5e-4 from
chunk 2 for FM), and every pointer argument the sharded handlers hand a
kernel wrapper contiguous, as on CUDA its kernel requires."""

import jax
import numpy as np
import pytest
import torch

from torch_parallel import (ATOL, CPU, D, FM_ATOL, J, P, RATE, STEPS, both,
                            fm_iq,
                            interpret_pallas_highest,  # noqa: F401
                            make_iq, port_mesh, run_jax, run_port,
                            seq_port)
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch

WFM = {
    # Mixed- and demod-domain halos rebuilt over the shards.
    "fused": dict(fuse_frontend=True, fuse_demod=True),
    # The decoupled geometry: 512-tap IRs, the halo shrinks to the IR.
    "decoupled": dict(fuse_frontend=True, fuse_demod=True,
                      filter_ir_len=512),
    # The merged kernel (#6) runs as #3 then #5 under sharding.
    "fuse_mid": dict(fuse_frontend=True, fuse_mid=True),
}


@pytest.mark.parametrize("name", list(WFM))
def test_time_sharded_fused_wfm(name):
    n, steps = 4096, 2
    xs = fm_iq(steps * D, n)
    got, want, seq = both(lambda L: L.wfm_receiver(**WFM[name]),
                           (2, n, RATE), xs, steps=steps)
    np.testing.assert_allclose(got[2:], want[2:], atol=FM_ATOL)
    np.testing.assert_allclose(got[2:], seq[2:], atol=FM_ATOL)
    np.testing.assert_array_equal(got, seq)


# (shift, output rate, bandwidth, input rate): A's 8:3 head (the
# polyphase form), and path U1's 2.048 MHz -> 240 kHz (p = 128, q = 15,
# Kw = 435: the mixer's wide form, a 307-sample history).
FRONTENDS = {"8:3": (-57000.0, 384000.0, 200000.0, RATE),
             "U1 wide": (-300e3, 240e3, 200e3, 2.048e6)}


@pytest.mark.parametrize("plan", list(FRONTENDS))
def test_time_sharded_fused_frontend_only(plan):
    """MixerDecimator alone on random IQ: the rebuilt mixed history is the
    kernel's own (bit for bit on the CPU), on either form's plan."""
    n = 2048
    shift, out, bw, rate = FRONTENDS[plan]
    xs = make_iq(STEPS * D, 2, n, seed=5)
    got, want, seq = both(
        lambda L: L.Chain(L.MixerDecimator(shift, out, bw)),
        (2, n, rate), xs)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, seq)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_time_sharded_channelizer(fuse):
    """The channelizer time-sharded: fused (#7, the raw-input halo only)
    and unfused (PFB, then per-channel demod and gain)."""
    m, n, rate = (64, 1024, 1024000.0) if fuse else (8, 256, 80000.0)
    xs = make_iq(2 * D, 1, n, seed=13 if fuse else 9)
    got, want, seq = both(
        lambda L: L.channelized_receiver(num_channels=m, input_rate=rate,
                                         fuse=fuse),
        (1, n, rate), xs, steps=2)
    np.testing.assert_allclose(got, want, atol=FM_ATOL)
    np.testing.assert_allclose(got, seq, atol=FM_ATOL)


def test_time_and_channel_sharded_wfm():
    """The WFM chain on a 2 x 4 (stream x time) mesh."""
    n, steps = 2048, 2
    xs = fm_iq(steps * D, n)
    pb = P.wfm_receiver().bind(P.StreamSig(2, n, RATE))
    jb = J.wfm_receiver().bind(J.StreamSig(2, n, RATE))
    got = run_port(pb, xs, D, steps, mesh=port_mesh((2, 4), ("ch", "t")),
                   ch_axis="ch")
    want = run_jax(jb, xs, D, steps, mesh=jax.make_mesh((2, 4), ("ch", "t")),
                   ch_axis="ch")
    np.testing.assert_allclose(got[2:], want[2:], atol=FM_ATOL)
    np.testing.assert_allclose(got[2:], seq_port(pb, xs)[2:], atol=FM_ATOL)


# -- live retunes -------------------------------------------------------------

def _retuned(L, bound, xs, shift2, gain2=None):
    """The sequential oracle of a package: scan half, retune phase-
    continuously (and set the gains), scan the rest."""
    half = xs.shape[0] // 2
    if L is P:
        params = tree_to_torch(bound.params, CPU)
        st, ys_a = P.scan(bound, params, tree_to_torch(bound.init_state(),
                                                       CPU),
                          torch.from_numpy(xs[:half]))
        st, ys_a = tree_to_numpy(st), ys_a.numpy()
    else:
        st, ys_a = J.scan(bound, bound.params, bound.init_state(),
                          xs[:half])
        st, ys_a = jax.tree.map(np.asarray, st), np.asarray(ys_a)
    params, state = list(bound.params), list(st)
    for i, blk in enumerate(bound.blocks):
        if hasattr(blk, "retune"):
            params[i], state[i] = blk.retune(params[i], state[i], shift2)
        if gain2 is not None and type(blk).__name__ == "_BoundGain":
            params[i] = np.float32(gain2)
    if L is P:
        _, ys_b = P.scan(bound, tree_to_torch(tuple(params), CPU),
                         tree_to_torch(tuple(state), CPU),
                         torch.from_numpy(xs[half:]))
        ys_b = ys_b.numpy()
    else:
        _, ys_b = J.scan(bound, tuple(params), tuple(state), xs[half:])
        ys_b = np.asarray(ys_b)
    return np.concatenate([ys_a, ys_b])


def _retune_between(shift2, steps, gain2=None, torch_state=True):
    def between(s, ts, state):
        if s != steps // 2:
            return state
        state = ts.set_shift(tree_to_numpy(state) if torch_state else
                             state, shift2)
        if gain2 is not None:
            ts.update_params(lambda blk, p: np.float32(gain2)
                             if type(blk).__name__ == "_BoundGain" else None)
        return state
    return between


@pytest.mark.parametrize("fuse_frontend", [False, True],
                         ids=["freq_shifter", "mixer_decimator"])
def test_time_sharded_live_retune(fuse_frontend):
    """``set_shift`` (and a gain, on the FreqShifter front end) on a
    running TimeShardedChain against the sequentially retuned scan: the
    folded start phase meets the per-shard k0 + d*adv offsets."""
    n, steps = 2048, 4
    sig = (2, n, RATE)
    kw = dict(tune_shift=100000.0, fuse_frontend=fuse_frontend)
    gain2 = None if fuse_frontend else 0.5
    xs = make_iq(steps * D, 2, n, seed=31 + fuse_frontend)
    pb = P.wfm_receiver(**kw).bind(P.StreamSig(*sig))
    jb = J.wfm_receiver(**kw).bind(J.StreamSig(*sig))
    got = run_port(pb, xs, D, steps,
                   between=_retune_between(-57000.0, steps, gain2))
    pb2 = P.wfm_receiver(**kw).bind(P.StreamSig(*sig))
    want_seq = _retuned(P, pb2, xs, -57000.0, gain2)
    want_jax = run_jax(jb, xs, D, steps, between=_retune_between(
        -57000.0, steps, gain2, torch_state=False))
    np.testing.assert_array_equal(got, want_seq)
    # Random IQ: the FM demod of the warm-up chunks is chaotic.
    np.testing.assert_allclose(got[2:], want_jax[2:], atol=FM_ATOL)


# The CUDA entry points of these wrappers read each tensor argument
# through a plain pointer: a strided view raises there, while the plain
# versions the CPU runs take it.
_POINTER_ARGS = [("ops.filter", "fused_overlap_save"),
                 ("ops.filter", "fused_filter_bank"),
                 ("ops.filter", "fused_demod_filter"),
                 ("ops.filter", "fused_filter_demod_filter"),
                 ("ops.channelizer", "pfb_demod_step"),
                 ("ops.scan", "agc_step")]


@pytest.mark.parametrize("name,make,sig,want", [
    ("fused", lambda L: L.wfm_receiver(**WFM["fused"]), (2, 4096, RATE),
     "fused_demod_filter"),
    ("fuse_mid", lambda L: L.wfm_receiver(**WFM["fuse_mid"]),
     (2, 4096, RATE), "fused_demod_filter"),
    ("decoupled", lambda L: L.wfm_receiver(**WFM["decoupled"]),
     (2, 4096, RATE), "fused_demod_filter"),
    ("channelizer", lambda L: L.channelized_receiver(
        num_channels=64, input_rate=1024000.0, fuse=True),
     (2, 1024, 1024000.0), "pfb_demod_step"),
    ("am_agc", lambda L: L.am_receiver(tune_shift=-30e3, agc=True),
     (2, 8192, 256000.0), "agc_step"),
], ids=["fused", "fuse_mid", "decoupled", "channelizer", "am_agc"])
def test_time_sharded_kernel_arguments_contiguous(monkeypatch, name, make,
                                                  sig, want):
    """Every tensor the sharded handlers hand a pointer-reading kernel
    wrapper (the halo-built states, the carry) is contiguous, as the
    blocks' own calls are: on CUDA the wrapper would raise."""
    import collections
    import importlib
    calls = collections.Counter()
    for mod, fn in _POINTER_ARGS:
        module = importlib.import_module(f"radiorust_tpu_torch.{mod}")
        real = getattr(module, fn)

        def check(*args, _real=real, _fn=fn, **kw):
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), (_fn, i, tuple(a.shape),
                                               a.stride())
            calls[_fn] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(module, fn, check)
    xs = fm_iq(2 * D, sig[1], streams=sig[0], rate=sig[2])
    run_port(make(P).bind(P.StreamSig(*sig)), xs, D, 2)
    assert calls[want] >= 2 * D, calls
