"""Sharded steps over a mesh of one process, held against the sequential
scan (the port's ``__graft_entry__.py::dryrun_multichip``).

    python -m radiorust_tpu_torch.tools.dryrun_multichip [N] [--device cpu]

Runs the JAX dry run's cases over a mesh of ``N`` entries (default 8) of
one device (the default CUDA; four entries of one card are four shards,
as in ``chip_smoke.py`` path Q), each compared with the sequential scan
of the same bound chain on the same device, so a wrong halo fails on
numbers, not shapes:

1.  the WFM chain on a ``ch x t`` mesh (streams and time);
2.  the fused chain (MixerDecimator + FmDemodFilter) on a time mesh;
2b. the merged mid-chain kernel (FilterDemodFilter), run sharded as its
    two kernels;
2c. the overlap-save filters' impulse responses shorter than the chunk
    (``filter_ir_len=512``);
3.  a mesh of the stream axis only;
4.  the fused channelizer (ChannelizerDemod) on the time mesh;
5.  ``PipelinedChain`` of a chain with SlewRateLimiter (which time
    sharding refuses);
6.  ``ChannelShardedChain``: the channelizer's channel groups;
7.  the stereo MPX decoder (Combine nodes) through ``TimeShardedGraph``;
8.  Squelch + the AM receiver with AGC (the prefix handlers);
9.  the WFM chain with ``overlap=2``.

Prints one line a case and ``{"dryrun_multichip": ...}``; raises on the
first disagreement.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

__all__ = ["dryrun_multichip"]


def _fm(steps_t: int, batch: int, n: int, rate: float) -> np.ndarray:
    """[T, batch, n] of a 1 kHz tone, FM at 150 kHz deviation (the demod
    is chaotic on raw noise)."""
    tt = np.arange(steps_t * n) / rate
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * tt)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / rate * np.cumsum(audio)))
    phases = np.exp(1j * np.linspace(0.0, 1.0, batch))
    flat = (iq[None, :] * phases[:, None]).astype(np.complex64)
    return np.moveaxis(flat.reshape(batch, steps_t, n), 1, 0)


def _seq(bound, xs, device):
    """The bound chain scanned over ``xs`` on ``device``: host [T, ...]."""
    from ..blocks.base import scan
    from ..convert import tree_to_torch
    _, ys = scan(bound, tree_to_torch(bound.params, device),
                 tree_to_torch(bound.init_state(), device),
                 torch.from_numpy(np.ascontiguousarray(xs)).to(device))
    return ys.cpu().numpy()


def _case(mesh, t, ch_axis, chain, sig, device, steps=2, skip_out=0,
          overlap=1) -> float:
    """``steps`` time-sharded group steps against the sequential scan of
    the same bound chain: the largest |diff| from output chunk
    ``skip_out``."""
    from ..convert import tree_to_torch
    from ..parallel.time_shard import TimeShardedChain
    batch, n = sig.batch, sig.chunk_len
    bound = chain.bind(sig)
    ts = TimeShardedChain(bound, mesh, t_axis="t", ch_axis=ch_axis,
                          overlap=overlap)
    xs = _fm(steps * t, batch, n, sig.sample_rate)
    params = tree_to_torch(ts.params, device)
    state = tree_to_torch(ts.init_state(), device)
    out_b, out_n = bound.out_sig.batch, bound.out_sig.chunk_len
    outs = []
    for s in range(steps):
        g = xs[s * t:(s + 1) * t]
        x_big = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(g, 0, 1).reshape(batch, t * n))).to(device)
        state, y = ts.process(params, state, x_big)
        outs.append(np.moveaxis(y.cpu().numpy().reshape(out_b, t, out_n),
                                1, 0))
    got = np.concatenate(outs)
    want = _seq(bound, xs, device)
    np.testing.assert_allclose(got[skip_out:], want[skip_out:], atol=5e-4)
    return float(np.max(np.abs(got[skip_out:] - want[skip_out:]),
                        initial=0.0))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Every case over a one-process mesh of ``n_devices`` entries of
    ``device`` (CUDA by default; without a card it raises): {case: the
    largest |diff| against the sequential run}."""
    from ..blocks.base import Chain, StreamSig
    from ..blocks.filters import Filter, SlewRateLimiter
    from ..blocks.graph import graph_scan
    from ..blocks.transform import FreqShifter, GainControl, Squelch
    from ..convert import tree_to_torch
    from ..models.analog import am_receiver
    from ..models.channelizer import channelized_receiver
    from ..models.stereo import MPX_RATE, stereo_mpx_decoder
    from ..models.wfm import wfm_receiver
    from ..parallel.channel_shard import ChannelShardedChain
    from ..parallel.mesh import make_mesh
    from ..parallel.pipeline import PipelinedChain
    from ..parallel.time_shard import TimeShardedGraph
    from ..runtime.blocks import resolve_device
    dev = resolve_device(device)
    nd = n_devices
    out = {}

    def note(name, err):
        out[name] = err
        print(f"dryrun {name}: max |diff| {err:.3e}", flush=True)

    ch = 2 if (nd % 2 == 0 and nd >= 4) else 1
    t = nd // ch
    mesh = make_mesh((ch, t), ("ch", "t"), dev)
    note("1 ch x t", _case(mesh, t, "ch", wfm_receiver(),
                           StreamSig(2 * ch, 2048, 1024000.0), dev,
                           skip_out=2))
    mesh_t = make_mesh((nd,), ("t",), dev)
    sig_f = StreamSig(2, 4096, 1024000.0)
    note("2 fused", _case(mesh_t, nd, None, wfm_receiver(
        fuse_frontend=True, fuse_demod=True), sig_f, dev, skip_out=2))
    note("2b fuse_mid", _case(mesh_t, nd, None, wfm_receiver(
        fuse_frontend=True, fuse_mid=True), sig_f, dev, skip_out=2))
    note("2c filter_ir_len=512", _case(mesh_t, nd, None, wfm_receiver(
        fuse_frontend=True, fuse_demod=True, filter_ir_len=512), sig_f,
        dev, skip_out=2))
    mesh_ch = make_mesh((nd, 1), ("ch", "t"), dev)
    note("3 streams only", _case(mesh_ch, 1, "ch", wfm_receiver(),
                                 StreamSig(nd, 2048, 1024000.0), dev,
                                 skip_out=2))
    note("4 fused channelizer", _case(
        mesh_t, nd, None, channelized_receiver(
            num_channels=64, input_rate=1024000.0, fuse=True),
        StreamSig(1, 1024, 1024000.0), dev))

    def lowpass(bins, freqs):
        return np.where(np.abs(freqs) <= 2000.0, 1.0 + 0.0j, 0.0j)

    sig_p = StreamSig(2, 64, 8000.0)
    chain_p = Chain(SlewRateLimiter(16000.0), Filter.new(lowpass),
                    GainControl(0.5), FreqShifter.with_shift(700.0))
    rng = np.random.default_rng(3)
    xs_p = (rng.standard_normal((5, 2, 64))
            + 1j * rng.standard_normal((5, 2, 64))).astype(np.complex64)
    pl = PipelinedChain(chain_p.bind(sig_p), devices=[dev] * min(nd, 4))
    got = pl.run(torch.from_numpy(xs_p).to(dev)).cpu().numpy()
    want = _seq(chain_p.bind(sig_p), xs_p, dev)
    np.testing.assert_allclose(got, want, atol=2e-4)
    note("5 pipeline", float(np.max(np.abs(got - want))))

    if 64 % nd == 0:
        bound_c = channelized_receiver(num_channels=64,
                                       input_rate=1024000.0).bind(
            StreamSig(1, 1024, 1024000.0))
        cs = ChannelShardedChain(bound_c, make_mesh((nd,), ("c",), dev),
                                 axis="c")
        rng_c = np.random.default_rng(6)
        xs_c = (rng_c.standard_normal((3, 1, 1024))
                + 1j * rng_c.standard_normal((3, 1, 1024))
                ).astype(np.complex64)
        params = tree_to_torch(cs.params, dev)
        st = tree_to_torch(cs.init_state(), dev)
        outs = []
        for s in range(3):
            st, y = cs.process(params, st, torch.from_numpy(xs_c[s]).to(dev))
            outs.append(y.cpu().numpy())
        got = np.stack(outs)
        want = _seq(bound_c, xs_c, dev)
        # Demodulated near-empty channels are atan2 noise: rows with
        # signal energy only.
        rows = np.abs(want).mean(axis=(0, 2)) > 1e-3
        np.testing.assert_allclose(got[:, rows], want[:, rows], atol=5e-4)
        note("6 channel-sharded",
             float(np.max(np.abs(got[:, rows] - want[:, rows]))))

    steps_s, n_s = 2, 1536
    bg = stereo_mpx_decoder().bind({"mpx": StreamSig(2, n_s, MPX_RATE)})
    tt = np.arange(steps_s * nd * n_s) / MPX_RATE
    th = 2 * np.pi * 19000.0 * tt + 0.3
    left = 0.8 * np.sin(2 * np.pi * 1000.0 * tt)
    right = 0.5 * np.sin(2 * np.pi * 2500.0 * tt)
    mpx = (0.5 * (left + right) + 0.5 * (left - right) * np.cos(2 * th)
           + 0.1 * np.cos(th))
    xs_s = np.stack([mpx, 0.7 * mpx]).astype(np.complex64)
    xs_s = np.moveaxis(xs_s.reshape(2, steps_s * nd, n_s), 1, 0)
    params = tree_to_torch(bg.params, dev)
    _, want_s = graph_scan(bg, params, tree_to_torch(bg.init_state(), dev),
                           {"mpx": torch.from_numpy(xs_s).to(dev)})
    tsg = TimeShardedGraph(bg, mesh_t, t_axis="t")
    st = tree_to_torch(tsg.init_state(), dev)
    got_s = {k: [] for k in bg.out_sigs}
    for s in range(steps_s):
        g = xs_s[s * nd:(s + 1) * nd]
        x_big = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(g, 0, 1).reshape(2, nd * n_s))).to(dev)
        st, ys = tsg.process(params, st, {"mpx": x_big})
        for k in got_s:
            out_n = bg.out_sigs[k].chunk_len
            got_s[k].append(np.moveaxis(
                ys[k].cpu().numpy().reshape(2, nd, out_n), 1, 0))
    worst = 0.0
    for k in got_s:
        got, want = np.concatenate(got_s[k]), want_s[k].cpu().numpy()
        np.testing.assert_allclose(got, want, atol=2e-4)
        worst = max(worst, float(np.max(np.abs(got - want))))
    note("7 stereo graph", worst)

    note("8 squelch + AM with AGC", _case(
        mesh_t, nd, None, Chain(Squelch(threshold=1e-2, alpha=0.995),
                                am_receiver(tune_shift=-30000.0, agc=True)),
        StreamSig(2, 2048, 256000.0), dev, skip_out=1))
    note("9 overlap=2", _case(mesh_t, nd, None, wfm_receiver(),
                              StreamSig(4, 2048, 1024000.0), dev,
                              skip_out=2, overlap=2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    res = dryrun_multichip(args.n_devices, args.device)
    print(json.dumps({"dryrun_multichip": {"n_devices": args.n_devices,
                                           "device": args.device,
                                           "max_abs_diff": res}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
