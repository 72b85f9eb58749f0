"""A worker of the port's process-group tests: started by
``launch_local_cluster`` (``tests/test_torch_multiprocess.py``), it joins
the job and runs one scenario on CPU tensors, each process checking its
own part against the same computation done in one process; it prints
``SCENARIO OK`` and exits 0, or raises."""

import argparse
import os
import sys

import numpy as np
import torch

from radiorust_tpu_torch.blocks.base import StreamSig, _leaves
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.models.wfm import wfm_receiver
from radiorust_tpu_torch.parallel import mesh as M
from radiorust_tpu_torch.parallel import multiprocess as mp

CPU = torch.device("cpu")
RATE = 1024000.0


def fm(total, batch):
    tt = np.arange(total) / RATE
    iq = np.exp(1j * 2 * np.pi * 150000.0 / RATE
                * np.cumsum(0.3 * np.sin(2 * np.pi * 1000.0 * tt)))
    return (iq[None, :] * np.exp(1j * np.linspace(0, 1, batch))[:, None]
            ).astype(np.complex64)


def local_mesh(shape, names):
    """The same grid, every entry this process's."""
    return M.Mesh(np.full(shape, CPU, dtype=object), names,
                  np.full(shape, mp.process_index()))


def collectives(nproc, loc):
    d_count = nproc * loc
    mesh = M.make_mesh((d_count,), ("t",), "cpu")
    full = M.Line([CPU] * d_count, axis="t")
    line = mesh.line("t")
    mine = M.local_indices(line)
    assert mine == list(range(mp.process_index() * loc,
                              (mp.process_index() + 1) * loc)), mine
    for dtype in (torch.float32, torch.complex64, torch.bool):
        vals = [(torch.arange(6).reshape(2, 3) + 10 * d).to(dtype)
                for d in range(d_count)]
        part = [v if d in mine else None for d, v in enumerate(vals)]
        for name, fn in (
                ("ring_left", lambda v, ln: M.ring_left(v, ln)),
                ("ring_left no wrap", lambda v, ln: M.ring_left(
                    v, ln, wrap=False, like=vals[0])),
                ("all_gather", M.all_gather),
                ("psum", M.psum),
                ("share", lambda v, ln: [M.share(
                    v[d_count - 1], d_count - 1, ln, like=vals[0])] * d_count)):
            if name == "psum" and dtype == torch.bool:
                continue
            want = fn(vals, full)
            got = fn(part, line)
            for d in mine:
                if want[d] is None:
                    assert got[d] is None, (name, d)
                    continue
                assert got[d].dtype == want[d].dtype, (name, d)
                assert torch.equal(got[d], want[d]), (name, dtype, d)
            for d in set(range(d_count)) - set(mine):
                if name != "share":
                    assert got[d] is None, (name, d)
    # A line of a 2-D mesh: across the processes, then within one.
    mesh2 = M.make_mesh((nproc, loc), ("ch", "t"), "cpu")
    across = mesh2.line("ch", t=loc - 1)
    within = mesh2.line("t", ch=mp.process_index())
    assert across.spans and not within.spans
    vals = [torch.full((3,), float(d)) for d in range(nproc)]
    mine = M.local_indices(across)
    got = M.all_gather([v if d in mine else None
                        for d, v in enumerate(vals)], across)
    for d in mine:
        assert torch.equal(got[d], torch.stack(vals)), got[d]
    vals = [torch.full((3,), float(d)) for d in range(loc)]
    got = M.ring_left(vals, within)
    assert all(torch.equal(got[d], vals[(d - 1) % loc]) for d in range(loc))


def ownership(nproc, loc):
    """Each process calls each block's ``process`` on its own shards only,
    and its output pieces are exactly its entries, bit for bit the
    one-process run's."""
    from radiorust_tpu_torch.parallel.time_shard import TimeShardedChain
    d_count, steps, n, batch = nproc * loc, 2, 2048, 2
    sig = StreamSig(batch, n, RATE)
    kw = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True)
    bound = wfm_receiver(**kw).bind(sig)
    calls = {}
    for i, blk in enumerate(bound.blocks):
        def counting(*a, _real=blk.process, _i=i, **k):
            calls[_i] = calls.get(_i, 0) + 1
            return _real(*a, **k)
        blk.process = counting
    ts = TimeShardedChain(bound, M.make_mesh((d_count,), ("t",), "cpu"))
    ref_bound = wfm_receiver(**kw).bind(sig)
    ref = TimeShardedChain(ref_bound, local_mesh((d_count,), ("t",)))
    x = torch.from_numpy(fm(steps * d_count * n, batch))
    params = tree_to_torch(bound.params, CPU)
    st = tree_to_torch(bound.init_state(), CPU)
    st_ref = tree_to_torch(ref_bound.init_state(), CPU)
    out_n = bound.out_sig.chunk_len
    rank = mp.process_index()
    for s in range(steps):
        xg = x[:, s * d_count * n:(s + 1) * d_count * n]
        st, y = ts.process(params, st, xg)
        st_ref, y_ref = ref.process(params, st_ref, xg)
        own = [(slice(0, batch), slice(d * out_n, (d + 1) * out_n))
               for d in range(rank * loc, (rank + 1) * loc)]
        assert y.indices == own, (y.indices, own)
        for index, piece in y.pieces:
            assert torch.equal(piece, y_ref[index]), index
        for a, b in zip(_leaves(st), _leaves(st_ref)):
            assert torch.equal(a, b)
    assert calls == {i: loc * steps for i in range(len(bound.blocks))}, \
        calls
    print(f"calls {calls}", flush=True)


def pipeline(nproc, loc):
    """``CrossProcessPipeline`` with 1 and 2 groups equal to
    ``PipelinedChain`` in one process, bit for bit."""
    from radiorust_tpu_torch.parallel.pipeline import (CrossProcessPipeline,
                                                       PipelinedChain)
    n, steps = 2048, 6
    for groups in (1, 2):
        bs = 2
        sig = StreamSig(bs, n, RATE)
        pipe = CrossProcessPipeline(wfm_receiver().bind(sig), groups=groups,
                                    device="cpu")
        xs = torch.from_numpy(np.moveaxis(fm(steps * n, groups * bs).reshape(
            groups * bs, steps, n), 1, 0).copy())
        got = pipe.run(xs)
        last = pipe.sid == pipe.stages - 1
        assert (got is None) == (not last), (groups, pipe.sid)
        if last:
            rows = slice(pipe.gid * bs, (pipe.gid + 1) * bs)
            one = PipelinedChain(wfm_receiver().bind(sig),
                                 devices=["cpu"] * pipe.stages)
            want = one.run(xs[:, rows])
            assert torch.equal(got, want), (groups, float(
                (got - want).abs().max()))
        mp.all_processes_ok(True)


def checkpoint(nproc, loc, path):
    """A carry of row pieces (streams across processes) through
    ``save_sharded`` / ``load_sharded``: read back whole and onto the
    mesh's rows, the continuation bit for bit."""
    from radiorust_tpu_torch.parallel.time_shard import TimeShardedChain
    from radiorust_tpu_torch.utils.checkpoint import (load_sharded,
                                                      save_sharded)
    n, batch = 2048, 2 * nproc
    mesh = M.make_mesh((nproc, loc), ("ch", "t"), "cpu")
    ts = TimeShardedChain(wfm_receiver().bind(StreamSig(batch, n, RATE)),
                          mesh, ch_axis="ch")
    x = torch.from_numpy(fm(3 * loc * n, batch))
    params = tree_to_torch(ts.params, CPU)
    st = tree_to_torch(ts.init_state(), CPU)
    for s in range(2):
        st, _ = ts.process(params, st, x[:, s * loc * n:(s + 1) * loc * n])
    leaves = _leaves(st)
    assert all(isinstance(t, M.Shards) for t in leaves), leaves[:2]
    save_sharded(path, st)
    try:
        save_sharded(path, st)
        raise AssertionError("saved over an existing checkpoint")
    except FileExistsError:
        pass
    whole = load_sharded(path, ts.init_state())
    for got, saved in zip(_leaves(whole), leaves):
        for index, piece in saved.pieces:
            assert np.array_equal(got[index], piece.numpy()), index
    back = load_sharded(path, ts.init_state(), mesh=mesh,
                        spec_fn=lambda shape: ("ch",))
    for got, saved in zip(_leaves(back), leaves):
        assert got.indices == saved.indices
        for (_, a), (_, b) in zip(got.pieces, saved.pieces):
            assert torch.equal(a, b)
    xg = x[:, 2 * loc * n:]
    _, y1 = ts.process(params, st, xg)
    _, y2 = ts.process(params, back, xg)
    for (i, a), (j, b) in zip(y1.pieces, y2.pieces):
        assert i == j and torch.equal(a, b), i
    if mp.process_index() == 0:
        np.savez(os.path.join(os.path.dirname(path), "whole.npz"),
                 *[np.asarray(a) for a in _leaves(whole)])


def checkpoint_smaller(nproc, loc, path):
    """The checkpoint of :func:`checkpoint` onto a job of fewer
    processes: each leaf whole on this process, equal to the first job's
    reading."""
    from radiorust_tpu_torch.models.wfm import wfm_receiver as rx
    from radiorust_tpu_torch.utils.checkpoint import load_sharded
    mesh = M.make_mesh((nproc * loc,), ("t",), "cpu")
    like = rx().bind(StreamSig(8, 2048, RATE)).init_state()
    back = load_sharded(path, like, mesh=mesh)
    with np.load(os.path.join(os.path.dirname(path), "whole.npz")) as f:
        want = [f[k] for k in f.files]
    got = _leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor) and np.array_equal(a.numpy(), b)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", required=True)
    ap.add_argument("--path", default="")
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    a = ap.parse_args()
    torch.set_num_threads(1)
    mp.initialize(a.coordinator, a.num_processes, a.process_id,
                  heartbeat_timeout_seconds=60)
    loc = mp.local_entries()
    scenario = {"collectives": collectives, "ownership": ownership,
                "pipeline": pipeline}.get(a.scenario)
    if scenario is not None:
        scenario(a.num_processes, loc)
    elif a.scenario == "checkpoint":
        checkpoint(a.num_processes, loc, a.path)
    elif a.scenario == "checkpoint_smaller":
        checkpoint_smaller(a.num_processes, loc, a.path)
    else:
        raise ValueError(a.scenario)
    assert mp.all_processes_ok(True)
    print("SCENARIO OK", flush=True)


if __name__ == "__main__":
    try:
        main()
        code = 0
    except BaseException:  # noqa: BLE001 - reported, then exit 1
        import traceback
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
