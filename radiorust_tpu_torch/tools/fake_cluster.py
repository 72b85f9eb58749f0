"""A cluster of processes on one machine driving the port's parallel layer
across process boundaries (the port's ``tools/fake_cluster.py``).

    python -m radiorust_tpu_torch.tools.fake_cluster [--device cpu]
        [--width small|full] [--out PATH] [--skip-kill-drill]
        [--skip-elastic]

Launcher mode starts 4 workers with 2 mesh entries each
(``parallel/multiprocess.py::launch_local_cluster``), joined into one
gloo process group.  On a card every worker runs on ``cuda:0`` (the
default device is CUDA; without a card a worker raises).  The workers
build meshes that span the processes and run each case, each process
stepping only its own shards; each holds its pieces against the
sequential run of the same chain in its own process (and, given
``--want NPZ``, against outputs computed elsewhere, such as the JAX
package's) and the job agrees on one verdict:

1. the WFM chain time-sharded ``t=8``, every halo crossing a process
   boundary somewhere, with a phase-continuous ``set_shift`` before the
   third group step;
2. the WFM chain on a ``ch=4 x t=2`` mesh: streams across processes,
   time within;
3. the 64-channel channelizer channel-sharded ``c=8`` (its branch
   ``all_gather`` across processes), and the fused one time-sharded
   ``t=8``;
4. ``save_sharded`` after two group steps, ``load_sharded``, and the
   continuation bit for bit against the uninterrupted run;
5. ``CrossProcessPipeline``: a stage of the chain per process;
6. the channelizer on an ``s=4 x c=2`` mesh: streams across processes,
   channels within;
7. ``CrossProcessPipeline(groups=2)``: 2 groups x 2 stages.

``--width small`` (the default) runs the JAX cases' sizes (batch 2,
chunk 2048; the channelizer 1 x 1024); ``--width full`` runs the port's
paths' widths (``wfm_receiver(tune_shift=100e3, fuse_frontend=True,
fuse_demod=True, filter_ir_len=6144)`` at 64 x 24576, its ``fuse_mid``
form for case 5, the channelizer at 4 x 65536 and 16.384 MHz).

The drills, after the cases:

- ``FAKE_CLUSTER_FAIL=<case>``: process 1 raises after that case's
  exchanges; the job must still converge on a joint ``ok=false``
  (every worker exits 1), by its verdict, not a timeout;
- ``FAKE_CLUSTER_KILL=<case>`` (the kill drill): process 1 SIGKILLs
  itself in the middle of case 1 (or 6); the survivors must error out of
  the dead peer's exchanges (nonzero codes), none hung;
- the elastic drill: 4 workers serve the time-sharded chain, save a
  sharded checkpoint and process 1 SIGKILLs itself; the survivors print
  ``DETECT <s>``; then 3 workers (6 entries) load the checkpoint and
  continue the stream, each chunk held against the sequential run.

Each worker prints one JSON line (``{"worker": ...}``: each case's verdict,
microseconds per group step after a warm-up group, launches of the
kernels, the cross-rank hops' count, bytes and host seconds); the
launcher prints a ``{"fake_cluster": ...}`` line and writes it to ``--out
PATH`` only when given.  A failed case or drill exits nonzero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import signal
import sys
import tempfile
import time

import numpy as np

from ..ops import kernel_wrappers

SCRIPT = "-m radiorust_tpu_torch.tools.fake_cluster"
CASES = ("wfm_time_sharded_t8_with_retune", "wfm_ch_across_hosts_x_t_within",
         "channelizer_c8_cross_process_all_gather",
         "sharded_checkpoint_resume", "pipeline_one_stage_per_process",
         "streams_across_hosts_x_channels_within",
         "pipeline_2groups_x_2stages")
KILL_HOOKED = ("wfm_time_sharded_t8_with_retune",
               "streams_across_hosts_x_channels_within")
ATOL = 5e-4          # a sharded run against a sequential one, from chunk 2
SKIP = 2             # chunks of FM warm-up before the comparison
SHIFT1 = -57000.0    # case 1's retune
CHAIN = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
             filter_ir_len=6144)
CH_TONES = {1: 1000.0, 5: 2500.0, 20: 4000.0, 41: 7000.0}  # channel: Hz

WIDTHS = {
    # The JAX package's fake cluster's sizes.
    "small": dict(steps=3, batch=2, n=2048, rate=1024000.0, chain={},
                  shift0=100e3,
                  ch_batch=1, ch_n=1024, ch_rate=1024000.0, pipe={},
                  pipe_batch=2, pipe_steps=6, group_batch=2, elastic=46),
    # The port's paths A, B and D.
    # Six group steps time four after the warm-up, the last one tapped.
    "full": dict(steps=6, batch=64, n=24576, rate=1024000.0, chain=CHAIN,
                 shift0=CHAIN["tune_shift"], ch_batch=4, ch_n=65536,
                 ch_rate=16384000.0,
                 pipe=dict(CHAIN, fuse_demod=False, fuse_mid=True),
                 pipe_batch=64, pipe_steps=16, group_batch=32, elastic=28),
}


def fm_iq(total: int, batch: int, rate: float) -> np.ndarray:
    """[batch, total] complex64: a 1 kHz tone FM-modulated at 150 kHz
    deviation, each stream at its own phase (the JAX cases' signal)."""
    tt = np.arange(total) / rate
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * tt)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / rate * np.cumsum(audio)))
    phases = np.exp(1j * np.linspace(0.0, 1.0, batch))
    return (iq[None, :] * phases[:, None]).astype(np.complex64)


def chunks(total: int, batch: int, n: int, rate: float) -> np.ndarray:
    """:func:`fm_iq` as [T, batch, n] chunks."""
    return np.moveaxis(fm_iq(total * n, batch, rate).reshape(
        batch, total, n), 1, 0)


def channel_input(width: str, steps: int, batch: int, n: int, rate: float,
                  seed: int) -> np.ndarray:
    """[steps, batch, n] complex64 channelizer input: unit normal noise at
    the small width (the JAX cases'), FM tones at the centres of the
    channels of ``CH_TONES`` at the full width (demodulated noise is
    chaotic in the last bits there)."""
    if width == "small":
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((steps, batch, n))
                + 1j * rng.standard_normal((steps, batch, n))
                ).astype(np.complex64)
    ts = np.arange(steps * n) / rate
    x = np.zeros(steps * n, np.complex128)
    for c, f in CH_TONES.items():
        x += np.exp(1j * (2 * np.pi * c * rate / 64 * ts
                          + 16000.0 / f * np.sin(2 * np.pi * f * ts)))
    x = x.astype(np.complex64).reshape(steps, 1, n)
    return np.repeat(x, batch, axis=1)


def channel_rows(width: str, want: np.ndarray) -> np.ndarray:
    """The folded channel rows compared: those with signal energy (the
    JAX cases' guard) at the small width, the occupied channels at the
    full width."""
    if width == "small":
        return np.abs(want).mean(axis=(0, 2)) > 1e-3
    rows = np.zeros(want.shape[1], bool)
    for c in CH_TONES:
        rows[c::64] = True
    return rows


def group_of(xs: np.ndarray, s: int, t: int) -> np.ndarray:
    """Group step s of [T, b, n] chunks: [b, t*n]."""
    g = xs[s * t:(s + 1) * t]
    return np.moveaxis(g, 0, 1).reshape(g.shape[1], -1)


def _maybe_die(case: str, rank: int) -> None:
    """The kill drill's hook: process 1 dies here, in the middle of
    ``case`` (after one group step's exchanges)."""
    if case and os.environ.get("FAKE_CLUSTER_KILL") == case and rank == 1:
        print(f"[p{rank}] SIGKILL drill: dying mid-{case}", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)


class Hold:
    """What a worker does around its kernel calls: by default nothing.  A
    subclass may record the kernel calls of one group step (or of a
    pipeline stage's run, ``per_shape`` calls a wrapper and shape;
    :meth:`tap`, a context manager yielding the records) and hold them
    against their plain versions (:meth:`check`, which raises on a
    disagreement and returns a row per call)."""

    def tap(self, per_shape: int):
        return contextlib.nullcontext([])

    def check(self, records, label: str) -> list:
        return []


class _Worker:
    """One process of the job: its rank, device, mesh entries and
    width."""

    def __init__(self, rank, nproc, device, width, hold, want):
        import torch
        self.torch = torch
        self.rank, self.nproc = rank, nproc
        self.device = device
        self.w = WIDTHS[width]
        self.width = width
        self.hold = hold
        self.want = want
        from ..parallel.multiprocess import local_entries
        self.local = local_entries(2)
        self.ndev = nproc * self.local
        self.results: dict = {}

    # -- helpers ------------------------------------------------------------

    def on_device(self, tree):
        from ..convert import tree_to_torch
        return tree_to_torch(tree, self.device)

    def sequential(self, bound, xs, retune_at=None, shift=None):
        """The chain scanned over [T, b, n] chunks in this process (with a
        ``set_shift`` before chunk ``retune_at``): host [T, b, out_n]."""
        from ..blocks.base import scan
        from ..blocks.frontend import _BoundMixerDecimator
        from ..blocks.transform import _BoundFreqShifter
        from ..convert import tree_to_numpy
        params = self.on_device(bound.params)
        state = self.on_device(bound.init_state())
        x = self.torch.from_numpy(np.ascontiguousarray(xs)).to(self.device)
        if retune_at is None:
            _, ys = scan(bound, params, state, x)
            return ys.cpu().numpy()
        state, ya = scan(bound, params, state, x[:retune_at])
        params, state = list(bound.params), list(tree_to_numpy(state))
        for i, blk in enumerate(bound.blocks):
            if isinstance(blk, (_BoundFreqShifter, _BoundMixerDecimator)):
                params[i], state[i] = blk.retune(params[i], state[i], shift)
        _, yb = scan(bound, self.on_device(tuple(params)),
                     self.on_device(tuple(state)), x[retune_at:])
        return np.concatenate([ya.cpu().numpy(), yb.cpu().numpy()])

    def counted(self, run):
        """``run()`` with the kernels' launch counters at 0 just before
        and read just after, the hops' counters likewise: (its result, the
        launches by kernel, the hops)."""
        from ..parallel.mesh import HOPS
        wrappers = kernel_wrappers()
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        for w in wrappers:
            w.launches = 0
        before = dict(HOPS)
        out = run()
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        hops = {k: HOPS[k] - before.get(k, 0) for k in HOPS}
        return out, launches, hops

    def timed_steps(self, step, steps, label, before=None):
        """``before(s)`` untimed, then ``step(s)``, for s in range(steps):
        each step timed (CUDA events on a card, the host clock on the
        CPU), the kernel calls of the last recorded and held against their
        plain versions.  Returns (results, microseconds a step: the mean
        over the steps between the first, a warm-up, and the last,
        recorded; those steps' microseconds; held rows)."""
        tap_at = steps - 1
        from ._common import timed
        outs, secs, records = [], [], []
        for s in range(steps):
            if before is not None:
                before(s)
            cm = (self.hold.tap(self.local) if s == tap_at
                  else contextlib.nullcontext([]))
            with cm as rec:
                out, sec = timed(lambda: step(s), self.device)
            records += rec
            outs.append(out)
            secs.append(sec)
        held = self.hold.check(records, f"{label} p{self.rank}")
        clean = [1e6 * t for t in (secs[1:tap_at] or secs[1:] or secs)]
        return outs, sum(clean) / len(clean), clean, held

    def held_to(self, label, key, ys, seq, split, skip=0,
                rows=None) -> dict:
        """Each step's pieces (``ys[s]``, a :class:`~radiorust_tpu_torch.
        parallel.mesh.Shards`) against this process's sequential run
        ``seq`` and, where ``--want`` holds ``key``, that reference, both
        laid out by ``split`` (host [T, ...] -> the steps' values), at
        ATOL, the first step's first ``skip`` positions left out: the
        largest |diff| of each."""
        from ..parallel.multiprocess import assert_addressable_allclose
        errs = {}
        for name, full in (("seq", seq), ("ref", self.want.get(key))):
            if full is None:
                continue
            worst = 0.0
            for s, (y, want) in enumerate(zip(ys, split(full))):
                cut_at = skip if s == 0 else 0
                assert_addressable_allclose(
                    y, want, ATOL, rows=rows, skip=cut_at,
                    label=f"{label} step {s} vs {name}")
                for index, piece in y.pieces:
                    got, ref = piece.cpu().numpy(), want[index]
                    if rows is not None:
                        got, ref = got[rows[index[0]]], ref[rows[index[0]]]
                    cut = max(0, cut_at - (index[-1].start or 0))
                    if got[..., cut:].size:
                        worst = max(worst, float(np.max(np.abs(
                            got[..., cut:] - ref[..., cut:]))))
            errs[name] = worst
        return errs

    # -- the cases -----------------------------------------------------------

    def case_time_sharded(self, mesh, t, ch_axis, retune, case):
        """Cases 1 and 2: the WFM chain time(+stream)-sharded against its
        sequential run, with a retune before the third step (case 1)."""
        from ..blocks.base import StreamSig
        from ..models.wfm import wfm_receiver
        from ..parallel.time_shard import TimeShardedChain
        w = self.w
        batch = (w["batch"] if self.width == "full" or not ch_axis
                 else 2 * mesh.shape[ch_axis])
        n, rate, steps = w["n"], w["rate"], w["steps"]
        kw = dict(w["chain"])
        kw["tune_shift"] = (w["shift0"] if retune
                            else w["chain"].get("tune_shift", 0.0))
        sig = StreamSig(batch, n, rate)
        bound = wfm_receiver(**kw).bind(sig)
        ts = TimeShardedChain(bound, mesh, t_axis="t", ch_axis=ch_axis)
        xs = chunks(steps * t, batch, n, rate)
        out_n = bound.out_sig.chunk_len
        cur = {"state": self.on_device(ts.init_state()),
               "params": self.on_device(ts.params)}

        def retune_at(s):
            if retune and s == 2:
                cur["state"] = self.on_device(ts.set_shift(cur["state"],
                                                           SHIFT1))
                cur["params"] = self.on_device(ts.params)

        def step(s):
            if s == 1:
                _maybe_die(case, self.rank)
            x = self.torch.from_numpy(group_of(xs, s, t))
            cur["state"], y = ts.process(cur["params"], cur["state"], x)
            return y

        (ys, us, samples, held), launches, hops = self.counted(
            lambda: self.timed_steps(step, steps, case, before=retune_at))
        seq = self.sequential(wfm_receiver(**kw).bind(sig), xs,
                              retune_at=2 * t if retune else None,
                              shift=SHIFT1)
        errs = self.held_to(case, case, ys, seq,
                            lambda f: [group_of(f, s, t)
                                       for s in range(steps)],
                            skip=SKIP * out_n)
        return dict(us_per_step=us, us_samples=samples, steps=steps,
                    chunks=t, launches=launches,
                    hops=hops, held=held, errors=errs, batch=batch,
                    shards=[[i[0].start, i[0].stop, i[1].start // out_n]
                            for i in ys[0].indices])

    def case_channel(self, mesh, case, stream_axis=None):
        """Cases 3 and 6: the channelizer channel-sharded (over streams x
        channels with ``stream_axis``) against its sequential run."""
        from ..blocks.base import StreamSig
        from ..models.channelizer import channelized_receiver
        from ..parallel.channel_shard import ChannelShardedChain
        w = self.w
        # The JAX case 6 serves a stream per process; the full width
        # keeps path D's 4 streams (one per process at s = 4).
        batch = (mesh.shape[stream_axis]
                 if stream_axis and self.width == "small" else w["ch_batch"])
        steps, n, rate = w["steps"], w["ch_n"], w["ch_rate"]
        chain = lambda: channelized_receiver(  # noqa: E731
            num_channels=64, input_rate=rate)
        bound = chain().bind(StreamSig(batch, n, rate))
        cs = ChannelShardedChain(bound, mesh, axis="c",
                                 stream_axis=stream_axis)
        xs = channel_input(self.width, steps, batch, n, rate,
                           7 if stream_axis else 6)
        cur = {"state": self.on_device(cs.init_state())}
        params = self.on_device(cs.params)

        def step(s):
            if s == 1:
                _maybe_die(case, self.rank)
            x = self.torch.from_numpy(xs[s]).to(self.device)
            cur["state"], y = cs.process(params, cur["state"], x)
            return y

        (ys, us, samples, held), launches, hops = self.counted(
            lambda: self.timed_steps(step, steps, case))
        seq = self.sequential(chain().bind(StreamSig(batch, n, rate)), xs)
        errs = self.held_to(case, case, ys, seq, lambda f: list(f),
                            rows=channel_rows(self.width, seq))
        return dict(us_per_step=us, us_samples=samples, steps=steps,
                    chunks=1, launches=launches,
                    hops=hops, held=held, errors=errs, batch=batch,
                    shards=[[int(i[0].start), int(i[0].stop)]
                            if isinstance(i[0], slice) else
                            [int(i[0][0]), int(i[0][-1]) + 1]
                            for i in ys[0].indices])

    def case_fused_channelizer(self, mesh, case):
        """Case 3's second half: the fused channelizer (#7) time-sharded
        over every entry."""
        from ..blocks.base import StreamSig
        from ..models.channelizer import channelized_receiver
        from ..parallel.time_shard import TimeShardedChain
        w = self.w
        t, steps = mesh.shape["t"], w["steps"]
        batch, n, rate = w["ch_batch"], w["ch_n"], w["ch_rate"]
        chain = lambda: channelized_receiver(  # noqa: E731
            num_channels=64, input_rate=rate, fuse=True)
        sig = StreamSig(batch, n, rate)
        bound = chain().bind(sig)
        ts = TimeShardedChain(bound, mesh, t_axis="t")
        xs = channel_input(self.width, steps * t, batch, n, rate, 8)
        out_n = bound.out_sig.chunk_len
        cur = {"state": self.on_device(ts.init_state())}
        params = self.on_device(ts.params)

        def step(s):
            x = self.torch.from_numpy(group_of(xs, s, t))
            cur["state"], y = ts.process(params, cur["state"], x)
            return y

        (ys, us, samples, held), launches, hops = self.counted(
            lambda: self.timed_steps(step, steps, case))
        seq = self.sequential(chain().bind(sig), xs)
        errs = self.held_to(case, case, ys, seq,
                            lambda f: [group_of(f, s, t)
                                       for s in range(steps)],
                            rows=channel_rows(self.width, seq))
        return dict(us_per_step=us, us_samples=samples, steps=steps,
                    chunks=t, launches=launches,
                    hops=hops, held=held, errors=errs, batch=batch,
                    shards=[[i[0].start, i[0].stop, i[1].start // out_n]
                            for i in ys[0].indices])

    def case_checkpoint(self, mesh, t, tmpdir, case):
        """Case 4: ``save_sharded`` after two group steps, ``load_sharded``,
        and two more steps of the resumed run bit for bit against the
        uninterrupted one."""
        from ..blocks.base import StreamSig
        from ..models.wfm import wfm_receiver
        from ..parallel.time_shard import TimeShardedChain
        from ..utils.checkpoint import load_sharded, save_sharded
        w = self.w
        batch, n, rate = w["batch"], w["n"], w["rate"]
        ts = TimeShardedChain(wfm_receiver(**w["chain"]).bind(
            StreamSig(batch, n, rate)), mesh, t_axis="t")
        xs = chunks(4 * t, batch, n, rate)
        params = self.on_device(ts.params)

        def run():
            st = self.on_device(ts.init_state())
            for s in range(2):
                st, _ = ts.process(params, st,
                                   self.torch.from_numpy(group_of(xs, s, t)))
            path = os.path.join(tmpdir, "ckpt")
            t0 = time.perf_counter()
            save_sharded(path, st)
            t1 = time.perf_counter()
            res = load_sharded(path, ts.init_state(), mesh=mesh)
            t2 = time.perf_counter()
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            for s in range(2, 4):
                x = self.torch.from_numpy(group_of(xs, s, t))
                st, y_ref = ts.process(params, st, x)
                res, y_res = ts.process(params, res, x)
                for (i, a), (j, b) in zip(y_ref.pieces, y_res.pieces):
                    assert i == j, (i, j)
                    if not self.torch.equal(a, b):
                        raise AssertionError(
                            f"{case}: resumed step {s} differs at {i} "
                            f"(max |diff| {float((a - b).abs().max())})")
            return dict(save_ms=1e3 * (t1 - t0), load_ms=1e3 * (t2 - t1),
                        bytes=nbytes)

        out, launches, hops = self.counted(run)
        return dict(out, launches=launches, hops=hops, steps=4, batch=batch)

    def case_pipeline(self, groups, case):
        """Cases 5 and 7: ``CrossProcessPipeline`` (``groups`` replicas of
        ``nproc / groups`` stages) against the sequential run, bit for
        bit."""
        from ..blocks.base import StreamSig
        from ..models.wfm import wfm_receiver
        from ..parallel.pipeline import CrossProcessPipeline
        w = self.w
        kw = w["pipe"] if groups == 1 else w["chain"]
        bs = w["pipe_batch"] if groups == 1 else w["group_batch"]
        steps = w["pipe_steps"] if groups == 1 else max(
            6, w["pipe_steps"] // 2)
        n, rate = w["n"], w["rate"]
        sig = StreamSig(bs, n, rate)
        pipe = CrossProcessPipeline(wfm_receiver(**kw).bind(sig),
                                    groups=groups, device=self.device)
        xs = chunks(steps, groups * bs, n, rate)

        def run():
            from ._common import timed
            with self.hold.tap(SKIP + 1) as rec:
                got, sec = timed(lambda: pipe.run(xs), self.device)
            # Each kernel's call of this stage's third chunk: the first
            # two demodulate the zero-primed filters' warm-up, chaotic in
            # the last bits.
            seen: dict = {}
            later = []
            for r in rec:
                seen[r["wrapper"]] = seen.get(r["wrapper"], -1) + 1
                if seen[r["wrapper"]] == SKIP:
                    later.append(r)
            return got, sec, self.hold.check(later, f"{case} p{self.rank}")

        (got, sec, held), launches, hops = self.counted(run)
        errs = {}
        if got is not None:
            rows = slice(pipe.gid * bs, (pipe.gid + 1) * bs)
            seq = self.sequential(wfm_receiver(**kw).bind(sig),
                                  xs[:, rows])
            got = got.cpu().numpy()
            np.testing.assert_array_equal(got, seq,
                                          err_msg=f"{case} vs seq")
            errs["seq"] = 0.0
            ref = self.want.get(case)
            if ref is not None:
                np.testing.assert_allclose(got[SKIP:], ref[:, rows][SKIP:],
                                           atol=ATOL,
                                           err_msg=f"{case} vs ref")
                errs["ref"] = float(np.max(np.abs(got[SKIP:]
                                                  - ref[:, rows][SKIP:])))
        ticks = steps + pipe.stages - 1
        return dict(us_per_tick=1e6 * sec / ticks, ticks=ticks, chunks=1,
                    launches=launches, hops=hops, held=held, errors=errs,
                    stage=[pipe.gid, pipe.sid], batch=bs,
                    blocks=len(pipe.stage.bound.blocks)
                    if hasattr(pipe.stage.bound, "blocks") else 1)

    # -- the job -------------------------------------------------------------

    def run(self, tmpdir: str) -> bool:
        """Every case in order; each process runs every case whatever its
        own verdict (a check fails on one process only, and leaving early
        would leave the others waiting in the next case's exchanges); the
        joint verdict comes last.  In kill mode a failure raises."""
        from ..parallel import multiprocess as mp
        from ..parallel.mesh import make_mesh
        kill = os.environ.get("FAKE_CLUSTER_KILL")
        ok = True
        nd, npr, loc = self.ndev, self.nproc, self.local
        mesh_t = make_mesh((nd,), ("t",), self.device)
        plan = [
            (CASES[0], lambda: self.case_time_sharded(
                mesh_t, nd, None, True, CASES[0])),
            (CASES[1], lambda: self.case_time_sharded(
                make_mesh((npr, loc), ("ch", "t"), self.device), loc, "ch",
                False, CASES[1])),
            (CASES[2], lambda: dict(
                channel=self.case_channel(
                    make_mesh((nd,), ("c",), self.device), CASES[2]),
                fused=self.case_fused_channelizer(mesh_t,
                                                  CASES[2] + "_fused"))),
            (CASES[3], lambda: self.case_checkpoint(mesh_t, nd, tmpdir,
                                                    CASES[3])),
            (CASES[4], lambda: self.case_pipeline(1, CASES[4])),
            (CASES[5], lambda: self.case_channel(
                make_mesh((npr, loc), ("s", "c"), self.device), CASES[5],
                stream_axis="s")),
            (CASES[6], lambda: self.case_pipeline(2, CASES[6])),
        ]
        if npr % 2:
            plan.pop()               # 2 groups need an even process count
        for name, fn in plan:
            try:
                self.results[name] = fn()
                if (os.environ.get("FAKE_CLUSTER_FAIL") == name
                        and self.rank == 1):
                    raise RuntimeError("injected failure (test)")
                print(f"[p{self.rank}] {name} ok", flush=True)
            except Exception as e:  # noqa: BLE001 - the joint verdict
                print(f"[p{self.rank}] {name} FAILED: {type(e).__name__}: "
                      f"{str(e)[:2000]}", flush=True)
                self.results[name] = {"failed": f"{type(e).__name__}"}
                ok = False
                if kill:
                    raise
        return mp.all_processes_ok(ok)


def elastic_worker(rank, nproc, device, width, ckpt_dir, mode) -> int:
    """The elastic drill's worker.  ``serve``: the time-sharded chain over
    every entry, two group steps, ``save_sharded``, then process 1
    SIGKILLs itself and the survivors go on until their first exchange
    with it fails: each prints ``DETECT <s>`` and exits 1 (7 if it never
    failed).  ``resume``: a smaller job (its entries over one process
    fewer) loads the checkpoint onto its mesh, continues the stream from
    the saved chunk and holds every chunk against the sequential run."""
    import torch

    from ..blocks.base import StreamSig
    from ..models.wfm import wfm_receiver
    from ..parallel import multiprocess as mp
    from ..parallel.mesh import make_mesh
    from ..parallel.time_shard import TimeShardedChain
    from ..utils.checkpoint import load_sharded, save_sharded
    w = WIDTHS[width]
    ndev = nproc * mp.local_entries(2)
    t, total = ndev, w["elastic"]
    mesh = make_mesh((ndev,), ("t",), device)
    batch, n, rate = w["batch"], w["n"], w["rate"]
    sig = StreamSig(batch, n, rate)
    ts = TimeShardedChain(wfm_receiver(**w["chain"]).bind(sig), mesh)
    xs = chunks(total, batch, n, rate)
    out_n = ts.out_sig.chunk_len
    from ..convert import tree_to_torch
    params = tree_to_torch(ts.params, device)

    def group_x(start):
        return torch.from_numpy(np.moveaxis(xs[start:start + t], 0, 1)
                                .reshape(batch, t * n))

    if mode == "serve":
        state = tree_to_torch(ts.init_state(), device)
        for s in range(2):
            state, _ = ts.process(params, state, group_x(s * t))
        save_sharded(os.path.join(ckpt_dir, "ckpt"), state)
        if rank == 0:
            with open(os.path.join(ckpt_dir, "progress.json"), "w") as f:
                json.dump({"chunks_done": 2 * t}, f)
        mp.all_processes_ok(True)   # the checkpoint is whole before the kill
        if rank == 1:
            print("[p1] elastic drill: SIGKILL mid-stream", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        t0 = time.monotonic()
        try:
            s0 = 2 * t
            while s0 + t <= total:
                state, y = ts.process(params, state, group_x(s0))
                s0 += t
            print(f"[p{rank}] ERROR: dead peer never detected", flush=True)
            return 7
        except Exception as e:  # noqa: BLE001 - the drill's way out
            print(f"[p{rank}] DETECT {time.monotonic() - t0:.3f} "
                  f"({type(e).__name__})", flush=True)
            return 1
    with open(os.path.join(ckpt_dir, "progress.json")) as f:
        done = json.load(f)["chunks_done"]
    seq = _Worker(rank, nproc, device, width, Hold(), {}).sequential(
        wfm_receiver(**w["chain"]).bind(sig), xs)
    state = load_sharded(os.path.join(ckpt_dir, "ckpt"), ts.init_state(),
                         mesh=mesh)
    ok, s0 = True, done
    worst = 0.0
    while s0 + t <= total:
        state, y = ts.process(params, state, group_x(s0))
        want = np.moveaxis(seq[s0:s0 + t], 0, 1).reshape(batch, t * out_n)
        try:
            mp.assert_addressable_allclose(y, want, ATOL,
                                           label=f"resume chunks {s0}")
            worst = max([worst] + [float(np.max(np.abs(
                p.cpu().numpy() - want[i]))) for i, p in y.pieces])
        except AssertionError as e:
            print(f"[p{rank}] resume check FAILED: {str(e)[:500]}",
                  flush=True)
            ok = False
        s0 += t
    ok = mp.all_processes_ok(ok and s0 == total)
    print(json.dumps({"resume": {"rank": rank, "ok": ok,
                                 "resumed_from_chunk": done,
                                 "chunks_recovered": total - done,
                                 "mesh_entries": ndev,
                                 "max_abs_err": worst}}), flush=True)
    return 0 if ok else 1


def worker(argv, hold: Hold = None) -> int:
    """A worker's main: the argv tail of ``launch_local_cluster`` and this
    tool's worker flags; returns its exit code."""
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", default="small", choices=sorted(WIDTHS))
    ap.add_argument("--want", default=None)
    args, _ = ap.parse_known_args(argv)
    torch.set_num_threads(1)
    from ..parallel import multiprocess as mp
    from ..runtime.blocks import resolve_device
    device = resolve_device(args.device)
    mode = os.environ.get("FAKE_CLUSTER_ELASTIC")
    hb = float(os.environ.get("FAKE_CLUSTER_HEARTBEAT", "120"))
    mp.initialize(args.coordinator, args.num_processes, args.process_id,
                  heartbeat_timeout_seconds=hb)
    rank = args.process_id
    ckpt = os.environ["FAKE_CLUSTER_TMP"]
    if mode:
        return elastic_worker(rank, args.num_processes, device, args.width,
                              ckpt, mode)
    want = {}
    if args.want:
        with np.load(args.want) as f:
            want = {k: f[k] for k in f.files}
    w = _Worker(rank, args.num_processes, device, args.width,
                hold or Hold(), want)
    print(f"[p{rank}] joined: {w.ndev} mesh entries ({w.local} here) on "
          f"{device}", flush=True)
    ok = w.run(ckpt)
    print(json.dumps({"worker": {"rank": rank, "device": str(device),
                                 "ok": ok, "cases": w.results}}),
          flush=True)
    return 0 if ok else 1


def run_worker(argv, hold: Hold = None) -> None:
    """Run :func:`worker` and leave at once with its code (a process
    group whose peer died must not hold the exit)."""
    try:
        code = worker(argv, hold)
    except BaseException as e:  # noqa: BLE001 - reported, then exit 1
        import traceback
        traceback.print_exc()
        print(f"worker error: {type(e).__name__}: {e}", flush=True)
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


# -- the launcher -------------------------------------------------------------


def _lines(outputs, key) -> list:
    """The ``{key: ...}`` JSON lines of the workers' outputs."""
    out = []
    for text in outputs:
        for line in text.splitlines():
            if line.startswith("{") and f'"{key}"' in line[:20]:
                out.append(json.loads(line)[key])
    return out


def run_cases(script=SCRIPT, num_processes=4, local_devices=2,
              args=(), env_extra=None, timeout=900.0):
    """The cases on a new cluster: (ok, the workers' records, codes,
    outputs).  ``env_extra`` selects a drill."""
    from ..parallel.multiprocess import launch_local_cluster
    tmp = tempfile.mkdtemp(prefix="rr_fake_cluster_")
    try:
        codes, outputs = launch_local_cluster(
            script, num_processes=num_processes, local_devices=local_devices,
            args=args, timeout=timeout,
            env_extra=dict(env_extra or {}, FAKE_CLUSTER_TMP=tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    records = _lines(outputs, "worker")
    ok = (codes == [0] * num_processes and len(records) == num_processes
          and all(r["ok"] for r in records))
    return ok, records, codes, outputs


def run_kill_drill(script=SCRIPT, num_processes=4, local_devices=2, args=(),
                   kill_case=CASES[0], timeout=600.0):
    """Process 1 SIGKILLs itself in ``kill_case``: the victim's code must
    be -9, every survivor's nonzero, none hung.  Returns (verdict,
    outputs)."""
    if kill_case not in KILL_HOOKED:
        raise ValueError(f"kill_case {kill_case!r} has no hook; hooked: "
                         f"{KILL_HOOKED}")
    t0 = time.monotonic()
    _, _, codes, outputs = run_cases(
        script, num_processes, local_devices, args,
        {"FAKE_CLUSTER_KILL": kill_case}, timeout)
    took = time.monotonic() - t0
    survivors = [codes[i] for i in range(num_processes) if i != 1]
    hung = [c for c in survivors if c is None]
    ok = (codes[1] == -signal.SIGKILL and not hung
          and all(c is not None and c != 0 for c in survivors))
    return {"ok": ok, "kill_case": kill_case, "victim_code": codes[1],
            "survivor_codes": survivors, "took_s": took,
            "hung": len(hung)}, outputs


def run_elastic_drill(script=SCRIPT, num_processes=4, local_devices=2,
                      args=(), heartbeat_s=10, timeout=900.0):
    """Serve, checkpoint, SIGKILL process 1 (the survivors' ``DETECT``
    seconds), then resume on ``num_processes - 1`` processes from the
    checkpoint.  Returns (verdict, outputs)."""
    from ..parallel.multiprocess import launch_local_cluster
    tmp = tempfile.mkdtemp(prefix="rr_elastic_")
    try:
        env = {"FAKE_CLUSTER_ELASTIC": "serve", "FAKE_CLUSTER_TMP": tmp,
               "FAKE_CLUSTER_HEARTBEAT": str(heartbeat_s)}
        codes_a, out_a = launch_local_cluster(
            script, num_processes=num_processes, local_devices=local_devices,
            args=args, timeout=timeout, env_extra=env)
        detect = [float(line.split()[2]) for text in out_a
                  for line in text.splitlines() if " DETECT " in line]
        survivors = [codes_a[i] for i in range(num_processes) if i != 1]
        phase_a = (codes_a[1] == -signal.SIGKILL
                   and all(c == 1 for c in survivors)
                   and len(detect) == num_processes - 1)
        t1 = time.monotonic()
        env["FAKE_CLUSTER_ELASTIC"] = "resume"
        codes_b, out_b = launch_local_cluster(
            script, num_processes=num_processes - 1,
            local_devices=local_devices, args=args, timeout=timeout,
            env_extra=env)
        recovery_s = time.monotonic() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resumed = _lines(out_b, "resume")
    ok = (phase_a and codes_b == [0] * (num_processes - 1)
          and len(resumed) == num_processes - 1
          and all(r["ok"] for r in resumed) and max(detect) < 15.0)
    return {"ok": ok, "heartbeat_s": heartbeat_s,
            "detect_s": max(detect) if detect else None,
            "detect_target_s": 15.0, "victim_code": codes_a[1],
            "survivor_codes": survivors, "resume_codes": codes_b,
            "recovery_s": recovery_s,
            "max_abs_err": max((r["max_abs_err"] for r in resumed),
                               default=None),
            "resume": resumed[0] if resumed else None}, out_a + out_b


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--process-id" in argv:
        run_worker(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", default="small", choices=sorted(WIDTHS))
    ap.add_argument("--num-processes", type=int, default=4)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--want", default=None,
                    help="npz of reference outputs by case")
    ap.add_argument("--out", default=None, help="write the summary here")
    ap.add_argument("--skip-kill-drill", action="store_true")
    ap.add_argument("--skip-elastic", action="store_true")
    args = ap.parse_args(argv)
    wargs = ["--device", args.device, "--width", args.width]
    if args.want:
        wargs += ["--want", os.path.abspath(args.want)]
    n, loc = args.num_processes, args.local_devices
    ok, records, codes, outputs = run_cases(SCRIPT, n, loc, wargs)
    for i, out in enumerate(outputs):
        print(f"--- process {i} (exit {codes[i]}) ---")
        print(out)
    summary = {"ok": ok, "num_processes": n, "local_entries": loc,
               "device": args.device, "width": args.width,
               "exit_codes": codes, "workers": records}
    if ok and not args.skip_kill_drill:
        drill, out = run_kill_drill(SCRIPT, n, loc, wargs)
        summary["kill_drill"] = drill
        print(f"--- SIGKILL drill: {json.dumps(drill)} ---")
        if not drill["ok"]:
            print("\n".join(out))
        ok = ok and drill["ok"]
    if ok and not args.skip_elastic:
        drill, out = run_elastic_drill(SCRIPT, n, loc, wargs)
        summary["elastic_drill"] = drill
        print(f"--- elastic drill: {json.dumps(drill)} ---")
        if not drill["ok"]:
            print("\n".join(out))
        ok = ok and drill["ok"]
    summary["ok"] = ok
    print(json.dumps({"fake_cluster": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
