"""Channel (expert) parallelism for channelizer chains (PyTorch port of
the JAX package's ``parallel/channel_shard.py``).

The polyphase filterbank turns one wideband stream into M narrowband
channels that ride the batch axis (``blocks/channelize.py``).  Split over
D devices, each owns M/D channels and all of their downstream
per-channel processing:

1. the wideband chunk is replicated (each shard needs its strided subset
   of every frame);
2. each shard runs the branch FIR of its branch group, M/D of the M
   polyphase branches;
3. one :func:`~radiorust_tpu_torch.parallel.mesh.all_gather` assembles
   the decimated branch values (the only exchange: 1/D of the input a
   shard);
4. each shard takes the DFT columns of its channel group and feeds its
   ``[b * M/D, t]`` folded channels through the downstream blocks, which
   never couple channels.

The branch FIR and the DFT are PyTorch calls here as they are XLA work
in the JAX package (``ops/channelizer.py``), not kernels; the downstream
blocks launch theirs.  Downstream per-channel state is kept ``[batch, M,
...]`` so that it splits by channel; the raw-input history is per stream
and replicated.  ``stream_axis`` adds a second mesh axis over the stream
batch (a 2-D streams x channels tile).
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks.base import _Compiled
from ..blocks.channelize import _BoundChannelizer
from ..convert import _map
from ..ops.channelizer import _dft_tensors, branch_fir, dft_channels
from .mesh import (Mesh, Replicas, Shards, all_gather, concat,
                   local_indices, move)

__all__ = ["ChannelShardedChain"]


def _local_channelize(chan, taps, xp, c: int, ndev: int):
    """Shard ``c``'s branch FIR: ``xp`` [b, hist + n] (history and chunk),
    ``taps`` [K, M]; returns its branch group's (vr, vi) [b, T, M/D]."""
    m, k = chan.m, chan.k
    mg = m // ndev
    b, total = xp.shape
    t_out = total // m - (k - 1)
    frames = xp.reshape(b, total // m, m)[..., c * mg:(c + 1) * mg]
    return branch_fir(frames.real, frames.imag,
                      taps[:, c * mg:(c + 1) * mg], t_out)


def _part(leaf, index):
    """``leaf[index]``, or the part of this process's pieces of a
    :class:`~radiorust_tpu_torch.parallel.mesh.Shards` at ``index``."""
    return leaf.get(index) if isinstance(leaf, Shards) else leaf[index]


class ChannelShardedChain:
    """A bound channelizer chain with its M channels (and all of their
    downstream processing) split over the mesh's channel axis.

    The first block must be a :class:`Channelizer` binding; every later
    block must keep the folded ``batch * M`` axis.  ``process(params,
    state, x, reset=None)`` has the bound chain's signature and its
    results (state in this executor's layout, :meth:`init_state`).
    ``stream_axis`` also splits the stream batch over a second axis: each
    device owns one (stream group, channel group) tile, and the gather
    stays within its stream group's row."""

    def __init__(self, bound_chain, mesh: Mesh, axis: str = "c",
                 stream_axis: str | None = None):
        blocks = getattr(bound_chain, "blocks", None)
        if not blocks or not isinstance(blocks[0], _BoundChannelizer):
            raise ValueError("ChannelShardedChain requires a bound Chain "
                             "whose first block is a Channelizer")
        self.chan = blocks[0]
        self.rest = blocks[1:]
        self.ndev = mesh.shape[axis]
        if self.chan.m % self.ndev:
            raise ValueError(
                f"num_channels {self.chan.m} not divisible by mesh axis "
                f"{axis!r} ({self.ndev} devices)")
        self.stream_axis = stream_axis
        self.sdev = mesh.shape[stream_axis] if stream_axis else 1
        if bound_chain.in_sig.batch % self.sdev:
            raise ValueError(
                f"stream batch {bound_chain.in_sig.batch} not divisible "
                f"by mesh axis {stream_axis!r} ({self.sdev} devices)")
        folded = self.chan.out_sig.batch
        for blk in self.rest:
            if blk.in_sig.batch != folded or blk.out_sig.batch != folded:
                raise ValueError(
                    f"{type(blk).__name__} changes the folded channel "
                    f"batch; only batch-preserving per-channel blocks can "
                    f"channel-shard")
            if not blk.shard_batch_ok(self.ndev * self.sdev):
                raise ValueError(
                    f"{type(blk).__name__} cannot split {folded} channel "
                    f"rows over {self.ndev * self.sdev} devices "
                    f"(per-shard constraint)")
        self.bound = bound_chain
        self.mesh = mesh
        self.axis = axis
        self.in_sig = bound_chain.in_sig
        self.out_sig = bound_chain.out_sig
        # The runtime actor's surface: the typed setters walk .blocks with
        # .params; the warm-up reads valid_from.
        self.blocks = bound_chain.blocks
        self.valid_from = bound_chain.valid_from
        # tiles[s][c]: the device of stream group s, channel group c.
        self._tiles = [mesh.line(axis, **({stream_axis: s} if stream_axis
                                          else {}))
                       for s in range(self.sdev)]
        self._replicas = Replicas()

    @property
    def params(self):
        return self.bound.params

    @params.setter
    def params(self, new):
        self.bound.params = new

    def init_state(self):
        """Chain-shaped state; the downstream per-channel leaves as
        ``[batch, M, ...]`` (the channel axis explicit, to split)."""
        b = self.in_sig.batch
        state = [self.chan.init_state()]
        for blk in self.rest:
            state.append(_map(blk.init_state(), lambda a: np.reshape(
                a, (b, self.chan.m) + a.shape[1:])))
        return tuple(state)

    def state_from_chain(self, chain_state):
        """A sequential chain's state (numpy) in this executor's layout
        (``[batch*M, ...]`` -> ``[batch, M, ...]``): a one-device
        checkpoint restored onto a channel mesh."""
        b = self.in_sig.batch
        out = [chain_state[0]]
        for s in chain_state[1:]:
            out.append(_map(s, lambda a: np.reshape(
                np.asarray(a), (b, self.chan.m) + np.shape(a)[1:])))
        return tuple(out)

    def state_to_chain(self, state):
        """The inverse of :meth:`state_from_chain` (numpy trees)."""
        from ..convert import tree_to_numpy
        out = [tree_to_numpy(state[0])]
        for s in state[1:]:
            out.append(_map(tree_to_numpy(s), lambda a: np.reshape(
                a, (-1,) + a.shape[2:])))
        return tuple(out)

    def _row(self, params, state, x, reset, devices, cut):
        """One stream group's step over this process's channel shards:
        (new raw history, {c: downstream state tree [b, M/D, ...]}, {c: y
        [b, M/D, t]}).  ``state`` is the whole executor's, ``cut`` the
        group's streams."""
        chan, ndev = self.chan, self.ndev
        m, mg = chan.m, chan.m // ndev
        bl = x.shape[0]
        mine = local_indices(devices)
        ps = self._replicas(params, devices)
        # The history and chunk are replicated: joined once per device.
        xps = {}
        for c in mine:
            dev = devices[c]
            if str(dev) not in xps:
                h = move(_part(state[0]["hist"], (cut,)), dev)
                r = move(reset, dev)
                h = torch.where(r[:, None], torch.zeros_like(h), h)
                xps[str(dev)] = torch.cat([h, move(x, dev)], dim=-1)
        branches: list = [None] * ndev
        for c in mine:
            branches[c] = _local_channelize(chan, ps[c][0]["taps"],
                                            xps[str(devices[c])], c, ndev)
        vrs = all_gather([None if v is None else v[0] for v in branches],
                         devices)
        vis = all_gather([None if v is None else v[1] for v in branches],
                         devices)
        tiles, news = {}, {}
        for c in mine:
            dev = devices[c]
            # [D, b, T, mg] -> [b, T, M]: shard order is branch order.
            vr = vrs[c].permute(1, 2, 0, 3).reshape(bl, -1, m)
            vi = vis[c].permute(1, 2, 0, 3).reshape(bl, -1, m)
            dr, di = _dft_tensors(m, dev, vr.dtype)
            y = dft_channels(vr, vi, dr[:, c * mg:(c + 1) * mg],
                             di[:, c * mg:(c + 1) * mg])     # [b, T, mg]
            y = y.transpose(1, 2).reshape(bl * mg, -1)
            # The local folded batch repeats each stream's flag mg times.
            r_loc = move(reset, dev)[:, None].expand(-1, mg).reshape(-1)
            new = []
            group = (cut, slice(c * mg, (c + 1) * mg))
            for j, blk in enumerate(self.rest, start=1):
                s = _map(state[j], lambda a: move(
                    _part(a, group), dev).reshape((bl * mg,) + a.shape[2:]))
                s, y = blk.process(ps[c][j], s, y, r_loc)
                new.append(_map(s, lambda a: a.reshape(
                    (bl, mg) + a.shape[1:])))
            tiles[c] = y.reshape(bl, mg, -1)
            news[c] = new
        xp = xps[str(devices[mine[0]])]
        hist_len = chan.hist_len
        hist = (xp[:, -hist_len:] if hist_len
                else _part(state[0]["hist"], (cut,)))
        return hist, news, tiles

    def process(self, params, state, x, reset=None):
        """One step.  On a mesh that spans processes each process steps
        only its own (stream group, channel group) tiles: the output is a
        :class:`~radiorust_tpu_torch.parallel.mesh.Shards` of the folded
        ``[batch * M, t]`` rows of those tiles, and the state's leaves are
        :class:`~radiorust_tpu_torch.parallel.mesh.Shards` of its rows and
        channel groups wherever this process does not hold them all."""
        from ..blocks.base import _leaves
        if reset is None:
            reset = torch.zeros((x.shape[0],), dtype=torch.bool,
                                device=x.device)
        m, mg = self.chan.m, self.chan.m // self.ndev
        batch = x.shape[0]
        bs = batch // self.sdev
        hists, downs, pieces = [], {}, []
        for s, devices in enumerate(self._tiles):
            mine = local_indices(devices)
            if not mine:
                continue
            cut = slice(s * bs, (s + 1) * bs)
            hist, news, tiles = self._row(params, state, x[cut], reset[cut],
                                          devices, cut)
            hists.append(((cut,), hist))
            for c in mine:
                downs[(s, c)] = news[c]
            first = devices[mine[0]]
            t = torch.cat([move(tiles[c], first) for c in mine], dim=1)
            if len(mine) == self.ndev:
                rows = slice(s * bs * m, (s + 1) * bs * m)
            else:
                rows = np.concatenate([
                    b * m + np.arange(c * mg, (c + 1) * mg)
                    for b in range(s * bs, (s + 1) * bs) for c in mine])
                if np.array_equal(rows, np.arange(rows[0], rows[-1] + 1)):
                    rows = slice(int(rows[0]), int(rows[-1]) + 1)
            pieces.append(((rows, slice(None)), t.reshape(-1, t.shape[-1])))
        y = Shards((batch * m, pieces[0][1].shape[-1]), pieces)
        if len(downs) == self.sdev * self.ndev:
            home = self.mesh.home
            new_state = [{"hist": torch.cat([move(h, home)
                                             for _, h in hists])}]
            for j in range(len(self.rest)):
                new_state.append(concat(
                    [concat([downs[(s, c)][j] for c in range(self.ndev)],
                            home, dim=1) for s in range(self.sdev)], home))
            if not self.mesh.spans_processes:
                y = y.join(home)
            return tuple(new_state), y
        h = hists[0][1]
        new_state = [{"hist": Shards((batch,) + tuple(h.shape[1:]), hists)}]
        keys = sorted(downs)
        for j in range(len(self.rest)):
            cols = zip(*(_leaves(downs[k][j]) for k in keys))
            it = iter([Shards(
                (batch, m) + tuple(col[0].shape[2:]),
                [((slice(s * bs, (s + 1) * bs),
                   slice(c * mg, (c + 1) * mg)), t)
                 for (s, c), t in zip(keys, col)]) for col in cols])
            new_state.append(_map(downs[keys[0]][j], lambda _: next(it)))
        return tuple(new_state), y

    def jit_step(self) -> _Compiled:
        """The compiled step for live serving (``RuntimeBlock(...,
        shard="channels")``): ``step(params, state, x, reset=None)`` as
        :func:`~radiorust_tpu_torch.blocks.base.jit_step`, one CUDA graph
        of every shard's work where the mesh is one card, eager
        otherwise.  On a mesh that spans processes it raises: a CUDA graph
        cannot capture a gloo exchange, and such a step runs eagerly
        through :meth:`process`."""
        if self.mesh.spans_processes:
            raise NotImplementedError(
                "ChannelShardedChain.jit_step on a mesh that spans "
                "processes: step eagerly with process()")
        return _Compiled(self.bound, whole_run=False, process=self.process,
                         capturable=self.mesh.single_device)
