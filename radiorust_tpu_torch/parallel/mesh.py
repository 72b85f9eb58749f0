"""The device mesh of the port's parallel layer, and its collectives.

The JAX package runs one controller over a ``jax.sharding.Mesh``:
``shard_map`` runs a handler once per device, with ``ppermute``,
``all_gather``, ``psum`` and ``axis_index`` between the devices.  The
port does the same by hand:

- :class:`Mesh` holds a numpy array of ``torch.device`` with named axes,
  and the rank of the process that owns each entry.  A device may appear
  more than once: four entries of ``cuda:0`` give one card four shards,
  as ``--xla_force_host_platform_device_count`` gives the JAX package
  virtual CPU devices.  Distinct cards work the same way.  After
  :func:`~radiorust_tpu_torch.parallel.multiprocess.initialize`,
  :func:`make_mesh` gives each process an equal block of entries in rank
  order (four workers with two entries each: the JAX fake cluster's
  8-entry global mesh).
- A sharded value is a list of D per-shard tensors, each on its shard's
  device; on a mesh that spans processes, the entries of the other
  processes hold ``None``, a placeholder: each process computes only its
  own shards.  An executor's results there are :class:`Shards`, this
  process's pieces of the value with their global indices.
- The collectives are plain functions over such lists: :func:`ring_left`
  (a cyclic shift), :func:`all_gather`, :func:`psum` and :func:`share`
  (one entry's value to every rank of a line); a shard's index is its
  position in the list.  Within a process, moving a tensor to the device
  it is on costs nothing, so on a mesh of one repeated card they copy
  nothing.  Between processes only the values that cross a rank boundary
  travel, point to point through the process group (gloo), each CUDA
  tensor staged through a pinned host buffer: copied out after its
  producers have finished, copied in on the current stream.
- :data:`TRAFFIC` counts the bytes each collective delivers to this
  process's shards, by kind and mesh axis
  (``tools/collective_volumes.py`` reads it).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import _map

__all__ = ["Mesh", "make_mesh", "move", "ring_left", "all_gather", "psum",
           "share", "Replicas", "split_batch", "concat", "Shards", "Line",
           "local_indices", "TRAFFIC", "HOPS"]

# {(kind, axis): bytes delivered to this process's shards}: ring_left
# counts each received value, all_gather the D values each shard stacks,
# psum the reduced value, share the carried value at each other shard.
TRAFFIC: collections.Counter = collections.Counter()
# This process's exchanges with other ranks: their count, the host
# seconds spent in them (staging excluded) and the bytes sent and
# received.
HOPS: collections.Counter = collections.Counter()


def _rank() -> int:
    from .multiprocess import process_index
    return process_index()


class Line(list):
    """The devices of one line of a mesh (one axis, the others fixed),
    with the rank that owns each entry and the axis's name."""

    def __init__(self, devices, ranks=None, axis: str = "", rank=None):
        super().__init__(devices)
        self.rank = _rank() if rank is None else rank
        self.ranks = [self.rank] * len(self) if ranks is None else list(ranks)
        self.axis = axis

    @property
    def spans(self) -> bool:
        return any(r != self.rank for r in self.ranks)


def local_indices(devices) -> List[int]:
    """The shards of ``devices`` (a :class:`Line` or a plain list, all
    local) that this process owns."""
    ranks = getattr(devices, "ranks", None)
    if ranks is None:
        return list(range(len(devices)))
    return [d for d, r in enumerate(ranks) if r == devices.rank]


def _spans(devices) -> bool:
    return isinstance(devices, Line) and devices.spans


def _axis(devices) -> str:
    return getattr(devices, "axis", "")


class Mesh:
    """A named grid of torch devices (entries may repeat), each entry
    owned by a rank of the job.

    ``devices``: anything ``np.array`` shapes into the grid (nested lists
    of ``torch.device`` or device strings); ``axis_names``: one name per
    grid axis; ``ranks``: the owner of each entry in the grid's order
    (default: this process owns them all).  ``shape`` maps each axis name
    to its size, as the JAX mesh's does."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        grid = np.array(devices, dtype=object)
        self.devices = np.empty(grid.shape, dtype=object)
        for i, d in np.ndenumerate(grid):
            self.devices[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device grid, axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate axis names {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self.size = self.devices.size
        self.rank = _rank()
        self.ranks = (np.full(self.devices.shape, self.rank) if ranks is None
                      else np.asarray(ranks, dtype=int).reshape(
                          self.devices.shape))
        if self.rank not in set(self.ranks.flat):
            raise ValueError(f"rank {self.rank} owns no entry of the mesh")

    @property
    def spans_processes(self) -> bool:
        """Whether other processes own entries of the mesh."""
        return bool((self.ranks != self.rank).any())

    @property
    def home(self) -> torch.device:
        """This process's first device of the grid: where its sharded
        results gather."""
        return self.devices[self.ranks == self.rank][0]

    @property
    def single_device(self) -> bool:
        """Whether one process owns every entry and every entry is one
        device (then a sharded step can be captured as one CUDA graph)."""
        return (not self.spans_processes
                and len({str(d) for d in self.devices.flat}) == 1)

    def line(self, axis: str, **at: int) -> Line:
        """The devices along ``axis``, the other axes at the indices
        ``at`` gives (0 where not given), with their ranks."""
        idx = []
        for name in self.axis_names:
            idx.append(slice(None) if name == axis else at.get(name, 0))
        if axis not in self.axis_names:
            raise ValueError(f"{axis!r} is not an axis of the mesh "
                             f"(axes: {self.axis_names})")
        return Line(list(self.devices[tuple(idx)]),
                    list(self.ranks[tuple(idx)]), axis, self.rank)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices "
                f"{[str(d) for d in self.devices.flat]}, ranks "
                f"{[int(r) for r in self.ranks.flat]})")


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names``.

    ``devices``: one device (a ``torch.device`` or a string such as
    ``"cuda"`` or ``"cpu"``), repeated over the whole grid; or a
    sequence of the grid's devices in order (repeats allowed); or None
    for the visible CUDA cards in order, one per entry (it raises if
    there are fewer).  In a job of several processes each entry's device
    is its owner's.

    In a job of N processes (:func:`~radiorust_tpu_torch.parallel.
    multiprocess.initialize`), entries ``[i * size/N, (i+1) * size/N)``
    belong to rank ``i`` (the JAX package's global device order); outside
    a job this process owns them all.  :class:`Mesh` takes any other
    layout."""
    from .multiprocess import process_count
    size = int(np.prod(axis_shapes))
    nproc = process_count()
    ranks = None
    if nproc > 1:
        if size % nproc:
            raise ValueError(f"a mesh of {size} entries over {nproc} "
                             f"processes: not an equal block each")
        ranks = [i * nproc // size for i in range(size)]
    if devices is None:
        per = size if ranks is None else list(ranks).count(_rank())
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < per:
            raise ValueError(f"{count} CUDA devices for {per} entries: "
                             f"pass a device to repeat (e.g. "
                             f"devices='cuda' or 'cpu')")
        devices = [torch.device("cuda", i % per) for i in range(size)]
    elif isinstance(devices, (str, torch.device)):
        devices = [torch.device(devices)] * size
    devices = list(devices)
    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for a mesh of {size}")
    grid = np.empty(size, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(tuple(axis_shapes)), axis_names, ranks)


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it is there already, else a copy
    (without blocking between two CUDA devices)."""
    if t.device == device:
        return t
    both_cuda = t.is_cuda and device.type == "cuda"
    return t.to(device, non_blocking=both_cuda)


# -- across processes ---------------------------------------------------------


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host for gloo: a CUDA tensor copied into a pinned
    buffer (the copy waits for the work that produced it)."""
    t = t.detach()
    if not t.is_cuda:
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _landing(like: torch.Tensor) -> torch.Tensor:
    """A host buffer to receive a value shaped as ``like`` (pinned where
    ``like`` is on a card)."""
    return torch.empty(like.shape, dtype=like.dtype,
                       pin_memory=like.is_cuda)


def _land(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    return buf.to(device, non_blocking=True) if device.type == "cuda" \
        else buf


def _exchange(sends, recvs) -> None:
    """Post every send ``(tensor, rank, tag)`` and receive ``(buffer,
    rank, tag)``, then wait for all: no ordering of the two sides can
    deadlock.  A failed peer raises here (no retry, no other path)."""
    import time

    import torch.distributed as dist
    t0 = time.perf_counter()
    # An empty value has nothing to carry; both sides know its shape.
    works = [dist.isend(t, r, tag=tag) for t, r, tag in sends if t.numel()]
    works += [dist.irecv(b, r, tag=tag) for b, r, tag in recvs
              if b.numel()]
    for w in works:
        w.wait()
    HOPS["exchanges"] += 1
    HOPS["seconds"] += time.perf_counter() - t0
    HOPS["bytes"] += sum(t.nbytes for t, _, _ in (*sends, *recvs))


def ring_left(vals: List[Optional[torch.Tensor]], devices, wrap: bool = True,
              like: Optional[torch.Tensor] = None):
    """Each shard receives the value of its left neighbour, cyclically
    (shard 0 that of shard D-1): ``ppermute`` with ``i -> i + 1``.
    ``wrap=False``: shard 0 receives nothing (``None``).  Across
    processes, shard d's value comes from its owner; ``like`` gives the
    value's shape and type where this process's own shard has none (by
    default its own value)."""
    n = len(vals)
    first = 0 if wrap else 1
    mine = local_indices(devices)
    out: list = [None] * n
    for d in mine:
        if d >= first and vals[(d - 1) % n] is not None:
            TRAFFIC["ring_left", _axis(devices)] += vals[(d - 1) % n].nbytes
    if not _spans(devices):
        for d in range(first, n):
            out[d] = move(vals[(d - 1) % n], devices[d])
        return out
    ranks = devices.ranks
    sends, recvs, landed = [], [], []
    for d in range(first, n):
        src = (d - 1) % n
        if ranks[d] == devices.rank and ranks[src] == devices.rank:
            out[d] = move(vals[src], devices[d])
        elif ranks[d] == devices.rank:
            tmpl = vals[d] if like is None else like
            buf = _landing(tmpl)
            recvs.append((buf, ranks[src], d))
            landed.append((d, buf))
            TRAFFIC["ring_left", _axis(devices)] += buf.nbytes
        elif ranks[src] == devices.rank:
            sends.append((_staged(vals[src]), ranks[d], d))
    _exchange(sends, recvs)
    for d, buf in landed:
        out[d] = _land(buf, devices[d])
    return out


def all_gather(vals: List[Optional[torch.Tensor]], devices):
    """Each shard receives the [D, ...] stack of every shard's value
    (stacked once per distinct device).  Across processes each rank sends
    its own shards' values, stacked, to every other rank of the line."""
    n = len(vals)
    mine = local_indices(devices)
    full = list(vals)
    if _spans(devices):
        ranks = devices.ranks
        first = vals[mine[0]]
        own = _staged(torch.stack([move(vals[d], first.device)
                                   for d in mine]))
        sends, recvs = [], []
        for r in sorted(set(ranks) - {devices.rank}):
            idx = [d for d in range(n) if ranks[d] == r]
            buf = torch.empty((len(idx),) + tuple(first.shape),
                              dtype=first.dtype, pin_memory=first.is_cuda)
            sends.append((own, r, 0))
            recvs.append((buf, r, 0))
            for j, d in enumerate(idx):
                full[d] = buf[j]
        _exchange(sends, recvs)
    stacks: Dict[str, torch.Tensor] = {}
    out: list = [None] * n
    for d in mine:
        key = str(devices[d])
        if key not in stacks:
            stacks[key] = torch.stack([move(v, devices[d]) for v in full])
        out[d] = stacks[key]
        TRAFFIC["all_gather", _axis(devices)] += out[d].nbytes
    return out


def psum(vals: List[Optional[torch.Tensor]], devices):
    """Each shard receives the sum of every shard's value."""
    return [None if s is None else s.sum(dim=0)
            for s in all_gather(vals, devices)]


def share(tree, src: int, devices, like=None):
    """Shard ``src``'s value (a tree of tensors) at every rank of the line,
    on this process's first device of it.  ``like``: a tree of the same
    shapes and types where this process does not own ``src``."""
    from ..blocks.base import _leaves
    mine = local_indices(devices)
    home = devices[mine[0]]
    if not _spans(devices):
        return _map(tree, lambda t: move(t, home))
    ranks = devices.ranks
    if ranks[src] == devices.rank:
        leaves = _leaves(tree)
        staged = [_staged(t) for t in leaves]
        others = sorted(set(ranks) - {devices.rank})
        _exchange([(t, r, j) for r in others for j, t in enumerate(staged)],
                  [])
        return _map(tree, lambda t: move(t, home))
    bufs = [_landing(t) for t in _leaves(like)]
    _exchange([], [(b, ranks[src], j) for j, b in enumerate(bufs)])
    TRAFFIC["share", _axis(devices)] += sum(b.nbytes for b in bufs)
    it = iter([_land(b, home) for b in bufs])
    return _map(like, lambda _: next(it))


class Shards:
    """This process's pieces of a value laid out over a mesh that spans
    processes: the port's counterpart of a ``jax.Array``'s addressable
    shards.  ``shape``: the whole value's; ``pieces``: ``(index,
    tensor)`` pairs, ``index`` a tuple of one slice (or an array of
    positions) per leading axis of the value."""

    def __init__(self, shape, pieces):
        self.shape = tuple(shape)
        self.pieces = list(pieces)

    @property
    def indices(self) -> list:
        return [i for i, _ in self.pieces]

    def get(self, index) -> torch.Tensor:
        """The part of this process's pieces at ``index`` (slices of the
        leading axes, inside one piece)."""
        for have, t in self.pieces:
            rel = []
            for want, got in zip(index, have):
                if not isinstance(got, slice):
                    break
                g0 = got.start or 0
                g1 = self.shape[len(rel)] if got.stop is None else got.stop
                w0 = want.start or 0
                w1 = self.shape[len(rel)] if want.stop is None else want.stop
                if not (g0 <= w0 and w1 <= g1):
                    break
                rel.append(slice(w0 - g0, w1 - g0))
            else:
                return t[tuple(rel)]
        raise KeyError(f"no piece of this process holds {index} "
                       f"(pieces {self.indices})")

    def join(self, device: torch.device) -> torch.Tensor:
        """The whole value on ``device``, where this process holds all of
        it in slices: each band of rows joined along the last axis, the
        bands along the first."""
        bands: Dict[int, list] = {}
        for index, t in self.pieces:
            col = (index[1].start or 0) if len(index) > 1 else 0
            bands.setdefault(index[0].start or 0, []).append((col, t))
        parts = []
        for _, band in sorted(bands.items()):
            ts = [move(t, device) for _, t in sorted(band,
                                                     key=lambda p: p[0])]
            parts.append(ts[0] if len(ts) == 1 else torch.cat(ts, dim=-1))
        whole = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        if tuple(whole.shape) != self.shape:
            raise ValueError(f"pieces {self.indices} do not make up the "
                             f"value of shape {self.shape}")
        return whole

    def __repr__(self) -> str:
        return f"Shards({self.shape}, {self.indices})"


class Replicas:
    """Params copied once to each distinct device of a shard list: call
    with a params tree and the devices; the copies of a device are made
    again only when the tree changes (another leaf, or a leaf written in
    place), so a step loop passing one tree copies nothing after its
    first call.  Leaves already on a device are used as they are."""

    def __init__(self):
        self._held = None
        self._copies: Dict[str, object] = {}

    def __call__(self, params, devices) -> list:
        """One params tree per entry of ``devices``; ``None`` at the
        entries other processes own."""
        from ..blocks.base import _hold, params_changed
        if self._held is None or params_changed(self._held, params):
            self._held = _hold(params)
            self._copies = {}
        out = []
        mine = set(local_indices(devices))
        for d, dev in enumerate(devices):
            if d not in mine:
                out.append(None)
                continue
            key = str(dev)
            if key not in self._copies:
                self._copies[key] = _map(
                    params, lambda t: move(t, dev)
                    if isinstance(t, torch.Tensor) else t)
            out.append(self._copies[key])
        return out


def _batch_leaf(t, b: int):
    if not isinstance(t, torch.Tensor) or t.dim() == 0 or t.shape[0] != b:
        shape = tuple(t.shape) if isinstance(t, torch.Tensor) else t
        raise ValueError(f"state leaf not batch-major: shape {shape}, "
                         f"batch {b}")
    return t


def split_batch(tree, parts: int, batch: int, devices=None) -> list:
    """``parts`` trees, each the ``batch // parts`` rows of every leaf of
    ``tree`` in turn (leaves are batch-major), on ``devices[i]`` where
    given."""
    if batch % parts:
        raise ValueError(f"batch {batch} not divisible by {parts}")
    bs = batch // parts
    out = []
    for i in range(parts):
        def cut(t, i=i):
            piece = _batch_leaf(t, batch)[i * bs:(i + 1) * bs]
            return piece if devices is None else move(piece, devices[i])
        out.append(_map(tree, cut))
    return out


def concat(trees: list, device: torch.device, dim: int = 0):
    """One tree of ``trees``' leaves concatenated along ``dim`` on
    ``device``."""
    from ..blocks.base import _leaves
    cols = zip(*(_leaves(t) for t in trees))
    it = iter([torch.cat([move(leaf, device) for leaf in col], dim=dim)
               for col in cols])
    return _map(trees[0], lambda _: next(it))
