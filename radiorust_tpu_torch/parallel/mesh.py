"""The device mesh of the port's parallel layer, and its collectives.

The JAX package runs one controller over a ``jax.sharding.Mesh``:
``shard_map`` runs a handler once per device, with ``ppermute``,
``all_gather``, ``psum`` and ``axis_index`` between the devices.  The
port runs in one process and does the same by hand:

- :class:`Mesh` holds a numpy array of ``torch.device`` with named axes.
  A device may appear more than once: four entries of ``cuda:0`` give
  one card four shards, as ``--xla_force_host_platform_device_count``
  gives the JAX package virtual CPU devices.  Distinct cards work the
  same way.
- A sharded value is a list of D per-shard tensors, each on its shard's
  device.
- The collectives are plain functions over such lists: :func:`ring_left`
  (a cyclic shift), :func:`all_gather`, :func:`psum`; a shard's index is
  its position in the list.  Moving a tensor to the device it is on
  costs nothing, so on a mesh of one repeated card they copy nothing.

The parallel executors (``time_shard``, ``channel_shard``) work over all
shards of one block at a time: exchange the block's halo across the D
shards, then call the block's ``process`` once per shard.  There is no
``torch.distributed`` here: process groups are the port's next slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..convert import _map

__all__ = ["Mesh", "make_mesh", "move", "ring_left", "all_gather", "psum",
           "Replicas", "split_batch", "concat"]


class Mesh:
    """A named grid of torch devices (entries may repeat).

    ``devices``: anything ``np.array`` shapes into the grid (nested lists
    of ``torch.device`` or device strings); ``axis_names``: one name per
    grid axis.  ``shape`` maps each axis name to its size, as the JAX
    mesh's does."""

    def __init__(self, devices, axis_names: Sequence[str]):
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

    @property
    def home(self) -> torch.device:
        """The first device of the grid: where sharded results gather."""
        return self.devices.flat[0]

    @property
    def single_device(self) -> bool:
        """Whether every entry is one device (then a sharded step can be
        captured as one CUDA graph)."""
        return len({str(d) for d in self.devices.flat}) == 1

    def line(self, axis: str, **at: int) -> List[torch.device]:
        """The devices along ``axis``, the other axes at the indices
        ``at`` gives (0 where not given)."""
        idx = []
        for name in self.axis_names:
            idx.append(slice(None) if name == axis else at.get(name, 0))
        if axis not in self.axis_names:
            raise ValueError(f"{axis!r} is not an axis of the mesh "
                             f"(axes: {self.axis_names})")
        return list(self.devices[tuple(idx)])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices "
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names``.

    ``devices``: one device (a ``torch.device`` or a string such as
    ``"cuda"`` or ``"cpu"``), repeated over the whole grid; or a
    sequence of the grid's devices in order (repeats allowed); or None
    for the visible CUDA cards in order, one per entry (it raises if
    there are fewer)."""
    size = int(np.prod(axis_shapes))
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < size:
            raise ValueError(f"{count} CUDA devices for a mesh of {size}: "
                             f"pass a device to repeat (e.g. "
                             f"devices='cuda' or 'cpu')")
        devices = [torch.device("cuda", i) for i in range(size)]
    elif isinstance(devices, (str, torch.device)):
        devices = [torch.device(devices)] * size
    devices = list(devices)
    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for a mesh of {size}")
    grid = np.empty(size, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(tuple(axis_shapes)), axis_names)


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it is there already, else a copy
    (without blocking between two CUDA devices)."""
    if t.device == device:
        return t
    both_cuda = t.is_cuda and device.type == "cuda"
    return t.to(device, non_blocking=both_cuda)


def ring_left(vals: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Each shard receives the value of its left neighbour, cyclically
    (shard 0 that of shard D-1): ``ppermute`` with ``i -> i + 1``."""
    n = len(vals)
    return [move(vals[(d - 1) % n], devices[d]) for d in range(n)]


def all_gather(vals: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Each shard receives the [D, ...] stack of every shard's value
    (stacked once per distinct device)."""
    stacks: Dict[str, torch.Tensor] = {}
    out = []
    for dev in devices:
        key = str(dev)
        if key not in stacks:
            stacks[key] = torch.stack([move(v, dev) for v in vals])
        out.append(stacks[key])
    return out


def psum(vals: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Each shard receives the sum of every shard's value."""
    return [s.sum(dim=0) for s in all_gather(vals, devices)]


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
        from ..blocks.base import _hold, params_changed
        if self._held is None or params_changed(self._held, params):
            self._held = _hold(params)
            self._copies = {}
        out = []
        for dev in devices:
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
