"""Checkpoint / resume of streaming state (port of the JAX package's
``utils/checkpoint.py``).

The reference has no checkpointing (SURVEY.md §5): its only persistent
state is per-block stream state (filter tails, demod previous sample,
resampler rings, oscillator phase).  Here that state is an explicit tree,
so a checkpoint is a direct serialization of it to ``.npz``.

The file format is the JAX package's, so a file written by either package
loads in the other: the same key paths (``_SEP``-joined segments, ``!d`` /
``!l`` / ``!t`` markers for empty containers, ``=`` for a bare root leaf)
and complex leaves stored as float32 ``[re, im]`` planes under a
single-key ``{"__c64_wire__": planes}`` dict.  That encoding is private to
this module: the port's streams stay complex.

A saved checkpoint restores a pipeline mid-stream with bit-equal
continuation.  Tensor leaves (on any device) are copied to the host.

:func:`save_sharded` / :func:`load_sharded` checkpoint the state of a job
of several processes (``parallel/multiprocess.py``) in the port's own
format: a directory with one ``.npz`` per rank in :func:`save_state`'s
format (that rank's pieces) and a ``manifest.json`` with each leaf's
global shape and dtype, each piece's rank and index, and the process
count.  The JAX package writes these through orbax; neither package reads
the other's sharded checkpoints.
"""

from __future__ import annotations

from typing import Any

import json
import os

import numpy as np

from ..convert import _map, tree_to_numpy
from ..numbers import stream_complex, stream_real

__all__ = ["save_state", "load_state", "save_sharded", "load_sharded"]

_MANIFEST = "manifest.json"
_FORMAT = "radiorust_tpu_torch.sharded/1"

_SEP = "\x1f"
_WIRE_KEY = "__c64_wire__"


def _is_complex(x) -> bool:
    return isinstance(x, complex) or (
        hasattr(x, "dtype") and np.issubdtype(x.dtype, np.complexfloating))


def _to_planes(tree):
    def leaf(x):
        if not _is_complex(x):
            return x
        arr = np.asarray(x)
        rdt = stream_real()
        return {_WIRE_KEY: np.stack([arr.real.astype(rdt),
                                     arr.imag.astype(rdt)])}
    return _map(tree, leaf)


def _from_planes(tree):
    if isinstance(tree, dict):
        if set(tree) == {_WIRE_KEY}:
            v = tree[_WIRE_KEY]
            return (v[0] + 1j * v[1]).astype(stream_complex())
        return {k: _from_planes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_planes(v) for v in tree)
    return tree


def _flatten(tree, prefix=""):
    # Empty containers serialize explicitly: a stateless block mid-chain
    # contributes an empty () state, and dropping it would shift every
    # following block's state one slot left.  They get a marker leaf whose
    # path segment "!<kind>" records the kind.
    if isinstance(tree, dict):
        if not tree:
            yield (f"{prefix}{_SEP}!d" if prefix else "!d"), np.zeros(0)
            return
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{_SEP}d{k}" if prefix else f"d{k}")
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        if not tree:
            yield (f"{prefix}{_SEP}!{tag}" if prefix else f"!{tag}"), np.zeros(0)
            return
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{_SEP}{tag}{i}" if prefix
                                else f"{tag}{i}")
    else:
        # A bare leaf at the root takes the reserved name "=".
        yield prefix if prefix else "=", tree


_EMPTY = {"!d": {}, "!l": [], "!t": ()}


def _rebuild(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if len(keys) == 1 and keys[0] == "=":
        return node["="]                     # bare root leaf
    if len(keys) == 1 and keys[0] in _EMPTY:
        return _EMPTY[keys[0]]
    kinds = {k[0] for k in keys}
    if len(kinds) != 1:
        raise ValueError(f"mixed container kinds in a checkpoint: {keys}")
    kind = kinds.pop()
    if kind == "d":
        return {k[1:]: _rebuild(v) for k, v in node.items()}
    items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
    seq = [_rebuild(v) for _, v in items]
    return seq if kind == "l" else tuple(seq)


def save_state(path: str, tree: Any) -> None:
    """Serialize a (possibly nested) params/state tree of numpy arrays,
    numpy scalars or tensors to ``.npz`` at exactly ``path`` (``np.savez``
    alone would append ``.npz`` to an extension-less path)."""
    arrays = {name: np.asarray(leaf)
              for name, leaf in _flatten(_to_planes(tree_to_numpy(tree)))}
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_state(path: str) -> Any:
    """Restore a tree saved with :func:`save_state` (by this package or
    the JAX package): host numpy leaves, complex planes joined."""
    data = np.load(path, allow_pickle=False)
    root: dict = {}
    for name in data.files:
        parts = name.split(_SEP)
        cur = root
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        value = data[name]
        cur[parts[-1]] = value[()] if value.shape == () else value
    return _from_planes(_rebuild(root))


def _leaf_list(tree) -> list:
    from ..blocks.base import _leaves
    return _leaves(tree)


def _bounds(index, shape) -> list:
    """A piece's index as ``[[start, stop], ...]`` per leading axis."""
    out = []
    for sl, n in zip(index, shape):
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            raise ValueError(f"a sharded checkpoint stores pieces cut by "
                             f"slices, not {index}")
        out.append([sl.start or 0, n if sl.stop is None else sl.stop])
    return out


def save_sharded(path: str, tree: Any) -> None:
    """Checkpoint a state tree of a job of several processes: every
    process writes only its own pieces.  Collective: every process of the
    job calls it.  ``path``, a directory on a filesystem every process
    shares, must not exist yet.

    A leaf that is a :class:`~radiorust_tpu_torch.parallel.mesh.Shards`
    is written piece by piece by the ranks holding them; any other leaf
    (a tensor, an array, a number) is the same on every process, as an
    executor's carry is, and rank 0 writes it.  Complex pieces are stored
    as float32 planes, as :func:`save_state` stores them."""
    import torch

    from ..parallel.mesh import Shards
    from ..parallel.multiprocess import (all_processes_ok, process_count,
                                         process_index)
    rank, nproc = process_index(), process_count()
    # Every process looks before any writes, so all raise together.
    if not all_processes_ok(not os.path.exists(path)):
        raise FileExistsError(f"sharded checkpoint {path!r} exists")
    os.makedirs(path, exist_ok=True)
    leaves, pieces, mine = [], {}, {}
    for i, leaf in enumerate(_leaf_list(tree)):
        if isinstance(leaf, Shards):
            shape = leaf.shape
            parts = leaf.pieces
            first = parts[0][1]
        else:
            arr = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) \
                else np.asarray(leaf)
            shape = tuple(arr.shape)
            parts = [(tuple(slice(None) for _ in shape), arr)] \
                if rank == 0 else []
            first = arr
        dtype = str(tree_to_numpy(first).dtype)
        leaves.append({"shape": list(shape), "dtype": dtype})
        for j, (index, part) in enumerate(parts):
            name = f"leaf{i}_piece{j}"
            mine[name] = part
            pieces.setdefault(i, []).append(
                {"rank": rank, "name": name,
                 "index": _bounds(index, shape)})
    save_state(os.path.join(path, f"rank{rank}.npz"), mine)
    listed = [None] * nproc
    if nproc > 1:
        import torch.distributed as dist
        dist.all_gather_object(listed, pieces)
    else:
        listed = [pieces]
    if rank == 0:
        for i, leaf in enumerate(leaves):
            leaf["pieces"] = [p for got in listed for p in got.get(i, [])]
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump({"format": _FORMAT, "process_count": nproc,
                       "leaves": leaves}, f)
    # Nobody returns before the manifest is there.
    all_processes_ok(True)


def _placed(full: np.ndarray, spec, mesh):
    """``full`` placed onto ``mesh`` by ``spec`` (a mesh axis name or
    ``None`` per leading axis): this process's distinct pieces, as a
    :class:`~radiorust_tpu_torch.parallel.mesh.Shards`, or the whole
    value on its first device where it holds all of it."""
    import torch

    from ..parallel.mesh import Shards
    home = mesh.home
    cuts = []
    for pos in zip(*np.nonzero(mesh.ranks == mesh.rank)):
        at = dict(zip(mesh.axis_names, pos))
        index = []
        for dim, axis in enumerate(spec):
            if axis is None:
                index.append(slice(None))
                continue
            step = full.shape[dim] // mesh.shape[axis]
            index.append(slice(at[axis] * step, (at[axis] + 1) * step))
        while index and index[-1] == slice(None):
            index.pop()                 # as the executors index pieces
        if tuple(index) not in cuts:
            cuts.append(tuple(index))
    whole = all(all(sl == slice(None) or (sl.start == 0 and
                                          sl.stop == full.shape[d])
                    for d, sl in enumerate(c)) for c in cuts)
    if whole:
        return torch.from_numpy(np.ascontiguousarray(full)).to(home)
    return Shards(full.shape, [
        (c, torch.from_numpy(np.ascontiguousarray(full[c])).to(home))
        for c in cuts])


def load_sharded(path: str, like: Any, mesh=None, spec_fn=None) -> Any:
    """Restore a :func:`save_sharded` checkpoint, possibly onto a mesh of
    another size than the one that saved it (four processes save, three
    restore).

    ``like``: a tree of the saved structure (e.g. an executor's
    ``init_state()``); its leaves' shapes must match.  Without ``mesh``
    the leaves come back as host numpy arrays, as :func:`load_state`
    gives them.  With ``mesh`` each leaf lands on this process's first
    device of it, whole, unless ``spec_fn(shape)`` returns a mesh axis name
    (or ``None``) per leading axis: then this process gets the pieces of
    the entries it owns.  Collective, like :func:`save_sharded`."""
    from ..parallel.multiprocess import all_processes_ok
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"{path!r} is not a sharded checkpoint of this "
                         f"package ({manifest.get('format')!r})")
    want = _leaf_list(like)
    if len(want) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} "
                         f"leaves, the tree {len(want)}")
    files = {}
    out = []
    for leaf, ref in zip(manifest["leaves"], want):
        shape = tuple(leaf["shape"])
        if tuple(np.shape(ref)) != shape and not hasattr(ref, "pieces"):
            raise ValueError(f"leaf of shape {np.shape(ref)}, checkpoint "
                             f"{shape}")
        full = np.zeros(shape, dtype=np.dtype(leaf["dtype"]))
        for p in leaf["pieces"]:
            r = p["rank"]
            if r not in files:
                files[r] = load_state(os.path.join(path, f"rank{r}.npz"))
            index = tuple(slice(a, b) for a, b in p["index"])
            full[index] = files[r][p["name"]]
        if mesh is None:
            out.append(full)
        else:
            spec = spec_fn(shape) if spec_fn else ()
            spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
            out.append(_placed(full, spec, mesh))
    # Every process has read before anyone may remove the files.
    all_processes_ok(True)
    it = iter(out)
    return _map(like, lambda _: next(it))
