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
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..convert import _map, tree_to_numpy
from ..numbers import stream_complex, stream_real

__all__ = ["save_state", "load_state"]

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
