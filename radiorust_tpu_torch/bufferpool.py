"""Host-side chunk buffer management.

Analog of the reference's ``src/bufferpool.rs``: ``Chunk`` is an immutable
view over shared storage with zero-copy beginning-split operations
(``bufferpool.rs:44-97``), ``ChunkBuf`` is its mutable builder, and
``ChunkBufPool`` recycles storage (``bufferpool.rs:187-223``).

In the port the *device* memory is managed by PyTorch's caching
allocator; this pool manages the **host staging buffers** the streaming
runtime shuffles between blocks and I/O drivers.  numpy slicing already gives zero-copy views, so ``Chunk``
is a thin wrapper adding the reference's split API and pool-recycling of
the backing storage: when the last view of a recyclable buffer is
released, its storage returns to the pool (the analog of the
``Arc::try_unwrap`` + mpsc return at ``bufferpool.rs:82-90``).

Usage (the reference's doc-test, ``bufferpool.rs:176-186``):

>>> pool = ChunkBufPool(dtype=float)
>>> buf = pool.get()
>>> buf.extend([1.0, 2.0, 3.0])
>>> chunk = buf.finalize()
>>> len(chunk), float(chunk[1])
(3, 2.0)
>>> head = chunk.separate_beginning(1)
>>> rest = chunk.discard_beginning(1)
>>> len(head), len(rest)
(1, 2)
"""

from __future__ import annotations

import sys
import weakref
from typing import List, Optional

import numpy as np

__all__ = ["Chunk", "ChunkBuf", "ChunkBufPool"]


class _Storage:
    """Backing array plus an optional return-to-pool hook."""

    __slots__ = ("array", "pool_ref", "__weakref__")

    def __init__(self, array: np.ndarray, pool: Optional["ChunkBufPool"]):
        self.array = array
        self.pool_ref = weakref.ref(pool) if pool is not None else None

    def __del__(self):
        if self.pool_ref is not None:
            pool = self.pool_ref()
            # Recycle only when no external view references the backing
            # array (numpy views hold a base reference) — the analog of the
            # reference's ``Arc::try_unwrap`` succeeding only for the last
            # owner (``bufferpool.rs:82-90``).  Expected refs: our
            # attribute + getrefcount's temporary.
            if pool is not None and sys.getrefcount(self.array) <= 2:
                pool._recycle(self.array)


class Chunk:
    """Immutable view of sample storage (``bufferpool.rs:44-97``)."""

    __slots__ = ("_storage", "_start", "_stop")

    def __init__(self, storage: _Storage, start: int, stop: int):
        self._storage = storage
        self._start = start
        self._stop = stop

    @classmethod
    def from_array(cls, array) -> "Chunk":
        """Non-recyclable chunk from an existing array
        (``bufferpool.rs:101-106``)."""
        arr = np.asarray(array)
        return cls(_Storage(arr, None), 0, len(arr))

    def __len__(self) -> int:
        return self._stop - self._start

    @property
    def data(self) -> np.ndarray:
        """Zero-copy numpy view of this chunk's samples."""
        return self._storage.array[self._start:self._stop]

    def __array__(self, dtype=None, copy=None):
        v = self.data
        if dtype is not None and dtype != v.dtype:
            if copy is False:
                # numpy 2 __array__ contract: copy=False means the caller
                # requires zero-copy; a dtype conversion cannot satisfy it.
                raise ValueError(
                    "Chunk cannot be viewed as a different dtype without "
                    "copying (copy=False requested)")
            return v.astype(dtype)   # astype always copies here
        # copy=True must NOT hand out a live view of pooled storage
        # (sibling zero-copy Chunks and recycled buffers share it).
        return v.copy() if copy else v

    def __getitem__(self, idx):
        return self.data[idx]

    # ndarray-like arithmetic (operations yield plain numpy arrays, so
    # user closures treat a Chunk exactly like the array it views).
    def __add__(self, o): return self.data + o          # noqa: E704
    def __radd__(self, o): return o + self.data         # noqa: E704
    def __sub__(self, o): return self.data - o          # noqa: E704
    def __rsub__(self, o): return o - self.data         # noqa: E704
    def __mul__(self, o): return self.data * o          # noqa: E704
    def __rmul__(self, o): return o * self.data         # noqa: E704
    def __truediv__(self, o): return self.data / o      # noqa: E704
    def __rtruediv__(self, o): return o / self.data     # noqa: E704
    def __neg__(self): return -self.data                # noqa: E704
    def __abs__(self): return abs(self.data)            # noqa: E704
    def __iter__(self): return iter(self.data)          # noqa: E704

    @property
    def dtype(self):
        return self._storage.array.dtype

    def discard_beginning(self, count: int) -> "Chunk":
        """Drop the first ``count`` samples (zero-copy,
        ``bufferpool.rs:60-68``)."""
        assert 0 <= count <= len(self)
        return Chunk(self._storage, self._start + count, self._stop)

    def separate_beginning(self, count: int) -> "Chunk":
        """Split off and return the first ``count`` samples, keeping the
        rest in place semantics-wise (``bufferpool.rs:70-79``).  Returns
        the beginning; use the result of :meth:`discard_beginning` for the
        remainder."""
        assert 0 <= count <= len(self)
        return Chunk(self._storage, self._start, self._start + count)


class ChunkBuf:
    """Mutable chunk builder (``bufferpool.rs:125-165``)."""

    def __init__(self, pool: Optional["ChunkBufPool"], array: np.ndarray):
        self._pool = pool
        self._array = array
        self._len = 0

    def __len__(self):
        return self._len

    def extend(self, samples) -> None:
        samples = np.asarray(samples)
        need = self._len + len(samples)
        if need > len(self._array):
            grown = np.empty(max(need, 2 * len(self._array) or 16),
                             self._array.dtype)
            grown[: self._len] = self._array[: self._len]
            self._array = grown
        self._array[self._len: need] = samples
        self._len = need

    def finalize(self) -> Chunk:
        """Freeze into an immutable recyclable :class:`Chunk`
        (``bufferpool.rs:157-164``)."""
        storage = _Storage(self._array, self._pool)
        chunk = Chunk(storage, 0, self._len)
        self._array = np.empty(0, self._array.dtype)
        self._len = 0
        return chunk


class ChunkBufPool:
    """Recycling allocator for chunk storage (``bufferpool.rs:187-223``)."""

    def __init__(self, dtype=np.complex64):
        self.dtype = np.dtype(dtype)
        self._free: List[np.ndarray] = []
        self.recycled = 0
        self.allocated = 0

    def get(self) -> ChunkBuf:
        return self.get_with_capacity(0)

    def get_with_capacity(self, capacity: int) -> ChunkBuf:
        for i, arr in enumerate(self._free):
            if len(arr) >= capacity:
                return ChunkBuf(self, self._free.pop(i))
        self.allocated += 1
        return ChunkBuf(self, np.empty(capacity, self.dtype))

    def _recycle(self, array: np.ndarray) -> None:
        if len(array):
            self.recycled += 1
            self._free.append(array)
