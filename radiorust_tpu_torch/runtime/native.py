"""Threaded native runtime: C++ broadcast channels + one thread per block
(port of the JAX package's ``runtime/native.py``).

The reference pipelines blocks across CPU cores via Tokio tasks and its
``broadcast_bp`` channel (``src/sync/broadcast_bp.rs``).  This module is
the native equivalent: each block runs on an OS thread, handing Signal
messages through the GIL-free C++ channel
(``radiorust_tpu_torch/native/broadcast_bp.cpp``).  PyTorch releases the
GIL while it copies and launches, so host I/O, keying/control logic and
device compute for different pipeline stages overlap.  Each block stage
runs its chunks through one :func:`~radiorust_tpu_torch.blocks.base.
jit_step` per binding: on the card a CUDA graph, captured on the stage's
own thread (captures take turns, in ``thread_local`` mode).

Use :class:`NativeGraph` to build a pipeline::

    g = NativeGraph()
    src = g.source(chunk_iter)
    shifted = g.block(FreqShifter.with_shift(700.0), src)
    out = g.sink(shifted)
    g.run()          # blocks until sources drain
    out.samples      # collected output

The library builds with ``g++`` from the port's own sources at first use,
into ``build/radiorust_tpu_torch/native-<hash of the sources>/`` beside
the package.  The asyncio runtime (:mod:`radiorust_tpu_torch.runtime.
flow`) remains the dynamic-rewiring API; this one favors throughput.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import pathlib
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..blocks.base import Block, StreamSig, jit_step
from ..numbers import stream_complex
from ..signal import Event, Samples, Warmup

__all__ = ["NativeChannel", "NativeGraph", "load_library"]

# The C++ sources ship inside the package (pyproject package-data).
_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[1] / "native"
_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "radiorust_tpu_torch"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LIB = None
_LIB_LOCK = threading.Lock()


def _build_so(srcs) -> pathlib.Path:
    """The shared library for these sources: built once per content hash,
    linked to a temporary name and renamed, so a concurrent process never
    loads a half-written file."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    d = _ROOT / f"native-{h.hexdigest()[:16]}"
    so = d / "libbroadcast_bp.so"
    if so.exists():
        return so
    d.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=d)
    os.close(fd)
    res = subprocess.run(["g++", *_FLAGS, "-o", tmp, *map(str, srcs),
                          "-lpthread"], capture_output=True, text=True)
    if res.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"could not build the native runtime:\n"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the native runtime library
    (broadcast_bp channel + IQ file loader)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        srcs = [_NATIVE_DIR / "broadcast_bp.cpp",
                _NATIVE_DIR / "iq_loader.cpp"]
        lib = ctypes.CDLL(str(_build_so(srcs)))
        lib.bp_channel_new.restype = ctypes.c_void_p
        lib.bp_channel_free.argtypes = [ctypes.c_void_p]
        lib.bp_send.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.bp_send.restype = ctypes.c_int
        lib.bp_can_send.argtypes = [ctypes.c_void_p]
        lib.bp_can_send.restype = ctypes.c_int
        lib.bp_sender_close.argtypes = [ctypes.c_void_p]
        lib.bp_subscribe.argtypes = [ctypes.c_void_p]
        lib.bp_subscribe.restype = ctypes.c_int
        lib.bp_unsubscribe.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bp_recv.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_size_t)]
        lib.bp_recv.restype = ctypes.c_int
        lib.bp_recv_timeout.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_size_t),
                                        ctypes.c_int]
        lib.bp_recv_timeout.restype = ctypes.c_int
        lib.bp_enlister_retain.argtypes = [ctypes.c_void_p]
        lib.bp_enlister_release.argtypes = [ctypes.c_void_p]
        lib.iq_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.iq_open.restype = ctypes.c_void_p
        lib.iq_size.argtypes = [ctypes.c_void_p]
        lib.iq_size.restype = ctypes.c_long
        lib.iq_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_long]
        lib.iq_read.restype = ctypes.c_long
        lib.iq_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class NativeChannel:
    """Python handle over a C++ capacity-1 broadcast channel.

    Payloads are Python objects; the channel carries integer tokens while a
    registry keeps the objects alive until every subscriber consumed them.
    """

    def __init__(self):
        self._lib = load_library()
        self._ptr = self._lib.bp_channel_new()
        self._tokens = itertools.count(1)
        self._registry: Dict[int, object] = {}
        self._reg_lock = threading.Lock()
        self._enlisted = True   # subscription point held open (see below)
        self._leak = False      # skip freeing (threads may still block on it)

    def send(self, obj) -> bool:
        """Blocking send; False when the channel is closed."""
        token = next(self._tokens)
        # The number of receivers isn't knowable before the send (receivers
        # may join); keep the object until the *next* send completes, which
        # implies all receivers took this one.
        with self._reg_lock:
            self._registry[token] = obj
            # When send(t) is entered, send(t-1) has returned, so every
            # receiver consumed t-2 in the C++ layer; program order then
            # guarantees their Python-side lookups of t-3 completed.
            stale = [t for t in self._registry if t < token - 2]
            for t in stale:
                del self._registry[t]
        return self._lib.bp_send(self._ptr, token) == 0

    def close_sender(self):
        self._lib.bp_sender_close(self._ptr)

    def release_enlister(self):
        """Drop the subscription point (the reference's ``Enlister`` Drop,
        ``src/sync/broadcast_bp.rs:181-190``).  Until this is called the
        channel assumes more receivers may subscribe and a sender with no
        receivers blocks; afterwards, a sender whose receivers are all
        gone observes closure (``send`` returns False).  Idempotent."""
        if self._enlisted:
            self._enlisted = False
            self._lib.bp_enlister_release(self._ptr)

    def subscribe(self) -> int:
        return self._lib.bp_subscribe(self._ptr)

    def unsubscribe(self, rid: int):
        self._lib.bp_unsubscribe(self._ptr, rid)

    def recv(self, rid: int, timeout_ms: int = -1):
        """Blocking receive; returns (ok, obj)."""
        out = ctypes.c_size_t()
        rc = self._lib.bp_recv_timeout(self._ptr, rid, ctypes.byref(out),
                                       timeout_ms)
        if rc != 0:
            return False, None
        with self._reg_lock:
            obj = self._registry.get(int(out.value))
        return True, obj

    def __del__(self):
        # A channel whose graph timed out may still have daemon threads
        # parked inside bp_recv/bp_send; freeing the C++ state under them
        # is use-after-free.  NativeGraph marks such channels leaked.
        if self._leak:
            return
        try:
            self._lib.bp_channel_free(self._ptr)
        except Exception:
            pass


class _Node:
    def __init__(self, name: str):
        self.name = name
        self.out_channel: Optional[NativeChannel] = None
        self.thread: Optional[threading.Thread] = None
        self.failure: Optional[BaseException] = None


class _SinkNode(_Node):
    def __init__(self, name):
        super().__init__(name)
        self.chunks: List[np.ndarray] = []
        self.events: List[Event] = []
        self.sample_rate: Optional[float] = None

    @property
    def samples(self) -> np.ndarray:
        # axis=-1: time axis for both 1-D chunks and batched [streams, n].
        return (np.concatenate(self.chunks, axis=-1) if self.chunks
                else np.zeros(0, stream_complex()))


class NativeGraph:
    """Static pipeline executed on OS threads with native channels."""

    def __init__(self):
        self._nodes: List[_Node] = []

    def source(self, messages: Iterable, name: str = "source") -> _Node:
        """A producer draining an iterable of Samples/Event messages."""
        node = _Node(name)
        node.out_channel = NativeChannel()

        def run():
            try:
                for msg in messages:
                    if not node.out_channel.send(msg):
                        return
            except BaseException as exc:  # surfaced by NativeGraph.run
                node.failure = exc
            finally:
                # Always close: a raising iterator must not leave
                # downstream parked in recv forever.
                node.out_channel.close_sender()

        node.thread = threading.Thread(target=run, name=name, daemon=True)
        self._nodes.append(node)
        return node

    def block(self, spec: Block, upstream: _Node,
              name: Optional[str] = None, device=None) -> _Node:
        """A processing stage wrapping a block spec, on CUDA unless
        ``device`` names another (without a card it raises here).  Chunks
        may be 1-D (one stream) or 2-D ``[streams, n]``; a binding is made
        per (batch, chunk_len, sample_rate), with its params uploaded once
        and its own compiled step."""
        from ..convert import tree_to_torch
        from ..utils.profiling import GLOBAL_STATS
        from .blocks import reset_masks, resolve_device, upload
        dev = resolve_device(device)
        node = _Node(name or type(spec).__name__)
        node.out_channel = NativeChannel()
        node.stats = GLOBAL_STATS.unique(node.name)
        # The stage's bindings by (batch, chunk_len, sample_rate), each
        # with its compiled step (``_jit``: captures, capture_ms).
        node.bindings = bindings = {}
        in_ch = upstream.out_channel
        # Subscribe at wiring time (main thread): the subscription exists
        # before any thread starts, so run() can release the channels'
        # enlisters and closure becomes observable to blocked senders.
        rid = in_ch.subscribe()

        def run():
            bound = None
            state = None
            pending_reset = False
            try:
                while True:
                    ok, msg = in_ch.recv(rid)
                    if not ok:
                        return
                    if isinstance(msg, Event):
                        if msg.is_interrupt:
                            pending_reset = True
                        node.stats.record_event()
                        if not node.out_channel.send(msg):
                            return
                        continue
                    chunk = np.asarray(msg.chunk)
                    t0 = time.perf_counter()
                    batched = chunk.ndim == 2
                    x = chunk if batched else chunk[None, :]
                    key = (x.shape[0], x.shape[1], msg.sample_rate)
                    if key not in bindings:
                        b = spec.bind(StreamSig(*key))
                        b._jit = jit_step(b)
                        b._dparams = tree_to_torch(b.params, dev)
                        bindings[key] = b
                    fresh = bindings[key] is not bound
                    if fresh:
                        bound = bindings[key]
                        state = tree_to_torch(bound.init_state(), dev)
                    if (fresh or pending_reset) and bound.valid_from > 0:
                        # Zero-primed history (first chunk, mid-stream
                        # signature change, or interrupt): warn consumers
                        # like the asyncio actor does.
                        if not node.out_channel.send(Warmup(
                                bound.valid_from)):
                            return
                    reset = reset_masks(bound, x.shape[0], dev)[
                        int(pending_reset and not fresh)]
                    pending_reset = False
                    state, y = bound._jit(bound._dparams, state,
                                          upload(x, dev), reset)
                    y = y.cpu().numpy()
                    node.stats.record_chunk(x.size,
                                            time.perf_counter() - t0)
                    out = Samples(bound.out_sig.sample_rate,
                                  y if batched or bound.out_sig.batch > 1
                                  else y[0])
                    if not node.out_channel.send(out):
                        return
            except BaseException as exc:  # surfaced by NativeGraph.run
                node.failure = exc
            finally:
                # Close before unsubscribing so downstream drains out and
                # upstream's next send observes this receiver gone instead
                # of deadlocking on an undelivered slot.
                node.out_channel.close_sender()
                in_ch.unsubscribe(rid)

        node.thread = threading.Thread(target=run, name=node.name,
                                       daemon=True)
        self._nodes.append(node)
        return node

    def sink(self, upstream: _Node, name: str = "sink") -> _SinkNode:
        node = _SinkNode(name)
        in_ch = upstream.out_channel
        rid = in_ch.subscribe()  # wiring-time, see block()

        def run():
            try:
                while True:
                    ok, msg = in_ch.recv(rid)
                    if not ok:
                        return
                    if isinstance(msg, Event):
                        node.events.append(msg)
                    else:
                        node.sample_rate = msg.sample_rate
                        node.chunks.append(np.asarray(msg.chunk))
            except BaseException as exc:  # surfaced by NativeGraph.run
                node.failure = exc
            finally:
                in_ch.unsubscribe(rid)

        node.thread = threading.Thread(target=run, name=name, daemon=True)
        self._nodes.append(node)
        return node

    def run(self, timeout: Optional[float] = 60.0):
        """Start all threads and join until the pipeline drains.

        Raises the first node failure (a block/source thread exception) as
        a ``RuntimeError`` chained to the original exception; raises
        ``TimeoutError`` when a node neither finishes nor fails within
        ``timeout`` seconds."""
        # Wiring is complete: every subscription was taken at graph-build
        # time, so drop the channels' subscription points.  From here on a
        # sender whose receivers are all gone observes closure instead of
        # waiting for receivers that can no longer appear (the reference's
        # Enlister drop, src/sync/broadcast_bp.rs:181-190).
        for node in self._nodes:
            if node.out_channel is not None:
                node.out_channel.release_enlister()
        for node in reversed(self._nodes):
            node.thread.start()
        for node in self._nodes:
            node.thread.join(timeout)
            if node.thread.is_alive():
                # Threads may still be parked inside the C++ channel;
                # freeing it under them is use-after-free, so leak instead.
                for n in self._nodes:
                    if n.out_channel is not None:
                        n.out_channel._leak = True
                self._raise_failure()
                raise TimeoutError(f"node {node.name} did not finish")
        self._raise_failure()

    def _raise_failure(self) -> None:
        for node in self._nodes:
            if node.failure is not None:
                raise RuntimeError(
                    f"node {node.name} failed") from node.failure
