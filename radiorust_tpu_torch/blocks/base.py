"""Block protocol and chain composition (PyTorch port).

Same contract as ``radiorust_tpu.blocks.base``:

- a :class:`Block` is a spec (constructor arguments only);
- ``block.bind(sig)`` does all host-side design work in float64 numpy and
  returns a :class:`BoundBlock` holding numpy ``params``, an
  ``init_state()`` tree of numpy arrays, and
  ``process(params, state, x, reset) -> (state', y)``;
- :class:`Chain` composes blocks; :func:`scan` runs a bound block over
  stacked chunks.

``process`` works on torch tensors: turn the numpy params and state into
tensors on the device of choice with
:func:`radiorust_tpu_torch.convert.tree_to_torch`.  The keys, shapes and
dtypes of params and state are the JAX package's, so its state can be
carried across.  PyTorch runs eagerly, so :func:`scan` is a Python loop
over the chunk axis.  The counterpart of ``jax.jit`` is a captured CUDA
graph: :func:`jit_step` (one step) and :func:`make_scan` (a whole run of
chunks) capture on CUDA tensors and replay; on CPU tensors they run
eagerly.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..convert import _map
from ..convert import tree_to_torch
from ..utils import profiling
from ..utils.profiling import tracing

__all__ = ["StreamSig", "Block", "BoundBlock", "Chain", "scan",
           "expand_reset", "no_reset", "jit_step", "make_scan",
           "jit_step_sharded", "shard_map_step", "params_changed",
           "foreign_leaves"]


@dataclass(frozen=True)
class StreamSig:
    """``batch`` independent streams, each delivering chunks of
    ``chunk_len`` complex64 samples at ``sample_rate`` Hz."""

    batch: int
    chunk_len: int
    sample_rate: float

    def with_(self, **kw) -> "StreamSig":
        return dataclasses.replace(self, **kw)


class Block:
    """Declarative spec for a signal-processing block."""

    def bind(self, sig: StreamSig) -> "BoundBlock":
        raise NotImplementedError


class BoundBlock:
    """A block resolved against a stream signature.

    ``input_is_real`` / ``output_is_real`` mark streams known to carry a
    zero imaginary part (after FM demodulation); :class:`Chain` propagates
    them so that later blocks can take their real-input forms.
    ``valid_from`` is the first output step that is comparable to the
    reference (overlap-save warmup).
    """

    in_sig: StreamSig
    out_sig: StreamSig
    params: Any = ()
    input_is_real: bool = False
    valid_from: int = 0

    @property
    def output_is_real(self) -> bool:
        return False

    def init_state(self):
        return ()

    def process(self, params, state, x, reset):
        """(params, state, x[batch, chunk_len], reset[batch]) ->
        (state', y[batch, out_chunk_len])."""
        raise NotImplementedError

    def shard_batch_ok(self, ndev: int) -> bool:
        """Whether this block's math holds on a per-device stream batch of
        ``in_sig.batch // ndev`` (data-parallel stream sharding,
        :func:`jit_step_sharded`).  Blocks with per-shard constraints
        beyond divisibility (the pair-packed fused kernels want an even
        local batch) override it; composites ask their members."""
        return self.in_sig.batch % ndev == 0

    def __call__(self, x, *, state=None, reset=None, params=None):
        """Eager single-step helper (mainly for tests): the bound params
        and initial state, and no reset, unless given, as tensors on
        ``x``'s device."""
        x = torch.as_tensor(x)
        if state is None:
            state = tree_to_torch(self.init_state(), x.device)
        if params is None:
            params = tree_to_torch(self.params, x.device)
        if reset is None:
            reset = no_reset(self.in_sig.batch, x.device)
        return self.process(params, state, x, reset)


def expand_reset(block: "BoundBlock", r, in_batch: int):
    """Widen a per-stream reset mask for a batch-growing block (the static
    ratio of the block's bound batch to ``in_batch``): each flag repeats
    for its derived streams, as ``repeat_interleave`` would, without a
    size computed on the device."""
    factor = block.in_sig.batch // in_batch
    if factor > 1 and r.dim():
        return r[:, None].expand(-1, factor).reshape(-1)
    return r


class _BoundChain(BoundBlock):
    _input_is_real = False

    def __init__(self, bound: Sequence[BoundBlock]):
        self.blocks = tuple(bound)
        self.in_sig = bound[0].in_sig
        self.out_sig = bound[-1].out_sig
        self.params = tuple(b.params for b in bound)
        # Warmup is cumulative through a chain.
        self.valid_from = sum(b.valid_from for b in bound)
        # A phase-mode tail makes the chain's output ragged.
        self.ragged_output = getattr(bound[-1], "ragged_output", False)

    def valid_counts(self, k0: int, nsteps: int = 1):
        """Valid output samples of chunks k0..k0+nsteps: the ragged tail
        block's schedule, else full chunks."""
        last = self.blocks[-1]
        if hasattr(last, "valid_counts"):
            return last.valid_counts(k0, nsteps)
        return np.full((nsteps,), self.out_sig.chunk_len, np.int64)

    # The host-side schedule mirror of a ragged tail (see
    # ``blocks/resampling.py``).
    def schedule_phase(self, state) -> int:
        return self.blocks[-1].schedule_phase(state[-1])

    def advance_schedule(self, phase: int):
        return self.blocks[-1].advance_schedule(phase)

    def init_state(self):
        return tuple(b.init_state() for b in self.blocks)

    def process(self, params, state, x, reset):
        new_state = []
        for block, p, s in zip(self.blocks, params, state, strict=True):
            s, x = block.process(p, s, x,
                                 expand_reset(block, reset,
                                              self.in_sig.batch))
            new_state.append(s)
        return tuple(new_state), x

    def shard_batch_ok(self, ndev: int) -> bool:
        return (self.in_sig.batch % ndev == 0
                and all(b.shard_batch_ok(ndev) for b in self.blocks))

    # Realness propagates through a nested chain (see the JAX package).
    @property
    def input_is_real(self) -> bool:
        return self._input_is_real

    @input_is_real.setter
    def input_is_real(self, value: bool) -> None:
        self._input_is_real = bool(value)
        is_real = bool(value)
        for b in self.blocks:
            b.input_is_real = is_real
            is_real = b.output_is_real

    @property
    def output_is_real(self) -> bool:
        return self.blocks[-1].output_is_real


class Chain(Block):
    """Sequential composition of blocks; nested chains flatten."""

    def __init__(self, *blocks: Block):
        flat = []
        for b in blocks:
            if isinstance(b, Chain):
                flat.extend(b.specs)
            else:
                flat.append(b)
        self.specs = tuple(flat)

    def bind(self, sig: StreamSig) -> _BoundChain:
        bound = []
        is_real = False
        for i, spec in enumerate(self.specs):
            b = spec.bind(sig)
            if getattr(b, "ragged_output", False) and i < len(self.specs) - 1:
                # Later blocks would read the padding as samples.
                raise ValueError(
                    f"{type(b).__name__} produces padded (schedule-valid) "
                    "chunks at this chunk length and must be the LAST "
                    "block of a compiled chain; re-chunk to a multiple "
                    "of the resampling period or consume it through the "
                    "runtime layer")
            b.input_is_real = is_real
            bound.append(b)
            sig = b.out_sig
            is_real = b.output_is_real
        return _BoundChain(bound)


def scan(bound: BoundBlock, params, state, xs, resets=None):
    """Run a bound block over stacked chunks.

    ``xs``: [T, batch, chunk_len] complex64 tensor; ``resets``: optional
    [T, batch] bool tensor.  Returns ``(final_state, ys [T, batch,
    out_chunk_len])``.
    """
    if resets is None:
        resets = torch.zeros((xs.shape[0], bound.in_sig.batch),
                             dtype=torch.bool, device=xs.device)
    ys = []
    for x, reset in zip(xs, resets):
        state, y = bound.process(params, state, x, reset)
        ys.append(y)
    return state, torch.stack(ys)


def no_reset(batch: int, device=None):
    """An all-false reset mask for ``batch`` streams."""
    return torch.zeros((batch,), dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# Compiled steps: captured CUDA graphs
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _spec(tree):
    """A hashable description of a tree: its structure and each leaf's
    shape, dtype and device."""
    return repr(_map(tree, lambda t: (tuple(t.shape), t.dtype, str(t.device))
                     if isinstance(t, torch.Tensor) else ("leaf", repr(t))))


def _stack(ys: list):
    """Trees of chunks [batch, n], one per step, as one tree of [T, batch,
    n] stacks."""
    cols = zip(*(_leaves(y) for y in ys))
    it = iter([torch.stack(list(c)) for c in cols])
    return _map(ys[0], lambda _: next(it))


def params_changed(held, params) -> bool:
    """Whether ``params`` is a new tree against ``held``, the (leaf,
    version) pairs a capture was made with: a leaf is another object, or
    a tensor leaf's ``_version`` moved (it was written in place).  Params
    are constants of a capture (device caches such as the response grids
    and re-laid taps are built from them once), so a new tree recaptures;
    copying new values into the captured tensors would leave the old
    filter in force."""
    leaves = _leaves(params)
    if len(leaves) != len(held):
        return True
    for leaf, (old, version) in zip(leaves, held):
        if leaf is not old:
            return True
        if isinstance(leaf, torch.Tensor) and leaf._version != version:
            return True
    return False


def _hold(params):
    return [(leaf, leaf._version if isinstance(leaf, torch.Tensor)
             else None) for leaf in _leaves(params)]


def foreign_leaves(own, given) -> list:
    """Indices of the leaves of ``given`` that are not the tensors of
    ``own`` (the static buffers of a capture) and so are copied in before
    a replay; a step's own returned state is not copied."""
    return [i for i, (o, g) in enumerate(zip(own, given)) if g is not o]


def _is_graph(bound) -> bool:
    return not isinstance(bound, BoundBlock)   # a BoundGraph


def _default_reset(bound, lead, device):
    """All-false reset masks with leading dims ``lead``: one tensor for a
    bound block, a dict per input for a bound graph."""
    def zeros(batch):
        return torch.zeros((*lead, batch), dtype=torch.bool, device=device)
    if _is_graph(bound):
        return {n: zeros(s.batch) for n, s in bound.in_sigs.items()}
    return zeros(bound.in_sig.batch)


class _Capture:
    """One captured graph: its static input buffers, its outputs, and the
    params tree it was captured with."""

    def __init__(self, graph, held, state, x, reset, out_state, out_y):
        self.graph, self.held = graph, held
        self.state, self.x, self.reset = state, x, reset
        self.out_state, self.out_y = out_state, out_y

    def copy_in(self, state, x, reset) -> int:
        """Copy the given leaves that are not the static buffers into
        them; returns the bytes copied."""
        nbytes = 0
        for tree, given in ((self.state, state), (self.x, x),
                            (self.reset, reset)):
            if given is None:
                continue
            own, new = _leaves(tree), _leaves(given)
            for i in foreign_leaves(own, new):
                own[i].copy_(new[i])
                nbytes += own[i].nbytes
        return nbytes


_WARMUP_STEPS = 2

# One capture at a time in the process (torch.cuda.graph's own rule): the
# actors of the native runtime capture their steps on their own threads.
_CAPTURE_LOCK = threading.Lock()


class _Compiled:
    """The runner behind :func:`jit_step` and :func:`make_scan`.

    On CPU tensors it runs eagerly.  On CUDA tensors it captures a
    ``torch.cuda.CUDAGraph`` per (shapes, dtypes, device, reset given)
    and params tree, and replays it; a capture that fails raises.
    Captures run one at a time in the process, in ``thread_local`` mode,
    so other threads may allocate, copy and replay meanwhile.
    ``captures`` counts captures and ``capture_ms`` is the last one's host
    time (warm-up included); :meth:`free` drops every graph.  The kernel
    wrappers' ``launches`` counters count while a step is captured (and
    in the eager warm-up before it), not on a replay.

    While :func:`~radiorust_tpu_torch.utils.profiling.tracing` is on (a
    profiler records, or ``profiling.enable(True)``), a call records the
    spans ``rr.entry`` and, inside it, ``rr.entry.key`` (the graph's
    key and the params check), ``rr.entry.copy_in``, ``rr.entry.replay``
    and ``rr.entry.clone_out`` (or ``rr.entry.eager``), the device span
    ``rr.entry.device`` (first copy in to last clone), and the counters
    ``entry.calls``, ``entry.steps``, ``entry.copy_in_bytes`` and
    ``entry.clone_out_bytes``.  A capture is always recorded:
    ``rr.entry.capture`` and ``entry.captures``, and
    ``entry.recaptures`` where it replaces a graph whose params changed.
    Off, a call checks once and its span sites open a shared no-op.

    ``process`` (default: the bound's own) is the step to run, a sharded
    one for the parallel layer; ``capturable=False`` keeps CUDA tensors
    eager too (a step across distinct devices cannot be one graph)."""

    def __init__(self, bound, whole_run: bool, process=None,
                 capturable: bool = True):
        self.bound = bound
        self._whole = whole_run
        self._fn = bound.process if process is None else process
        self.capturable = capturable
        self._captured = {}
        self.captures = 0
        self.capture_ms = None

    def free(self) -> None:
        self._captured.clear()

    def _process(self, params, state, x, reset):
        return self._fn(params, state, x, reset)

    def _eager(self, params, state, x, reset):
        if not self._whole:
            if reset is None:
                reset = _default_reset(self.bound, (), _leaves(x)[0].device)
            return self._process(params, state, x, reset)
        if _is_graph(self.bound):
            from .graph import graph_scan
            return graph_scan(self.bound, params, state, x, reset)
        return scan(self.bound, params, state, x, reset)

    def __call__(self, params, state, x, reset=None):
        on = tracing()
        span = profiling.span if on else profiling.no_span
        with span("rr.entry"):
            lead = _leaves(x)[0]
            if on:
                profiling.count("entry.calls")
                profiling.count("entry.steps",
                                lead.shape[0] if self._whole else 1)
            device = lead.device
            if device.type != "cuda" or not self.capturable:
                with span("rr.entry.eager"):
                    return self._eager(params, state, x, reset)
            with span("rr.entry.key"):
                key = (_spec(state), _spec(x), _spec(reset))
                cap = self._captured.get(key)
                stale = cap is None or params_changed(cap.held, params)
            if stale:
                cap = self._recapture(key, cap, params, state, x, reset,
                                      device)
            start = profiling.device_start(device) if on else None
            with span("rr.entry.copy_in"):
                copied = cap.copy_in(state, x, reset)
            with span("rr.entry.replay"):
                cap.graph.replay()
            with span("rr.entry.clone_out"):
                # A whole run returns clones of its state; one step its
                # own buffers.
                out_state = (_map(cap.out_state, torch.clone)
                             if self._whole else cap.state)
                out_y = _map(cap.out_y, torch.clone)
            if on:
                profiling.device_stop("rr.entry.device", start, device)
                cloned = _leaves(out_y) + (_leaves(out_state)
                                           if self._whole else [])
                profiling.count("entry.copy_in_bytes", copied)
                profiling.count("entry.clone_out_bytes",
                                sum(t.nbytes for t in cloned))
            return out_state, out_y

    def _recapture(self, key, cap, params, state, x, reset, device):
        with _CAPTURE_LOCK:
            if cap is not None:
                # Free the old graph first, once no replay of it is
                # queued.
                torch.cuda.synchronize(device)
                del self._captured[key], cap
                profiling.count("entry.recaptures")
            with profiling.span("rr.entry.capture", always=True) as timed:
                cap = self._capture(params, state, x, reset, device)
        self.captures += 1
        self.capture_ms = timed.ns / 1e6
        profiling.count("entry.captures")
        self._captured[key] = cap
        return cap

    def _steps(self, x, reset):
        """(x, reset) of each step the capture runs."""
        if not self._whole:
            return [(x, reset)]
        t = _leaves(x)[0].shape[0]
        return [(_map(x, lambda v: v[i]), _map(reset, lambda v: v[i]))
                for i in range(t)]

    def _capture(self, params, state, x, reset, device) -> _Capture:
        lead = (_leaves(x)[0].shape[0],) if self._whole else ()
        static_reset = (_default_reset(self.bound, lead, device)
                        if reset is None else _map(reset, torch.clone))
        # Warm-up: eager steps on a side stream, on clones of the state
        # (the caller's state does not advance), so that every lazy
        # device cache (tables, grids, re-laid taps, cuFFT plans) is
        # filled before the capture, which cannot copy from the host.
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            st = _map(state, torch.clone)
            steps = self._steps(x, static_reset)
            for i in range(_WARMUP_STEPS):
                xi, ri = steps[min(i, len(steps) - 1)]
                st, _ = self._process(params, st, xi, ri)
        torch.cuda.current_stream(device).wait_stream(side)
        del st
        s_state = _map(state, torch.clone)
        s_x = _map(x, torch.clone)
        graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: collecting a dead
        # binding there destroys its CUDA graph, which a capture forbids
        # ("function reset"), and the capture fails.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                if self._whole:
                    st, ys = s_state, []
                    for xi, ri in self._steps(s_x, static_reset):
                        st, y = self._process(params, st, xi, ri)
                        ys.append(y)
                    out_state, out_y = st, _stack(ys)
                else:
                    new_state, out_y = self._process(params, s_state, s_x,
                                                     static_reset)
                    out_state = s_state
                    out_y = _write_back(s_state, new_state, out_y)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
        return _Capture(graph, _hold(params), s_state, s_x,
                        None if reset is None else static_reset,
                        out_state, out_y)


def _write_back(own_tree, new_tree, y):
    """Inside a capture: copy a step's new state onto its own state
    buffers.  A leaf the block passed through unchanged is the buffer
    itself and is skipped; a new leaf or output that is a view into a
    state buffer is cloned first, before any buffer is written.  Returns
    the step's output."""
    own, new = _leaves(own_tree), _leaves(new_tree)
    if len(own) != len(new):
        raise ValueError("a step's new state has another structure than "
                         "its state")
    bufs = {t.untyped_storage().data_ptr() for t in own}

    def detach(t):
        aliased = t.untyped_storage().data_ptr() in bufs
        return t.clone() if aliased else t

    srcs = [n if n is o else detach(n) for o, n in zip(own, new)]
    y = _map(y, detach)
    for o, s in zip(own, srcs):
        if s is o:
            continue
        if s.shape != o.shape or s.dtype != o.dtype:
            raise ValueError(f"a state leaf changed from {tuple(o.shape)} "
                             f"{o.dtype} to {tuple(s.shape)} {s.dtype}")
        o.copy_(s)
    return y


def jit_step(bound) -> _Compiled:
    """One compiled chunk step: ``step(params, state, x, reset=None) ->
    (state', y)`` for a bound block or chain (x a [batch, n] tensor) or a
    :class:`~radiorust_tpu_torch.blocks.graph.BoundGraph` (x and reset
    dicts by input, y by output).

    On CPU tensors it calls ``process``.  On CUDA tensors it captures the
    step as a CUDA graph at the first call (after eager warm-up steps on
    copies of the state) and replays it after; a new params tree (another
    leaf object, or a leaf written in place) recaptures, since params are
    constants of a capture.

    The state it returns is the step's own static buffer, **advanced in
    place by the next call**: pass it back and nothing is copied; any
    other state is copied into the buffers first.  Clone it to keep it.
    y is a new tensor each call."""
    return _Compiled(bound, whole_run=False)


def make_scan(bound) -> _Compiled:
    """A compiled run over stacked chunks: ``run(params, state, xs,
    resets=None) -> (state', ys)``, the counterpart of :func:`scan` (or
    ``graph_scan`` for a bound graph, xs and resets dicts of [T, batch,
    n] and [T, batch]).

    On CPU tensors it calls ``scan`` / ``graph_scan``.  On CUDA tensors it
    captures the whole loop over the T chunks as one CUDA graph at the
    first call per T, shapes and params tree, and replays it once a call;
    the inputs are copied into the graph's buffers, and the state and ys
    it returns are copies that a later call does not change."""
    return _Compiled(bound, whole_run=True)


def shard_map_step(fn, mesh, axis: str):
    """A step over the mesh's ``axis``, data-parallel over streams:
    ``fn(params, state, x, reset) -> (state', y)`` runs once per shard,
    params replicated (copied once to each distinct device), and the
    state, chunks and reset masks cut along their leading stream axis,
    shard i taking the i-th equal part on the i-th device of ``axis``
    (the other axes at index 0).  The results are concatenated back on
    the first of those devices.  Dict-valued chunks and resets (a
    :class:`~radiorust_tpu_torch.blocks.graph.BoundGraph`) cut the same
    way.  No values cross between shards: streams never couple.
    On a mesh that spans processes it raises ``NotImplementedError``:
    there each process steps its own streams with the executors'
    ``process``."""
    from ..parallel.mesh import Replicas, concat, split_batch
    if mesh.spans_processes:
        raise NotImplementedError(
            "shard_map_step on a mesh that spans processes: each process "
            "steps its own streams eagerly (the executors' process)")
    devices = mesh.line(axis)
    replicas = Replicas()

    def step(params, state, x, reset):
        d = len(devices)
        batch = _leaves(x)[0].shape[0]
        ps = replicas(params, devices)
        outs = [fn(p, s, xi, ri) for p, s, xi, ri in zip(
            ps, split_batch(state, d, batch, devices),
            split_batch(x, d, batch, devices),
            split_batch(reset, d, batch, devices))]
        return (concat([o[0] for o in outs], devices[0]),
                concat([o[1] for o in outs], devices[0]))

    return step


def jit_step_sharded(bound, mesh, axis: str) -> _Compiled:
    """:func:`jit_step` data-parallel over a mesh axis: the stream batch
    splits over ``mesh.shape[axis]`` shards (:func:`shard_map_step`),
    params replicate, and no collectives are needed.  Same calling
    convention as :func:`jit_step`; where every device of the mesh is one
    card the step is one CUDA graph holding every shard's launches, and
    across distinct devices it runs eagerly.

    Requires ``bound.shard_batch_ok(mesh.shape[axis])``: the batch must
    split evenly and each block's per-shard constraints hold on the local
    batch (the pair-packed fused kernels need it even).

    On a mesh that spans processes it raises ``NotImplementedError``: a
    CUDA graph cannot capture a gloo exchange, and such a step runs
    eagerly through the executors' ``process``."""
    if mesh.spans_processes:
        raise NotImplementedError(
            "jit_step_sharded on a mesh that spans processes: step each "
            "process's shards eagerly (the executors' process)")
    ndev = mesh.shape[axis]
    if not bound.shard_batch_ok(ndev):
        batch = (bound.in_sig.batch if isinstance(bound, BoundBlock)
                 else {k: s.batch for k, s in bound.in_sigs.items()})
        raise ValueError(
            f"batch {batch} cannot shard over mesh axis {axis!r} ({ndev} "
            f"devices): the local batch must divide evenly and satisfy "
            f"every block's per-shard constraint (pair-packed fused "
            f"kernels need an even local batch)")
    return _Compiled(bound, whole_run=False,
                     process=shard_map_step(bound.process, mesh, axis),
                     capturable=mesh.single_device)
