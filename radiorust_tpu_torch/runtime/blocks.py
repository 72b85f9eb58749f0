"""Runtime block actors (PyTorch port of the JAX package's
``runtime/blocks.py``).

Each runtime block mirrors the reference's uniform block pattern
(``src/blocks/mod.rs:193-239``): construction spawns an asyncio task that
loops ``recv -> process -> send``, forwards events transparently, and
resets stream state on interrupt events.  :class:`RuntimeBlock` wraps *any*
block spec (:class:`radiorust_tpu_torch.blocks.base.Block`): the spec is
re-bound whenever the incoming chunk's (batch, length, sample rate)
changes, and every chunk's math runs on the actor's device through one
:func:`~radiorust_tpu_torch.blocks.base.jit_step` per binding (a captured
CUDA graph on the card, eager on the CPU).

Messages between actors stay host numpy.  On the card a chunk is cast to
the stream dtype into pinned staging memory and copied to the device
without blocking; each output is copied back into its own pinned buffer
behind a CUDA event.  Params live on the device per binding and are
uploaded again only on a retune (one recapture of the binding's step);
the stream state lives in the step's own buffers.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..blocks.base import Block, StreamSig, jit_step
from ..bufferpool import Chunk, ChunkBuf, ChunkBufPool
from ..convert import _map, tree_to_numpy, tree_to_torch
from ..numbers import stream_complex
from ..signal import (BufferOverflow, Event, EventHandlers, EventHandling,
                      Samples, SamplesLost, Warmup)
from .flow import (ChannelClosed, Receiver, ReceiverConnector, Sender,
                   SenderConnector, new_receiver, new_sender)

__all__ = [
    "RuntimeBlock", "RuntimeGraph", "MapSignal", "Silence", "Blackhole",
    "Buffer", "Rechunker", "KeyerSource", "ArraySource", "ArraySink",
    "FileSink", "wait_until",
]


async def wait_until(predicate: Callable[[], bool], *actors,
                     poll: float = 0.02,
                     timeout: Optional[float] = 120.0) -> None:
    """Await ``predicate()`` becoming true while watching ``actors``.

    A failed actor stops emitting, so a bare "wait for N output chunks"
    loop would hang forever; this surfaces any recorded ``.failure`` as
    the error instead (chained), and raises :class:`TimeoutError` after
    ``timeout`` seconds (``None`` disables the deadline)."""
    loop = asyncio.get_running_loop()
    deadline = None if timeout is None else loop.time() + timeout
    while not predicate():
        for a in actors:
            f = getattr(a, "failure", None)
            if f is not None:
                raise RuntimeError(
                    f"{getattr(a, 'name', type(a).__name__)} failed") from f
        if deadline is not None and loop.time() > deadline:
            raise TimeoutError("condition not reached before timeout")
        await asyncio.sleep(poll)


def resolve_device(device) -> torch.device:
    """The device an actor computes on: CUDA unless the caller names
    another (``device="cpu"``).  Without a card and without a device it
    raises: it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def check_serving(mesh, mesh_axis, shard: str, allowed) -> Optional[str]:
    """Validate the mesh arguments where the actor is made (a typo'd axis
    raises here, not inside the actor's task) and return the serving
    axis: ``mesh_axis``, by default the mesh's first axis; None without a
    mesh."""
    from ..parallel.mesh import Mesh
    if shard not in allowed:
        raise ValueError(f"shard must be one of {allowed}, got {shard!r}")
    if shard != "streams" and mesh is None:
        raise ValueError(f"shard={shard!r} requires a mesh")
    if mesh is None:
        if mesh_axis is not None:
            raise ValueError("mesh_axis given without a mesh")
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a radiorust_tpu_torch.parallel.mesh."
                        f"Mesh, got {type(mesh).__name__}")
    if mesh_axis is None:
        return mesh.axis_names[0]
    if mesh_axis not in mesh.axis_names:
        raise ValueError(f"mesh_axis {mesh_axis!r} not an axis of the mesh "
                         f"(axes: {mesh.axis_names})")
    return mesh_axis


def _fallback(name: str, kind: str, err: Exception) -> None:
    logging.getLogger(__name__).warning(
        "%s: cannot %s (%s); using the single-device program", name, kind,
        err)


def _knob(old, value: float):
    """A retuned knob in the dtype of the param it replaces (float32;
    float64 in a binding made under the c128 stream mode)."""
    return np.asarray(value, np.asarray(old).dtype)[()]


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host chunk as a tensor of the stream dtype on ``device``, never
    sharing the message's storage (a pooled buffer may be recycled once
    the message is dropped).  On CUDA the cast lands in pinned staging
    memory and the copy to the device does not block; the caching host
    allocator keeps the staging block from reuse until that copy ends."""
    dt = stream_complex()
    if device.type != "cuda":
        return torch.from_numpy(np.array(x, dtype=dt))
    pinned = torch.empty(x.shape, pin_memory=True,
                         dtype=torch.from_numpy(np.empty(0, dt)).dtype)
    np.copyto(pinned.numpy(), x, casting="same_kind")
    return pinned.to(device, non_blocking=True)


def start_fetch(tree, device: torch.device):
    """Start copying a step's output tree to the host: (host tree, CUDA
    event or None).  On CUDA each tensor goes to its own pinned buffer
    without blocking; read the buffers once the event completes."""
    if device.type != "cuda":
        return tree, None

    def fetch(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host
    host = _map(tree, fetch)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return host, event


def reset_masks(bound, batch: int, device: torch.device):
    """The (all-false, all-true) reset masks of a binding, made once on
    its device: a step is passed one of them, never a host bool."""
    masks = getattr(bound, "_masks", None)
    if masks is None:
        masks = bound._masks = (
            torch.zeros((batch,), dtype=torch.bool, device=device),
            torch.ones((batch,), dtype=torch.bool, device=device))
    return masks


class _TaskMixin:
    failure: Optional[Exception] = None  # fatal error, if any

    def _record_failure(self, exc: Exception) -> None:
        """A failure in user code (filter design closure, map closure) or
        device dispatch must not die silently: the reference's task would
        panic visibly on stderr.  Record it and log it; the caller falls
        through to its teardown so peers observe ChannelClosed instead of
        a silent stall."""
        self.failure = exc
        logging.getLogger(__name__).exception(
            "block %r failed; tearing down its channels",
            getattr(self, "name", type(self).__name__))

    def stop(self) -> None:
        """Cancel this block's task (the reference's struct-drop analog:
        the task exits and its endpoints close, releasing blocked peers)."""
        task = getattr(self, "_task", None)
        if task is not None:
            task.cancel()


class _ProducerMixin(_TaskMixin):
    sender_connector: SenderConnector

    def feed_into(self, consumer) -> None:
        consumer.receiver_connector.connect(self.sender_connector)


class _ConsumerMixin(_TaskMixin):
    receiver_connector: ReceiverConnector

    def feed_from(self, producer) -> None:
        self.receiver_connector.connect(producer.sender_connector)

    def feed_from_none(self) -> None:
        self.receiver_connector.disconnect()


def _spawn(coro):
    return asyncio.get_running_loop().create_task(coro)


class RuntimeBlock(_ProducerMixin, _ConsumerMixin, EventHandling):
    """Streaming actor around a block spec.

    A binding is made per (batch, chunk_len, sample_rate) and cached, each
    with its own compiled step and device params.  Stream state carries
    across chunks and resets on interrupt events or rebinds.

    Chunks may be 1-D ``[n]`` (one stream, the reference's model) or 2-D
    ``[streams, n]`` — batched serving: one message carries a chunk step
    of many independent streams through one device program (outputs stay
    2-D downstream).  Chunks of any numeric dtype are cast to the stream
    dtype.

    ``device`` is CUDA unless given (``device="cpu"`` runs the plain
    versions of the kernels); without a card it raises.

    Mesh serving (``mesh``, a :class:`~radiorust_tpu_torch.parallel.mesh.
    Mesh`, whose entries may repeat one card; ``mesh_axis``, by default
    its first axis), three modes:

    - ``shard="streams"``: batched ``[streams, n]`` chunks split their
      stream axis over the mesh axis
      (:func:`~radiorust_tpu_torch.blocks.base.jit_step_sharded`);
    - ``shard="channels"``: a channelizer-led chain splits its M channels
      over the axis (:class:`~radiorust_tpu_torch.parallel.channel_shard.
      ChannelShardedChain`);
    - ``shard="time"``: each chunk of D*chunk_len samples runs as D
      consecutive chunks with halo exchange
      (:class:`~radiorust_tpu_torch.parallel.time_shard.
      TimeShardedChain`); ``overlap=S`` splits the batch into S
      sub-batches.

    A binding that cannot shard (a batch that does not split, a chain
    that is not channelizer-led, a block that cannot time-shard) logs a
    warning and runs the single-device step, as the JAX package's
    actor does; :attr:`executor` says which one the current binding
    took.  Without a ``device`` the actor's device is the mesh's first.
    """

    def __init__(self, spec: Block, name: Optional[str] = None,
                 pipeline_depth: int = 0, mesh=None,
                 mesh_axis: Optional[str] = None, shard: str = "streams",
                 overlap: int = 1, device=None):
        from ..utils.profiling import GLOBAL_STATS
        self.mesh_axis = check_serving(mesh, mesh_axis, shard,
                                       ("streams", "channels", "time"))
        self.mesh, self.shard, self.overlap = mesh, shard, overlap
        self.device = resolve_device(device if mesh is None or device
                                     else mesh.home)
        self.spec = spec
        self.name = name or type(spec).__name__
        self.stats = GLOBAL_STATS.unique(self.name)
        # With depth d > 0 the actor keeps up to d chunks' device work in
        # flight and fetches d chunks behind, overlapping device compute
        # with downstream host work — the analog of the reference's
        # task-per-block pipelining across cores (src/blocks/mod.rs:27-34).
        # Events flush the pipeline so sample/event ordering is preserved
        # exactly.  Depth 0 fetches synchronously (adds no latency).
        self.pipeline_depth = pipeline_depth
        self._init_actor_fields()
        receiver, self.receiver_connector = new_receiver()
        self.sender, self.sender_connector = new_sender()
        self._bindings: Dict[Tuple[int, int, float], Any] = {}
        self._task = _spawn(self._run(receiver))

    def _init_actor_fields(self) -> None:
        """Shared actor state (RuntimeGraph.__init__ calls this too)."""
        # Events riding the stream are observable on any block, as the
        # reference's impl_block_trait! EventHandling provides
        # (src/blocks/mod.rs:126-142).
        self.event_handlers = EventHandlers()
        self._bound = None
        self._state = None       # host numpy state, when not on the device
        self._dstate = None      # the step's device state
        self._dparams = None     # device params of the current binding
        self._dparams_src = None  # the params tree they were made from
        self._sched_phase = None  # ragged-tail valid-prefix schedule mirror
        self._restored_state = None  # pending load_checkpoint state
        self.failure: Optional[Exception] = None
        self._pending_reset = False
        # One override slot per tunable (the reference keeps one watch
        # channel per parameter): a rebind re-applies ALL live retunes.
        self._param_overrides: Dict[str, Callable] = {}
        # Last value per typed setter, so the getters reflect a
        # pre-binding retune (the override only APPLIES at first bind).
        self._typed_values: Dict[str, float] = {}
        self.chunks_processed = 0

    @property
    def executor(self) -> Optional[str]:
        """The step the current binding runs: "streams", "channels" or
        "time" (sharded over the mesh), "single" (one device: no mesh, or
        a fallback), or None before the first chunk."""
        return getattr(self._bound, "executor", None)

    def _get_bound(self, chunk_len: int, sample_rate: float,
                   batch: int = 1):
        key = (batch, chunk_len, sample_rate)
        bound = self._bindings.get(key)
        if bound is None:
            bound = self.spec.bind(StreamSig(batch, chunk_len, sample_rate))
            if (self.mesh is not None and self.shard in ("channels", "time")
                    and getattr(bound, "ragged_output", False)):
                # The channel and time executors would emit the padded
                # chunks untrimmed (their group steps bypass the schedule
                # mirror).  Stream sharding is fine.
                raise ValueError(
                    "phase-mode (arbitrary-ratio) resampler tails are not "
                    "supported under channel/time mesh serving; serve "
                    "single-device or data-parallel, or re-chunk to a "
                    "multiple of the resampling period")
            bound = self._sharded(bound, chunk_len, sample_rate, batch)
            self._bindings[key] = bound
        return bound

    def _sharded(self, bound, chunk_len: int, sample_rate: float,
                 batch: int):
        """The binding's executor with its compiled step (``_jit``): the
        mesh mode's, or the single-device step where it cannot shard."""
        from ..blocks.base import jit_step_sharded
        mesh, axis = self.mesh, self.mesh_axis
        if mesh is not None and self.shard == "channels":
            from ..parallel.channel_shard import ChannelShardedChain
            try:
                cs = ChannelShardedChain(bound, mesh, axis=axis)
            except ValueError as e:
                _fallback(self.name, "channel-shard", e)
            else:
                cs._jit, cs.executor = cs.jit_step(), "channels"
                return cs
        elif mesh is not None and self.shard == "time":
            from ..parallel.time_shard import TimeShardedChain
            d = mesh.shape[axis]
            try:
                if chunk_len % d:
                    raise ValueError(f"chunk {chunk_len} not divisible by "
                                     f"the time axis ({d} devices)")
                inner = self.spec.bind(
                    StreamSig(batch, chunk_len // d, sample_rate))
                ts = TimeShardedChain(inner, mesh, t_axis=axis,
                                      overlap=self.overlap)
                ts.check(batch)
            except (ValueError, NotImplementedError) as e:
                _fallback(self.name, "time-shard", e)
            else:
                ts._jit, ts.executor = ts.jit_step(), "time"
                # The actor consumes and produces GROUP chunks.
                ts.in_sig, ts.out_sig = ts.group_sigs()
                return ts
        elif mesh is not None and bound.shard_batch_ok(mesh.shape[axis]):
            bound._jit = jit_step_sharded(bound, mesh, axis)
            bound.executor = "streams"
            return bound
        bound._jit, bound.executor = jit_step(bound), "single"
        return bound

    def update_params(self, fn: Callable[[Any, Any], Any],
                      slot: str = "update_params") -> None:
        """Host-side retune: ``fn(bound, params) -> params`` (numpy trees)
        applied to the current and future bindings (analog of
        watch-channel setters).  ``slot`` names the tunable: a later call
        with the same slot replaces it, while calls with different slots
        compose.  The next chunk uploads the new params: one recapture of
        the binding's step."""
        self._param_overrides[slot] = fn
        if self._bound is not None:
            self._bound.params = fn(self._bound, self._bound.params)
            # A user fn may write into the params IN PLACE and return the
            # same object, which the identity check at dispatch would read
            # as "unchanged": upload again regardless.
            self._dparams = None
            self._dparams_src = None

    # -- typed convenience setters (the reference's watch-channel API) -----
    #
    # Each setter locates the matching sub-block when this runtime block
    # wraps a Chain, mirroring the reference where every block has its own
    # watch channel.

    @staticmethod
    def _map_blocks(bound, params, fn):
        """Apply fn(block, block_params) -> new_params over a bound block,
        every sub-block of a bound chain, or every node of a bound graph;
        None leaves params unchanged."""
        from ..blocks.graph import BoundGraph
        if isinstance(bound, BoundGraph):
            out = []
            for node, pp in zip(bound.bound, params):
                if node is None:
                    out.append(pp)
                    continue
                new = fn(node, pp)
                out.append(pp if new is None else new)
            return tuple(out)
        blocks = getattr(bound, "blocks", None)
        if blocks is not None:
            out = []
            for blk, pp in zip(blocks, params):
                new = fn(blk, pp)
                out.append(pp if new is None else new)
            return tuple(out)
        new = fn(bound, params)
        return params if new is None else new

    def _sync_state(self) -> None:
        """Pull the live device stream state back into host numpy so
        host-side retunes can rewrite it (waits for the chunks in
        flight)."""
        if self._dstate is not None:
            self._state = tree_to_numpy(self._dstate)
            self._dstate = None

    def _apply_typed(self, fn, slot: str) -> None:
        def override(bound, params):
            return self._map_blocks(bound, params, fn)
        self.update_params(override, slot=slot)

    def set_gain(self, gain: float) -> None:
        """``GainControl::set`` analog (src/blocks/transform.rs:89-91)."""
        from ..blocks.transform import _BoundGain
        self._typed_values["set_gain"] = float(gain)
        self._apply_typed(lambda blk, p: _knob(p, gain)
                          if isinstance(blk, _BoundGain) else None,
                          slot="set_gain")

    def _blocks_and_params(self):
        from ..blocks.graph import BoundGraph
        bound = self._bound
        if bound is None:
            return None, None
        inner = getattr(bound, "bound", bound)   # the sharded executors
        if isinstance(inner, (list, tuple)):
            # BoundGraph.bound is its node list: the graph is the binding.
            inner = bound
        if isinstance(inner, BoundGraph):
            pairs = [(b, p) for b, p in zip(inner.bound, inner.params)
                     if b is not None]
            return (tuple(b for b, _ in pairs),
                    tuple(p for _, p in pairs))
        blocks = getattr(inner, "blocks", None)
        if blocks is None:
            return (inner,), (inner.params,)
        return blocks, inner.params

    def gain(self) -> float:
        """``GainControl::get`` analog (src/blocks/transform.rs:85-87):
        the current gain of the (first) GainControl."""
        from ..blocks.transform import _BoundGain
        blocks, params = self._blocks_and_params()
        if blocks is not None:
            for blk, p in zip(blocks, params):
                if isinstance(blk, _BoundGain):
                    return float(np.asarray(p))
        if "set_gain" in self._typed_values:
            # Pre-binding: a setter already registered a retune that the
            # first binding will apply.
            return self._typed_values["set_gain"]
        from ..blocks.transform import GainControl
        for spec in self._iter_specs():
            if isinstance(spec, GainControl):
                return float(spec.gain)
        raise ValueError("no GainControl to read")

    def _iter_specs(self):
        specs = getattr(self.spec, "specs", None)
        if specs is not None:
            return specs
        g = self.spec
        nodes = getattr(g, "_nodes", None)
        if nodes is not None:                       # Graph spec
            out = []
            for kind, payload in nodes:
                if kind not in ("input", "select") and payload:
                    out.append(payload[0])
            return out
        return [g]

    def shift(self) -> float:
        """``FreqShifter::shift`` analog (src/blocks/transform.rs:380-382):
        the current shift of the (first) FreqShifter/MixerDecimator."""
        from ..blocks.frontend import _BoundMixerDecimator
        from ..blocks.transform import _BoundFreqShifter
        blocks, _ = self._blocks_and_params()
        if blocks is not None:
            for blk in blocks:
                if isinstance(blk, (_BoundFreqShifter,
                                    _BoundMixerDecimator)):
                    return blk.current_shift
        if "set_shift" in self._typed_values:
            return self._typed_values["set_shift"]
        for spec in self._iter_specs():
            if hasattr(spec, "shift") and not callable(spec.shift):
                return float(spec.shift)
        raise ValueError("no FreqShifter/MixerDecimator to read")

    def update_shift(self, modify) -> None:
        """``FreqShifter::update_shift`` analog
        (src/blocks/transform.rs:388-390): read-modify-write retune with
        phase continuity: ``block.update_shift(lambda s: s + 100.0)``."""
        self.set_shift(float(modify(self.shift())))

    def set_agc(self, reference: float = None, rate: float = None,
                max_gain: float = None) -> None:
        """Retune AgcControl loop knobs (only the given ones) without
        touching the carried gain state."""
        from ..blocks.transform import _BoundAgc

        def upd(blk, p):
            if not isinstance(blk, _BoundAgc):
                return None
            new = dict(p)
            if reference is not None:
                new["reference"] = _knob(p["reference"], reference)
            if rate is not None:
                new["rate"] = _knob(p["rate"], rate)
            if max_gain is not None:
                new["max_gain"] = _knob(p["max_gain"], max_gain)
            return new
        self._apply_typed(upd, slot="set_agc")

    def set_squelch(self, threshold: float = None,
                    alpha: float = None) -> None:
        """Retune Squelch gating knobs (only the given ones)."""
        from ..blocks.transform import _BoundSquelch

        def upd(blk, p):
            if not isinstance(blk, _BoundSquelch):
                return None
            new = dict(p)
            if threshold is not None:
                new["threshold"] = _knob(p["threshold"], threshold)
            if alpha is not None:
                new["alpha"] = _knob(p["alpha"], alpha)
            return new
        self._apply_typed(upd, slot="set_squelch")

    def set_shift(self, shift: float) -> None:
        """``FreqShifter::set_shift`` analog with phase continuity
        (src/blocks/transform.rs:384-386): rewrites both the phasor tables
        and the carried phase state of the current binding (the state is
        read back from the device, rewritten on the host and copied into
        the step's buffers with the next chunk)."""
        self._typed_values["set_shift"] = float(shift)
        from ..blocks.frontend import _BoundMixerDecimator
        from ..blocks.transform import _BoundFreqShifter
        shifters = (_BoundFreqShifter, _BoundMixerDecimator)
        self._sync_state()
        if self._bound is not None and self._state is not None:
            bound = self._bound
            blocks = getattr(bound, "blocks", None)
            if blocks is not None:
                # A chain or a sharded executor (a time-sharded graph's
                # nodes, None for its inputs); the phase fold is
                # elementwise, so it takes the channel executor's
                # [batch, M] leaves too.
                params = list(bound.params)
                state = list(self._state)
                for i, blk in enumerate(blocks):
                    if isinstance(blk, shifters):
                        params[i], state[i] = blk.retune(params[i],
                                                         state[i], shift)
                bound.params = tuple(params)
                self._state = tuple(state)
            elif isinstance(bound, shifters):
                bound.params, self._state = bound.retune(
                    bound.params, self._state, shift)
            self._dparams = None
            self._dparams_src = None
        self._apply_typed(lambda blk, p: blk.shift_params(shift)
                          if isinstance(blk, shifters) else None,
                          slot="set_shift")

    def update_filter(self, freq_resp, window=None) -> None:
        """``Filter::update`` analog (src/blocks/filters.rs:279-297)."""
        from ..blocks.filters import _BoundFilter
        from ..blocks.frontend import _BoundFilterDemodFilter

        def fn(blk, p):
            if isinstance(blk, _BoundFilter):
                return blk.update_params(freq_resp, window)
            if isinstance(blk, _BoundFilterDemodFilter):
                # The merged kernel's channel-filter response.
                return blk.update_filter_params(freq_resp, window)
            return None

        self._apply_typed(fn, slot="update_filter")

    def set_map_params(self, new_params) -> None:
        """Retune a parameterized ``MapSample.with_params`` closure without
        rebinding (the reference hot-swaps map closures over an mpsc,
        src/blocks/transform.rs:132-179)."""
        from ..blocks.transform import _BoundMap

        def fn(blk, p):
            if isinstance(blk, _BoundMap) and blk._parameterized:
                return new_params
            return None

        self._apply_typed(fn, slot="set_map_params")

    def deviation(self) -> float:
        """``FmMod/FmDemod::deviation`` analog
        (src/blocks/modulation.rs:72-74,150-152): recovered from the
        (first) modulator/demodulator's factor param."""
        from ..numbers import TAU as _TAU
        from ..blocks.channelize import _BoundChannelizerDemod
        from ..blocks.frontend import (_BoundFilterDemodFilter,
                                       _BoundFmDemodFilter)
        from ..blocks.modulation import _BoundFmDemod, _BoundFmMod
        blocks, params = self._blocks_and_params()
        if blocks is not None:
            for blk, p in zip(blocks, params):
                if isinstance(blk, _BoundFmMod):
                    return float(np.asarray(p)) * blk.in_sig.sample_rate \
                        / _TAU
                if isinstance(blk, _BoundFmDemod):
                    return blk.in_sig.sample_rate / float(np.asarray(p)) \
                        / _TAU
                if isinstance(blk, (_BoundFmDemodFilter,
                                    _BoundFilterDemodFilter)):
                    return blk.in_sig.sample_rate \
                        / float(np.asarray(p["factor"])) / _TAU
                if isinstance(blk, _BoundChannelizerDemod):
                    # Per-channel demod runs at the channel rate.
                    return blk.out_sig.sample_rate \
                        / float(np.asarray(p["factor"])) / _TAU
        if "set_deviation" in self._typed_values:
            return self._typed_values["set_deviation"]
        for spec in self._iter_specs():
            if hasattr(spec, "deviation"):
                return float(spec.deviation)
        raise ValueError("no FmMod/FmDemod to read")

    def set_deviation(self, deviation: float) -> None:
        """``FmMod/FmDemod::set_deviation`` analog
        (src/blocks/modulation.rs:76-79,154-157)."""
        self._typed_values["set_deviation"] = float(deviation)
        from ..numbers import TAU as _TAU
        from ..blocks.channelize import _BoundChannelizerDemod
        from ..blocks.frontend import (_BoundFilterDemodFilter,
                                       _BoundFmDemodFilter)
        from ..blocks.modulation import _BoundFmDemod, _BoundFmMod

        def fn(blk, p):
            if isinstance(blk, _BoundFmMod):
                return _knob(p, deviation / blk.in_sig.sample_rate * _TAU)
            if isinstance(blk, _BoundFmDemod):
                return _knob(p, blk.in_sig.sample_rate / deviation / _TAU)
            if isinstance(blk, (_BoundFmDemodFilter,
                                _BoundFilterDemodFilter)):
                return {**p, "factor": _knob(
                    p["factor"], blk.in_sig.sample_rate / deviation / _TAU)}
            if isinstance(blk, _BoundChannelizerDemod):
                return {**p, "factor": _knob(
                    p["factor"], blk.out_sig.sample_rate / deviation / _TAU)}
            return None

        self._apply_typed(fn, slot="set_deviation")

    # -- checkpoint / resume of the live stream state -----------------------

    def save_checkpoint(self, path: str) -> None:
        """Serialize the live stream state (filter tails, demod previous
        sample, oscillator phase, ...) to ``path``.  Call from the event
        loop between sends (the same contract as the typed setters).  The
        file format is :mod:`radiorust_tpu_torch.utils.checkpoint`'s, which
        the JAX package reads too."""
        from ..utils.checkpoint import save_state
        self._sync_state()
        # A state loaded via load_checkpoint but not yet bound (no chunk
        # processed since) is still a complete, serializable stream state.
        state = self._state if self._state is not None \
            else self._restored_state
        if state is None:
            raise RuntimeError("no stream state yet: the block has not "
                               "processed a chunk")
        save_state(path, state)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a state saved by :meth:`save_checkpoint` (possibly in
        another process, or by the JAX package).  The next chunk continues
        the stream bit-exactly, provided it has the same (batch,
        chunk_len, sample_rate) signature the state was saved under."""
        from ..utils.checkpoint import load_state
        state = load_state(path)
        self._dstate = None
        self._pending_reset = False
        if self._bound is not None:
            self._state = state
            if getattr(self._bound, "ragged_output", False):
                # Restored phase lands mid-schedule; re-derive the mirror.
                self._sched_phase = self._bound.schedule_phase(state)
        else:
            self._restored_state = state

    # -- output hooks (RuntimeGraph overrides these for multi-output) ------

    async def _emit_event(self, msg) -> None:
        await self.sender.send(msg)

    async def _send_warmup(self, bound, inflight) -> None:
        """Zero-primed history: warn consumers the next valid_from outputs
        are not reference-comparable.  Flush first so the event lands
        before those outputs' peers."""
        if bound.valid_from > 0:
            await self._flush(inflight)
            await self.sender.send(Warmup(bound.valid_from))

    def _close_outputs(self) -> None:
        self.sender.close()

    def _step(self, bound, x, reset):
        """One compiled step of the current binding: (state', y)."""
        return bound._jit(self._dparams, self._dstate, x, reset)

    async def _fetched(self, entry):
        """Wait for an in-flight entry's output to reach the host (depth
        0: block; depth > 0: poll, so other actors run while the card
        works) and return its host tree as numpy."""
        host, event = entry[0], entry[1]
        if event is not None:
            if self.pipeline_depth > 0:
                while not event.query():
                    await asyncio.sleep(0)
            else:
                event.synchronize()
        t0 = time.perf_counter()
        out = _map(host, lambda t: t.numpy())
        self.chunks_processed += 1
        self.stats.record_chunk(entry[3], t0 - entry[5])
        self.stats.record_host(time.perf_counter() - t0)
        return out

    async def _fetch_send(self, entry) -> None:
        """Fetch one in-flight device result and emit it downstream.

        With ``pipeline_depth > 0`` the recorded wall time is
        dispatch-to-fetch latency (it includes device queue wait);
        throughput numbers remain correct, per-chunk times read higher.
        """
        y = await self._fetched(entry)
        _, _, bound, _, batched, _, valid = entry
        if valid is not None:
            # Phase-mode (arbitrary-ratio) resampler tail: the compiled
            # step pads each chunk to a static length; the actor trims to
            # the schedule's valid prefix so downstream consumers see a
            # gapless stream (the reference's variable-count accumulator
            # behavior, src/blocks/resampling.rs:103-133).
            if valid == 0:
                return
            y = y[:, :valid]
        # 1-D input stays 1-D downstream — unless the chain grows the
        # batch (a Channelizer folds channels into it): then the output is
        # genuinely 2-D [channels, t] and y[0] would strip all but one.
        flatten = not batched and bound.out_sig.batch == 1
        await self.sender.send(Samples(bound.out_sig.sample_rate,
                                       y[0] if flatten else y))

    async def _flush(self, inflight) -> None:
        while inflight:
            await self._fetch_send(inflight.popleft())

    async def _run(self, receiver: Receiver):
        inflight = deque()
        recv_task = None
        try:
            while True:
                # Under sustained load the next message is already waiting
                # and the pipeline holds `depth` chunks; when input goes
                # idle, drain in-flight work instead of withholding it
                # (capacity-1 channel semantics: peers never starve).
                recv_task = asyncio.ensure_future(receiver.recv())
                while inflight:
                    await asyncio.sleep(0)  # let a ready recv complete
                    done, _ = await asyncio.wait({recv_task}, timeout=0)
                    if done:
                        break
                    await self._fetch_send(inflight.popleft())
                msg = await recv_task
                recv_task = None
                if isinstance(msg, Event):
                    # Events flush pending device work first: ordering
                    # between samples and events is part of the contract.
                    await self._flush(inflight)
                    if msg.is_interrupt:
                        self._pending_reset = True
                    self.stats.record_event()
                    self.event_handlers.invoke(msg)
                    await self._emit_event(msg)
                    continue
                t0 = time.perf_counter()
                chunk = np.asarray(msg.chunk)
                # 2-D [streams, n] chunks batch independent streams through
                # one device program (the deliberate widening that
                # amortizes per-dispatch cost over the batch).
                batched = chunk.ndim == 2
                x = chunk if batched else chunk[None, :]
                bound = self._get_bound(x.shape[1], msg.sample_rate,
                                        x.shape[0])
                fresh = bound is not self._bound
                restored = False
                if fresh:
                    self._bound = bound
                    # Re-apply EVERY live retune (one slot per tunable).
                    for override in self._param_overrides.values():
                        bound.params = override(bound, bound.params)
                    if (self._restored_state is not None
                            and not self._pending_reset):
                        # Resuming a checkpoint: the state is real stream
                        # history, so the stream continues (no zero-primed
                        # warmup, no reset).
                        self._state = self._restored_state
                        self._restored_state = None
                        restored = True
                    else:
                        # An interrupt between load_checkpoint and the
                        # first chunk declares the stream discontinuous:
                        # the restored history is stale, start fresh.
                        self._restored_state = None
                        self._state = bound.init_state()
                    # Ragged (phase-mode resampler) tails: mirror the
                    # schedule phase host-side so each emitted chunk can
                    # be trimmed to its valid prefix.  Derived from the
                    # host state, so a checkpoint restore lands
                    # mid-schedule correctly; never read per chunk.
                    self._sched_phase = (
                        bound.schedule_phase(self._state)
                        if getattr(bound, "ragged_output", False) else None)
                    self._dstate = None
                    self._pending_reset = False
                reset = reset_masks(bound, x.shape[0],
                                    self.device)[int(self._pending_reset)]
                if (fresh or self._pending_reset) and not restored:
                    self.stats.record_host(time.perf_counter() - t0)
                    await self._send_warmup(bound, inflight)
                    t0 = time.perf_counter()
                self._pending_reset = False
                if self._dstate is None:
                    self._dstate = tree_to_torch(self._state, self.device)
                if self._dparams is None or self._dparams_src is not \
                        bound.params:
                    # Params are constant between retunes (every setter
                    # REASSIGNS bound.params, and update_params drops the
                    # cache): one upload, and one capture, per retune.
                    self._dparams = tree_to_torch(bound.params, self.device)
                    self._dparams_src = bound.params
                self._dstate, y = self._step(
                    bound, upload(x, self.device), reset)
                host, event = start_fetch(y, self.device)
                valid = None
                if self._sched_phase is not None:
                    valid, self._sched_phase = bound.advance_schedule(
                        self._sched_phase)
                inflight.append((host, event, bound, x.size, batched, t0,
                                 valid))
                self.stats.record_host(time.perf_counter() - t0)
                while len(inflight) > self.pipeline_depth:
                    await self._fetch_send(inflight.popleft())
        except ChannelClosed:
            # Input closed: drain whatever is still in flight downstream.
            try:
                await self._flush(inflight)
            except ChannelClosed:
                pass
            except Exception as exc:  # device error during the drain
                self._record_failure(exc)
            return
        except Exception as exc:
            self._record_failure(exc)
            return
        finally:
            if recv_task is not None:
                recv_task.cancel()
                try:
                    await recv_task
                except (asyncio.CancelledError, ChannelClosed):
                    pass
            # Task exit drops the task-owned endpoints (reference: the task
            # owns Receiver/Sender, src/blocks/mod.rs:213-230), so teardown
            # cascades down the chain instead of leaving peers parked.
            receiver.close()
            self._close_outputs()


class _OutputHandle:
    """Producer facade for one named output of a :class:`RuntimeGraph`,
    so ``consumer.feed_from(rg.out("audio"))`` works like any producer."""

    def __init__(self, sender_connector: SenderConnector):
        self.sender_connector = sender_connector

    def feed_into(self, consumer) -> None:
        consumer.receiver_connector.connect(self.sender_connector)


class RuntimeGraph(RuntimeBlock):
    """Streaming actor around a DAG with one input and N named outputs.

    The reference gets fan-out by broadcasting one producer's chunks to N
    consumer chains in lock-step (``src/flow.rs:44-52``), each chain
    recomputing from the shared stream.  This actor instead runs a
    :class:`radiorust_tpu_torch.blocks.graph.Graph` — the whole DAG, shared
    prefix included, as ONE compiled step per chunk — and publishes each
    named output on its own capacity-1 sender.  Events (and interrupt
    resets) are forwarded to every output, preserving the in-band ordering
    contract per stream.

    Delivery semantics per output: outputs with a connected consumer run
    in lock-step with backpressure (the reference's broadcast contract);
    an output *without* a consumer drops its chunks instead of stalling
    the others (a late subscriber simply starts at the live stream
    position).  If NO output has a consumer, the actor parks.

    Everything else (rebind on shape/rate change, interrupt resets,
    per-output Warmup, 1-D/2-D batched chunks, ``pipeline_depth``, typed
    setters applied per node, checkpoints, ``device``) is inherited from
    :class:`RuntimeBlock`.  A mesh serves a graph over its streams
    (``shard="streams"``) or time-sharded (``shard="time"``:
    :class:`~radiorust_tpu_torch.parallel.time_shard.TimeShardedGraph`).
    """

    def __init__(self, graph_spec, name: Optional[str] = None,
                 pipeline_depth: int = 0, mesh=None,
                 mesh_axis: Optional[str] = None, shard: str = "streams",
                 overlap: int = 1, device=None):
        from ..utils.profiling import GLOBAL_STATS
        if len(graph_spec._inputs) != 1:
            raise ValueError("RuntimeGraph wraps single-input graphs; "
                             "multi-input graphs are a compiled-path "
                             "feature (bind + graph_scan)")
        self.mesh_axis = check_serving(mesh, mesh_axis, shard,
                                       ("streams", "time"))
        self.mesh, self.shard, self.overlap = mesh, shard, overlap
        self.device = resolve_device(device if mesh is None or device
                                     else mesh.home)
        self.spec = graph_spec
        self.name = name or "RuntimeGraph"
        self.stats = GLOBAL_STATS.unique(self.name)
        self.pipeline_depth = pipeline_depth
        self._init_actor_fields()
        receiver, self.receiver_connector = new_receiver()
        self.senders: Dict[str, Sender] = {}
        self._connectors: Dict[str, SenderConnector] = {}
        for out_name in graph_spec._outputs:
            s, sc = new_sender()
            self.senders[out_name] = s
            self._connectors[out_name] = sc
        self._bindings: Dict[Tuple[int, int, float], Any] = {}
        self._task = _spawn(self._run(receiver))

    def out(self, name: str) -> _OutputHandle:
        """Producer handle for output ``name`` (connect consumers to it)."""
        return _OutputHandle(self._connectors[name])

    @property
    def sender_connector(self):
        raise AttributeError(
            "RuntimeGraph has named outputs; connect consumers via "
            "sink.feed_from(rg.out(name))")

    def _step(self, bound, x, reset):
        name = next(iter(bound.in_sigs))
        return bound._jit(self._dparams, self._dstate, {name: x},
                          {name: reset})

    def _sharded(self, bound, chunk_len: int, sample_rate: float,
                 batch: int):
        if self.mesh is not None and self.shard == "time":
            tsg = self._bind_time_sharded(chunk_len, sample_rate, batch)
            if tsg is not None:
                return tsg
            bound._jit, bound.executor = jit_step(bound), "single"
            return bound
        return super()._sharded(bound, chunk_len, sample_rate, batch)

    def _bind_time_sharded(self, chunk_len: int, sample_rate: float,
                           batch: int):
        """The ``shard="time"`` binding: the DAG time-sharded over the
        mesh, D chunks a group step; None (with a logged warning) where
        the chunk does not divide or a node cannot time-shard."""
        from ..parallel.time_shard import TimeShardedGraph
        d = self.mesh.shape[self.mesh_axis]
        try:
            if chunk_len % d:
                raise ValueError(f"chunk {chunk_len} not divisible by the "
                                 f"time axis ({d} devices)")
            inner = self.spec.bind(
                StreamSig(batch, chunk_len // d, sample_rate))
            tsg = TimeShardedGraph(inner, self.mesh, t_axis=self.mesh_axis,
                                   overlap=self.overlap)
            tsg.check(batch)
        except (ValueError, NotImplementedError) as e:
            _fallback(self.name, "time-shard", e)
            return None
        # The actor consumes and produces GROUP chunks.
        tsg.in_sigs, tsg.out_sigs = tsg.group_sigs()
        tsg._jit, tsg.executor = tsg.jit_step(), "time"
        return tsg

    # -- multi-output hooks -------------------------------------------------

    async def _broadcast(self, make_msg) -> None:
        """Send to every output that has a consumer; drop for outputs that
        don't; park (backpressure) while no output has any consumer."""
        while all(s._channel.receivers == 0 for s in self.senders.values()):
            await asyncio.sleep(0.01)
        for name, s in self.senders.items():
            if s._channel.receivers == 0:
                continue
            await s.send(make_msg(name))

    async def _emit_event(self, msg) -> None:
        await self._broadcast(lambda name: msg)

    async def _send_warmup(self, bound, inflight) -> None:
        if any(vf > 0 for vf in bound.valid_from.values()):
            await self._flush(inflight)
            for name, s in self.senders.items():
                vf = bound.valid_from[name]
                if vf > 0 and s._channel.receivers > 0:
                    await s.send(Warmup(vf))

    def _close_outputs(self) -> None:
        for s in self.senders.values():
            s.close()

    async def _fetch_send(self, entry) -> None:
        # ``valid`` is always None for graphs: ragged (phase-mode
        # resampler) outputs are rejected at graph construction.
        ys = await self._fetched(entry)
        _, _, bound, _, batched, _, _ = entry
        await self._broadcast(
            lambda name: Samples(
                bound.out_sigs[name].sample_rate,
                ys[name][0] if (not batched
                                and bound.out_sigs[name].batch == 1)
                else ys[name]))


class Silence(_ProducerMixin):
    """Producer of zero chunks with tunable size and rate
    (``src/blocks/io/mod.rs:22-87``)."""

    def __init__(self, chunk_size: int, sample_rate: float):
        self.chunk_size = chunk_size
        self.sample_rate = sample_rate
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run())

    def set_chunk_size(self, n: int):
        self.chunk_size = n

    def set_sample_rate(self, r: float):
        self.sample_rate = r

    async def _run(self):
        try:
            while True:
                chunk = np.zeros(self.chunk_size, stream_complex())
                await self.sender.send(Samples(self.sample_rate, chunk))
        except ChannelClosed:
            return
        finally:
            self.sender.close()


class Blackhole(_ConsumerMixin, EventHandling):
    """Sink that discards samples but observes events
    (``src/blocks/io/mod.rs:91-131``)."""

    def __init__(self):
        receiver, self.receiver_connector = new_receiver()
        self.event_handlers = EventHandlers()
        self.samples_seen = 0
        self._task = _spawn(self._run(receiver))

    async def _run(self, receiver):
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                else:
                    # Per-stream time length (axis -1): correct for both
                    # 1-D chunks and batched [streams, n] serving chunks.
                    self.samples_seen += np.shape(msg.chunk)[-1]
        except ChannelClosed:
            return
        finally:
            receiver.close()


class _TemporalQueue:
    """Duration/age-tracked queue (``src/blocks/buffering.rs:33-112``)."""

    def __init__(self, clock=time.monotonic):
        self._q: List[Tuple[float, Any]] = []
        self._clock = clock
        self.duration = 0.0
        self.event_count = 0

    def push(self, msg):
        self._q.append((self._clock(), msg))
        if isinstance(msg, Event):
            self.event_count += 1
        else:
            self.duration += msg.duration

    def pop(self):
        if not self._q:
            return None
        _, msg = self._q.pop(0)
        if isinstance(msg, Event):
            self.event_count -= 1
        else:
            # Running total (the reference recomputes by summing the whole
            # queue each op, buffering.rs:54-59 — O(1) here, same value up
            # to float accumulation; reset to exact zero when drained).
            self.duration -= msg.duration
        if not self._q:
            self.duration = 0.0
        return msg

    def age(self) -> float:
        return self._clock() - self._q[0][0] if self._q else 0.0

    def __len__(self):
        return len(self._q)

    def leading_event(self) -> bool:
        return bool(self._q) and isinstance(self._q[0][1], Event)


QUEUE_MAX_EVENTS = 256


class Buffer(_ProducerMixin, _ConsumerMixin, EventHandling):
    """Elastic/lossy buffer (``src/blocks/buffering.rs:132-267``).

    Fills to ``initial_capacity`` seconds before draining, refills to
    ``min_capacity`` after underrun, suspends receiving above
    ``max_capacity``, and discards entries older than ``max_age`` (emitting
    one :class:`BufferOverflow` interrupt per gap).
    """

    def __init__(self, initial_capacity: float, min_capacity: float,
                 max_capacity: float, max_age: float,
                 clock=time.monotonic):
        self.initial = initial_capacity
        self.min_capacity = min_capacity
        self.max_capacity = max_capacity
        self.max_age = max_age
        self.event_handlers = EventHandlers()
        receiver, self.receiver_connector = new_receiver()
        self.sender, self.sender_connector = new_sender()
        self._queue = _TemporalQueue(clock)
        self._task = _spawn(self._run(receiver))

    async def _run(self, receiver):
        queue = self._queue
        initial = True
        underrun = True
        shutdown = False
        marked_missing = False
        fill_task = None  # persistent: cancelling a recv could lose a chunk
        drain_task = None
        try:
            while True:
                if shutdown and not len(queue):
                    return
                can_fill = (not shutdown
                            and queue.duration <= self.max_capacity
                            and queue.event_count < QUEUE_MAX_EVENTS)
                if can_fill and fill_task is None:
                    fill_task = asyncio.ensure_future(receiver.recv())
                want_drain = (not underrun) or shutdown
                drain_task = (asyncio.ensure_future(self.sender.reserve())
                              if want_drain else None)
                tasks = [t for t in (fill_task, drain_task) if t]
                if not tasks:
                    fill_task = asyncio.ensure_future(receiver.recv())
                    tasks = [fill_task]
                done, _ = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED)
                # Only the reserve task is safe to cancel (reserving has no
                # side effects); the fill task persists across iterations.
                if drain_task is not None and drain_task not in done:
                    drain_task.cancel()
                    try:
                        await drain_task
                    except (asyncio.CancelledError, ChannelClosed):
                        pass
                    drain_task = None
                if fill_task is not None and fill_task in done:
                    # A drain (reserve) task that completed in the same
                    # wakeup must still have its result retrieved; the
                    # unused reservation is cancelled so it releases its
                    # claim on the slot.
                    if drain_task is not None and drain_task in done:
                        try:
                            drain_task.result().cancel()
                        except ChannelClosed:
                            pass
                        drain_task = None
                    try:
                        msg = fill_task.result()
                    except ChannelClosed:
                        shutdown = True
                        fill_task = None
                        continue
                    fill_task = None
                    if isinstance(msg, Event):
                        # Handlers observe events when the block receives
                        # them (impl_block_trait! EventHandling semantics).
                        self.event_handlers.invoke(msg)
                    queue.push(msg)
                    if initial:
                        if queue.duration >= self.initial:
                            underrun = False
                            initial = False
                    elif queue.duration >= self.min_capacity:
                        underrun = False
                    marked_missing = self._try_drain(marked_missing)
                elif drain_task is not None and drain_task in done:
                    try:
                        res = drain_task.result()
                    except ChannelClosed:
                        return
                    # Use the claimed reservation directly: it holds the
                    # slot, so a second try_reserve would see it as busy.
                    marked_missing, underrun = self._drain_one(
                        marked_missing, res)
        except ChannelClosed:
            return
        except Exception as exc:
            self._record_failure(exc)
            return
        finally:
            for t in (fill_task, drain_task):
                if t is not None:
                    t.cancel()
            receiver.close()
            self.sender.close()

    def _drop_stale(self, keep_last: bool) -> bool:
        # Only a LEADING event vetoes the drop; aged events further back
        # are discarded with the samples around them, exactly like the
        # reference's pop loop (buffering.rs:206-247).
        queue = self._queue
        dropped = False
        if queue.leading_event():
            return False
        limit = 1 if keep_last else 0
        while len(queue) > limit and queue.age() > self.max_age:
            queue.pop()
            dropped = True
        return dropped

    def _try_drain(self, marked_missing):
        try:
            res = self.sender.try_reserve()
        except ChannelClosed:
            return marked_missing
        if res is None:
            return marked_missing
        if len(self._queue) > 1 and self._drop_stale(keep_last=True):
            if not marked_missing:
                res.send(BufferOverflow())
                return True
        msg = self._queue.pop()
        if msg is not None:
            res.send(msg)
            return False
        res.cancel()
        return marked_missing

    def _drain_one(self, marked_missing, res=None):
        if res is None:
            try:
                res = self.sender.try_reserve()
            except ChannelClosed:
                return marked_missing, True
            if res is None:
                return marked_missing, False
        if self._drop_stale(keep_last=False):
            if not marked_missing:
                res.send(BufferOverflow())
                return True, False
        msg = self._queue.pop()
        if msg is None:
            res.cancel()
            return marked_missing, True
        res.send(msg)
        return False, False


class Rechunker(_ProducerMixin, _ConsumerMixin, EventHandling):
    """Regroup arbitrary chunk lengths into a fixed length
    (``src/blocks/chunks.rs:42-177``).

    Zero-copy where the reference is: full output chunks are split off the
    incoming chunk with ``separate_beginning`` (views into the same
    storage, ``chunks.rs:119-127``); only boundary-straddling remainders go
    through a pooled patchwork buffer (``chunks.rs:100-117``), whose
    storage recycles once the consumer releases it."""

    def __init__(self, output_chunk_len: int):
        if output_chunk_len <= 0:
            raise ValueError("output_chunk_len must be positive")
        self.output_chunk_len = output_chunk_len
        # Patchwork pools are created per stream dtype on first use so
        # boundary-straddling remainders keep the stream's dtype.
        self._pools: Dict[np.dtype, ChunkBufPool] = {}
        self.event_handlers = EventHandlers()
        receiver, self.receiver_connector = new_receiver()
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run(receiver))

    def _pool(self, dtype) -> ChunkBufPool:
        dtype = np.dtype(dtype)
        pool = self._pools.get(dtype)
        if pool is None:
            pool = self._pools[dtype] = ChunkBufPool(dtype)
        return pool

    @property
    def pool(self) -> ChunkBufPool:
        """The stream-dtype pool (the stream mode's complex dtype unless
        the stream differs)."""
        if len(self._pools) == 1:
            return next(iter(self._pools.values()))
        return self._pool(stream_complex())

    def set_output_chunk_len(self, n: int):
        if n <= 0:
            raise ValueError("output_chunk_len must be positive")
        self.output_chunk_len = n

    async def _run(self, receiver):
        patchwork: Optional[Tuple[float, ChunkBuf]] = None
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                    if patchwork is not None and len(patchwork[1]):
                        await self.sender.send(SamplesLost())
                        patchwork = None
                    await self.sender.send(msg)
                    continue
                rate = msg.sample_rate
                if np.ndim(getattr(msg.chunk, "data", msg.chunk)) != 1:
                    # Batched [streams, n] chunks have no single time axis
                    # to regroup zero-copy; fail loudly over silently
                    # slicing the stream axis.
                    raise TypeError(
                        "Rechunker requires 1-D chunks; got batched "
                        f"shape {np.shape(np.asarray(msg.chunk))}")
                chunk = (msg.chunk if isinstance(msg.chunk, Chunk)
                         else Chunk.from_array(np.asarray(msg.chunk)))
                if patchwork is not None and patchwork[0] != rate \
                        and len(patchwork[1]):
                    await self.sender.send(SamplesLost())
                    patchwork = None
                n = self.output_chunk_len
                # A live set_output_chunk_len shrink can strand a patchwork
                # larger than the new length; signal the loss in-band.  A
                # patchwork of exactly n is a complete chunk (emitted
                # below, take=0), no loss.
                if patchwork is not None and len(patchwork[1]) > n:
                    await self.sender.send(SamplesLost())
                    patchwork = None
                # Top up an in-progress patchwork first.
                if patchwork is not None and len(patchwork[1]):
                    buf = patchwork[1]
                    take = min(n - len(buf), len(chunk))
                    buf.extend(chunk.separate_beginning(take).data)
                    chunk = chunk.discard_beginning(take)
                    if len(buf) == n:
                        await self.sender.send(Samples(rate, buf.finalize()))
                        patchwork = None
                # Full output chunks split off zero-copy.
                while len(chunk) >= n:
                    head = chunk.separate_beginning(n)
                    chunk = chunk.discard_beginning(n)
                    await self.sender.send(Samples(rate, head))
                if len(chunk):
                    if patchwork is None:
                        patchwork = (rate, self._pool(chunk.dtype)
                                     .get_with_capacity(n))
                    patchwork[1].extend(chunk.data)
        except ChannelClosed:
            return
        except Exception as exc:
            self._record_failure(exc)
            return
        finally:
            receiver.close()
            self.sender.close()


class KeyerSource(_ProducerMixin):
    """Streaming morse keyer producer wrapping
    :class:`radiorust_tpu_torch.blocks.morse.Keyer`
    (``src/blocks/morse.rs:282-420``)."""

    def __init__(self, chunk_len: int, sample_rate: float, speed,
                 message: Optional[str] = None):
        from ..blocks.morse import Keyer
        self._keyer = Keyer(chunk_len, sample_rate, speed, message)
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run())

    def send(self, text: str):
        self._keyer.send(text)

    def set_speed(self, speed):
        self._keyer.set_speed(speed)

    async def _run(self):
        try:
            while True:
                for chunk, events in self._keyer.chunks(1):
                    for e in events:
                        await self.sender.send(e)
                    await self.sender.send(
                        Samples(self._keyer.sample_rate, chunk))
        except ChannelClosed:
            return
        finally:
            self.sender.close()


class ArraySource(_ProducerMixin):
    """Feed a prerecorded IQ array as chunks (test/file source).  Chunks
    split the array's first axis: a 2-D ``[rows, n]`` array gives
    ``[chunk_len, n]`` chunks."""

    def __init__(self, data, chunk_len: int, sample_rate: float,
                 repeat: bool = False):
        self.data = np.asarray(data, stream_complex())
        self.chunk_len = chunk_len
        self.sample_rate = sample_rate
        self.repeat = repeat
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run())

    async def _run(self):
        try:
            carry = np.zeros((0,) + self.data.shape[1:], self.data.dtype)
            while True:
                # Chunks are zero-copy views split off one backing array
                # (the reference's separate_beginning pattern,
                # src/bufferpool.rs:70-79); only wrap-straddling chunks
                # copy (stitched from tail + next cycle's head).
                whole = Chunk.from_array(self.data)
                while len(carry) and len(whole):
                    need = self.chunk_len - len(carry)
                    take = min(need, len(whole))
                    carry = np.concatenate(
                        [carry, np.asarray(whole.separate_beginning(take))])
                    whole = whole.discard_beginning(take)
                    if len(carry) == self.chunk_len:
                        await self.sender.send(
                            Samples(self.sample_rate, carry))
                        carry = carry[:0]
                while len(whole) >= self.chunk_len:
                    head = whole.separate_beginning(self.chunk_len)
                    whole = whole.discard_beginning(self.chunk_len)
                    await self.sender.send(Samples(self.sample_rate, head))
                if self.repeat:
                    # Never drop the tail: it leads the next cycle, so the
                    # repeated stream is gap-free.
                    if len(whole):
                        carry = (np.concatenate([carry, np.asarray(whole)])
                                 if len(carry) else
                                 np.asarray(whole).copy())
                    continue
                if len(whole):
                    # Final partial chunk: emit short rather than discard.
                    await self.sender.send(Samples(self.sample_rate, whole))
                return
        except ChannelClosed:
            return
        finally:
            self.sender.close()


class ArraySink(_ConsumerMixin, EventHandling):
    """Collect received samples into a list of chunks."""

    def __init__(self):
        receiver, self.receiver_connector = new_receiver()
        self.event_handlers = EventHandlers()
        self.chunks: List[np.ndarray] = []
        self.events: List[Event] = []
        self.sample_rate: Optional[float] = None
        self._task = _spawn(self._run(receiver))

    @property
    def samples(self) -> np.ndarray:
        # axis=-1: time axis for both 1-D chunks and batched [streams, n].
        return (np.concatenate(self.chunks, axis=-1) if self.chunks
                else np.zeros(0, stream_complex()))

    async def _run(self, receiver):
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.events.append(msg)
                    self.event_handlers.invoke(msg)
                else:
                    self.sample_rate = msg.sample_rate
                    self.chunks.append(np.asarray(msg.chunk))
        except ChannelClosed:
            return
        finally:
            receiver.close()


class FileSink(_ConsumerMixin, EventHandling):
    """Stream received complex64 samples to a raw IQ file."""

    def __init__(self, path: str):
        receiver, self.receiver_connector = new_receiver()
        self.event_handlers = EventHandlers()
        self._file = open(path, "wb")
        self._task = _spawn(self._run(receiver))

    async def _run(self, receiver):
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                else:
                    np.asarray(msg.chunk, np.complex64).tofile(self._file)
        except ChannelClosed:
            return
        finally:
            self._file.close()
            receiver.close()


class MapSignal(_ProducerMixin, _ConsumerMixin, EventHandling):
    """Applies a host closure to every message (samples *and* events)
    before forwarding — the reference's ``MapSignal``
    (``src/blocks/transform.rs:202-263``).  The closure is hot-swappable
    via :meth:`set_closure`.  Events are also observable via ``on_event``
    (the reference's ``NopSignal`` template, src/blocks/mod.rs:193-239)."""

    def __init__(self, closure=None):
        self._closure = closure if closure is not None else (lambda m: m)
        self.event_handlers = EventHandlers()
        receiver, self.receiver_connector = new_receiver()
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run(receiver))

    def set_closure(self, closure):
        self._closure = closure

    async def _run(self, receiver):
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                await self.sender.send(self._closure(msg))
        except ChannelClosed:
            return
        except Exception as exc:  # user closure raised
            self._record_failure(exc)
            return
        finally:
            receiver.close()
            self.sender.close()
