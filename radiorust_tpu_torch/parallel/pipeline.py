"""Pipeline parallelism: one chain stage per device, overlapped in flight
(PyTorch port of the JAX package's ``parallel/pipeline.py``).

The reference's own parallelism is a task per block, a chain of k blocks
running up to k chunks deep (``src/blocks/mod.rs:27-34``,
``src/flow.rs:44-52``).  Here a bound chain is cut into contiguous
stages, each with its params and state on its own device, and each tick
moves one chunk through every occupied stage.  On CUDA each stage runs on
its own stream: a tick issues every stage's work before waiting for
anything, so the stages' kernels overlap on the device (the JAX package
gets the same from asynchronous dispatch).  A chunk handed from one stage
to the next carries an event; the next stage's stream waits on it, and
the tensor is marked as used on that stream for the caching allocator.

Time sharding scales one chain without a pipeline bubble but needs every
block's state to be halo-expressible; the pipeline scales *any* chain
(the slew limiter's sequential clamp included), its throughput set by the
slowest stage after a warm-up of ``stages - 1`` chunks.

``CrossProcessPipeline`` (a stage per process) waits for the port's
process-group slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..blocks.base import BoundBlock, _BoundChain
from ..convert import tree_to_numpy, tree_to_torch
from ..numbers import stream_complex
from .mesh import move

__all__ = ["PipelinedChain", "balance_partition"]


def balance_partition(n_blocks: int, n_stages: int) -> List[int]:
    """Contiguous block counts per stage, as even as possible (with no
    cost model of the blocks; pass :class:`PipelinedChain` an explicit
    ``partition`` to encode measured stage costs)."""
    if not (1 <= n_stages <= n_blocks):
        raise ValueError(f"need 1 <= stages ({n_stages}) <= blocks "
                         f"({n_blocks})")
    base, extra = divmod(n_blocks, n_stages)
    return [base + (i < extra) for i in range(n_stages)]


class _Stage:
    """One stage: a contiguous sub-chain with its params and state on one
    device, and on CUDA a stream of its own."""

    def __init__(self, blocks: Sequence[BoundBlock], device):
        self.bound = blocks[0] if len(blocks) == 1 else _BoundChain(blocks)
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.params = tree_to_torch(self.bound.params, self.device)
        self.reset_state()

    def reset_state(self):
        self.state = tree_to_torch(self.bound.init_state(), self.device)

    def run(self, x, reset, ready):
        """Issue this stage's step on ``x`` (ready once event ``ready``
        has passed, or now): (y, its reset mask, event when y is ready)."""
        if self.stream is None:
            x, reset = move(x, self.device), move(reset, self.device)
            self.state, y = self.bound.process(self.params, self.state, x,
                                               reset)
            return y, self._out_reset(reset), None
        with torch.cuda.stream(self.stream):
            if ready is not None:
                self.stream.wait_event(ready)
            # Made on another stream: not to be reused before this one
            # has read it.
            for t in (x, reset):
                if t.is_cuda:
                    t.record_stream(self.stream)
            x, reset = move(x, self.device), move(reset, self.device)
            self.state, y = self.bound.process(self.params, self.state, x,
                                               reset)
            out_reset = self._out_reset(reset)
            done = torch.cuda.Event()
            done.record(self.stream)
        return y, out_reset, done

    def _out_reset(self, reset):
        # A batch-growing stage (a channelizer) widens the mask: one flag
        # per output stream.
        factor = self.bound.out_sig.batch // self.bound.in_sig.batch
        if factor > 1:
            return reset[:, None].expand(-1, factor).reshape(-1)
        return reset


class PipelinedChain:
    """A bound chain with one stage per device, pipelined.

    ``push(x, reset)`` feeds one input chunk and returns the chunk that
    left the last stage this tick (a tensor on the last stage's device,
    ready on the current stream), or ``None`` while the pipeline fills:
    the first output returns on the ``depth``-th push.  ``push(None)``
    ticks without feeding (drain).  ``run(xs)`` feeds T chunks, drains
    and returns ``[T, batch, n]``.  The results are those of scanning the
    chain: only where and when each stage runs changes.

    ``devices``: one per stage (repeats allowed: stages on one card run
    on their own streams); by default the first CUDA device once per
    block.  ``partition``: blocks per stage (default
    :func:`balance_partition`)."""

    def __init__(self, bound_chain: _BoundChain, devices=None,
                 partition: Optional[Sequence[int]] = None):
        blocks = list(bound_chain.blocks)
        if devices is None:
            from ..runtime.blocks import resolve_device
            devices = [resolve_device(None)] * len(blocks)
        devices = [torch.device(d) for d in devices]
        if partition is None:
            partition = balance_partition(len(blocks), len(devices))
        if len(partition) != len(devices):
            raise ValueError("partition and devices length mismatch")
        if sum(partition) != len(blocks) or min(partition) < 1:
            raise ValueError(f"partition {partition} does not cover "
                             f"{len(blocks)} blocks")
        self.bound = bound_chain
        self.in_sig = bound_chain.in_sig
        self.out_sig = bound_chain.out_sig
        self.stages: List[_Stage] = []
        i = 0
        for cnt, dev in zip(partition, devices):
            self.stages.append(_Stage(blocks[i:i + cnt], dev))
            i += cnt
        # buf[s]: (chunk, reset, event) waiting at stage s, or None.
        self._buf: List[Optional[tuple]] = [None] * len(self.stages)

    @property
    def depth(self) -> int:
        return len(self.stages)

    def reset(self):
        """Drop every chunk in flight and start every stage's state
        anew."""
        self._sync()
        self._buf = [None] * len(self.stages)
        for st in self.stages:
            st.reset_state()

    def _sync(self):
        for st in self.stages:
            if st.stream is not None:
                st.stream.synchronize()

    def push(self, x=None, reset=None):
        """One tick: ``x`` [batch, chunk_len] complex (a tensor on any
        device, or numpy) enters stage 0, or None to drain."""
        stages = self.stages
        if x is not None:
            x = torch.as_tensor(x)
            if reset is None:
                reset = torch.zeros((self.in_sig.batch,), dtype=torch.bool)
            reset = torch.as_tensor(reset)
            ready = None
            if x.is_cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(x.device))
            self._buf[0] = (x, reset, ready)
        outs: List[Optional[tuple]] = [None] * len(stages)
        # Every occupied stage is issued before anything is awaited.
        for s, stage in enumerate(stages):
            if self._buf[s] is not None:
                outs[s] = stage.run(*self._buf[s])
        # Stage s's output waits at stage s+1's door.
        self._buf = [None] + outs[:-1]
        tail = outs[-1]
        if tail is None:
            return None
        y, _, done = tail
        if done is not None:
            current = torch.cuda.current_stream(y.device)
            current.wait_event(done)
            y.record_stream(current)
        return y

    def run(self, xs, resets=None):
        """Feed ``xs[T, batch, chunk_len]``, drain, and return the T
        output chunks stacked, in order."""
        t_total = len(xs)
        outs = []
        for t in range(t_total + self.depth - 1):
            x = xs[t] if t < t_total else None
            rst = None if (resets is None or t >= t_total) else resets[t]
            y = self.push(x, rst)
            if y is not None:
                outs.append(y)
        if len(outs) != t_total:
            raise RuntimeError(f"{len(outs)} outputs for {t_total} inputs")
        if not outs:
            return torch.from_numpy(np.zeros(
                (0, self.out_sig.batch, self.out_sig.chunk_len),
                stream_complex()))
        return torch.stack(outs)

    def save_checkpoint(self, path: str) -> None:
        """Save the pipeline mid-stream: every stage's state **and** the
        chunks in flight between stages (up to ``depth - 1``; dropping them
        would lose samples on resume).  Restore with
        :meth:`load_checkpoint` on a pipeline of the same chain and
        partition."""
        from ..utils.checkpoint import save_state
        self._sync()
        stages = [tree_to_numpy(st.state) for st in self.stages]
        bufs = [() if b is None else (tree_to_numpy(b[0]),
                                      tree_to_numpy(b[1]))
                for b in self._buf]
        save_state(path, {"stages": stages, "bufs": bufs})

    def load_checkpoint(self, path: str) -> None:
        """Resume from :meth:`save_checkpoint` (in this process or
        another): stage states and chunks in flight land on their stages'
        devices, and the next ``push`` continues bit for bit."""
        from ..utils.checkpoint import load_state
        data = load_state(path)
        if len(data["stages"]) != len(self.stages):
            raise ValueError(
                f"checkpoint has {len(data['stages'])} stages, pipeline "
                f"has {len(self.stages)}: partition must match")
        self._sync()
        for st, s in zip(self.stages, data["stages"]):
            st.state = tree_to_torch(s, st.device)
        self._buf = [
            None if len(b) == 0 else
            (tree_to_torch(b[0], st.device),
             torch.from_numpy(np.asarray(b[1], bool)).to(st.device), None)
            for b, st in zip(data["bufs"], self.stages)]
