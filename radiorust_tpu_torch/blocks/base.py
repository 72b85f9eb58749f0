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
over the chunk axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

__all__ = ["StreamSig", "Block", "BoundBlock", "Chain", "scan",
           "expand_reset", "no_reset"]


@dataclass(frozen=True)
class StreamSig:
    """``batch`` independent streams, each delivering chunks of
    ``chunk_len`` complex64 samples at ``sample_rate`` Hz."""

    batch: int
    chunk_len: int
    sample_rate: float


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


def expand_reset(block: "BoundBlock", r, in_batch: int):
    """Widen a per-stream reset mask for a batch-growing block (the static
    ratio of the block's bound batch to ``in_batch``)."""
    factor = block.in_sig.batch // in_batch
    if factor > 1 and r.dim():
        return torch.repeat_interleave(r, factor)
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
        for spec in self.specs:
            b = spec.bind(sig)
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
