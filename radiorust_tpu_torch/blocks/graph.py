"""Dataflow graphs of blocks (PyTorch port of the JAX package's
``blocks/graph.py``).

:class:`Chain` covers the linear case; a :class:`Graph` covers the DAG:
declare named inputs, add blocks with explicit upstream nodes (a node may
feed many downstream nodes), name the outputs, and ``bind`` resolves the
whole DAG into one ``process`` over dicts of named chunks.  Shared
prefixes are computed once.

    g = Graph()
    iq = g.input("iq")
    front = g.add(Downsampler(384000.0, 200000.0), iq)
    g.output("audio", g.add(audio_tail, front))
    bg = g.bind({"iq": StreamSig(1, 16384, 1024000.0)})
    state, ys = bg.process(params, state, {"iq": x})   # ys["audio"]

Besides single-input blocks a graph takes fan-in nodes (a block with
``bind_multi``, such as :class:`~radiorust_tpu_torch.blocks.transform.
Combine`) and multi-output banks (:meth:`Graph.bank`, such as
:class:`~radiorust_tpu_torch.blocks.filters.FilterBank`), whose outputs
are reached through one select node each.  Params and state are tuples
with one entry per node, ``()`` for input and select nodes: the JAX
package's layout, so its trees carry across through
:mod:`radiorust_tpu_torch.convert`.  PyTorch runs eagerly, so
:func:`graph_scan` is a Python loop over the chunk axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from .base import Block, BoundBlock, StreamSig, expand_reset

__all__ = ["Graph", "BoundGraph", "NodeRef", "graph_scan",
           "linear_bound_graph"]


class _BoundSelect(BoundBlock):
    """Projection of one output of a bank node: stateless, it picks an
    element of the bank's output tuple."""

    def __init__(self, bank: BoundBlock, index: int):
        self.index = index
        self.in_sig = self.out_sig = bank.out_sigs[index]
        self._bank = bank

    @property
    def output_is_real(self):
        return self._bank.outputs_real[self.index]

    def process(self, params, state, xs, reset):
        return (), xs[self.index]


@dataclass(frozen=True)
class NodeRef:
    """Handle to a graph node (an input or an added block)."""
    idx: int


class Graph:
    """Declarative DAG builder.  Nodes are added in topological order by
    construction (an upstream ``NodeRef`` must already exist)."""

    def __init__(self):
        # Each entry: (kind, payload).  "input": name; "block": (spec,
        # upstream idx or tuple of them); "bank": (spec, upstream idx);
        # "select": (bank idx, output index).
        self._nodes: List[tuple] = []
        self._inputs: Dict[str, int] = {}
        self._outputs: Dict[str, int] = {}

    def input(self, name: str = "in") -> NodeRef:
        if name in self._inputs:
            raise ValueError(f"duplicate input name {name!r}")
        self._nodes.append(("input", name))
        ref = NodeRef(len(self._nodes) - 1)
        self._inputs[name] = ref.idx
        return ref

    def add(self, block: Block, upstream) -> NodeRef:
        """Add a block fed by ``upstream``: a :class:`NodeRef`, or a
        sequence of them for a fan-in block (one with ``bind_multi``)."""
        if isinstance(upstream, (tuple, list)):
            ups = tuple(upstream)
            if not ups:
                raise ValueError("fan-in upstream list is empty")
            for u in ups:
                self._check_ref(u)
            if len(ups) == 1:
                self._nodes.append(("block", (block, ups[0].idx)))
            else:
                if not hasattr(block, "bind_multi"):
                    raise TypeError(
                        f"{type(block).__name__} takes one input; fan-in "
                        "nodes need a block with bind_multi (e.g. Combine)")
                self._nodes.append(
                    ("block", (block, tuple(u.idx for u in ups))))
            return NodeRef(len(self._nodes) - 1)
        self._check_ref(upstream)
        self._nodes.append(("block", (block, upstream.idx)))
        return NodeRef(len(self._nodes) - 1)

    def _check_ref(self, upstream) -> None:
        if not isinstance(upstream, NodeRef) or not (
                0 <= upstream.idx < len(self._nodes)):
            raise ValueError("upstream must be a NodeRef from this graph")
        if self._nodes[upstream.idx][0] == "bank":
            raise ValueError(
                "a bank node itself is not a stream; use the per-output "
                "NodeRefs returned by Graph.bank")

    def bank(self, block: Block, upstream: NodeRef):
        """Add a multi-output block fed by ``upstream``; returns one
        :class:`NodeRef` per output.  The block declares ``num_outputs``;
        its bound form sets ``out_sigs`` and ``outputs_real`` and returns a
        tuple of chunks from ``process``."""
        self._check_ref(upstream)
        k = getattr(block, "num_outputs", None)
        if not isinstance(k, int) or k < 1:
            raise TypeError(
                f"{type(block).__name__} is not a multi-output block "
                "(missing num_outputs); use Graph.add")
        self._nodes.append(("bank", (block, upstream.idx)))
        bank_idx = len(self._nodes) - 1
        refs = []
        for j in range(k):
            self._nodes.append(("select", (bank_idx, j)))
            refs.append(NodeRef(len(self._nodes) - 1))
        return tuple(refs)

    def chain(self, blocks, upstream: NodeRef) -> NodeRef:
        """Add several blocks in sequence."""
        ref = upstream
        for b in blocks:
            ref = self.add(b, ref)
        return ref

    def output(self, name: str, node: NodeRef) -> None:
        if name in self._outputs:
            raise ValueError(f"duplicate output name {name!r}")
        self._outputs[name] = node.idx

    def bind(self, sigs) -> "BoundGraph":
        """``sigs``: dict input name -> StreamSig (or a bare StreamSig when
        the graph has exactly one input)."""
        if isinstance(sigs, StreamSig):
            if len(self._inputs) != 1:
                raise ValueError("graph has multiple inputs; pass a dict")
            sigs = {next(iter(self._inputs)): sigs}
        missing = set(self._inputs) - set(sigs)
        if missing:
            raise ValueError(f"missing input signatures: {sorted(missing)}")
        if not self._outputs:
            raise ValueError("graph has no outputs")
        return BoundGraph(self._nodes, self._inputs, self._outputs, sigs)


class BoundGraph:
    """A graph resolved against input signatures: ``process`` over dicts
    of named chunks, with :class:`BoundBlock`'s contract otherwise.  Each
    node follows ``Chain.bind``'s realness propagation and cumulative
    warm-up (``valid_from``, per output)."""

    def __init__(self, nodes, inputs: Dict[str, int],
                 outputs: Dict[str, int], sigs: Dict[str, StreamSig]):
        self._inputs = dict(inputs)
        self._outputs = dict(outputs)
        self.in_sigs = dict(sigs)
        # Per node: bound block (None for inputs), upstream, originating
        # input name (the reset mask it follows), signature, realness,
        # valid_from.
        self.bound: List[Optional[BoundBlock]] = []
        self._upstream: List[Any] = []
        self._origin: List[str] = []
        out_sig: List[StreamSig] = []
        is_real: List[bool] = []
        valid_from: List[int] = []
        for kind, payload in nodes:
            if kind == "input":
                self.bound.append(None)
                self._upstream.append(None)
                self._origin.append(payload)
                out_sig.append(sigs[payload])
                is_real.append(False)
                valid_from.append(0)
            elif kind == "select":
                bank_idx, j = payload
                b = _BoundSelect(self.bound[bank_idx], j)
                self.bound.append(b)
                self._upstream.append(bank_idx)
                self._origin.append(self._origin[bank_idx])
                out_sig.append(b.out_sig)
                is_real.append(b.output_is_real)
                valid_from.append(valid_from[bank_idx])
            elif isinstance(payload[1], tuple):
                spec, up = payload
                # Fan-in: bound against every upstream signature, under one
                # reset origin.
                origins = {self._origin[u] for u in up}
                if len(origins) != 1:
                    raise ValueError(
                        "fan-in upstreams must derive from one graph "
                        f"input (reset-mask origin); got {sorted(origins)}")
                b = spec.bind_multi(tuple(out_sig[u] for u in up))
                b.input_is_real_flags = [is_real[u] for u in up]
                self.bound.append(b)
                self._upstream.append(up)
                self._origin.append(origins.pop())
                out_sig.append(b.out_sig)
                is_real.append(b.output_is_real)
                valid_from.append(max(valid_from[u] for u in up)
                                  + b.valid_from)
            else:
                spec, up = payload
                b = spec.bind(out_sig[up])
                b.input_is_real = is_real[up]
                self.bound.append(b)
                self._upstream.append(up)
                self._origin.append(self._origin[up])
                out_sig.append(b.out_sig)
                # A bank node's value is a tuple, not a stream; only its
                # select nodes are referenceable (Graph enforces it).
                is_real.append(kind == "block" and b.output_is_real)
                valid_from.append(valid_from[up] + b.valid_from)
        for b in self.bound:
            if b is not None and getattr(b, "ragged_output", False):
                raise ValueError(
                    f"{type(b).__name__} produces padded (schedule-valid) "
                    "chunks at this chunk length and cannot be a graph "
                    "node; re-chunk to a multiple of the resampling period")
        self.out_sigs = {n: out_sig[i] for n, i in self._outputs.items()}
        #: Per-output first reference-comparable chunk index.
        self.valid_from = {n: valid_from[i] for n, i in self._outputs.items()}
        self.params = tuple(() if b is None else b.params
                            for b in self.bound)

    def init_state(self):
        return tuple(() if b is None else b.init_state()
                     for b in self.bound)

    def process(self, params, state, xs: Dict[str, Any], resets=None):
        """(params, state, {input: chunk}, {input: reset[batch]}?) ->
        (state', {output: chunk})."""
        if resets is None:
            resets = {n: torch.zeros((self.in_sigs[n].batch,),
                                     dtype=torch.bool, device=xs[n].device)
                      for n in self._inputs}
        vals: List[Any] = [None] * len(self.bound)
        new_state = []
        for i, b in enumerate(self.bound):
            origin = self._origin[i]
            if b is None:
                vals[i] = xs[origin]
                new_state.append(())
                continue
            r = expand_reset(b, resets[origin], self.in_sigs[origin].batch)
            up = self._upstream[i]
            xin = (tuple(vals[u] for u in up) if isinstance(up, tuple)
                   else vals[up])
            s, vals[i] = b.process(params[i], state[i], xin, r)
            new_state.append(s)
        return tuple(new_state), {n: vals[i]
                                  for n, i in self._outputs.items()}

    def shard_batch_ok(self, ndev: int) -> bool:
        """Whether data-parallel stream sharding holds: every input batch
        splits over the mesh axis and every node's per-shard constraints
        hold on its local batch (``BoundBlock.shard_batch_ok``)."""
        return (all(sig.batch % ndev == 0 for sig in self.in_sigs.values())
                and all(b.shard_batch_ok(ndev) for b in self.bound
                        if b is not None))


def linear_bound_graph(bound_chain) -> BoundGraph:
    """A bound chain in the ``BoundGraph`` shape: input node "in", the
    chain's blocks, output "out".  The input node contributes ``()``, so
    the graph's params and state are ``((),) + the chain's``."""
    blocks = list(bound_chain.blocks)
    bg = BoundGraph.__new__(BoundGraph)
    bg._inputs = {"in": 0}
    bg._outputs = {"out": len(blocks)}
    bg.in_sigs = {"in": bound_chain.in_sig}
    bg.bound = [None, *blocks]
    bg._upstream = [None, *range(len(blocks))]
    bg._origin = ["in"] * (len(blocks) + 1)
    bg.out_sigs = {"out": bound_chain.out_sig}
    bg.valid_from = {"out": bound_chain.valid_from}
    bg.params = ((), *bound_chain.params)
    return bg


def graph_scan(bg: BoundGraph, params, state, xs: Dict[str, Any],
               resets=None):
    """Run a bound graph over stacked chunks: each ``xs[name]`` is
    [T, batch, chunk_len]; ``resets`` optional {name: [T, batch] bool}.
    Returns (final_state, {output: [T, batch, out_chunk_len]})."""
    t = next(iter(xs.values())).shape[0]
    ys: Dict[str, list] = {}
    for i in range(t):
        r = None if resets is None else {n: v[i] for n, v in resets.items()}
        state, y = bg.process(params, state, {n: v[i] for n, v in xs.items()},
                              r)
        for n, v in y.items():
            ys.setdefault(n, []).append(v)
    return state, {n: torch.stack(v) for n, v in ys.items()}
