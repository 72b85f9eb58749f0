"""Time-sharded chain execution with halo exchange (PyTorch port of the
JAX package's ``parallel/time_shard.py``).

The cross-chunk state of every block on the wideband receive path is
either a pure function of the block's previous input chunk (a filter's
tail, a resampler's history, a demodulator's previous sample) or advances
in closed form per chunk (the mixer's integer phase index, FmMod's phase
by the chunk's increment sum).  So D consecutive chunks can run as D
shards at once: shard d rebuilds its predecessor's state from shard d-1's
input tail (a halo, moved by :func:`~radiorust_tpu_torch.parallel.mesh.
ring_left`), and shard 0 starts from the carry of the previous step.
Squelch's envelope is affine in its carry and AgcControl's gain update is
clamped-affine; both shard through an exclusive prefix of per-shard maps
(:func:`~radiorust_tpu_torch.parallel.mesh.all_gather` of a few numbers a
stream).  ``SlewRateLimiter``'s complex clamp has no such composition and
is rejected (it pipelines: ``parallel/pipeline.py``).

A handler works over all D shards of one block: it builds each shard's
state from the halos, then calls the block's own ``process`` once per
shard, so the shard runs the block's kernel at the block's shapes.  Where
a fused kernel carries an intermediate-domain state (the mixer
decimator's mixed history, the demod filter's demodulated tail), the
handler rebuilds the neighbour's intermediate with the kernel's own
arithmetic (``ops/frontend.py::mix_tail``, ``ops/filter.py::
fm_demod_planes``).  The merged filter-demod-filter kernel's intermediate
cannot be rebuilt from an input halo, so under time sharding its block
runs as #3 then #5 (one more launch a shard).

On a mesh of one repeated card the halo moves copy nothing and a step can
be captured as one CUDA graph (:meth:`TimeShardedChain.jit_step`); across
distinct devices it runs eagerly, the shards' work queued on each
device's stream.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..blocks import analysis as _analysis
from ..blocks import channelize as _channelize
from ..blocks import chunks as _chunks
from ..blocks import filters as _filters
from ..blocks import frontend as _frontend
from ..blocks import graph as _graph
from ..blocks import modulation as _modulation
from ..blocks import resampling as _resampling
from ..blocks import transform as _transform
from ..blocks.base import BoundBlock, StreamSig, _Compiled
from ..convert import _map, tree_to_torch
from ..ops.assoc_scan import associative_scan
from .mesh import (Mesh, Replicas, Shards, all_gather, concat,
                   local_indices, move, ring_left, share)

__all__ = ["TimeShardedChain", "TimeShardedGraph"]


def _no_reset(x):
    return torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)


def _halo_tail(xs, carry, hist: int, devices) -> List[torch.Tensor]:
    """For each shard d, the ``hist`` samples just before its chunk: the
    tail of ``carry || x_0 || ... || x_{d-1}``, contiguous (the kernels
    read their histories through plain pointers).  Neighbour chunks
    arrive by ``ring_left`` (several hops when ``hist`` spans several
    chunks); positions before the group's start come from ``carry``, the
    previous step's tail."""
    mine = local_indices(devices)
    n = xs[mine[0]].shape[-1]
    if hist == 0:
        return _lmap(lambda x: x[:, :0], xs)
    k = -(-hist // n)                      # chunks of halo needed
    if k == 1:
        # Only the tail crosses, not the whole chunk.
        prev = ring_left(_lmap(lambda x: x[:, -hist:], xs), devices)
    else:
        parts, cur = [], xs
        for _ in range(k):
            cur = ring_left(cur, devices)
            parts.append(cur)
        # parts[j-1][d] = x_{d-j}: [x_{d-k} .. x_{d-1}], then its tail.
        prev = [torch.cat([p[d] for p in parts[::-1]], dim=-1)[:, -hist:]
                if d in mine else None for d in range(len(xs))]
    out: list = [None] * len(xs)
    for d in mine:
        own = d * n                        # samples the neighbours give
        if own >= hist:
            out[d] = prev[d].contiguous()
        else:
            c = move(carry, devices[d])
            out[d] = torch.cat([c[:, own:hist], prev[d][:, hist - own:]],
                               dim=-1)
    return out


def _lmap(fn, vals):
    """``fn`` over this process's shards, ``None`` kept elsewhere."""
    return [None if v is None else fn(v) for v in vals]


def _per_shard(devices, fn):
    """``[fn(d, device)]`` over this process's shards, ``None`` at the
    entries other processes own."""
    out: list = [None] * len(devices)
    for d in local_indices(devices):
        out[d] = fn(d, devices[d])
    return out


# -- per-block sharded processing --------------------------------------------
#
# A handler takes (block, per-shard params, carry, per-shard inputs, shard
# devices) and returns (per-shard new states, per-shard outputs).  Where a
# block's state is a function of its previous input it only rebuilds that
# state from the halo and delegates to the block's own ``process``.


def _each(block, params, states, xs):
    """The block's ``process`` once per shard on its rebuilt state."""
    outs = [None if x is None else
            block.process(p, s, x, _no_reset(x[0] if isinstance(x, tuple)
                                              else x))
            for p, s, x in zip(params, states, xs)]
    return ([None if o is None else o[0] for o in outs],
            [None if o is None else o[1] for o in outs])


def _sharded_stateless(block, params, state, xs, devices):
    _, ys = _each(block, params, [()] * len(xs), xs)
    return [()] * len(xs), ys


def _sharded_filter(block, params, state, xs, devices):
    """Overlap-save Filter and FilterBank: the state is the previous m
    input samples (the whole previous chunk at m = chunk), rebuilt from
    the neighbour's tail."""
    prev = _halo_tail(xs, state["prev"], state["prev"].shape[-1], devices)
    return _each(block, params, _lmap(lambda p: {"prev": p}, prev), xs)


def _sharded_select(block, params, state, xs, devices):
    return [()] * len(xs), _lmap(lambda x: x[block.index], xs)


def _sharded_resampler(block, params, state, xs, devices):
    if getattr(block, "phase_mode", False):
        # The grid phase advances by C mod p a chunk, whatever the data:
        # shard d's phase in closed form, int32 as the JAX package's.
        p = block.plan.p
        c = xs[local_indices(devices)[0]].shape[-1]
        hist = _halo_tail(xs, state["hist"], block.plan.phase_hist, devices)
        states = _per_shard(devices, lambda d, dev: {
            "hist": hist[d],
            "phase": (move(state["phase"], dev) + d * (c % p)) % p})
        return _each(block, params, states, xs)
    hist = _halo_tail(xs, state["hist"], block.plan.hist, devices)
    return _each(block, params, _lmap(lambda h: {"hist": h}, hist), xs)


def _carried(leaf, dev):
    """A carried state leaf on ``dev``, contiguous: the kernels read it
    through a plain pointer (a plain version's carry may be a view)."""
    return move(leaf, dev).contiguous()


def _first_or(state_leaf, d: int, dev, other):
    """Shard 0 takes the carried value, every later shard ``other``."""
    return _carried(state_leaf, dev) if d == 0 else other


def _sharded_fm_demod(block, params, state, xs, devices):
    prev = _halo_tail(xs, state["prev"][:, None], 1, devices)
    states = _per_shard(devices, lambda d, dev: {
        "prev": prev[d][:, 0],
        "have_prev": _first_or(state["have_prev"], d, dev,
                               torch.ones_like(state["have_prev"],
                                               device=dev)),
        "last_out": move(state["last_out"], dev)})
    return _each(block, params, states, xs)


def _sharded_freq_shifter(block, params, state, xs, devices):
    # Closed-form phase index: shard d is d chunks ahead of the carry.
    states = _per_shard(devices, lambda d, dev: {
        "k0": (move(state["k0"], dev) + d * params[d]["adv"]) % block.denom,
        "start_phase": move(state["start_phase"], dev)})
    return _each(block, params, states, xs)


def _exclusive_sum(gathered, d: int):
    """Sum of rows k < d of a gathered [D, batch] stack (masked, as the
    JAX package sums it)."""
    mask = (torch.arange(gathered.shape[0], device=gathered.device)
            < d)[:, None]
    return torch.sum(torch.where(mask, gathered,
                                 torch.zeros_like(gathered)), dim=0)


def _sharded_fm_mod(block, params, state, xs, devices):
    """Shard d's phase offset is the sum of every earlier shard's
    increment sum: an exclusive prefix over the shards."""
    sums = _per_shard(devices, lambda d, dev: torch.sum(
        xs[d].real * params[d], dim=-1))
    gathered = all_gather(sums, devices)
    states = _per_shard(devices, lambda d, dev: {
        "phase": move(state["phase"], dev) + _exclusive_sum(gathered[d], d)})
    return _each(block, params, states, xs)


def _sharded_squelch(block, params, state, xs, devices):
    """The one-pole envelope is affine in its carry (e -> alpha^n e +
    B_d): each shard reduces its chunk to B_d, one ``all_gather`` shares
    them, and the exclusive prefix of the maps seeds each shard's
    envelope.  Exact in real arithmetic; the float32 sums run in another
    order than the sequential scan's, so an envelope within an ulp of the
    threshold can gate the other way."""
    n = xs[local_indices(devices)[0]].shape[-1]

    def reduce(d, dev):
        x, alpha = xs[d], params[d]["alpha"]
        pw = (x * torch.conj(x)).real
        powers = alpha ** torch.arange(n - 1, -1, -1, dtype=pw.dtype,
                                       device=x.device)
        return (1.0 - alpha) * torch.sum(pw * powers[None, :], dim=-1)

    gathered = all_gather(_per_shard(devices, reduce), devices)

    def seed(d, dev):
        g = gathered[d]
        a_n = params[d]["alpha"] ** float(n)
        k = torch.arange(g.shape[0], device=dev)
        w = torch.where(k < d, a_n ** torch.clamp(d - 1 - k, min=0),
                        torch.zeros_like(a_n))
        env = move(state["env"], dev)
        return {"env": (a_n ** d) * env + torch.sum(w[:, None] * g, dim=0)}

    return _each(block, params, _per_shard(devices, seed), xs)


def _sharded_agc(block, params, state, xs, devices):
    """Each per-sample gain update is a clamped-affine map, a family closed
    under composition: each shard reduces its chunk to one map (a, b, lo,
    hi), an ``all_gather`` shares the D maps, a scan over the shards forms
    the exclusive prefix, and applied to the carried gain it seeds each
    shard's gain; then the block's ``process`` (on CUDA the AGC kernel)
    runs unchanged.  Exact in real arithmetic."""
    from ..ops.scan import _agc_compose, _agc_elems

    def reduce(d, dev):
        p = params[d]
        elems = _agc_elems(p["rate"], p["reference"], p["max_gain"], xs[d])
        return tuple(t[:, -1] for t in associative_scan(_agc_compose, elems))

    local = _per_shard(devices, reduce)
    gathered = [all_gather(_lmap(lambda m: m[j], local), devices)
                for j in range(4)]                    # 4 x D x [D, b]

    def seed(d, dev):
        g0 = _carried(state["gain"], dev)
        if d == 0:                    # the identity map: no predecessor
            return {"gain": g0}
        # [b, D] rows: the scan runs along the shards.
        pre = associative_scan(_agc_compose, tuple(
            gathered[j][d].transpose(0, 1) for j in range(4)))
        a, b, lo, hi = (t[:, d - 1] for t in pre)
        return {"gain": torch.clamp(a * g0 + b, lo, hi)}

    return _each(block, params, _per_shard(devices, seed), xs)


def _sharded_overlapper(block, params, state, xs, devices):
    """The analysis window's history is a (k-1)-chunk halo, fetched with
    the multi-hop ``ring_left`` chain."""
    k = block.chunk_count
    b, n = xs[local_indices(devices)[0]].shape
    if k == 1:
        return _each(block, params, [state] * len(xs), xs)
    hist = (k - 1) * n
    h = _halo_tail(xs, state["hist"].reshape(b, hist), hist, devices)
    return _each(block, params, _lmap(
        lambda t: {"hist": t.reshape(b, k - 1, n)}, h), xs)


def _sharded_channelizer(block, params, state, xs, devices):
    hist = _halo_tail(xs, state["hist"], block.hist_len, devices)
    return _each(block, params, _lmap(lambda h: {"hist": h}, hist), xs)


def _sharded_channelizer_demod(block, params, state, xs, devices):
    """Fused PFB + demod (#7): the kernel recomputes demod continuity from
    the raw history, so the only halo is the raw-input tail;
    ``have_prev``/``last_out`` matter on shard 0 only."""
    hist = _halo_tail(xs, state["hist"], block.hist_len, devices)
    states = _per_shard(devices, lambda d, dev: {
        "hist": hist[d],
        "have_prev": _first_or(state["have_prev"], d, dev,
                               torch.ones_like(state["have_prev"],
                                               device=dev)),
        "last_out": _carried(state["last_out"], dev)})
    return _each(block, params, states, xs)


def _check_mixer_decimator(block, n: int) -> None:
    if block.plan.hist > n:
        raise NotImplementedError("decimator history exceeds one chunk")


def _sharded_mixer_decimator(block, params, state, xs, devices):
    """Fused mixer + decimator (#2).  The mixer's phase index advances in
    closed form (shard d starts at k0 + d*adv); the decimator's history
    is in the mixed domain, so each shard mixes its neighbour's raw tail
    with the neighbour's phasing in the kernel's order of operations
    (:func:`~radiorust_tpu_torch.ops.frontend.mix_tail`): the history the
    neighbour's kernel writes, bit for bit."""
    from ..blocks.transform import start_phasor
    from ..ops.frontend import mix_tail
    _check_mixer_decimator(block, xs[local_indices(devices)[0]].shape[-1])
    hist, denom = block.plan.hist, block.denom
    tails = (ring_left(_lmap(lambda x: x[:, -hist:], xs), devices)
             if hist else None)
    states: list = [None] * len(xs)
    for d in local_indices(devices):
        p, dev = params[d], devices[d]
        k0 = move(state["k0"], dev)
        sp = move(state["start_phase"], dev)
        st = {"k0": (k0 + d * p["adv"]) % denom, "start_phase": sp,
              "histr": move(state["histr"], dev),
              "histi": move(state["histi"], dev)}
        if hist and d > 0:
            prev = {"k0": (k0 + (d - 1) * p["adv"]) % denom,
                    "start_phase": sp}
            st["histr"], st["histi"] = mix_tail(
                tails[d], p["table_a"], p["table_b"],
                *start_phasor(prev, denom))
        states[d] = st
    return _each(block, params, states, xs)


def _demod_halos(fr, fi, state, devices, params, m: int):
    """Per shard (plr, pli, have_prev, prevd) of a demod filter (#5) fed
    ``fr``/``fi``: shard 0's from the carry; shard d's last-sample halo
    from shard d-1's input, and its demodulated m-sample history from a
    replica of shard d-1's demod (:func:`~radiorust_tpu_torch.ops.filter.
    fm_demod_planes`, the plain arithmetic of #5's demod prologue)."""
    from ..ops.filter import fm_demod_planes
    big = len(fr)
    lr = ring_left(_lmap(lambda t: t[:, -1].contiguous(), fr), devices)
    li = ring_left(_lmap(lambda t: t[:, -1].contiguous(), fi), devices)
    plr = _per_shard(devices, lambda d, dev: _first_or(state["plr"], d, dev,
                                                       lr[d]))
    pli = _per_shard(devices, lambda d, dev: _first_or(state["pli"], d, dev,
                                                       li[d]))
    have = _per_shard(devices, lambda d, dev: _first_or(
        state["have_prev"], d, dev,
        torch.ones_like(state["have_prev"], device=dev)))
    # Shard d's replica is shard d+1's history (ring_left without its
    # wrap: shard 0 takes the carry, so the last shard needs none).
    n = fr[local_indices(devices)[0]].shape[-1]
    tails = _per_shard(devices, lambda d, dev: None if d == big - 1 else
                       fm_demod_planes(fr[d], fi[d], plr[d], pli[d],
                                       _carried(state["last_out"], dev),
                                       have[d], params[d]["factor"])
                       [:, n - m:].contiguous())
    prevd = ring_left(tails, devices, wrap=False, like=state["prevd"])
    if 0 in local_indices(devices):
        prevd[0] = move(state["prevd"], devices[0])
    return plr, pli, have, prevd


def _sharded_fm_demod_filter(block, params, state, xs, devices):
    """Fused FM demod + filter (#5).  Two halos: the neighbour's last raw
    sample, and its demodulated tail, which each shard rebuilds with the
    demod's own arithmetic before it crosses.  On CPU tensors that is bit
    for bit the neighbour's; on CUDA the kernel contracts its products
    into fused multiply-adds, so the rebuilt tail, the filter's history,
    can differ from it by float32 rounding."""
    m = state["prevd"].shape[-1]
    fr = _lmap(lambda x: x.real.contiguous(), xs)
    fi = _lmap(lambda x: x.imag.contiguous(), xs)
    plr, pli, have, prevd = _demod_halos(fr, fi, state, devices, params, m)
    states = _per_shard(devices, lambda d, dev: {
        "plr": plr[d], "pli": pli[d], "prevd": prevd[d],
        "last_out": _carried(state["last_out"], dev), "have_prev": have[d]})
    return _each(block, params, states, xs)


def _sharded_filter_demod_filter(block, params, state, xs, devices):
    """Merged channel filter + demod + deemphasis (#6).  Its inputs
    include the last *filtered* sample and the neighbour's demodulated
    chunk, both intermediates no shard can see, so the sharded form runs
    the two kernels it merges: the channel filter (#3) on each shard's
    input halo, then the demod filter (#5) with halos as
    :func:`_sharded_fm_demod_filter` builds them.  The same math, one more
    launch a shard, in sharded mode only."""
    from ..ops.filter import fused_demod_filter, fused_overlap_save
    mine = local_indices(devices)
    n = xs[mine[0]].shape[-1]
    m = block.ir_len
    prev = _halo_tail(xs, state["prev"], m, devices)
    fr, fi = [None] * len(xs), [None] * len(xs)
    for d in mine:
        x, h = xs[d], prev[d]
        g1 = block._grids[0].planes(params[d]["response1"])
        fr[d], fi[d] = fused_overlap_save(
            h.real.contiguous(), h.imag.contiguous(), x.real.contiguous(),
            x.imag.contiguous(), *g1)
    plr, pli, have, prevd = _demod_halos(fr, fi, state, devices, params, m)
    pieces, ys = [None] * len(xs), [None] * len(xs)
    for d in mine:
        x, p, dev = xs[d], params[d], devices[d]
        last_out = _carried(state["last_out"], dev)
        y, dout = fused_demod_filter(
            fr[d], fi[d], plr[d], pli[d], prevd[d], last_out, have[d],
            *block._grids[1].planes(p["response2"]), p["factor"])
        # The carry is read by the kernels: contiguous, as the block's.
        pieces[d] = {"prev": x[:, n - m:],
                     "plr": fr[d][:, -1].contiguous(),
                     "pli": fi[d][:, -1].contiguous(),
                     "prevd": dout[:, n - m:].contiguous(),
                     "last_out": dout[:, -1].contiguous(),
                     "have_prev": torch.ones_like(have[d])}
        ys[d] = torch.complex(y, torch.zeros_like(y))
    return pieces, ys


_HANDLERS = {
    _channelize._BoundChannelizer: _sharded_channelizer,
    _channelize._BoundChannelizerDemod: _sharded_channelizer_demod,
    _frontend._BoundFilterDemodFilter: _sharded_filter_demod_filter,
    _chunks._BoundOverlapper: _sharded_overlapper,
    _frontend._BoundMixerDecimator: _sharded_mixer_decimator,
    _frontend._BoundFmDemodFilter: _sharded_fm_demod_filter,
    _filters._BoundFilter: _sharded_filter,
    _filters._BoundFilterBank: _sharded_filter,
    _graph._BoundSelect: _sharded_select,
    _resampling._BoundResampler: _sharded_resampler,
    _modulation._BoundFmDemod: _sharded_fm_demod,
    _modulation._BoundFmMod: _sharded_fm_mod,
    _transform._BoundFreqShifter: _sharded_freq_shifter,
    _transform._BoundGain: _sharded_stateless,
    _transform._BoundSquelch: _sharded_squelch,
    _transform._BoundAgc: _sharded_agc,
    _transform._BoundMap: _sharded_stateless,
    _transform._BoundCombine: _sharded_stateless,
    _analysis._BoundFourier: _sharded_stateless,
}

# Rejections a handler would raise at its first step, checked at
# construction instead: {bound type: check(block, chunk_len)}.
_CHECKS = {_frontend._BoundMixerDecimator: _check_mixer_decimator}


def _handler_for(block: BoundBlock):
    h = _HANDLERS.get(type(block))
    if h is None:
        raise NotImplementedError(
            f"{type(block).__name__} does not support time sharding "
            "(sequential per-sample state); use channel sharding or the "
            "pipeline")
    return h


def _retune_shift(nodes, params, state, shift: float):
    """Phase-continuous ``set_shift`` of every FreqShifter /
    MixerDecimator node (numpy trees, between steps).  The carried ``k0``
    is the group-start index of the next step, the sequential carry's
    meaning, so the fold applies unchanged and the per-shard offsets
    restart from the folded phase with the new advance."""
    from ..blocks.frontend import _BoundMixerDecimator
    from ..blocks.transform import _BoundFreqShifter
    from ..convert import tree_to_numpy
    shifters = (_BoundFreqShifter, _BoundMixerDecimator)
    params, state = list(params), list(state)
    hit = False
    for i, blk in enumerate(nodes):
        if blk is not None and isinstance(blk, shifters):
            params[i], state[i] = blk.retune(params[i],
                                             tree_to_numpy(state[i]), shift)
            hit = True
    if not hit:
        raise ValueError("no FreqShifter/MixerDecimator to retune")
    return tuple(params), tuple(state)


def _map_node_params(nodes, params, fn):
    """Params-only typed setters: ``fn(block, params) -> new params or
    None`` over every node."""
    out = []
    for blk, pp in zip(nodes, params):
        new = None if blk is None else fn(blk, pp)
        out.append(pp if new is None else new)
    return tuple(out)


def _reset_all(reset, state, init):
    """All-or-nothing reset on the device: any true flag puts every
    stream's carry back to ``init``."""
    any_r = reset.any()
    return _zip_map(state, init, lambda s, i: torch.where(any_r, i, s))


def _zip_map(a, b, fn):
    if isinstance(a, dict):
        return {k: _zip_map(a[k], b[k], fn) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(x, y, fn) for x, y in zip(a, b))
    return fn(a, b)


def _rows_of(t, cut: slice, batch: int):
    """Rows ``cut`` of a batch-major state leaf: a tensor's, or the piece
    of a :class:`~radiorust_tpu_torch.parallel.mesh.Shards` holding
    them."""
    if isinstance(t, Shards):
        return t.get((cut,))
    from .mesh import _batch_leaf
    return _batch_leaf(t, batch)[cut]


def _row_shards(carries: dict, row_b: int, batch: int):
    """The rows' carries ({row: tree}) as one tree of :class:`~
    radiorust_tpu_torch.parallel.mesh.Shards` over the stream batch."""
    from ..blocks.base import _leaves
    rows = sorted(carries)
    cols = zip(*(_leaves(carries[r]) for r in rows))
    it = iter([Shards((batch,) + tuple(col[0].shape[1:]),
                      [((slice(r * row_b, (r + 1) * row_b),), t)
                       for r, t in zip(rows, col)]) for col in cols])
    return _map(carries[rows[0]], lambda _: next(it))


def _refuse_spanning(mesh, what: str) -> None:
    if mesh.spans_processes:
        raise NotImplementedError(
            f"{what} on a mesh that spans processes: a CUDA graph cannot "
            f"capture a gloo exchange; step eagerly with process()")


class TimeShardedGraph:
    """Time sharding of a bound DAG
    (:class:`~radiorust_tpu_torch.blocks.graph.BoundGraph`): the handlers
    in topological order, fan-out values reused; each step takes D
    consecutive chunks of every input.

    ``process(params, state, xs_big)`` takes ``{input: [batch,
    D*chunk_len]}`` and returns ``(state', {output: [batch,
    D*out_chunk_len]})``, equal to ``graph_scan`` over the D chunks up to
    float32 ordering in the prefix handlers (which for Squelch's gate and
    AGC's clamps can flip a decision within an ulp of it).  ``ch_axis``
    also splits the stream batch over a second mesh axis (one time-shard
    walk per row of the mesh); ``overlap=S`` splits each row's batch into
    S sub-batches with a walk each (rows never couple, so it is exact
    where pair-packed filters keep their pairs).  Params are replicated
    to each distinct device once; the state and results live on the
    mesh's first device.
    """

    def __init__(self, bound_graph, mesh: Mesh, t_axis: str = "t",
                 ch_axis: Optional[str] = None, overlap: int = 1):
        self.bound = bound_graph
        self.mesh = mesh
        self.t_axis = t_axis
        self.ch_axis = ch_axis
        self.t_devices = mesh.shape[t_axis]
        self.overlap = overlap
        self.in_sigs = bound_graph.in_sigs
        self.out_sigs = bound_graph.out_sigs
        self._handlers = [None if b is None else _handler_for(b)
                          for b in bound_graph.bound]
        for b in bound_graph.bound:
            check = _CHECKS.get(type(b))
            if check is not None:
                check(b, b.in_sig.chunk_len)
        rows = mesh.shape[ch_axis] if ch_axis else 1
        self._rows = [mesh.line(t_axis, **({ch_axis: r} if ch_axis else {}))
                      for r in range(rows)]
        self._replicas = Replicas()
        self._init = {}

    def init_state(self):
        return self.bound.init_state()

    @property
    def params(self):
        return self.bound.params

    @params.setter
    def params(self, value):
        self.bound.params = value

    @property
    def blocks(self):
        """The node list (``None`` for graph inputs), aligned with the
        params and state tuples: the typed setters' walk."""
        return self.bound.bound

    @property
    def valid_from(self):
        """Per-output warm-up in output chunks (the graph's: history
        priming happens once, at the head of the stream)."""
        return self.bound.valid_from

    def group_sigs(self):
        """The group (D-chunk) input and output signature dicts."""
        d = self.t_devices

        def grp(sigs):
            return {k: StreamSig(s.batch, d * s.chunk_len, s.sample_rate)
                    for k, s in sigs.items()}

        return grp(self.bound.in_sigs), grp(self.bound.out_sigs)

    def set_shift(self, state, shift: float):
        """Phase-continuous retune of every FreqShifter / MixerDecimator
        node: updates ``self.params`` and returns the rewritten carry (a
        numpy tree).  Call between steps."""
        new_params, new_state = _retune_shift(
            self.bound.bound, self.bound.params, state, shift)
        self.bound.params = new_params
        return new_state

    def update_params(self, fn) -> None:
        """Params-only live retune over the nodes."""
        self.bound.params = _map_node_params(self.bound.bound,
                                             self.bound.params, fn)

    def check(self, batch: int) -> None:
        """Raise now what a step at ``batch`` streams would raise: the
        batch over the mesh rows and the overlap sub-batches."""
        rows = len(self._rows)
        if batch % rows:
            raise ValueError(f"batch {batch} not divisible by the "
                             f"{rows} rows of axis {self.ch_axis!r}")
        if (batch // rows) % self.overlap:
            raise ValueError(f"local batch {batch // rows} not divisible "
                             f"by overlap={self.overlap}")

    def _walk(self, params, state, xs, devices):
        """One sub-group's node walk over its D shards: (carry, {output:
        per-shard values})."""
        bg = self.bound
        ps = self._replicas(params, devices)
        vals: list = [None] * len(bg.bound)
        carry = []
        for i, b in enumerate(bg.bound):
            if b is None:
                vals[i] = xs[bg._origin[i]]
                carry.append(())
                continue
            up = bg._upstream[i]
            xin = ([None if vals[up[0]][d] is None else
                    tuple(vals[u][d] for u in up) for d in range(len(devices))]
                   if isinstance(up, tuple) else vals[up])
            pieces, vals[i] = self._handlers[i](
                b, [None if p is None else p[i] for p in ps], state[i], xin,
                devices)
            # The next step's carry is the last shard's piece, at every
            # rank of the line (the closed-form handlers read it on every
            # shard).
            like = next(p for p in pieces if p is not None)
            carry.append(share(pieces[-1], len(devices) - 1, devices, like))
        return tuple(carry), {n: vals[j] for n, j in bg._outputs.items()}

    def process(self, params, state, xs_big):
        """One group step: ``(state', {output: [batch, D*out_n]})``.  On a
        mesh that spans processes each process steps only its own shards:
        each output is a :class:`~radiorust_tpu_torch.parallel.mesh.
        Shards` of this process's pieces (one per entry it owns), and the
        carry is a tree of tensors where this process holds every row of
        the mesh, else of :class:`~radiorust_tpu_torch.parallel.mesh.
        Shards` of its rows; ``state`` may be either, or a whole tree."""
        d_count = self.t_devices
        batch = next(iter(xs_big.values())).shape[0]
        self.check(batch)
        rows, sub = len(self._rows), self.overlap
        row_b = batch // rows
        sb = row_b // sub
        carries: dict = {}
        pieces: dict = {k: [] for k in self.out_sigs}
        for r, devices in enumerate(self._rows):
            mine = local_indices(devices)
            if not mine:
                continue
            home = devices[mine[0]]
            subs = []
            for j in range(sub):
                cut = slice(r * row_b + j * sb, r * row_b + (j + 1) * sb)
                # One row of one walk takes the state whole (leaves need
                # not be batch-major).
                st = _map(state, lambda t: move(
                    t if rows * sub == 1 else _rows_of(t, cut, batch), home))
                shards = {}
                for name, x in xs_big.items():
                    n = x.shape[-1] // d_count
                    shards[name] = [
                        move(x[cut, d * n:(d + 1) * n], devices[d])
                        .contiguous() if d in mine else None
                        for d in range(d_count)]
                subs.append(self._walk(params, st, shards, devices))
            carries[r] = (subs[0][0] if sub == 1
                          else concat([c for c, _ in subs], home))
            for name in pieces:
                for d in mine:
                    y = (subs[0][1][name][d] if sub == 1 else
                         torch.cat([ys[name][d] for _, ys in subs], dim=0))
                    # A row's outputs are its streams' (a channelizer
                    # folds each stream into M rows).
                    k, m = y.shape[0], y.shape[-1]
                    pieces[name].append(((slice(r * k, (r + 1) * k),
                                          slice(d * m, (d + 1) * m)), y))
        outs = {name: Shards((rows * p[0][1].shape[0],
                              d_count * p[0][1].shape[-1]), p)
                for name, p in pieces.items()}
        if len(carries) < rows:
            return _row_shards(carries, row_b, batch), outs
        home = self.mesh.home
        state = (_map(carries[0], lambda t: move(t, home)) if rows == 1
                 else concat([carries[r] for r in range(rows)], home))
        if self.mesh.spans_processes:
            return state, outs
        return state, {name: y.join(home) for name, y in outs.items()}

    def _group_step(self, params, state, xs, reset):
        """One group step with the actor's all-or-nothing reset."""
        dev = next(iter(xs.values())).device
        key = str(dev)
        if key not in self._init:
            self._init[key] = tree_to_torch(self.init_state(), dev)
        state = _reset_all(next(iter(reset.values())), state,
                           self._init[key])
        return self.process(params, state, xs)

    def jit_step(self) -> _Compiled:
        """The compiled group step for live serving (``RuntimeGraph(...,
        shard="time")``): ``step(params, state, xs, resets)`` as
        :func:`~radiorust_tpu_torch.blocks.base.jit_step` over the group
        signatures, one CUDA graph holding every shard's launches where
        the mesh is one card, eager otherwise.  A reset is all or nothing:
        any true flag restarts every stream's carry before the group.
        On a mesh that spans processes it raises: a CUDA graph cannot
        capture a gloo exchange, and such a step runs eagerly through
        :meth:`process`."""
        _refuse_spanning(self.mesh, "TimeShardedGraph.jit_step")
        return _Compiled(self.bound, whole_run=False,
                         process=self._group_step,
                         capturable=self.mesh.single_device)


class TimeShardedChain:
    """A bound chain over ``D * chunk_len`` samples a step, time-sharded
    over the mesh's ``t_axis`` (and stream-sharded over ``ch_axis`` when
    given): a thin wrapper of :class:`TimeShardedGraph` over the chain as
    a linear graph.

    ``process(params, state, x_big)`` takes [batch, D*chunk_len] and
    returns the next carry and [batch, D*out_chunk_len], equal to
    scanning the chain over the D chunks (see :class:`TimeShardedGraph`
    for the prefix handlers' float32 caveat)."""

    def __init__(self, bound_chain, mesh: Mesh, t_axis: str = "t",
                 ch_axis: Optional[str] = None, overlap: int = 1):
        from ..blocks.graph import linear_bound_graph
        self.bound = bound_chain
        self.mesh = mesh
        self.t_axis = t_axis
        self.ch_axis = ch_axis
        self.t_devices = mesh.shape[t_axis]
        self.in_sig = bound_chain.in_sig
        self.out_sig = bound_chain.out_sig
        self._graph = TimeShardedGraph(linear_bound_graph(bound_chain),
                                       mesh, t_axis=t_axis, ch_axis=ch_axis,
                                       overlap=overlap)

    def init_state(self):
        return self.bound.init_state()

    @property
    def params(self):
        return self.bound.params

    @params.setter
    def params(self, value):
        self.bound.params = value

    @property
    def blocks(self):
        """The chain's bound blocks (the typed setters' walk)."""
        return self.bound.blocks

    @property
    def valid_from(self):
        """The chain's warm-up in output chunks (history priming happens
        once, at the head of the stream)."""
        return self.bound.valid_from

    def group_sigs(self):
        """The group (D-chunk) input and output signatures."""
        d = self.t_devices
        i, o = self.in_sig, self.out_sig
        return (StreamSig(i.batch, d * i.chunk_len, i.sample_rate),
                StreamSig(o.batch, d * o.chunk_len, o.sample_rate))

    def check(self, batch: int) -> None:
        """Raise now what a step at ``batch`` streams would raise."""
        self._graph.check(batch)

    def process(self, params, state, x_big):
        # The graph's node 0 (its input) has () params and state.
        new_state, ys = self._graph.process(((), *params), ((), *state),
                                            {"in": x_big})
        return tuple(new_state[1:]), ys["out"]

    def _group_step(self, params, state, x, reset):
        new_state, ys = self._graph._group_step(
            ((), *params), ((), *state), {"in": x}, {"in": reset})
        return tuple(new_state[1:]), ys["out"]

    def jit_step(self) -> _Compiled:
        """The compiled group step for live serving (``RuntimeBlock(...,
        shard="time")``): ``step(params, state, x, reset)`` as
        :func:`~radiorust_tpu_torch.blocks.base.jit_step` over the group
        signature; one CUDA graph of every shard's launches where the
        mesh is one card, eager otherwise.  A reset is all or nothing.
        On a mesh that spans processes it raises, as
        :meth:`TimeShardedGraph.jit_step` does."""
        _refuse_spanning(self.mesh, "TimeShardedChain.jit_step")
        return _Compiled(self.bound, whole_run=False,
                         process=self._group_step,
                         capturable=self.mesh.single_device)

    def set_shift(self, state, shift: float):
        """Phase-continuous retune of every FreqShifter / MixerDecimator:
        updates ``self.params`` and returns the rewritten carry (a numpy
        tree).  Call between steps."""
        new_params, new_state = _retune_shift(
            self.bound.blocks, self.bound.params, state, shift)
        self.bound.params = new_params
        return new_state

    def update_params(self, fn) -> None:
        """Params-only live retune: ``fn(block, params) -> params or
        None`` over the chain's blocks."""
        self.bound.params = _map_node_params(self.bound.blocks,
                                             self.bound.params, fn)
