"""The compiled entry points on CPU tensors: ``jit_step`` and ``make_scan``
run eagerly there and equal ``scan`` / ``graph_scan`` bit for bit, and
the JAX package's ``jit_step`` / ``make_scan`` (unpacked from its wire
format) within 3e-4 from ``valid_from`` (the WFM bound), on path A's
chain at batch 2 and on path C's stereo graph; ``BoundBlock.__call__``;
and the plain bookkeeping of a CUDA capture: when a params tree is new
(recapture), which state leaves are copied in, and how a step's new
state is written onto its own buffers."""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu.blocks.base import StreamSig as JSig
from radiorust_tpu.blocks.base import jit_step as jjit_step
from radiorust_tpu.blocks.base import make_scan as jmake_scan
from radiorust_tpu.blocks.base import pack_wire, unpack_wire
from radiorust_tpu.models.stereo import \
    wfm_stereo_receiver as jwfm_stereo_receiver
from radiorust_tpu.models.wfm import wfm_receiver as jwfm_receiver
from radiorust_tpu_torch.blocks import base as tbase
from radiorust_tpu_torch.blocks.base import (Chain, StreamSig, foreign_leaves,
                                             jit_step, make_scan, no_reset,
                                             params_changed, scan)
from radiorust_tpu_torch.blocks.graph import graph_scan
from radiorust_tpu_torch.blocks.transform import FreqShifter, GainControl
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.models.stereo import wfm_stereo_receiver
from radiorust_tpu_torch.models.wfm import wfm_receiver

ATOL = 3e-4
RATE = 1024000.0
CHAIN = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
             filter_ir_len=6144)
STEREO = dict(tune_shift=100e3, fuse_frontend=True, filter_ir_len=6144)
T, N = 3, 16384


@pytest.fixture(autouse=True)
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pfe.pl, "pallas_call", interp)
    monkeypatch.setattr(pfl.pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


def fm_tones(tones, offset=-100e3, deviation=150000.0):
    """[T, len(tones), N] complex64 FM tones (float64 synthesis)."""
    t = np.arange(T * N) / RATE
    rows = []
    for f in tones:
        audio = 0.5 * np.sin(2 * np.pi * f * t)
        phase = (2 * np.pi * deviation / RATE * np.cumsum(audio)
                 + 2 * np.pi * offset * t)
        rows.append(np.exp(1j * phase).astype(np.complex64))
    return np.stack(rows).reshape(len(tones), T, N).transpose(1, 0, 2)


def _equal(a, b):
    """Trees of tensors equal bit for bit."""
    la, lb = tbase._leaves(a), tbase._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _path(kind):
    """(port bound, JAX bound, xs as the bound takes them, reset)."""
    sig = (2, N, RATE)
    xs = fm_tones([900.0, 2100.0])
    if kind == "chain":
        return (wfm_receiver(**CHAIN).bind(StreamSig(*sig)),
                jwfm_receiver(**CHAIN).bind(JSig(*sig)), xs)
    return (wfm_stereo_receiver(**STEREO).bind({"iq": StreamSig(*sig)}),
            jwfm_stereo_receiver(**STEREO).bind({"iq": JSig(*sig)}),
            {"iq": xs})


def _tree(x, fn):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


@pytest.mark.parametrize("kind", ["chain", "graph"])
def test_compiled_equals_eager_and_jax(kind):
    tb, jb, xs = _path(kind)
    graph = kind == "graph"
    params = tree_to_torch(tb.params, "cpu")
    state0 = tree_to_torch(tb.init_state(), "cpu")
    txs = _tree(xs, torch.from_numpy)
    eager = (graph_scan if graph else scan)(tb, params, state0, txs)

    run = make_scan(tb)
    st, ys = run(params, state0, txs)
    _equal((st, ys), eager)
    assert run.captures == 0          # CPU tensors: no capture

    step = jit_step(tb)
    st = state0
    outs = []
    for i in range(T):
        st, y = step(params, st, _tree(txs, lambda v: v[i]))
        outs.append(y)
    _equal(st, eager[0])
    _equal(tbase._stack(outs), eager[1])

    # The JAX package's compiled forms on the same inputs, unpacked.
    batch = 2
    resets = ({"iq": np.zeros((T, batch), bool)} if graph
              else np.zeros((T, batch), bool))
    _, jys = jmake_scan(jb)(pack_wire(jb.params), pack_wire(jb.init_state()),
                            pack_wire(_tree(xs, jnp.asarray)), resets)
    jys = unpack_wire(jys)
    jstep = jjit_step(jb)
    pst = pack_wire(jb.init_state())
    jouts = []
    for i in range(T):
        r = ({"iq": np.zeros(batch, bool)} if graph
             else np.zeros(batch, bool))
        pst, py = jstep(pack_wire(jb.params), pst,
                        pack_wire(_tree(xs, lambda v: jnp.asarray(v[i]))), r)
        jouts.append(unpack_wire(py))
    vf = tb.valid_from if isinstance(tb.valid_from, dict) else {
        None: tb.valid_from}
    for name, v in vf.items():
        pick = (lambda y: y[name]) if graph else (lambda y: y)
        got = pick(eager[1]).numpy()[v:]
        np.testing.assert_allclose(got, np.asarray(pick(jys))[v:], atol=ATOL)
        np.testing.assert_allclose(
            got, np.stack([np.asarray(pick(y)) for y in jouts])[v:],
            atol=ATOL)


def test_bound_block_call():
    sig = StreamSig(2, 16, 48000.0)
    b = Chain(FreqShifter.with_shift(1000.0), GainControl(0.5)).bind(sig)
    x = np.exp(1j * np.arange(32).reshape(2, 16) * 0.1).astype(np.complex64)
    params = tree_to_torch(b.params, "cpu")
    state = tree_to_torch(b.init_state(), "cpu")
    want = b.process(params, state, torch.from_numpy(x), no_reset(2))
    _equal(b(x), want)                 # numpy input, defaults
    st2, y2 = b(torch.from_numpy(x), state=want[0], params=params,
                reset=no_reset(2))
    _equal((st2, y2), b.process(params, want[0], torch.from_numpy(x),
                                no_reset(2)))
    assert not torch.equal(y2, want[1])   # the oscillator moved on


def test_recapture_bookkeeping():
    """A capture holds its params tree: the same tree replays; another
    leaf object, or a leaf written in place, recaptures (params are
    constants of a capture)."""
    b = wfm_receiver(**CHAIN).bind(StreamSig(2, N, RATE))
    params = tree_to_torch(b.params, "cpu")
    held = tbase._hold(params)
    assert not params_changed(held, params)
    # Another params tree with the same values: new leaf objects.
    assert params_changed(held, tree_to_torch(b.params, "cpu"))
    # One leaf swapped (a retune through shift_params -> tree_to_torch).
    retuned = (tree_to_torch(b.blocks[0].shift_params(50e3), "cpu"),
               *params[1:])
    assert params_changed(held, retuned)
    # A leaf written in place: its version moves.
    params[1]["response"].mul_(1.0)
    assert params_changed(held, params)
    assert not params_changed(tbase._hold(params), params)
    assert params_changed(held, params[:-1])


def test_copy_in_bookkeeping():
    """The step's own state is not copied; a foreign state is."""
    b = wfm_receiver(**CHAIN).bind(StreamSig(2, N, RATE))
    own = tbase._leaves(tree_to_torch(b.init_state(), "cpu"))
    assert foreign_leaves(own, own) == []
    other = [t.clone() for t in own]
    assert foreign_leaves(own, other) == list(range(len(own)))
    mixed = own[:2] + other[2:]
    assert foreign_leaves(own, mixed) == list(range(2, len(own)))


def test_write_back_in_place():
    """A step's new state lands on its own buffers: a leaf passed through
    is skipped, a leaf that is a view of another state buffer (or of its
    own) is read before any buffer is written, and an output that views
    a state buffer keeps the value it had."""
    a = torch.arange(6.0)
    bb = torch.zeros(6)
    c = torch.ones(3)
    own = {"a": a, "b": bb, "c": c}
    new = {"a": bb + 1.0,          # a fresh tensor
           "b": a,                 # the old a, a view of another buffer
           "c": c}                 # passed through
    y = a[:3]                      # an output that views a state buffer
    want_a, want_b, want_y = (bb + 1.0), a.clone(), a[:3].clone()
    got_y = tbase._write_back(own, new, y)
    assert own["a"] is a and own["b"] is bb and own["c"] is c
    assert torch.equal(a, want_a) and torch.equal(bb, want_b)
    assert torch.equal(c, torch.ones(3))
    assert torch.equal(got_y, want_y)
    # The element order is the buffer's own: a flipped view of itself.
    own2 = {"a": torch.arange(4.0)}
    tbase._write_back(own2, {"a": own2["a"].flip(0)}, ())
    assert own2["a"].tolist() == [3.0, 2.0, 1.0, 0.0]
    with pytest.raises(ValueError):
        tbase._write_back({"a": torch.zeros(3)}, {"a": torch.zeros(4)}, ())
