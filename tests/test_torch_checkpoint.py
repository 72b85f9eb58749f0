"""Checkpoints of the port (``radiorust_tpu_torch/utils/checkpoint.py``,
``RuntimeBlock.save_checkpoint`` / ``load_checkpoint``) on CPU tensors.

1. The non-sharded scenarios of ``tests/test_checkpoint.py``: the npz
   tree format round-trips every container and leaf kind, and a restored
   chain, phase-mode resampler, graph or actor continues its stream bit
   for bit.
2. The file format is the JAX package's: a file written by either
   package's ``save_state`` loads in the other with the same tree, and a
   checkpoint written by the JAX ``RuntimeBlock`` resumes in the port's
   (and the reverse), each continuing the stream within 3e-4 of the
   uninterrupted run of the other package from ``valid_from`` — the WFM
   bound of ``tests/test_torch_compiled.py`` — on path A's chain.
"""

import asyncio

import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch

import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
import radiorust_tpu.runtime as jrt
import radiorust_tpu.utils.checkpoint as jck
import radiorust_tpu_torch.runtime as trt
from radiorust_tpu import config
from radiorust_tpu.models.wfm import wfm_receiver as jwfm_receiver
from radiorust_tpu_torch.blocks.base import Chain, StreamSig, scan
from radiorust_tpu_torch.blocks.filters import Filter
from radiorust_tpu_torch.blocks.graph import graph_scan
from radiorust_tpu_torch.blocks.modulation import FmDemod
from radiorust_tpu_torch.blocks.resampling import Downsampler
from radiorust_tpu_torch.blocks.transform import FreqShifter, GainControl
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.models.wfm import wfm_receiver, wfm_receiver_graph
from radiorust_tpu_torch.runtime import RuntimeBlock
from radiorust_tpu_torch.signal import Disconnection, Samples, Warmup
from radiorust_tpu_torch.utils.checkpoint import load_state, save_state

CPU = "cpu"
ATOL = 3e-4
RATE = 1024000.0
CHAIN = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
             filter_ir_len=6144)


def run(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout), debug=True)


def _t(tree):
    return tree_to_torch(tree, CPU)


def _scan(bound, state, xs):
    return scan(bound, _t(bound.params), state, torch.from_numpy(xs))


def assert_same(a, b, path="root"):
    """Trees equal in structure, container types, leaf dtypes and values
    (either package's leaves)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        aa, bb = np.asarray(a), np.asarray(b)
        assert aa.dtype == bb.dtype and aa.shape == bb.shape, path
        np.testing.assert_array_equal(aa, bb, err_msg=path)


def random_tree(rng, depth):
    dtypes = [np.complex64, np.float32, np.float64, np.int32, np.bool_]

    def leaf():
        dt = dtypes[rng.integers(len(dtypes))]
        shape = tuple(rng.integers(1, 4, size=rng.integers(0, 3)))
        a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
             if dt == np.complex64 else rng.standard_normal(shape) * 10)
        v = a.astype(dt)
        return dt(v[()]) if shape == () else v

    kind = rng.integers(6)
    if depth == 0 or kind >= 3:
        return leaf()
    children = [random_tree(rng, depth - 1)
                for _ in range(int(rng.integers(0, 4)))]
    if kind == 0:
        return {f"k{i}": c for i, c in enumerate(children)}
    return children if kind == 1 else tuple(children)


# ---------------------------------------------------------------------------
# 1. The JAX package's scenarios, on the port
# ---------------------------------------------------------------------------

def test_save_load_roundtrip_types(tmp_path):
    tree = {"a": np.arange(6, dtype=np.int32),
            "b": (torch.ones(3, dtype=torch.complex64) * (1 + 2j),
                  {"c": np.float32(2.5)}),
            "d": [np.zeros((2, 2), np.float32)]}
    path = str(tmp_path / "ckpt.npz")
    save_state(path, tree)
    got = load_state(path)
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"][0], tree["b"][0].numpy())
    assert got["b"][0].dtype == np.complex64
    np.testing.assert_allclose(got["b"][1]["c"], 2.5)
    assert isinstance(got["b"], tuple) and isinstance(got["d"], list)


def test_resume_continues_stream(tmp_path):
    n = 2048
    bound = wfm_receiver().bind(StreamSig(1, n, RATE))
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((6, 1, n)) + 1j * rng.standard_normal((6, 1, n))
          ).astype(np.complex64)
    _, ys_all = _scan(bound, _t(bound.init_state()), xs)
    st, ys_a = _scan(bound, _t(bound.init_state()), xs[:3])
    path = str(tmp_path / "mid.npz")
    save_state(path, st)
    _, ys_b = _scan(bound, _t(load_state(path)), xs[3:])
    np.testing.assert_array_equal(ys_all[:3].numpy(), ys_a.numpy())
    np.testing.assert_array_equal(ys_all[3:].numpy(), ys_b.numpy())


def test_phase_mode_resampler_checkpoint_resume(tmp_path):
    bound = Downsampler(384.0, 200.0).bind(StreamSig(1, 100, 1024.0))
    assert bound.phase_mode
    rng = np.random.default_rng(3)
    xs = (rng.standard_normal((6, 1, 100))
          + 1j * rng.standard_normal((6, 1, 100))).astype(np.complex64)
    _, ys_all = _scan(bound, _t(bound.init_state()), xs)
    st, ys_a = _scan(bound, _t(bound.init_state()), xs[:3])
    path = str(tmp_path / "phase.npz")
    save_state(path, st)
    restored = load_state(path)
    assert restored["phase"].dtype == np.int32
    assert int(restored["phase"][0]) == 300 % 8      # mid-schedule
    assert bound.schedule_phase(restored) == 300 % 8
    _, ys_b = _scan(bound, _t(restored), xs[3:])
    np.testing.assert_array_equal(ys_all[:3].numpy(), ys_a.numpy())
    np.testing.assert_array_equal(ys_all[3:].numpy(), ys_b.numpy())


def test_empty_containers_roundtrip(tmp_path):
    tree = (np.arange(3, dtype=np.float32), (), {"k": []},
            [np.float32(1.5), ()])
    path = str(tmp_path / "empty.npz")
    save_state(path, tree)
    got = load_state(path)
    assert isinstance(got, tuple) and len(got) == 4
    np.testing.assert_array_equal(got[0], tree[0])
    assert got[1] == () and got[2] == {"k": []}
    assert isinstance(got[3], list) and got[3][0] == np.float32(1.5)
    assert got[3][1] == ()


def test_resume_with_stateless_block_midchain(tmp_path):
    n = 512
    bound = Chain(FreqShifter(700.0), GainControl(0.5),
                  FmDemod(5000.0)).bind(StreamSig(1, n, 48000.0))
    rng = np.random.default_rng(7)
    xs = (rng.standard_normal((4, 1, n)) + 1j * rng.standard_normal((4, 1, n))
          ).astype(np.complex64)
    _, ys_all = _scan(bound, _t(bound.init_state()), xs)
    st, _ = _scan(bound, _t(bound.init_state()), xs[:2])
    path = str(tmp_path / "mid.npz")
    save_state(path, st)
    _, ys_b = _scan(bound, _t(load_state(path)), xs[2:])
    np.testing.assert_array_equal(ys_all[2:].numpy(), ys_b.numpy())


def test_graph_state_roundtrip(tmp_path):
    bg = wfm_receiver_graph().bind(StreamSig(1, 2048, RATE))
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((4, 1, 2048))
          + 1j * rng.standard_normal((4, 1, 2048))).astype(np.complex64)
    params = _t(bg.params)
    st, ys_a = graph_scan(bg, params, _t(bg.init_state()),
                          {"iq": torch.from_numpy(xs[:2])})
    path = str(tmp_path / "graph_state.npz")
    save_state(path, st)
    _, ys_b = graph_scan(bg, params, _t(load_state(path)),
                         {"iq": torch.from_numpy(xs[2:])})
    _, ys_full = graph_scan(bg, params, _t(bg.init_state()),
                            {"iq": torch.from_numpy(xs)})
    for k in ("audio", "spectrum"):
        np.testing.assert_array_equal(
            torch.cat([ys_a[k], ys_b[k]]).numpy(), ys_full[k].numpy())


def _filter_spec():
    return Chain(FreqShifter.with_shift(1000.0),
                 Filter.new(lambda b, f: np.where(np.abs(f) <= 200.0,
                                                  1.0, 0.0)))


async def _drive(make_actor, chunks, rate, ckpt_in=None, ckpt_out=None,
                 rt=trt, interrupt_first=False):
    """Feed ``chunks`` to a fresh actor (restored from ``ckpt_in``),
    checkpoint it to ``ckpt_out`` after the last output; returns (the
    outputs, the events the sink saw)."""
    sender, connector = rt.new_sender()
    blk = make_actor()
    if ckpt_in is not None:
        blk.load_checkpoint(ckpt_in)
    sink = rt.ArraySink()
    blk.feed_from(type("P", (), {"sender_connector": connector})())
    sink.feed_from(blk)
    if interrupt_first:
        await sender.send(Disconnection())
    for c in chunks:
        await sender.send(Samples(rate, c))
    for _ in range(2000):
        if len(sink.chunks) >= len(chunks):
            break
        await asyncio.sleep(0.01)
    assert blk.failure is None
    if ckpt_out is not None:
        blk.save_checkpoint(ckpt_out)
    return list(sink.chunks), list(sink.events)


def test_runtime_block_checkpoint_resume(tmp_path):
    """A fresh actor resumes bit-exactly, with no Warmup and no reset."""
    rng = np.random.default_rng(3)
    xs = (rng.standard_normal((6, 256))
          + 1j * rng.standard_normal((6, 256))).astype(np.complex64)

    def actor():
        return RuntimeBlock(_filter_spec(), device=CPU)

    full, _ = run(_drive(actor, list(xs), 8000.0))
    path = str(tmp_path / "actor.npz")
    first, ev_a = run(_drive(actor, list(xs[:3]), 8000.0, ckpt_out=path))
    rest, ev_b = run(_drive(actor, list(xs[3:]), 8000.0, ckpt_in=path))
    np.testing.assert_array_equal(np.concatenate(first + rest),
                                  np.concatenate(full))
    assert any(isinstance(e, Warmup) for e in ev_a)
    assert not any(isinstance(e, Warmup) for e in ev_b)


def test_interrupt_invalidates_restored_checkpoint(tmp_path):
    """An interrupt between load_checkpoint and the first chunk: the
    restored history is dropped (a cold start, Warmup re-emitted); a
    pending restored state saves again unchanged."""
    x = (np.linspace(0, 1, 256) + 1j).astype(np.complex64)
    path = str(tmp_path / "pre.npz")
    resaved = str(tmp_path / "resaved.npz")

    def actor():
        return RuntimeBlock(_filter_spec(), device=CPU)

    def restored_then_saved():
        blk = actor()
        blk.load_checkpoint(path)
        blk.save_checkpoint(resaved)
        return blk

    run(_drive(actor, [x], 8000.0, ckpt_out=path))
    got, events = run(_drive(restored_then_saved, [x], 8000.0,
                             interrupt_first=True))
    cold, _ = run(_drive(actor, [x], 8000.0))
    np.testing.assert_array_equal(got[0], cold[0])
    assert any(isinstance(e, Warmup) for e in events)
    assert_same(load_state(path), load_state(resaved))


def test_bare_root_leaf_and_extensionless_path(tmp_path):
    p = str(tmp_path / "leaf.ckpt")              # no .npz extension
    save_state(p, np.float32(0.25))
    assert load_state(p) == np.float32(0.25)
    save_state(p, np.complex64(1 + 2j))
    assert load_state(p) == np.complex64(1 + 2j)
    state = {"prev": np.arange(4, dtype=np.complex64)}
    save_state(p, state)
    np.testing.assert_array_equal(load_state(p)["prev"], state["prev"])


def test_random_pytrees_round_trip(tmp_path):
    rng = np.random.default_rng(42)
    for case in range(25):
        t = random_tree(rng, 3)
        p = str(tmp_path / f"t{case}.npz")
        save_state(p, t)
        assert_same(t, load_state(p))


# ---------------------------------------------------------------------------
# 2. Files move between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_format_shared_with_jax(tmp_path, writer):
    rng = np.random.default_rng(5)
    save, load = ((jck.save_state, load_state) if writer == "jax"
                  else (save_state, jck.load_state))
    for case in range(25):
        t = random_tree(rng, 3)
        p = str(tmp_path / f"t{case}.npz")
        save(p, t)
        assert_same(t, load(p))


@pytest.fixture
def interpret_pallas_highest(monkeypatch):
    """The JAX package's kernels in interpret mode at float32 matmul
    precision, as its own CPU tests run them."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pfe.pl, "pallas_call", interp)
    monkeypatch.setattr(pfl.pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_actor_checkpoint_moves_between_packages(tmp_path, writer,
                                                 interpret_pallas_highest):
    """Path A's chain, 2 streams of FM tones: one package's actor runs
    three chunks and checkpoints, the other's resumes for three more (no
    Warmup); its outputs equal the reader package's uninterrupted run
    within 3e-4, and its own uninterrupted run's too."""
    n, t_chunks = 16384, 6
    t = np.arange(t_chunks * n) / RATE
    rows = [np.exp(1j * (2 * np.pi * 150000.0 / RATE
                         * np.cumsum(0.5 * np.sin(2 * np.pi * f * t))
                         - 2 * np.pi * 100e3 * t)).astype(np.complex64)
            for f in (900.0, 2100.0)]
    xs = np.stack(rows).reshape(2, t_chunks, n).transpose(1, 0, 2)
    port = (lambda: RuntimeBlock(wfm_receiver(**CHAIN), device=CPU), trt)
    jax_ = (lambda: jrt.RuntimeBlock(jwfm_receiver(**CHAIN)), jrt)
    first, second = (jax_, port) if writer == "jax" else (port, jax_)
    path = str(tmp_path / "a.npz")
    run(_drive(first[0], list(xs[:3]), RATE, ckpt_out=path, rt=first[1]))
    rest, events = run(_drive(second[0], list(xs[3:]), RATE, ckpt_in=path,
                              rt=second[1]))
    assert not any(type(e).__name__ == "Warmup" for e in events)
    valid_from = wfm_receiver(**CHAIN).bind(StreamSig(2, n, RATE)).valid_from
    assert valid_from <= 3 and len(rest) == 3
    for make, rt in (first, second):
        full, _ = run(_drive(make, list(xs), RATE, rt=rt))
        for got, want in zip(rest, full[3:]):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       atol=ATOL)
    assert_same(load_state(path), jck.load_state(path))
