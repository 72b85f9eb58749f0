"""The port's native runtime (``radiorust_tpu_torch/runtime/native.py``):
the C++ broadcast channel built with ``g++`` from the port's own sources
(never the JAX package's library), and ``NativeGraph`` with one OS thread
per block stage on the CPU (``device="cpu"``) — the scenarios of
``tests/test_native_runtime.py``, plus batched 2-D chunks equal to the
port's ``scan`` bit for bit with two stages on two threads, and the CUDA
default (a stage without a card and without a device raises)."""

import pathlib
import threading

import numpy as np
import pytest
import torch

import radiorust_tpu_torch
from radiorust_tpu_torch.blocks.base import Chain, StreamSig, scan
from radiorust_tpu_torch.blocks.filters import Filter
from radiorust_tpu_torch.blocks.transform import FreqShifter, GainControl
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.runtime import native
from radiorust_tpu_torch.runtime.native import NativeChannel, NativeGraph
from radiorust_tpu_torch.signal import Samples, Warmup

CPU = "cpu"


def test_library_builds_from_the_ports_sources():
    native.load_library()
    src = pathlib.Path(radiorust_tpu_torch.__file__).parent / "native"
    assert sorted(p.name for p in src.glob("*.cpp")) == [
        "broadcast_bp.cpp", "iq_loader.cpp"]
    builds = list(native._ROOT.glob("native-*/libbroadcast_bp.so"))
    assert builds and all(b.is_relative_to(native._ROOT) for b in builds)


def test_channel_basic_handoff():
    ch = NativeChannel()
    got = []

    def consumer():
        rid = ch.subscribe()
        while True:
            ok, obj = ch.recv(rid, timeout_ms=5000)
            if not ok:
                return
            got.append(obj)

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    for v in ["a", "b", "c"]:
        assert ch.send(v)
    ch.close_sender()
    t.join(5)
    assert not t.is_alive() and got == ["a", "b", "c"]


def test_channel_broadcast_backpressure():
    ch = NativeChannel()
    results = [[], []]
    ready = threading.Barrier(3)

    def consumer(i):
        rid = ch.subscribe()
        ready.wait()
        while True:
            ok, obj = ch.recv(rid, timeout_ms=5000)
            if not ok:
                return
            results[i].append(obj)

    threads = [threading.Thread(target=consumer, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    ready.wait()
    for v in range(5):
        assert ch.send(v)
    ch.close_sender()
    for t in threads:
        t.join(5)
        assert not t.is_alive()
    assert results == [list(range(5))] * 2


def test_native_graph_pipeline():
    data = np.arange(32, dtype=np.complex64)
    msgs = [Samples(48000.0, data[i:i + 8]) for i in range(0, 32, 8)]
    g = NativeGraph()
    src = g.source(msgs)
    gain = g.block(GainControl(0.5), src, device=CPU)
    shift = g.block(FreqShifter.with_shift(0.0), gain, device=CPU)
    out = g.sink(shift)
    g.run(timeout=60.0)
    np.testing.assert_allclose(out.samples, data * 0.5, atol=1e-6)
    assert out.sample_rate == 48000.0
    assert gain.stats.chunks == 4 and gain.stats.samples == 32
    assert gain.stats.wall_seconds > 0.0


def test_channel_closure_observable_after_enlister_release():
    ch = NativeChannel()
    rid = ch.subscribe()
    ch.release_enlister()
    ch.unsubscribe(rid)
    assert ch.send("x") is False


def test_graph_source_failure_surfaces():
    def boom():
        yield Samples(48000.0, np.zeros(8, np.complex64))
        raise ValueError("driver died")

    g = NativeGraph()
    g.sink(g.block(GainControl(1.0), g.source(boom()), device=CPU))
    with pytest.raises(RuntimeError) as ei:
        g.run(timeout=30.0)
    assert isinstance(ei.value.__cause__, ValueError)


def test_graph_block_failure_surfaces_not_hangs():
    class _BadSpec:
        def bind(self, sig):
            raise ValueError("bad bind")

    data = np.arange(64, dtype=np.complex64)
    msgs = [Samples(48000.0, data[i:i + 8]) for i in range(0, 64, 8)]
    g = NativeGraph()
    g.sink(g.block(_BadSpec(), g.source(msgs), name="bad", device=CPU))
    with pytest.raises(RuntimeError) as ei:
        g.run(timeout=30.0)
    assert isinstance(ei.value.__cause__, ValueError)


def test_graph_emits_warmup_on_rebind():
    rng = np.random.default_rng(7)
    iq = (rng.standard_normal(1536) + 1j * rng.standard_normal(1536)
          ).astype(np.complex64)
    msgs = [Samples(48000.0, iq[:512]), Samples(48000.0, iq[512:1024]),
            Samples(48000.0, iq[1024:1280]),   # rebind: 512 -> 256
            Samples(48000.0, iq[1280:1536])]
    g = NativeGraph()
    lp = Filter(lambda bins, freqs: np.where(np.abs(freqs) <= 8000.0,
                                             1.0 + 0.0j, 0.0j))
    out = g.sink(g.block(lp, g.source(msgs), device=CPU))
    g.run(timeout=120.0)
    warmups = [e for e in out.events if isinstance(e, Warmup)]
    assert len(warmups) == 2 and all(w.steps == 1 for w in warmups)
    assert len(out.chunks) == 4


def test_graph_broadcast_fanout_two_branches():
    data = np.arange(256, dtype=np.complex64)
    msgs = [Samples(48000.0, data[i:i + 32]) for i in range(0, 256, 32)]
    g = NativeGraph()
    src = g.source(msgs)
    out_a = g.sink(g.block(GainControl(0.5), src, name="a", device=CPU))
    out_b = g.sink(g.block(GainControl(2.0), src, name="b", device=CPU))
    g.run(timeout=60.0)
    np.testing.assert_allclose(out_a.samples, data * 0.5, atol=1e-6)
    np.testing.assert_allclose(out_b.samples, data * 2.0, atol=1e-6)


def test_graph_threaded_stress():
    n_chunks, n = 200, 16
    rng = np.random.default_rng(11)
    data = (rng.standard_normal(n_chunks * n)
            + 1j * rng.standard_normal(n_chunks * n)).astype(np.complex64)
    msgs = [Samples(8000.0, data[i * n:(i + 1) * n])
            for i in range(n_chunks)]
    g = NativeGraph()
    s1 = g.block(GainControl(2.0), g.source(msgs), name="g1", device=CPU)
    tap = g.sink(s1, name="tap")
    out = g.sink(g.block(GainControl(0.25), s1, name="g2", device=CPU),
                 name="out")
    g.run(timeout=120.0)
    assert len(tap.chunks) == n_chunks and len(out.chunks) == n_chunks
    np.testing.assert_allclose(tap.samples, data * 2.0, atol=1e-5)
    np.testing.assert_allclose(out.samples, data * 0.5, atol=1e-5)


def test_batched_two_stages_equal_scan():
    """2-D [streams, n] chunks through two stages on two threads equal the
    port's scan of the whole chain bit for bit."""
    rng = np.random.default_rng(5)
    xs = (rng.standard_normal((6, 3, 256))
          + 1j * rng.standard_normal((6, 3, 256))).astype(np.complex64)
    lp = Filter.new(lambda b, f: np.where(np.abs(f) <= 900.0, 1.0, 0.0))
    front, back = Chain(FreqShifter.with_shift(300.0), lp), GainControl(0.5)
    g = NativeGraph()
    src = g.source([Samples(8000.0, x) for x in xs])
    out = g.sink(g.block(back, g.block(front, src, device=CPU), device=CPU))
    g.run(timeout=60.0)
    bound = Chain(front, back).bind(StreamSig(3, 256, 8000.0))
    _, want = scan(bound, tree_to_torch(bound.params, CPU),
                   tree_to_torch(bound.init_state(), CPU),
                   torch.from_numpy(xs))
    assert [c.shape for c in out.chunks] == [(3, 256)] * 6
    np.testing.assert_array_equal(np.stack(out.chunks), want.numpy())


def test_block_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = NativeGraph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.block(GainControl(1.0), g.source([]))
