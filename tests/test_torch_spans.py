"""The port's span and counter registry (``utils/profiling.py``) and the
compiled entry's spans and counters (``blocks/base.py`` ``_Compiled``):
nesting and self time, nothing recorded and no profiler range or clock
touched with tracing off, the entry's ranges in a profiler's Chrome trace,
the operator's switch, the report, and, on the card only, the replay
path's copy bytes, recapture counter and device span."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from radiorust_tpu_torch.blocks.base import (Chain, StreamSig, jit_step,
                                             make_scan)
from radiorust_tpu_torch.blocks.transform import FreqShifter, GainControl
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.utils import profiling
from radiorust_tpu_torch.utils.profiling import SPANS, SpanRegistry

T = 3


@pytest.fixture(autouse=True)
def fresh_registry():
    SPANS.reset()
    profiling.enable(False)
    yield
    profiling.enable(False)
    SPANS.reset()


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, when
    the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the replay path runs only on the card")
    return "cuda"


def _bound(batch=2, n=16):
    return Chain(FreqShifter.with_shift(1000.0),
                 GainControl(0.5)).bind(StreamSig(batch, n, 48000.0))


def _inputs(b, device, lead=()):
    params = tree_to_torch(b.params, device)
    state = tree_to_torch(b.init_state(), device)
    shape = (*lead, b.in_sig.batch, b.in_sig.chunk_len)
    x = torch.randn(shape, dtype=torch.complex64, device=device)
    return params, state, x


def _call(kind, device="cpu", batch=2, n=16):
    b = _bound(batch, n)
    if kind == "make_scan":
        params, state, xs = _inputs(b, device, (T,))
        return make_scan(b)(params, state, xs)
    params, state, x = _inputs(b, device)
    return jit_step(b)(params, state, x)


def test_nesting_and_self_time(monkeypatch):
    ticks = iter([0, 10, 40, 50, 60, 100])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    reg = SpanRegistry()
    reg.enabled = True
    with reg.span("outer"):
        with reg.span("inner"):
            pass
        with reg.span("inner"):
            pass
    snap = reg.snapshot()["spans"]
    assert snap["outer"] == {"count": 1, "total_ns": 100, "self_ns": 60}
    assert snap["inner"] == {"count": 2, "total_ns": 40, "self_ns": 40}


def test_span_off_and_always():
    reg = SpanRegistry()
    with reg.span("off"):
        pass
    with reg.span("rare", always=True):
        pass
    assert set(reg.snapshot()["spans"]) == {"rare"}


def test_threads_keep_their_own_parents():
    """A span opened on another thread is no child of this thread's open
    span, and concurrent updates are not lost."""
    reg = SpanRegistry()
    reg.enabled = True
    n_threads, n_spans = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with reg.span("main"):
            def work():
                for _ in range(n_spans):
                    with reg.span("worker"):
                        reg.count("worker.n")
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = reg.snapshot()
    assert snap["counters"]["worker.n"] == n_threads * n_spans
    assert snap["spans"]["worker"]["count"] == n_threads * n_spans
    main = snap["spans"]["main"]
    assert main["self_ns"] == main["total_ns"]


@pytest.mark.parametrize("kind", ["jit_step", "make_scan"])
def test_off_records_nothing(kind, monkeypatch):
    """Tracing off: the registry is unchanged, no profiler range is
    constructed and the registry's clock is never read."""
    assert not profiling.tracing()

    def refuse(*a, **kw):
        raise AssertionError("touched with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_range", refuse)
    monkeypatch.setattr(profiling, "_clock", refuse)
    before = profiling.snapshot()
    _call(kind)
    assert profiling.snapshot() == before


@pytest.mark.parametrize("kind, steps", [("jit_step", 1), ("make_scan", T)])
def test_profiler_trace_holds_entry_spans(kind, steps, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.window"):
            _call(kind)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("cat") in ("user_annotation", "cpu_op")]
    win = [e for e in events if e["name"] == "test.window"]
    assert len(win) == 1
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    for name in ("rr.entry", "rr.entry.eager"):
        got = [e for e in events if e["name"] == name]
        assert len(got) == 1, name
        assert w0 <= got[0]["ts"] and got[0]["ts"] + got[0]["dur"] <= w1
    snap = profiling.snapshot()
    assert snap["counters"] == {"entry.calls": 1, "entry.steps": steps}
    entry = snap["spans"]["rr.entry"]
    eager = snap["spans"]["rr.entry.eager"]
    assert entry["count"] == eager["count"] == 1
    assert 0 <= entry["self_ns"] == entry["total_ns"] - eager["total_ns"]


def test_enable_records_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_range", refuse)
    profiling.enable(True)
    assert profiling.tracing()
    _call("jit_step")
    _call("make_scan")
    snap = profiling.snapshot()
    assert snap["counters"] == {"entry.calls": 2, "entry.steps": 1 + T}
    assert snap["spans"]["rr.entry"]["count"] == 2
    assert snap["spans"]["rr.entry.eager"]["count"] == 2
    # No device span off CUDA.
    assert profiling.device_start("cpu") is None
    profiling.device_stop("rr.entry.device", None, "cpu")
    assert "rr.entry.device" not in profiling.snapshot()["spans"]
    profiling.enable(False)
    _call("jit_step")
    assert profiling.snapshot() == snap


def test_report_renders_every_name():
    profiling.enable(True)
    _call("make_scan")
    with profiling.span("rr.ops.load", always=True):
        pass
    profiling.count("entry.recaptures", 0)
    text = profiling.report()
    snap = profiling.snapshot()
    for name in [*snap["spans"], *snap["counters"]]:
        assert name in text
    assert {"rr.entry", "rr.entry.eager", "rr.ops.load", "entry.calls",
            "entry.steps", "entry.recaptures"} <= set(text.split())


@pytest.mark.card
def test_card_replay_spans_and_counters(card):
    """On the card: each call's copy bytes equal the count from shapes, a
    params change recaptures once, and the device span is positive and
    below the call's host-clock latency."""
    profiling.enable(True)
    b = _bound(batch=8, n=4096)
    params, state, xs = _inputs(b, card, (T,))
    run = make_scan(b)
    st, ys = run(params, state, xs)                   # captures
    snap = profiling.snapshot()
    assert snap["counters"]["entry.captures"] == 1
    capture = snap["spans"]["rr.entry.capture"]
    assert capture["count"] == 1 and run.captures == 1
    assert run.capture_ms == capture["total_ns"] / 1e6
    state_bytes = _nbytes(st)
    SPANS.reset()
    st, ys = run(params, st, xs)                      # a replay
    torch.cuda.synchronize()
    c = profiling.snapshot()["counters"]
    assert c["entry.copy_in_bytes"] == xs.nbytes + state_bytes
    assert c["entry.clone_out_bytes"] == _nbytes(ys) + state_bytes
    assert c["entry.steps"] == T and "entry.captures" not in c

    step = jit_step(b)
    params, state, x = _inputs(b, card)
    st, y = step(params, state, x)                    # captures
    st, y = step(params, st, x)
    torch.cuda.synchronize()
    SPANS.reset()
    t0 = time.perf_counter()
    st, y = step(params, st, x)                       # its own state
    torch.cuda.synchronize()
    latency_ns = (time.perf_counter() - t0) * 1e9
    snap = profiling.snapshot()
    assert snap["counters"]["entry.copy_in_bytes"] == x.nbytes
    assert snap["counters"]["entry.clone_out_bytes"] == y.nbytes
    dev = snap["spans"]["rr.entry.device"]
    assert dev["count"] == 1 and 0 < dev["total_ns"] < latency_ns

    retuned = tree_to_torch(b.params, card)           # a new params tree
    st, y = step(retuned, st, x)
    torch.cuda.synchronize()
    c = profiling.snapshot()["counters"]
    assert c["entry.recaptures"] == 1 and c["entry.captures"] == 1
    assert np.isfinite(y.cpu().numpy()).all()


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.nbytes if isinstance(tree, torch.Tensor) else 0
