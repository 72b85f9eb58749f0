"""Checkpoint-based worker recycling in the port
(``radiorust_tpu_torch/runtime/recycle.py``), on the CPU.

The counterparts of ``tests/test_recycle.py``: the stitched output of a
stream served across recycled worker processes equals one uninterrupted
generation bit for bit, only the cold generation emits a Warmup, a
phase-mode tail is refused, a dead worker raises promptly and a worker's
error surfaces.  Beside them: the port's recycled stream against the JAX
package's ``serve_recycling`` on the same chunks, ``device=None`` without
a card raising before any worker starts, and the drill tool
(``tools/recycle_onchip.py``) on the CPU.  Every worker is a spawn
process, so the file keeps their number small (12)."""

import time

import numpy as np
import pytest

from radiorust_tpu_torch.runtime import recycle, serve_recycling
from torch_recycle import (chunks, dying_spec, jax_spec, port_spec,
                           ragged_spec)

FILTER_BOUND = 2.4e-5   # the filters' bound, max |diff| / max |ref|
TIMING = ("boot_s", "first_output_s", "input_wait_s", "peek_s",
          "checkpoint_s", "seconds", "wall_s")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``serve(budget)``: the port's run of :func:`chunks` at that budget
    on the CPU, once per budget in this file, and this process's resident
    MB while it ran, 537 MB (512 MiB) of ballast included (a worker's peak
    RSS must be its own, below that)."""
    runs = {}

    def serve(budget):
        if budget not in runs:
            stats = []
            path = str(tmp_path_factory.mktemp("gen") / "gen.npz")
            ballast = np.ones(64 * 2**20)
            here = recycle.rss_mb()
            runs[budget] = (*serve_recycling(
                port_spec, chunks(), 8000.0, chunks_per_worker=budget,
                ckpt_path=path, device="cpu", stats=stats), stats, here)
            del ballast
        return runs[budget]
    return serve


@pytest.mark.parametrize("budget,want_gens", [(3, 3), (7, 1)])
def test_recycling_bit_exact(served, budget, want_gens):
    outs, gens, warmups, stats, here = served(budget)
    assert gens == want_gens
    assert len(stats) == gens
    assert all(0 < s["maxrss_mb"] < here for s in stats), (here, stats)
    # What each generation ran on, as it saw it: the CPU, which launches
    # no kernel.
    assert all(s["device"] == "cpu" and s["launches"] == {}
               for s in stats), stats
    assert all(s[k] >= 0.0 for s in stats for k in TIMING), stats
    assert all(s["wall_s"] > s["seconds"] >= s["first_output_s"]
               for s in stats), stats
    # Only the cold generation primes zero history (Warmup); every
    # resumed generation continues the checkpointed stream state.
    assert warmups[0] == 1 and all(w == 0 for w in warmups[1:]), warmups
    # Uninterrupted single-worker run == stitched recycled run, bitwise.
    ref, gens1, *_ = served(len(chunks()) + 1)
    assert gens1 == 1
    np.testing.assert_array_equal(np.concatenate(outs), np.concatenate(ref))


def test_recycling_matches_the_jax_package(served, tmp_path, monkeypatch):
    # The JAX worker inherits the environment: its matmuls at highest.
    monkeypatch.setenv("RRTPU_MATMUL_PRECISION", "highest")
    from radiorust_tpu.runtime import serve_recycling as jax_serve
    outs, gens, warmups, *_ = served(3)
    want, jax_gens, jax_warmups = jax_serve(
        jax_spec, chunks(), 8000.0, chunks_per_worker=len(chunks()) + 1,
        ckpt_path=str(tmp_path / "jax.npz"), jax_platform="cpu")
    assert (gens, jax_gens) == (3, 1)
    assert warmups == [1, 0, 0] and jax_warmups == [1]
    got, want = np.concatenate(outs), np.concatenate(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= FILTER_BOUND, rel


def test_recycling_rejects_phase_mode(tmp_path):
    # Ragged (trimmed-schedule) chains break the lock-step protocol; the
    # worker must reject them with a clear error, not hang.
    xs = [np.ones(100, np.complex64)] * 2
    with pytest.raises(RuntimeError, match="one output chunk per input"):
        serve_recycling(ragged_spec, xs, 1024.0, chunks_per_worker=4,
                        ckpt_path=str(tmp_path / "gen.npz"), device="cpu",
                        timeout=120.0)


def test_recycling_dead_worker_raises_promptly(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died without reporting"):
        serve_recycling(dying_spec, chunks(2), 8000.0, chunks_per_worker=4,
                        ckpt_path=str(tmp_path / "gen.npz"), device="cpu",
                        timeout=120.0)
    # Liveness polling, not the full queue timeout.
    assert time.monotonic() - t0 < 60.0


def test_recycling_surfaces_worker_error(tmp_path):
    # A 3-D chunk is not a stream the actor can bind; the worker's failure
    # must surface as a supervisor-side RuntimeError, not a hang.
    bad = [np.zeros((3, 5, 7), np.complex64)]
    with pytest.raises(RuntimeError, match="recycling worker"):
        serve_recycling(port_spec, bad, 8000.0, chunks_per_worker=4,
                        ckpt_path=str(tmp_path / "gen.npz"), device="cpu",
                        timeout=120.0)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_recycling_without_a_card_raises_before_spawning(tmp_path,
                                                         monkeypatch,
                                                         device):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(recycle.multiprocessing, "get_context",
                        lambda *a: spawned.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_recycling(port_spec, chunks(2), 8000.0, chunks_per_worker=4,
                        ckpt_path=str(tmp_path / "gen.npz"), device=device)
    assert spawned == []


def test_recycle_drill_tool_on_the_cpu(monkeypatch, capsys):
    import json

    from radiorust_tpu_torch.tools import recycle_onchip
    monkeypatch.setenv("RECYCLE_RETENTION", "0")
    result = recycle_onchip.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == result
    # The JAX tool's fields (tools/recycle_onchip.py), and the port's.
    assert {"generations", "warmups_per_gen", "chunks", "chunks_per_worker",
            "samples_out", "max_abs_err_vs_single_gen", "bitwise_equal",
            "recycled_wall_s", "single_gen_wall_s", "ok", "gen_wall_s",
            "gen_devices", "gen_launches", "platform", "card"} <= set(result)
    assert result["ok"] and result["bitwise_equal"]
    assert result["generations"] == 2 and result["warmups_per_gen"] == [1, 0]
    assert result["samples_out"] == 8 * 2048
    assert (result["platform"], result["card"]) == ("cpu", "cpu")
    assert len(result["gen_wall_s"]) == 2 and "retention" not in result
    assert result["gen_devices"] == ["cpu", "cpu"]
    assert result["gen_launches"] == [{}, {}]
