"""The port's measurement tools (``radiorust_tpu_torch/tools/``), on the
CPU.

1. Each tool runs as ``python -m radiorust_tpu_torch.tools.<name> --device
   cpu`` at a tiny size; its JSON lines carry every field of the JAX
   tool's lines (read from ``tools/<name>.py``) but the TPU-only ones,
   with finite numbers, and the soak's checks pass.
2. Without a card each tool raises.
3. Each tool's ``build`` binds the same chain as the JAX tool's: bound
   through the JAX package by the same ``build`` and stepped on the same
   numpy input (the validate models' signals, or an FM tone), the port on
   CPU tensors matches it past the chain's warm-up within the bounds of
   ``PERF.md`` section 2.
"""

import ast
import importlib
import json
import math
import os
import pathlib
import subprocess
import sys

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiorust_tpu import config
from radiorust_tpu.blocks.base import scan as jscan
from radiorust_tpu.blocks.graph import graph_scan as jgraph_scan
from radiorust_tpu_torch import validate
from radiorust_tpu_torch.blocks.base import scan
from radiorust_tpu_torch.blocks.graph import graph_scan
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.tools import (bench_channelizer, bench_configs,
                                       bench_latency, bench_serving, soak)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ("bench_configs", "bench_latency", "bench_channelizer", "soak",
         "bench_serving")
# Fields of the JAX tools' lines that belong to the TPU: the relay's
# retention allowance (soak) and the after-failure marker (a failed
# config raises in the port).
TPU_ONLY = {"relay_retention_allowance_mb", "after_failure"}
# The tiny CPU sizes, one torch thread a tool.  The soak's checks read
# wall-clock rates, which other processes on a shared CPU move: its
# source is paced at its sample rate (SOAK_THROTTLE=1, so that the rate
# checks ask whether the stack keeps real time) and it runs at a raised
# priority (``nice -n -10``) where the system allows one.
ENV = {"BENCH_BATCH": "2", "BENCH_T": "2", "BENCH_REPS": "1",
       "BENCH_CHUNK": "4096", "SOAK_SECONDS": "12", "SOAK_THROTTLE": "1",
       "SERVE_CHUNKS": "2", "OMP_NUM_THREADS": "1"}
ARGS = {"bench_configs": bench_configs.CONFIGS}


def jax_fields(tool: str) -> set:
    """The string keys of the JSON records the JAX tool prints: every
    dict literal of ``tools/<tool>.py`` keyed by "metric", "variant" or
    "ok"."""
    tree = ast.parse((REPO / "tools" / f"{tool}.py").read_text())
    fields = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and all(
                isinstance(k, ast.Constant) for k in node.keys):
            keys = {k.value for k in node.keys}
            if keys & {"metric", "variant", "ok"}:
                fields |= keys
    # A record's keys set after the literal (rec["..."] = ...).
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", None) == "rec"):
            fields.add(node.targets[0].slice.value)
    return fields


def _records(stdout: str, tool: str) -> list:
    if tool == "soak":
        return [json.loads(stdout)]
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def _finite(value) -> bool:
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return math.isfinite(value)
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, list):
        return all(_finite(v) for v in value)
    return True


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_runs_on_the_cpu_with_the_jax_fields(tool, tmp_path):
    env = dict(os.environ, **ENV)
    env.pop("PYTHONPATH", None)
    env["PYTHONPATH"] = str(REPO)
    out = tmp_path / "soak.json"
    cmd = [sys.executable, "-m", f"radiorust_tpu_torch.tools.{tool}",
           *ARGS.get(tool, ()), "--device", "cpu"]
    if tool == "soak":
        # nice runs the command at its own priority where it may not
        # raise it.
        cmd = ["nice", "-n", "-10", *cmd, "--out", str(out)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    records = _records(proc.stdout, tool)
    want = {"bench_configs": len(bench_configs.CONFIGS),
            "bench_latency": len(bench_latency.CONFIGS),
            "bench_channelizer": 1, "soak": 1,
            "bench_serving": len(bench_serving.VARIANTS)}[tool]
    assert len(records) == want, proc.stdout
    fields = jax_fields(tool) - TPU_ONLY
    assert fields, tool
    for rec in records:
        assert fields <= set(rec), (tool, fields - set(rec))
        assert rec["platform"] == "cpu" and rec["device"] == "cpu"
        assert _finite(rec), rec
        if "checksum" in rec:
            assert rec["checksum"] > 0
    if tool == "soak":
        rec = dict(records[0], probes=None)
        assert rec["ok"] and rec["throughput_ok"] and rec["rss_ok"], rec
        assert rec["queue_ok"] and rec["chunks_processed"] > 10, rec
        assert rec["throttled"] is True
        # Sink samples are 48 kHz audio, 3/64 of the input, give or take
        # the chunks in flight (tests/test_soak.py's bound).
        expect = rec["chunks_processed"] * rec["chunk"] * 3 // 64
        assert abs(rec["sink_samples"] - expect) <= 3 * rec["chunk"], rec
        assert rec["device_mem_growth_mb"] is None      # no card
        assert json.loads(out.read_text())["ok"]
    if tool == "bench_channelizer":
        assert records[0]["baseline"]["msps"] == json.loads(
            (REPO / "CHANNELIZER_BASELINE.json").read_text())[
                "channelizer_pipelined_msps"]
    # Nothing is written beside the run but what --out names.
    assert {p.name for p in tmp_path.iterdir()} <= {"soak.json"}


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"radiorust_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_a_failing_config_raises():
    with pytest.raises(ValueError, match="unknown config"):
        bench_configs.main(["nonesuch", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown variants"):
        bench_serving.main(["chunk1_depth0_x1", "--device", "cpu"])


# --- the same chains as the JAX tools' ---------------------------------------

@pytest.fixture
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


def jax_lib(name):
    return importlib.import_module(f"radiorust_tpu.{name}")


def fm_tone(batch: int, n: int) -> np.ndarray:
    """[4, batch, n]: an FM carrier at DC, a 1 kHz tone at 1.024 Msps."""
    return validate._carriers(n, 1024000.0, ((0, 1000.0, 1.0),), 1024,
                              75000.0, batch, 0.5)


# (tool, config): (bind(lib) -> (bound, graph?), input [T, batch, n],
# bound: max |d| / max |ref| past the warm-up).  The WFM and stereo
# chains are held to the WFM path's 3e-4 (PERF.md section 2), the
# channelizer to path D's 2e-5, morse_rf to 1e-2 (FmMod's carried phase,
# path J's), the bandwidth meter's hertz to path L's 9e-3.
def _cfg(name, batch):
    def bind(lib):
        b, _, graph, post = bench_configs.build(name, batch, lib)
        return b, graph, post
    return bind


def _lat(name, batch):
    def bind(lib):
        b, _, _, graph = bench_latency.build(name, batch, lib)
        return b, graph, None
    return bind


def _spec(make, batch, n, rate=1024000.0):
    def bind(lib):
        spec = make(lib)
        return spec.bind(lib("blocks.base").StreamSig(batch, n, rate)), \
            False, None
    return bind


def _vx(model, batch):
    """The validate model's input, its first ``batch`` streams."""
    return lambda: validate.build(model).xs[:, :batch]


def _fm(batch, n):
    return lambda: fm_tone(batch, n)


CASES = {
    ("bench_configs", "morse"): (
        _cfg("morse", 2), _vx("morse", 2), 3e-4),
    ("bench_configs", "morse_rf"): (
        _cfg("morse_rf", 2), _vx("morse_rf", 2), 1e-2),
    ("bench_configs", "audiopipe"): (
        _cfg("audiopipe", 2), _vx("audiopipe", 2), 3e-4),
    ("bench_configs", "bw_meter"): (
        _cfg("bw_meter", 2), _vx("bw_meter", 2), 9e-3),
    ("bench_configs", "stereo"): (
        _cfg("stereo", 2), _vx("stereo", 2), 3e-4),
    ("bench_configs", "stereo_wide"): (
        _cfg("stereo_wide", 2), _vx("stereo_wide", 2),
        3e-4),
    ("bench_latency", "wfm"): (_lat("wfm", 1), _fm(1, 16384), 3e-4),
    ("bench_latency", "wfm_wide"): (
        _lat("wfm_wide", 1), _fm(1, 24576), 3e-4),
    ("bench_latency", "wfm_unfused"): (
        _lat("wfm_unfused", 1), _fm(1, 16384), 3e-4),
    ("bench_latency", "stereo"): (
        _lat("stereo", 1), _vx("stereo", 1), 3e-4),
    ("bench_channelizer", "channelizer64"): (
        lambda lib: (bench_channelizer.build(1, 65536, lib), False, None),
        _vx("channelizer", 1), 2e-5),
    ("soak", "wfm"): (
        _spec(lambda lib: soak.build(lib=lib), 1, 24576),
        _fm(1, 24576), 3e-4),
    ("bench_serving", "wfm"): (
        _spec(lambda lib: bench_serving.build(lib), 1, 16384),
        _fm(1, 16384), 3e-4),
}


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: "-".join(c))
def test_build_binds_the_jax_tools_chain(case, interpret_pallas_highest):
    bind, make_xs, bound_rel = CASES[case]
    xs = make_xs()
    tb, graph, post = bind(validate.port_lib)
    jb, jgraph, jpost = bind(jax_lib)
    assert graph == jgraph
    assert type(tb).__name__ == type(jb).__name__
    if graph:
        assert sorted(tb.out_sigs) == sorted(jb.out_sigs)
    else:
        assert (tb.out_sig.batch, tb.out_sig.chunk_len,
                tb.out_sig.sample_rate) == (jb.out_sig.batch,
                                            jb.out_sig.chunk_len,
                                            jb.out_sig.sample_rate)
        assert [type(b).__name__ for b in tb.blocks] == \
            [type(b).__name__ for b in jb.blocks]
    # Steps past the warm-up: the chain's valid_from (a graph's latest
    # output's), then one more.
    vf = (max(tb.valid_from.values()) if isinstance(tb.valid_from, dict)
          else tb.valid_from)
    t = min(vf + 1, xs.shape[0])
    xs = np.ascontiguousarray(xs[:t])
    if graph:
        _, want = jgraph_scan(jb, jb.params, jb.init_state(),
                              {"iq": jnp.asarray(xs)})
        _, got = graph_scan(tb, tree_to_torch(tb.params, "cpu"),
                            tree_to_torch(tb.init_state(), "cpu"),
                            {"iq": torch.from_numpy(xs)})
        pairs = [(got[k], want[k]) for k in sorted(want)]
    else:
        _, want = jscan(jb, jb.params, jb.init_state(), jnp.asarray(xs))
        _, got = scan(tb, tree_to_torch(tb.params, "cpu"),
                      tree_to_torch(tb.init_state(), "cpu"),
                      torch.from_numpy(xs))
        pairs = [(got, want)]
        if post is not None:
            # The bandwidth meter's hertz.
            bwm_t = validate.port_lib("models.bandwidth_meter")
            bwm_j = jax_lib("models.bandwidth_meter")
            rate = tb.out_sig.sample_rate
            pairs = [(bwm_t.measure_bandwidth(got, rate),
                      bwm_j.measure_bandwidth(want, rate))]
    v = vf if t > vf else t - 1
    for g, w in pairs:
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert np.all(np.isfinite(g))
        rel = _rel(g[v:], w[v:])
        assert rel <= bound_rel, (case, rel)
