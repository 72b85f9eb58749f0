"""The port's bench (``radiorust_tpu_torch/tools/bench.py``) and its
accounting (``radiorust_tpu_torch/tools/mfu.py``), on the CPU.

1. ``bench.build`` binds the JAX bench's chain (``bench.py``): the same
   blocks and output signature, and on an FM tone the port's output past
   the chain's warm-up is within path A's 3e-4 of the JAX chain's.
2. ``bench.main --device cpu`` at a tiny size prints one JSON line with
   every field of the JAX bench's records (read from ``bench.py``), all
   numbers finite, and writes no file; without a card the bench and the
   accounting raise, as does the bench without its baseline file.
3. ``mfu.analyze`` gives the JAX tool's stage list for each of its eight
   configs, and each stage's input, output and state bytes equal those of
   the JAX block (``jax.eval_shape``: nothing compiled).  Params are not
   compared: the JAX package's tables differ by the ground rules (the
   TPU's packed layouts).  The JAX ``tools/mfu.py`` itself is never
   imported (it sets ``JAX_PLATFORMS`` and the matmul precision when
   imported); its configs are built by name through ``mfu.config``.
4. The count functions give hand-counted values on tiny geometries.
5. The code's shape: ``chip_smoke.py`` keeps no peak, bound or count of
   its own and imports them from ``tools/mfu.py``; every root tool has
   its counterpart in the port or a reason in ``ROADMAP.md``; the
   ``collective_volumes`` measurements raise without a card and a
   device.
"""

import ast
import importlib
import json
import math
import pathlib
import types

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiorust_tpu import config as jconfig
from radiorust_tpu.blocks.base import scan as jscan
from radiorust_tpu_torch import validate
from radiorust_tpu_torch.blocks.base import scan
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.tools import bench, collective_volumes, mfu

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = {"BENCH_BATCH": "2", "BENCH_T": "2", "BENCH_REPS": "1",
        "BENCH_CHUNK": "16384"}
PATH_A_BOUND = 3e-4     # PERF.md section 2: a WFM path vs its reference


@pytest.fixture
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    jconfig.set_matmul_precision("highest")
    yield
    jconfig.set_matmul_precision(None)


def jax_lib(name):
    return importlib.import_module(f"radiorust_tpu.{name}")


# --- 1. the bench's chain ----------------------------------------------------

def test_build_binds_the_jax_bench_chain(interpret_pallas_highest):
    args = (2, 24576, 6144, True, True)
    tb, jb = bench.build(*args), bench.build(*args, lib=jax_lib)
    assert [type(b).__name__ for b in tb.blocks] == \
        [type(b).__name__ for b in jb.blocks]
    assert [type(b).__name__ for b in tb.blocks] == [
        "_BoundMixerDecimator", "_BoundFilter", "_BoundFmDemodFilter",
        "_BoundResampler", "_BoundGain"]
    assert (tb.out_sig.batch, tb.out_sig.chunk_len, tb.out_sig.sample_rate) \
        == (jb.out_sig.batch, jb.out_sig.chunk_len, jb.out_sig.sample_rate)
    assert tb.valid_from == jb.valid_from
    # An FM tone (tests/test_torch_tools.py's), steps to one past the
    # warm-up.
    xs = validate._carriers(24576, bench.RATE, ((0, 1000.0, 1.0),), 1024,
                            75000.0, 2, 0.5)[:tb.valid_from + 1]
    _, want = jscan(jb, jb.params, jb.init_state(), jnp.asarray(xs))
    _, got = scan(tb, tree_to_torch(tb.params, "cpu"),
                  tree_to_torch(tb.init_state(), "cpu"), torch.from_numpy(xs))
    got, want = got.numpy()[tb.valid_from:], np.asarray(want)[tb.valid_from:]
    assert np.all(np.isfinite(got))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= PATH_A_BOUND, rel


# --- 2. the bench's run -------------------------------------------------------

def jax_bench_fields() -> set:
    """The keys of the JAX bench's record dicts: each dict literal of
    ``bench.py`` keyed by "metric" or "mfu"."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fields = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            keys = {k.value for k in node.keys}
            if keys & {"metric", "mfu"}:
                fields |= keys
    return fields


def _finite(value) -> bool:
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return math.isfinite(value)
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, list):
        return all(_finite(v) for v in value)
    return True


def test_bench_runs_on_the_cpu_with_the_jax_fields(monkeypatch, capsys,
                                                   tmp_path):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    kept = {name: (REPO / name).read_bytes()
            for name in ("BASELINE_MEASURED.json", "MFU.json")}
    rec = bench.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    fields = jax_bench_fields()
    assert {"metric", "value", "vs_baseline", "mfu", "hbm_fraction",
            "achieved_tflops", "hbm_model_gbps"} <= fields
    assert fields <= set(rec), fields - set(rec)
    assert _finite(rec), rec
    assert rec["metric"] == "wfm_chain_input_throughput"
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    assert "card" not in rec
    assert rec["value"] > 0 and rec["checksum"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 25.472)
    # The accounting is mfu.analyze's of the chain timed, at 67 TFLOP/s
    # and 3.35 TB/s.
    acct = mfu.analyze("wfm", bench.build(2, 16384, 6144, True, True),
                       16384, bench.RATE, 2, "cpu")
    assert rec["flops_per_input_sample"] == acct["flops_per_input_sample"]
    assert rec["mfu"] == pytest.approx(rec["achieved_tflops"] / 67.0)
    assert rec["hbm_fraction"] == pytest.approx(rec["hbm_model_gbps"]
                                                / 3350.0)
    # It reads the baseline and writes nothing: not beside the run, not at
    # the repo's root.
    assert not list(tmp_path.iterdir())
    for name, data in kept.items():
        assert (REPO / name).read_bytes() == data, name


@pytest.mark.parametrize("tool", [bench, mfu], ids=["bench", "mfu"])
def test_the_tools_raise_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


def test_bench_raises_without_its_baseline(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "BASELINE_FILE", tmp_path / "missing.json")
    with pytest.raises(FileNotFoundError, match="missing.json"):
        bench.main(["--device", "cpu"])


def test_mfu_writes_only_with_out(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.chdir(tmp_path)
    recs = mfu.main(["morse", "--json-only", "--device", "cpu"])
    assert not list(tmp_path.iterdir())
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(ln) for ln in lines] == recs
    out = tmp_path / "mfu.json"
    mfu.main(["morse", "bw_meter", "--device", "cpu", "--out", str(out)])
    assert set(json.loads(out.read_text())) == {"morse", "bw_meter"}
    with pytest.raises(ValueError, match="unknown config"):
        mfu.main(["nonesuch", "--device", "cpu"])


# --- 3. the accounting against the JAX tool's stages ---------------------------

def _jax_bytes(tree) -> int:
    return int(sum(np.prod(leaf.shape, dtype=np.int64)
                   * np.dtype(leaf.dtype).itemsize
                   for leaf in jax.tree.leaves(tree)))


@pytest.mark.parametrize("name", mfu.CONFIGS)
def test_analyze_gives_the_jax_tools_stages(name, monkeypatch):
    for k in ("BENCH_CHUNK", "BENCH_IR", "BENCH_FUSE_FRONTEND",
              "BENCH_FUSE_DEMOD"):
        monkeypatch.delenv(k, raising=False)
    batch = 2
    spec, n, rate = mfu.config(name)
    rec = mfu.analyze(name, spec, n, rate, batch, "cpu")
    jspec, jn, jrate = mfu.config(name, lib=jax_lib)
    assert (jn, jrate) == (n, rate)
    assert rec["flops_per_step"] > 0 and rec["hbm_bytes_per_step"] > 0
    assert rec["peak_f32_tflops"] == 67.0 and rec["peak_hbm_gbps"] == 3350.0
    assert rec["matmul_precision"] == "float32"
    JSig = jax_lib("blocks.base").StreamSig
    x = jax.ShapeDtypeStruct((batch, n), jnp.complex64)
    if hasattr(jspec, "input"):
        jb = jspec.bind({"iq": JSig(batch, n, rate)})
        st = jb.init_state()
        _, y = jax.eval_shape(jb.process, jb.params, st, {"iq": x})
        assert rec["stages"] == []
        assert (rec["input_bytes"], rec["state_bytes"],
                rec["output_bytes"]) == (_jax_bytes(x), _jax_bytes(st),
                                         _jax_bytes(y))
        return
    jb = jspec.bind(JSig(batch, n, rate))
    want = []
    for blk in jb.blocks:
        st = blk.init_state()
        reset = jax.ShapeDtypeStruct((x.shape[0],), jnp.bool_)
        _, y = jax.eval_shape(blk.process, blk.params, st, x, reset)
        want.append((type(blk).__name__.lstrip("_"), _jax_bytes(x),
                     _jax_bytes(st), _jax_bytes(y)))
        x = y
    got = [(s["stage"], s["input_bytes"], s["state_bytes"],
            s["output_bytes"]) for s in rec["stages"]]
    assert got == want
    for s in rec["stages"]:
        assert s["hbm_bytes"] == (s["input_bytes"] + 2 * s["state_bytes"]
                                  + s["params_bytes"] + s["output_bytes"])
    assert rec["hbm_bytes_per_step"] == sum(s["hbm_bytes"]
                                            for s in rec["stages"])
    assert rec["flops_per_step"] == sum(s["flops"] for s in rec["stages"])


def test_analyze_counts_a_bound_chain_and_refuses_other_signatures():
    spec, n, rate = mfu.config("wfm")
    bound = bench.build(2, n, 6144, True, True)
    a = mfu.analyze("wfm", bound, n, rate, 2, "cpu")
    b = mfu.analyze("wfm", spec, n, rate, 2, "cpu")
    assert a["flops_per_step"] == b["flops_per_step"]
    assert a["hbm_bytes_per_step"] == b["hbm_bytes_per_step"]
    with pytest.raises(ValueError, match="bound at"):
        mfu.analyze("wfm", bound, n, rate, 4, "cpu")


def test_stage_flops_refuses_a_block_it_does_not_count():
    from radiorust_tpu_torch.blocks.base import StreamSig
    from radiorust_tpu_torch.blocks.transform import MapSample, Squelch
    sig = StreamSig(2, 64, 1000.0)
    with pytest.raises(TypeError, match="no count"):
        mfu.stage_flops(Squelch(0.5, 0.1).bind(sig))
    with pytest.raises(TypeError, match="no count for the sample map"):
        mfu.stage_flops(MapSample(lambda z: z * 2).bind(sig))


# --- 4. the counts by hand ---------------------------------------------------

def test_counts_on_tiny_geometries():
    # An 8-point FFT: 5 N log2 N = 5 * 8 * 3.
    assert mfu.fft_flops(8) == 120.0
    # A 4-tap 2:1 plan (one phase, q = 1) on an 8-sample chunk: 4 outputs
    # of 4 multiply-adds on each of 2 planes = 64; one plane, 32.
    plan = types.SimpleNamespace(p=2, q=1, kernel=np.array([[1., 2., 3., 4.]]))
    assert mfu.nonzero_taps(plan) == 4
    assert mfu.decimate_flops(plan, 1, 8) == 64
    assert mfu.decimate_flops(plan, 1, 8, planes=1) == 32
    # Phase mode: 3 valid outputs, 3 windows: 3 * 4 * 2 * 2.
    assert mfu.decimate_phase_flops(plan, 1, 3) == 48
    # The mixer adds 18 a sample: 64 + 18 * 8.
    assert mfu.mix_decimate_flops(plan, 1, 8) == 64 + 144
    # One overlap-save row of 8 points: forward 120, multiply 6 * 8,
    # inverse 120; a 2-band bank shares the forward transform.
    assert mfu.overlap_save_flops(1, 8) == 288.0
    assert mfu.filter_bank_flops(1, 8, 2) == 120 + 2 * (48 + 120)
    # #5 on 2 streams of 4 new samples, m = 4: 8 * 2 * 4 demods, one
    # paired 8-point row.
    assert mfu.demod_filter_flops(2, 4, 4) == 64 + 288
    # #6: a complex row each, the demods, one paired real row.
    assert mfu.filter_demod_filter_flops(2, 4, 4) == 2 * 288 + 64 + 288
    # #7: one frame of 8 branches at 2 taps: 4 * 2 * 8 + 120 + 8 * 8.
    assert mfu.pfb_demod_flops(1, 1, 2, 8) == 64 + 120 + 64
    assert mfu.slew_flops(2, 3) == 72 and mfu.agc_flops(2, 3) == 60
    # The bound: 3.35 GB at 3.35 TB/s is 1 ms, 67 GFLOP at 67 TFLOP/s too.
    assert mfu.bound_of(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert mfu.bound_of(1.0, 134e9) == (pytest.approx(2.0), "operations")
    # A tensor and its complex halves, passed twice, count once.
    z = torch.zeros(4, dtype=torch.complex64)
    assert mfu.io_bytes((z, z), (z.real,)) == 32 + 16


def test_stage_flops_of_the_bench_chain_are_its_kernels_counts():
    b = bench.build(2, 24576, 6144, True, True)
    mix, filt, demod, tail, gain = b.blocks
    n_mid = mix.out_sig.chunk_len
    assert mfu.stage_flops(mix) == mfu.mix_decimate_flops(mix.plan, 2, 24576)
    assert mfu.stage_flops(filt) == mfu.overlap_save_flops(2, n_mid + 6144)
    assert mfu.stage_flops(demod) == mfu.demod_filter_flops(2, 6144, n_mid)
    assert mfu.stage_flops(tail) == mfu.decimate_flops(tail.plan, 2, n_mid, 1)
    assert mfu.stage_flops(gain) == 2 * 2 * gain.in_sig.chunk_len
    assert mfu.stage_flops(b) == sum(mfu.stage_flops(x) for x in b.blocks)


# --- 5. the code's shape ------------------------------------------------------

def test_decimate_bytes_at_path_k_count_the_nonzero_taps_once():
    """#1's bytes at path K's phase-mode plan (384 kHz -> 44.1 kHz, chunk
    6144, 64 streams): the input, history, phase, outputs, new history
    and new phase, plus the plan's 147 x 285 nonzero taps once, whatever
    taps tensor the kernel is handed (the dense W, the polyphase
    re-layout or the wide form's bands)."""
    from radiorust_tpu_torch.ops import frontend as tfe
    from radiorust_tpu_torch.ops.polyphase import plan_downsample
    plan = plan_downsample(384000.0, 44100.0, 36000.0)
    q, kw = plan.kernel.shape
    assert (plan.p, q, kw, mfu.nonzero_taps(plan)) == (1280, 147, 1564,
                                                       147 * 285)
    b, n = 64, 6144
    x = torch.zeros((b, n), dtype=torch.complex64)
    h = torch.zeros((b, kw - 1), dtype=torch.complex64)
    ph = torch.zeros(b, dtype=torch.int32)
    y = torch.zeros((b, 5 * q), dtype=torch.complex64)
    want = (8 * b * (n + (kw - 1) + 5 * q + (kw - 1)) + 2 * 4 * b
            + 4 * 147 * 285)
    assert mfu.decimate_bytes(plan, (x, h, ph), (y, h.clone(),
                                                 ph.clone())) == want
    # The taps tensor a call passes changes nothing: only the plan counts.
    w = torch.from_numpy(plan.kernel)
    bands = tfe.wide_layout(plan.kernel).taps
    assert bands.size < w.numel() and 4 * 147 * 285 < 4 * w.numel()
    assert mfu.decimate_bytes(plan, (x, h, ph), (y, h.clone(), ph.clone()),
                              calls=3) == want + 2 * 4 * 147 * 285
    assert mfu.bound_of(want, mfu.decimate_phase_flops(plan, b, 4 * q))[1] \
        == "bytes"


def test_mix_decimate_counts_at_path_u1_read_the_wide_plan():
    """#2's counts at path U1's wide plan (2.048 MHz -> 240 kHz, p = 128,
    q = 15, Kw = 435, 64 x 16384): the operations over the plan's nonzero
    taps (each row a band of Kw), as ``stage_flops`` of the bound block
    reads them; the bytes those of the samples, history planes, phasor,
    outputs and new history, the nonzero taps once and the oscillator
    tables A and B (complex64, 128 each) once."""
    from radiorust_tpu_torch.blocks.base import StreamSig
    from radiorust_tpu_torch.blocks.frontend import MixerDecimator
    from radiorust_tpu_torch.ops import frontend as tfe
    b, n = 64, 16384
    blk = MixerDecimator(-300e3, 240e3, 200e3).bind(
        StreamSig(b, n, 2.048e6))
    plan = blk.plan
    q, kw = plan.kernel.shape
    nz = mfu.nonzero_taps(plan)
    assert (plan.p, q, kw, plan.hist) == (128, 15, 435, 307)
    assert not tfe.fits_block(plan.p, q, kw) and nz < q * kw
    want_flops = 2 * 2 * b * (n // 128) * nz + mfu.MIX_FLOPS * b * n
    assert mfu.mix_decimate_flops(plan, b, n) == want_flops
    assert mfu.stage_flops(blk) == want_flops
    ta, tb = (torch.from_numpy(blk.params[k]) for k in ("table_a",
                                                         "table_b"))
    assert ta.shape == tb.shape == (128,)
    x = torch.zeros((b, n), dtype=torch.complex64)
    hr, hi = torch.zeros((b, 307)), torch.zeros((b, 307))
    c0, s0 = torch.zeros(b), torch.zeros(b)
    y = torch.zeros((b, n // 128 * 15), dtype=torch.complex64)
    nh = torch.zeros((b, 307), dtype=torch.complex64)
    want = (8 * b * n + 2 * 4 * b * 307 + 2 * 4 * b + 8 * b * 1920
            + 8 * b * 307 + 4 * nz + 8 * (128 + 128))
    got = mfu.mix_decimate_bytes(plan, (x, hr, hi, c0, s0), (y, nh),
                                 (ta, tb))
    assert got == want
    assert mfu.mix_decimate_bytes(plan, (x, hr, hi, c0, s0), (y, nh),
                                  (ta, tb), calls=2) == want + 4 * nz \
        + 8 * 256
    assert mfu.bound_of(want, want_flops)[1] == "bytes"


def test_chip_smoke_takes_the_model_from_mfu():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    own = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            own.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name):
                        own.add(e.id)
    banned = {n for n in own if n.startswith("PEAK_") or n.endswith("_FLOPS")
              or n in ("bound_of", "fft_flops", "nonzero_taps", "io_bytes",
                       "tensors")}
    assert not banned, banned
    imported = {a.name for node in tree.body
                if isinstance(node, ast.ImportFrom)
                and node.module == "radiorust_tpu_torch.tools.mfu"
                for a in node.names}
    assert {"bound_of", "io_bytes", "tensors"} <= imported, imported
    # Every count it calls (a name ending in _flops) is mfu's.
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)
            and n.id.endswith("_flops") and isinstance(n.ctx, ast.Load)}
    local = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)
             and isinstance(n.ctx, ast.Store)} | {
        f.name for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)}
    assert used - local <= imported, used - local - imported
    assert {"decimate_flops", "mix_decimate_flops", "overlap_save_flops",
            "filter_bank_flops", "demod_filter_flops",
            "filter_demod_filter_flops", "pfb_demod_flops", "slew_flops",
            "agc_flops", "decimate_phase_flops"} <= imported
    # The bench keeps no peak of its own either.
    btree = ast.parse((REPO / "radiorust_tpu_torch" / "tools"
                       / "bench.py").read_text())
    consts = [n.targets[0].id for n in btree.body if isinstance(n, ast.Assign)
              and isinstance(n.targets[0], ast.Name)]
    assert not [c for c in consts if c.startswith("PEAK")
                or c.endswith("_FLOPS")], consts


# Root tools the port leaves out, with ROADMAP.md's ground rule for each:
# the TPU A/B experiments and relay probes, the relay's monitor and the
# on-chip recycling drill (ROADMAP.md, "Port behaviour, not TPU
# workarounds" and queue 1's settled recycling).
NOT_PORTED_TOOLS = {"exp_*": "TPU A/B experiments (ground rules)",
                    "probe_*": "TPU relay probes (ground rules)",
                    "relay_monitor.sh": "the TPU relay's monitor",
                    "recycle_onchip.py": "recycling, settled not ported"}
COUNTERPART = {"validate_tpu.py": "validate.py", "bench.py": "tools/bench.py"}


def test_every_root_tool_has_its_port_or_a_reason():
    import fnmatch
    port = REPO / "radiorust_tpu_torch"
    roots = sorted((REPO / "tools").iterdir()) + [REPO / "bench.py"]
    assert len(roots) > 10
    for path in roots:
        name = path.name
        if path.is_dir() or name.startswith("__"):
            continue
        if any(fnmatch.fnmatch(name, pat) for pat in NOT_PORTED_TOOLS):
            continue
        want = port / COUNTERPART.get(name, f"tools/{name}")
        assert want.exists(), f"{name}: no counterpart {want}"
    for name in ("mfu.py", "bench.py"):
        assert (port / "tools" / name).exists()


@pytest.mark.parametrize("fn", ["measure_time_sharded_wfm",
                                "measure_channel_sharded",
                                "measure_fused_time_sharded"])
def test_collective_volumes_raise_without_a_card(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(collective_volumes, fn)()
