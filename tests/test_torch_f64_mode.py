"""The c128 stream mode of the port (``RRTPU_STREAM_DTYPE=c128``), held
against the JAX package's c128 run and the f64 oracles of
``tests/test_f64_mode.py``.

Under c128 bound blocks carry float64 / complex128 params, state and
chunks end to end on the CPU, through the plain versions of the kernels.
One subprocess (the JAX side needs ``jax_enable_x64``, a process-global
flag) runs the same blocks of both packages on the same numpy inputs from
a seed and prints its measurements as JSON; the tests below read them:

- every output is complex128, the port within ``VS_JAX`` (max |d| / max
  |ref|) of the JAX package's c128 run and within ``VS_ORACLE`` of the
  f64 per-sample oracles (``tests/test_f64_mode.py``'s, copied);
- ``MixerDecimator.supported`` is false and a fused front end refuses at
  bind in both packages; the other fused blocks bind in both and the
  port's run in complex128;
- a ``RuntimeBlock`` and a ``PipelinedChain`` on CPU tensors carry
  complex128; a c128 checkpoint restores as c128;
- a params tree put on a CUDA device raises (no card is needed: the
  check comes before any CUDA call).

The c64 default is checked in this process: nothing changes under it.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from radiorust_tpu_torch import numbers
from radiorust_tpu_torch.blocks.base import Chain, StreamSig, scan
from radiorust_tpu_torch.blocks.filters import Filter
from radiorust_tpu_torch.blocks.modulation import FmDemod
from radiorust_tpu_torch.blocks.transform import FreqShifter, GainControl
from radiorust_tpu_torch.convert import tree_to_torch

REPO = pathlib.Path(__file__).resolve().parents[1]
VS_JAX = 1e-9       # port vs the JAX package's c128 run (max-rel)
VS_ORACLE = 1e-10   # port vs the f64 oracles (tests/test_f64_mode.py)

SCRIPT = r"""
import asyncio, json, os, sys, tempfile
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch

import radiorust_tpu.blocks.base as jb
import radiorust_tpu.blocks.filters as jf
import radiorust_tpu.blocks.frontend as jfe
import radiorust_tpu.blocks.modulation as jm
import radiorust_tpu.blocks.resampling as jr
import radiorust_tpu.blocks.transform as jt
from radiorust_tpu import numbers as jnum
from radiorust_tpu.models.wfm import wfm_receiver as jwfm
from radiorust_tpu.windowing import Kaiser as JKaiser

import radiorust_tpu_torch.blocks.base as tb
import radiorust_tpu_torch.blocks.filters as tf
import radiorust_tpu_torch.blocks.frontend as tfe
import radiorust_tpu_torch.blocks.modulation as tm
import radiorust_tpu_torch.blocks.resampling as tr
import radiorust_tpu_torch.blocks.transform as tt
from radiorust_tpu_torch import numbers as tnum
from radiorust_tpu_torch.blocks.channelize import Channelizer, ChannelizerDemod
from radiorust_tpu_torch.blocks.graph import Graph, graph_scan
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.models.wfm import wfm_receiver as twfm
from radiorust_tpu_torch.ops.polyphase import design_ir
from radiorust_tpu_torch.parallel.pipeline import PipelinedChain
from radiorust_tpu_torch.utils.checkpoint import load_state, save_state
from radiorust_tpu_torch.windowing import Kaiser

out = {"mode": [jnum.stream_mode(), tnum.stream_mode()]}
rng = np.random.default_rng(0)
batch, n, rate = 2, 2048, 384000.0
x = (rng.standard_normal((3, batch, n))
     + 1j * rng.standard_normal((3, batch, n))).astype(np.complex128)
xs = x[0, 0]
CPU = "cpu"

def lp(bins, freqs):
    return np.where(np.abs(freqs) <= 100000.0, 1.0 + 0.0j, 0.0j)

def dtypes(tree):
    return sorted({str(np.asarray(v).dtype) for v in
                   jax.tree.leaves(tree_to_numpy(tree))})

def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))

def port_run(block, sig, chunks):
    b = block.bind(sig)
    p, st = tree_to_torch(b.params, CPU), tree_to_torch(b.init_state(), CPU)
    ys = []
    for c in chunks:
        st, y = b.process(p, st, torch.from_numpy(c),
                          torch.zeros((sig.batch,), dtype=torch.bool))
        ys.append(y)
    return b, torch.stack(ys).numpy(), st

def jax_run(block, sig, chunks):
    b = block.bind(sig)
    st = b.init_state()
    ys = []
    for c in chunks:
        st, y = b.process(b.params, st, jnp.asarray(c),
                          jnp.zeros((sig.batch,), bool))
        ys.append(np.asarray(y))
    return np.stack(ys)

sig = tb.StreamSig(batch, n, rate)
jsig = jb.StreamSig(batch, n, rate)
cases = {
    "FreqShifter": (tt.FreqShifter.with_shift(-57000.0),
                    jt.FreqShifter.with_shift(-57000.0)),
    "Filter": (tf.Filter.new(lp), jf.Filter.new(lp)),
    "Filter_ir512": (tf.Filter.new(lp, ir_len=512),
                     jf.Filter.new(lp, ir_len=512)),
    "FmDemod": (tm.FmDemod(150000.0), jm.FmDemod(150000.0)),
    "Downsampler": (tr.Downsampler(48000.0, 40000.0),
                    jr.Downsampler(48000.0, 40000.0)),
    "GainControl": (tt.GainControl(0.5), jt.GainControl(0.5)),
    "Squelch": (tt.Squelch(1e-1, 0.999), jt.Squelch(1e-1, 0.999)),
    "AgcControl": (tt.AgcControl(1.0, 1e-3, 64.0),
                   jt.AgcControl(1.0, 1e-3, 64.0)),
    "SlewRateLimiter": (tf.SlewRateLimiter(100000.0),
                        jf.SlewRateLimiter(100000.0)),
    "FmMod": (tm.FmMod(2500.0), jm.FmMod(2500.0)),
}
res = {}
port_y = {}
for name, (tblk, jblk) in cases.items():
    b, got, _ = port_run(tblk, sig, x[:2])
    want = jax_run(jblk, jsig, x[:2])
    port_y[name] = got
    res[name] = {"dtype": str(got.dtype), "vs_jax": rel(got, want),
                 "params": dtypes(b.params), "state": dtypes(b.init_state())}

# Phase mode: 1024 -> 384 at chunk 100 (not whole periods).
psig = tb.StreamSig(1, 100, 1024.0)
xp = (rng.standard_normal((6, 1, 100))
      + 1j * rng.standard_normal((6, 1, 100))).astype(np.complex128)
dn, got_p, _ = port_run(tr.Downsampler(384.0, 200.0), psig, xp)
assert dn.phase_mode
want_p = jax_run(jr.Downsampler(384.0, 200.0), jb.StreamSig(1, 100, 1024.0),
                 xp)
res["Downsampler_phase"] = {"dtype": str(got_p.dtype),
                            "vs_jax": rel(got_p, want_p),
                            "params": dtypes(dn.params),
                            "state": dtypes(dn.init_state())}
out["blocks"] = res

# --- the f64 oracles of tests/test_f64_mode.py ------------------------------
orc = {}
thr, alpha = 1e-1, 0.999
e = 0.0
want = np.empty(n, np.complex128)
for i, s in enumerate(xs):
    e = alpha * e + (1.0 - alpha) * abs(s) ** 2
    want[i] = s if e > thr else 0.0
orc["Squelch"] = float(np.abs(port_y["Squelch"][0, 0] - want).max())
g = 1.0
want = np.empty(n, np.complex128)
for i, s in enumerate(xs):
    want[i] = s * g
    g = min(max(g + 1e-3 * (1.0 - abs(want[i])), 0.0), 64.0)
orc["AgcControl"] = float(np.abs(port_y["AgcControl"][0, 0] - want).max())
md = 100000.0 / rate
prev = 0.0 + 0.0j
want = np.empty(n, np.complex128)
for i, s in enumerate(xs):
    diff = s - prev
    nr = abs(diff)
    if nr > md:
        s = prev + diff / nr * md
    want[i] = s
    prev = s
orc["SlewRateLimiter"] = float(
    np.abs(port_y["SlewRateLimiter"][0, 0] - want).max())
fac = 2500.0 / rate * 2 * np.pi
theta = np.mod(np.cumsum(xs.real) * fac, 2 * np.pi)
want = np.cos(theta) + 1j * np.sin(theta)
orc["FmMod"] = float(np.abs(port_y["FmMod"][0, 0] - want).max())
for name, m in (("Filter", n), ("Filter_ir512", 512)):
    ir = tf.design_impulse_response(lp, Kaiser.with_null_at_bin(2.0), m,
                                    rate)
    resp = tf.extend_response(ir, pad=n)
    prev = np.zeros((batch, m), np.complex128)
    errs = []
    for t in range(2):
        w = np.fft.ifft(np.fft.fft(np.concatenate([prev, x[t]], axis=-1))
                        * resp)[..., :n]
        errs.append(rel(port_y[name][t], w))
        prev = x[t][..., n - m:]
    orc[name] = max(errs)
vc = dn.valid_counts(0, 6)
got_flat = np.concatenate([o[0, :v] for o, v in zip(got_p, vc)])
irp = design_ir(1024.0, 384.0, (384.0 - 200.0) / 2.0, 3.0)
L = len(irp)
ring = np.zeros(L, np.complex128)
rpos, pos, ref = 0, 0.0, []
for s in xp[:, 0, :].reshape(-1):
    ring[rpos] = s
    rpos += 1
    if rpos == L:
        rpos = 0
    pos += 384.0
    if pos >= 1024.0:
        pos -= 1024.0
        ref.append(np.sum(np.concatenate([ring[rpos:], ring[:rpos]]) * irp))
ref = np.array(ref, np.complex128)
orc["Downsampler_phase"] = float(np.abs(got_flat - ref[:len(got_flat)]).max())
out["oracles"] = orc

# --- a receive chain, and the gates of the fused blocks ---------------------
chain = tb.Chain(tt.FreqShifter.with_shift(-57000.0), tf.Filter.new(lp),
                 tm.FmDemod(150000.0), tr.Downsampler(48000.0, 40000.0),
                 tt.GainControl(0.5))
cb = chain.bind(sig)
_, ys = tb.scan(cb, tree_to_torch(cb.params, CPU),
                tree_to_torch(cb.init_state(), CPU), torch.from_numpy(x))
out["chain"] = {"dtype": str(ys.dtype),
                "finite": bool(torch.isfinite(ys.real).all())}

def binds(fn):
    try:
        fn()
        return "binds"
    except ValueError as err:
        return "refuses: " + str(err)[:80]

wsig = (2, 24576, 1024000.0)

def supported_under_c128(mod, nums, sig_cls):
    # Bound under c64, asked under c128: the gate reads the mode.
    nums.set_stream_mode("c64")
    try:
        b = mod.MixerDecimator(100e3, 384e3, 200e3).bind(sig_cls(*wsig))
        ok64 = bool(b.supported(sig_cls(*wsig)))
    finally:
        nums.set_stream_mode(None)
    return [ok64, bool(b.supported(sig_cls(*wsig)))]

gates = {
    "mixdec_supported_port": supported_under_c128(tfe, tnum, tb.StreamSig),
    "mixdec_supported_jax": supported_under_c128(jfe, jnum, jb.StreamSig),
    "mixdec_port": binds(lambda: tfe.MixerDecimator(100e3, 384e3, 200e3)
                         .bind(tb.StreamSig(*wsig))),
    "mixdec_jax": binds(lambda: jfe.MixerDecimator(100e3, 384e3, 200e3)
                        .bind(jb.StreamSig(*wsig))),
    "wfm_fused_port": binds(lambda: twfm(fuse_frontend=True)
                            .bind(tb.StreamSig(*wsig))),
    "wfm_fused_jax": binds(lambda: jwfm(fuse_frontend=True)
                           .bind(jb.StreamSig(*wsig))),
}
fused = {}
fsig = tb.StreamSig(2, 2048, 384000.0)
for name, blk in (
        ("FmDemodFilter", tfe.FmDemodFilter(75000.0, lp)),
        ("FilterDemodFilter", tfe.FilterDemodFilter(lp, 75000.0, lp)),
        ("Channelizer", Channelizer(64)),
        ("ChannelizerDemod", ChannelizerDemod(64, 75000.0))):
    s = (tb.StreamSig(2, 4096, 16.384e6) if "Channelizer" in name else fsig)
    xc = (rng.standard_normal((2, 2, s.chunk_len))
          + 1j * rng.standard_normal((2, 2, s.chunk_len)))
    b, y, _ = port_run(blk, s, xc)
    fused[name] = {"dtype": str(y.dtype),
                   "finite": bool(np.isfinite(y).all()),
                   "params": dtypes(b.params),
                   "state": dtypes(b.init_state())}
    if name == "FmDemodFilter":
        # Against the unfused pair it equals, also in complex128.
        from radiorust_tpu_torch.windowing import Rectangular
        _, yu, _ = port_run(tb.Chain(tm.FmDemod(75000.0),
                                     tf.Filter(lp, Rectangular())), s, xc)
        fused[name]["vs_unfused"] = rel(y[1:], yu[1:])
g = Graph()
i = g.input("iq")
lo, hi = g.bank(tf.FilterBank([lp, lp]), i)
g.output("a", lo)
g.output("b", hi)
bg = g.bind({"iq": fsig})
_, gy = graph_scan(bg, tree_to_torch(bg.params, CPU),
                   tree_to_torch(bg.init_state(), CPU),
                   {"iq": torch.from_numpy(x[:2])})
fused["FilterBank"] = {"dtype": str(gy["a"].dtype),
                       "finite": bool(torch.isfinite(gy["a"].real).all()),
                       "params": dtypes(bg.params),
                       "state": dtypes(bg.init_state())}
gates["fused"] = fused
out["gates"] = gates

# --- the runtime, the pipeline, checkpoints ---------------------------------
from radiorust_tpu_torch.runtime import ArraySink, ArraySource, RuntimeBlock

async def actor():
    data = x[:, 0, :].reshape(-1)
    src = ArraySource(data, chunk_len=n, sample_rate=rate)
    rb = RuntimeBlock(tb.Chain(tt.FreqShifter.with_shift(-57000.0),
                               tf.Filter.new(lp)), device=CPU)
    sink = ArraySink()
    rb.feed_from(src)
    sink.feed_from(rb)
    for _ in range(2000):
        if len(sink.samples) >= len(data):
            break
        await asyncio.sleep(0.01)
    return sink
sink = asyncio.run(asyncio.wait_for(actor(), 120), debug=True)
ab = tb.Chain(tt.FreqShifter.with_shift(-57000.0), tf.Filter.new(lp)).bind(
    tb.StreamSig(1, n, rate))
_, want = tb.scan(ab, tree_to_torch(ab.params, CPU),
                  tree_to_torch(ab.init_state(), CPU),
                  torch.from_numpy(x[:, :1, :]))
got = np.stack(sink.chunks)
out["runtime"] = {"dtypes": sorted({str(c.dtype) for c in sink.chunks}),
                  "vs_scan": rel(got, want.numpy()[:, 0])}

pc = PipelinedChain(cb, devices=[CPU, CPU])
py = pc.run(torch.from_numpy(x))
_, sy = tb.scan(cb, tree_to_torch(cb.params, CPU),
                tree_to_torch(cb.init_state(), CPU), torch.from_numpy(x))
out["pipeline"] = {"dtype": str(py.dtype),
                   "equal": bool(torch.equal(py, sy))}

st, _ = tb.scan(cb, tree_to_torch(cb.params, CPU),
                tree_to_torch(cb.init_state(), CPU), torch.from_numpy(x[:1]))
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "c128.npz")
    save_state(path, st)
    back = load_state(path)
out["checkpoint"] = {"saved": dtypes(st), "restored": dtypes(back),
                     "equal": all(np.array_equal(np.asarray(a), b) for a, b
                                  in zip(jax.tree.leaves(tree_to_numpy(st)),
                                         jax.tree.leaves(back)))}

# --- CUDA under c128 raises where a tree reaches the device -----------------
try:
    tree_to_torch(cb.params, "cuda")
    out["cuda"] = "no raise"
except RuntimeError as err:
    out["cuda"] = str(err)
print("F64JSON " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def c128():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"RRTPU_STREAM_DTYPE": "c128", "JAX_PLATFORMS": "cpu",
                "RRTPU_MATMUL_PRECISION": "highest",
                "PYTHONPATH": str(REPO)})
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("F64JSON "))
    return json.loads(line[len("F64JSON "):])


BLOCKS = ["FreqShifter", "Filter", "Filter_ir512", "FmDemod", "Downsampler",
          "Downsampler_phase", "GainControl", "Squelch", "AgcControl",
          "SlewRateLimiter", "FmMod"]


def test_both_packages_read_c128(c128):
    assert c128["mode"] == ["c128", "c128"]


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_the_jax_c128_run(c128, name):
    r = c128["blocks"][name]
    assert r["dtype"] == "complex128", r
    assert r["vs_jax"] <= VS_JAX, r
    # Params and state take the mode's dtypes (integers stay integers).
    for leaf in r["params"] + r["state"]:
        assert leaf not in ("float32", "complex64"), r


@pytest.mark.parametrize("name", ["Squelch", "AgcControl",
                                  "SlewRateLimiter", "FmMod", "Filter",
                                  "Filter_ir512", "Downsampler_phase"])
def test_block_matches_the_f64_oracle(c128, name):
    assert c128["oracles"][name] < VS_ORACLE, c128["oracles"]


def test_receive_chain_runs_complex128(c128):
    assert c128["chain"] == {"dtype": "torch.complex128", "finite": True}


def test_fused_front_end_refuses_in_both_packages(c128):
    g = c128["gates"]
    # MixerDecimator.supported: true bound and asked under c64, false
    # asked under c128, in both packages.
    assert g["mixdec_supported_port"] == [True, False]
    assert g["mixdec_supported_jax"] == [True, False]
    for key in ("mixdec_port", "mixdec_jax", "wfm_fused_port",
                "wfm_fused_jax"):
        assert g[key].startswith("refuses"), (key, g[key])
        assert "FreqShifter + Downsampler" in g[key], (key, g[key])


@pytest.mark.parametrize("name", ["FmDemodFilter", "FilterDemodFilter",
                                  "FilterBank", "Channelizer",
                                  "ChannelizerDemod"])
def test_other_fused_blocks_bind_and_run_complex128(c128, name):
    r = c128["gates"]["fused"][name]
    assert r["dtype"] in ("complex128", "torch.complex128"), r
    assert r["finite"], r
    for leaf in r["params"] + r["state"]:
        assert leaf not in ("float32", "complex64"), r
    if name == "FmDemodFilter":
        assert r["vs_unfused"] <= VS_JAX, r


def test_runtime_block_and_pipeline_carry_complex128(c128):
    assert c128["runtime"]["dtypes"] == ["complex128"], c128["runtime"]
    assert c128["runtime"]["vs_scan"] == 0.0, c128["runtime"]
    assert c128["pipeline"] == {"dtype": "torch.complex128", "equal": True}


def test_c128_checkpoint_restores_as_c128(c128):
    ck = c128["checkpoint"]
    assert ck["equal"], ck
    assert ck["restored"] == ck["saved"], ck
    assert "complex128" in ck["saved"] and "complex64" not in ck["saved"]


def test_cuda_raises_under_c128(c128):
    assert "c128" in c128["cuda"] and "cuda" in c128["cuda"], c128["cuda"]


def test_c64_default_is_unchanged(monkeypatch):
    monkeypatch.delenv("RRTPU_STREAM_DTYPE", raising=False)
    numbers.set_stream_mode(None)
    assert numbers.stream_mode() == "c64"
    assert numbers.stream_real() is np.float32
    assert numbers.stream_complex() is np.complex64
    numbers.check_device("cuda")           # no raise under c64
    sig = StreamSig(2, 512, 384000.0)
    chain = Chain(FreqShifter.with_shift(-57000.0), Filter.new(lambda b, f:
                  np.where(np.abs(f) <= 1e5, 1.0 + 0j, 0j)),
                  FmDemod(150000.0), GainControl(0.5))
    b = chain.bind(sig)
    x = torch.from_numpy(np.exp(1j * np.arange(2 * 2 * 512).reshape(
        2, 2, 512) * 0.01).astype(np.complex64))
    _, ys = scan(b, tree_to_torch(b.params, "cpu"),
                 tree_to_torch(b.init_state(), "cpu"), x)
    assert ys.dtype == torch.complex64


def test_set_stream_mode_round_trip(monkeypatch):
    monkeypatch.delenv("RRTPU_STREAM_DTYPE", raising=False)
    try:
        numbers.set_stream_mode("C128")
        assert numbers.stream_mode() == "c128"
        assert numbers.as_stream_complex([1 + 1j]).dtype == np.complex128
        assert numbers.as_stream_real([1.0]).dtype == np.float64
        with pytest.raises(RuntimeError, match="c128"):
            numbers.check_device(torch.device("cuda", 0))
        numbers.check_device("cpu")
        with pytest.raises(ValueError):
            numbers.set_stream_mode("c32")
    finally:
        numbers.set_stream_mode(None)
    assert numbers.stream_mode() == "c64"
    monkeypatch.setenv("RRTPU_STREAM_DTYPE", "f16")
    with pytest.raises(ValueError, match="RRTPU_STREAM_DTYPE"):
        numbers.stream_mode()
    assert numbers.DESIGN_REAL_DTYPE is np.float64
    assert numbers.DESIGN_COMPLEX_DTYPE is np.complex128
