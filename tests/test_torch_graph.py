"""The port's graph layer (Graph, FilterBank, MapSample, Combine) and the
stereo WFM receiver on CPU tensors against the JAX package's on the same
numpy inputs.

Tolerances: FilterBank bands atol 1e-5 (the JAX package's bank-vs-filter
bound); graphs and the stereo receiver atol 3e-4 from ``valid_from + 2``
(the JAX package's fused-vs-unfused WFM bound and its stereo tests' skip);
channel separation above 60 dB for the MPX decoder (``test_stereo.py``).
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_filter as pfl
import radiorust_tpu.ops.pallas_frontend as pfe
from radiorust_tpu import config
from radiorust_tpu.blocks.base import StreamSig as JSig
from radiorust_tpu.blocks.filters import FilterBank as JFilterBank
from radiorust_tpu.blocks.graph import Graph as JGraph
from radiorust_tpu.blocks.graph import graph_scan as jgraph_scan
from radiorust_tpu.blocks.transform import Combine as JCombine
from radiorust_tpu.blocks.transform import GainControl as JGain
from radiorust_tpu.blocks.transform import MapSample as JMapSample
from radiorust_tpu.blocks.transform import Nop as JNop
from radiorust_tpu.models.stereo import stereo_mpx_decoder as jstereo_mpx
from radiorust_tpu.models.stereo import wfm_stereo_receiver as jstereo_rx
from radiorust_tpu_torch.blocks.base import StreamSig
from radiorust_tpu_torch.blocks.filters import FilterBank
from radiorust_tpu_torch.blocks.graph import Graph, graph_scan, \
    linear_bound_graph
from radiorust_tpu_torch.blocks.transform import (Combine, GainControl,
                                                  MapSample, Nop)
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.models.stereo import (MPX_RATE, PILOT_FREQ,
                                               stereo_mpx_decoder,
                                               wfm_stereo_receiver)
from radiorust_tpu_torch.models.wfm import wfm_receiver
from radiorust_tpu_torch.ops import filter as tfl

ATOL = 3e-4
RATE = 1024000.0
F_L, F_R = 1000.0, 2500.0
STEREO = dict(tune_shift=100e3, fuse_frontend=True, filter_ir_len=6144)


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


def t(a):
    return torch.from_numpy(np.array(a))


def make_mpx(ts, a_l=0.8, a_r=0.5, pilot_phase=0.3):
    """Ground-truth stereo composite at sample times ``ts`` (seconds)."""
    left = a_l * np.sin(2 * np.pi * F_L * ts)
    right = a_r * np.sin(2 * np.pi * F_R * ts)
    th = 2 * np.pi * PILOT_FREQ * ts + pilot_phase
    return (0.5 * (left + right) + 0.5 * (left - right) * np.cos(2 * th)
            + 0.1 * np.cos(th))


def stereo_iq(t_chunks, n, offset=-100e3, deviation=150000.0):
    """[T, 2, n] complex64 FM of two stereo composites (L/R levels swapped
    on stream 1), carrier at ``offset`` Hz, synthesized in float64."""
    ts = np.arange(t_chunks * n) / RATE
    rows = []
    for a_l, a_r in ((0.25, 0.15), (0.15, 0.25)):
        mpx = make_mpx(ts, a_l, a_r)
        phase = (2 * np.pi * deviation / RATE * np.cumsum(mpx)
                 + 2 * np.pi * offset * ts)
        rows.append(np.exp(1j * phase).astype(np.complex64))
    return np.stack(rows).reshape(2, t_chunks, n).transpose(1, 0, 2)


def tone_peaks(channel, rate):
    n = len(channel)
    spec = np.abs(np.fft.rfft(channel * np.hanning(n)))
    freqs = np.fft.rfftfreq(n, 1.0 / rate)
    out = []
    for f in (F_L, F_R):
        i = int(np.argmin(np.abs(freqs - f)))
        out.append(float(spec[max(i - 2, 0): i + 3].max()))
    return out


def run_jax_graph(bg, xs, state=None):
    state = bg.init_state() if state is None else state
    state, ys = jgraph_scan(bg, bg.params, state,
                            {k: jnp.asarray(v) for k, v in xs.items()})
    return state, {k: np.asarray(v) for k, v in ys.items()}


def run_port_graph(bg, xs, params=None, state=None):
    params = tree_to_torch(bg.params if params is None else params, "cpu")
    state = tree_to_torch(bg.init_state() if state is None else state, "cpu")
    state, ys = graph_scan(bg, params, state,
                           {k: torch.from_numpy(v) for k, v in xs.items()})
    return state, {k: v.numpy() for k, v in ys.items()}


def _bands():
    def low(bins, freqs):
        return np.where(np.abs(freqs) <= 15000.0, 1.0 + 0j, 0j)

    def one_sided(bins, freqs):
        return np.where((freqs >= 18000.0) & (freqs <= 20000.0), 2.0 + 0j,
                        0j)

    def high(bins, freqs):
        return np.where(np.abs(freqs) >= 30000.0, 1.0 + 0j, 0j)
    return [low, one_sided, high]


@pytest.mark.parametrize("n,ir_len", [(1536, None), (1000, 600)])
def test_filter_bank_matches_jax(n, ir_len):
    # Both take the bank kernel's geometry (its plain version on the
    # CPU): 3072 = 24 x 128, and 1600 = 25 x 64 on 64-point rows.
    sig = (2, n, MPX_RATE)
    jb = JFilterBank(_bands(), ir_len=ir_len).bind(JSig(*sig))
    tb = FilterBank(_bands(), ir_len=ir_len).bind(StreamSig(*sig))
    assert tb.kernel_geometry == tfl.bank_supported(n, 3, tb.ir_len, 2)
    assert tb.kernel_geometry
    assert tb.num_outputs == 3 and tb.out_sigs == (StreamSig(*sig),) * 3
    np.testing.assert_array_equal(tb.params["responses"],
                                  jb.params["responses"])
    for real in (False, True):
        jb.input_is_real = tb.input_is_real = real
        assert tb.outputs_real == jb.outputs_real == (real, False, real)
    rng = np.random.default_rng(60)
    jstate, tstate = jb.init_state(), tree_to_torch(tb.init_state(), "cpu")
    params = tree_to_torch(jb.params, "cpu")
    for step in range(3):
        x = (rng.standard_normal((2, n))
             + 1j * rng.standard_normal((2, n))).astype(np.complex64)
        reset = np.asarray([step == 2, False])
        jstate, want = jb.process(jb.params, jstate, jnp.asarray(x), reset)
        tstate, got = tb.process(params, tstate, t(x), t(reset))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    narrow = [_bands()[0], _bands()[2]]
    for k, v in tb.update_params(narrow).items():
        np.testing.assert_array_equal(v, jb.update_params(narrow)[k])


def test_graph_refuses_what_jax_refuses():
    g = Graph()
    x = g.input("x")
    with pytest.raises(ValueError, match="duplicate input"):
        g.input("x")
    bands = g.bank(FilterBank(_bands()), x)
    bank_node = type(x)(bands[0].idx - 1)
    with pytest.raises(ValueError, match="bank node"):
        g.add(GainControl(1.0), bank_node)
    with pytest.raises(TypeError, match="fan-in"):
        g.add(GainControl(1.0), (bands[0], bands[1]))
    with pytest.raises(TypeError, match="multi-output"):
        g.bank(GainControl(1.0), x)
    g.output("y", bands[0])
    with pytest.raises(ValueError, match="duplicate output"):
        g.output("y", bands[1])
    with pytest.raises(ValueError, match="missing input"):
        g.bind({})
    # A fan-in node needs one reset origin.
    g2 = Graph()
    a, b = g2.input("a"), g2.input("b")
    g2.output("s", g2.add(Combine(lambda u, v: u + v), (a, b)))
    sig = StreamSig(1, 64, 1000.0)
    with pytest.raises(ValueError, match="one graph input"):
        g2.bind({"a": sig, "b": sig})
    with pytest.raises(ValueError, match="no outputs"):
        Graph().bind({})


def _small_graph(mod):
    """input -> Nop -> {MapSample(square), Gain} -> Combine(sum) and a
    parameterized real-output map; ``mod`` is the JAX or the port module
    set (Graph, Nop, MapSample, GainControl, Combine)."""
    G, NopB, Map, Gain, Comb, ops = mod
    g = G()
    x = g.input("x")
    nop = g.add(NopB(), x)
    sq = g.add(Map(lambda z: z * z), nop)
    gain = g.add(Gain(0.5), nop)
    g.output("sum", g.add(Comb(lambda u, v: u + v, preserves_real=True),
                          (sq, gain)))
    g.output("mag", g.add(Map.with_params(lambda z, p: ops(z) * p,
                                          np.float32(2.0),
                                          real_output=True), nop))
    return g


def test_small_graph_matches_jax():
    sig = (2, 256, 1000.0)
    jg = _small_graph((JGraph, JNop, JMapSample, JGain, JCombine,
                       jnp.abs)).bind(JSig(*sig))
    tg = _small_graph((Graph, Nop, MapSample, GainControl, Combine,
                       torch.abs)).bind(StreamSig(*sig))
    assert tg.valid_from == jg.valid_from
    rng = np.random.default_rng(61)
    xs = {"x": (rng.standard_normal((3, 2, 256))
                + 1j * rng.standard_normal((3, 2, 256))).astype(np.complex64)}
    _, want = run_jax_graph(jg, xs)
    _, got = run_port_graph(tg, xs, params=jg.params)
    for k in ("sum", "mag"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    assert np.all(got["mag"].imag == 0)
    # A chain in the graph shape runs like the chain.
    chain = wfm_receiver().bind(StreamSig(1, 16384, RATE))
    lg = linear_bound_graph(chain)
    assert lg.params[0] == () and lg.params[1:] == chain.params
    assert lg.valid_from == {"out": chain.valid_from}


def test_stereo_mpx_decoder_separation_and_matches_jax():
    n, t_chunks = 6144, 10
    ts = np.arange(t_chunks * n) / MPX_RATE
    mpx = make_mpx(ts).astype(np.complex64).reshape(t_chunks, 1, n)
    sigs = {"mpx": (1, n, MPX_RATE)}
    jg = jstereo_mpx().bind({k: JSig(*v) for k, v in sigs.items()})
    tg = stereo_mpx_decoder().bind({k: StreamSig(*v)
                                    for k, v in sigs.items()})
    assert tg.valid_from == jg.valid_from == {"stereo": 2, "pilot": 1}
    _, want = run_jax_graph(jg, {"mpx": mpx})
    _, got = run_port_graph(tg, {"mpx": mpx}, params=jg.params)
    skip = tg.valid_from["stereo"] + 2
    np.testing.assert_allclose(got["stereo"][skip:], want["stereo"][skip:],
                               atol=ATOL)
    p = tg.valid_from["pilot"] + 2
    np.testing.assert_allclose(got["pilot"][p:], want["pilot"][p:],
                               atol=ATOL)
    audio = got["stereo"][skip:, 0, :].reshape(-1)
    l_at_fl, l_at_fr = tone_peaks(audio.real, 48000.0)
    r_at_fl, r_at_fr = tone_peaks(audio.imag, 48000.0)
    assert 20 * np.log10(l_at_fl / (l_at_fr + 1e-9)) > 60.0
    assert 20 * np.log10(r_at_fr / (r_at_fl + 1e-9)) > 60.0


@pytest.fixture(scope="module")
def stereo_jax_run():
    """The JAX stereo receiver over 7 chunks of 2 x 24576, and its state
    after the first 3."""
    config.set_matmul_precision("highest")
    sig = {"iq": JSig(2, 24576, RATE)}
    xs = {"iq": stereo_iq(7, 24576)}
    jg = jstereo_rx(**STEREO).bind(sig)
    _, want = run_jax_graph(jg, xs)
    state3, _ = run_jax_graph(jg, {"iq": xs["iq"][:3]})
    config.set_matmul_precision(None)
    return jg, xs, want, state3


def test_wfm_stereo_receiver_matches_jax(stereo_jax_run):
    jg, xs, want, _ = stereo_jax_run
    tg = wfm_stereo_receiver(**STEREO).bind({"iq": StreamSig(2, 24576,
                                                             RATE)})
    assert tg.valid_from == jg.valid_from == {"stereo": 3, "pilot": 2}
    _, got = run_port_graph(tg, xs, params=jg.params)
    for k in ("stereo", "pilot"):
        v = tg.valid_from[k] + 2
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k][v:], want[k][v:], atol=ATOL)
    # The tones come back on their own ears (stream 0: L louder).
    audio = got["stereo"][tg.valid_from["stereo"] + 2:, 0, :].reshape(-1)
    l_at_fl, l_at_fr = tone_peaks(audio.real, 48000.0)
    r_at_fl, r_at_fr = tone_peaks(audio.imag, 48000.0)
    assert 20 * np.log10(l_at_fl / (l_at_fr + 1e-9)) > 30.0
    assert 20 * np.log10(r_at_fr / (r_at_fl + 1e-9)) > 30.0


def test_stereo_state_handoff_from_jax(stereo_jax_run):
    jg, xs, want, state3 = stereo_jax_run
    tg = wfm_stereo_receiver(**STEREO).bind({"iq": StreamSig(2, 24576,
                                                             RATE)})
    tstate, got = run_port_graph(tg, {"iq": xs["iq"][3:]}, state=state3)
    for k in ("stereo", "pilot"):
        np.testing.assert_allclose(got[k], want[k][3:], atol=ATOL)
    # The state comes back with the JAX package's structure, keys, shapes
    # and dtypes (``()`` for input and select nodes).
    back = tree_to_numpy(tstate)
    ref = jg.init_state()
    assert len(back) == len(ref)
    for tnode, jnode in zip(back, ref):
        if jnode == ():
            assert tnode == ()
            continue
        assert set(tnode) == set(jnode)
        for k in jnode:
            assert tnode[k].shape == jnode[k].shape, k
            assert tnode[k].dtype == jnode[k].dtype, k
