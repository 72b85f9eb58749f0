"""Host-side design of the port equals the JAX package's exactly: both
sides are float64 numpy, so every array must match bit for bit, dtype
included."""

import numpy as np
import pytest

import radiorust_tpu.blocks.filters as jfilters
import radiorust_tpu.blocks.transform as jtransform
import radiorust_tpu.ops.polyphase as jpoly
from radiorust_tpu.blocks.base import StreamSig as JSig
from radiorust_tpu.models import wfm as jwfm
from radiorust_tpu.windowing import Kaiser as JKaiser
from radiorust_tpu.windowing import Rectangular as JRect
import radiorust_tpu_torch.blocks.filters as tfilters
import radiorust_tpu_torch.numbers as tnumbers
import radiorust_tpu_torch.blocks.transform as ttransform
import radiorust_tpu_torch.ops.polyphase as tpoly
from radiorust_tpu_torch.blocks.base import StreamSig as TSig
from radiorust_tpu_torch.models import wfm as twfm
from radiorust_tpu_torch.windowing import Kaiser as TKaiser
from radiorust_tpu_torch.windowing import Rectangular as TRect


def assert_tree_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("n,rate,resp,window", [
    (6144, 384000.0, jwfm._lowpass_100k, "kaiser"),
    (1536, 384000.0, jwfm._deemphasis_band, "rect"),
    (1023, 48000.0, jwfm._lowpass_100k, "kaiser"),   # odd n: literal swap
    (999, 384000.0, jwfm._deemphasis_band, "rect"),
])
def test_impulse_and_extended_response_equal(n, rate, resp, window):
    jw, tw = ((JKaiser.with_null_at_bin(2.0), TKaiser.with_null_at_bin(2.0))
              if window == "kaiser" else (JRect(), TRect()))
    jir = jfilters.design_impulse_response(resp, jw, n, rate)
    tir = tfilters.design_impulse_response(resp, tw, n, rate)
    assert_tree_equal(tir, jir)
    assert_tree_equal(tfilters.extend_response(tir),
                      jfilters.extend_response(jir))
    assert_tree_equal(tfilters.extend_response(tir, pad=n + 128),
                      jfilters.extend_response(jir, pad=n + 128))
    assert_tree_equal(tfilters.deemphasis_factor(50e-6, np.arange(5.0)),
                      jfilters.deemphasis_factor(50e-6, np.arange(5.0)))


@pytest.mark.parametrize("rates", [
    (1024000.0, 384000.0, 200000.0),
    (384000.0, 48000.0, 40000.0),
    (1024000.0, 102400.0, 50000.0),
])
def test_plan_downsample_equal(rates):
    jp = jpoly.plan_downsample(*rates)
    tp = tpoly.plan_downsample(*rates)
    assert (tp.p, tp.q, tp.hist, tp.s0, tp.out_per_in) == \
        (jp.p, jp.q, jp.hist, jp.s0, jp.out_per_in)
    assert_tree_equal(tp.kernel, jp.kernel)


@pytest.mark.parametrize("chunk,numer", [(24576, 100000), (16384, -100000),
                                         (6000, 12345)])
def test_shift_tables_equal(chunk, numer):
    assert ttransform._inner_block(chunk) == jtransform._inner_block(chunk)
    assert_tree_equal(ttransform._shift_tables(chunk, 1024000, numer),
                      jtransform._shift_tables(chunk, 1024000, numer))


@pytest.mark.parametrize("kw,sig", [
    (dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
          filter_ir_len=6144), (64, 24576, 1024000.0)),
    (dict(tune_shift=-50e3), (2, 16384, 1024000.0)),
])
def test_bound_slice_params_and_state_equal(kw, sig):
    jb = jwfm.wfm_receiver(**kw).bind(JSig(*sig))
    tb = twfm.wfm_receiver(**kw).bind(TSig(*sig))
    assert [type(b).__name__ for b in tb.blocks] == \
        [type(b).__name__ for b in jb.blocks]
    assert tb.valid_from == jb.valid_from
    assert tb.out_sig == TSig(*vars(jb.out_sig).values())
    assert [b.output_is_real for b in tb.blocks] == \
        [b.output_is_real for b in jb.blocks]
    assert_tree_equal(tb.params, jb.params)
    assert_tree_equal(tb.init_state(), jb.init_state())


def test_c128_stream_mode_not_ported(monkeypatch):
    # Ported since slice 6f (tests/test_torch_f64_mode.py holds it against
    # the JAX package): under c128 a binding carries complex128 state, a
    # fused front end refuses as in the JAX package, an unknown mode raises.
    assert tnumbers.stream_complex() is np.complex64
    monkeypatch.setenv("RRTPU_STREAM_DTYPE", "c128")
    assert tnumbers.stream_complex() is np.complex128
    state = twfm.wfm_receiver().bind(TSig(1, 16384, 1024000.0)).init_state()
    kinds = {np.asarray(v).dtype for blk in state
             for v in (blk.values() if isinstance(blk, dict) else ())}
    assert np.dtype(np.complex128) in kinds
    assert np.dtype(np.complex64) not in kinds
    with pytest.raises(ValueError, match="FreqShifter"):
        twfm.wfm_receiver(fuse_frontend=True).bind(TSig(1, 16384, 1024000.0))
    monkeypatch.setenv("RRTPU_STREAM_DTYPE", "c32")
    with pytest.raises(ValueError, match="RRTPU_STREAM_DTYPE"):
        tnumbers.stream_complex()
