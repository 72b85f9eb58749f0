"""Fused receiver blocks (PyTorch port of the JAX package's
``blocks/frontend.py``).

- :class:`MixerDecimator` equals ``Chain(FreqShifter.with_shift(s),
  Downsampler(rate, bw))`` (same mixer tables, same rational plan) in one
  kernel, :func:`radiorust_tpu_torch.ops.frontend.fused_mix_decimate`.
- :class:`FmDemodFilter` equals ``Chain(FmDemod(dev), Filter(resp))`` for
  a real impulse response, in one kernel,
  :func:`radiorust_tpu_torch.ops.filter.fused_demod_filter`, with stream
  pairs sharing each transform (so the batch must be even).
- :class:`FilterDemodFilter` equals ``Chain(Filter(resp), FmDemod(dev),
  Filter(deemph))`` in one kernel,
  :func:`radiorust_tpu_torch.ops.filter.fused_filter_demod_filter` (even
  batch, both filters at one IR length).

Each raises at bind where its kernel does not take the geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import numbers as _nums
from ..math import round_half_away
from ..numbers import TAU
from ..ops import filter as _ofilter
from ..ops import frontend as _ofront
from ..ops.polyphase import plan_downsample
from .base import Block, BoundBlock, StreamSig
from .filters import (GridCache, _is_real_ir, design_impulse_response,
                      extend_response)
from .transform import (_inner_block, _shift_param_update,
                        fold_phase_state, start_phasor)

__all__ = ["MixerDecimator", "FmDemodFilter", "FilterDemodFilter"]


class _BoundMixerDecimator(BoundBlock):
    def __init__(self, sig: StreamSig, shift: float, precision_hz: float,
                 output_rate: float, bandwidth: float, quality: float):
        self.in_sig = sig
        self.current_shift = float(shift)
        n = sig.chunk_len
        self.denom = round_half_away((sig.sample_rate / precision_hz))
        plan = plan_downsample(sig.sample_rate, output_rate, bandwidth,
                               quality)
        self.plan = plan
        self.out_sig = StreamSig(sig.batch, plan.out_len(n), output_rate)
        if not self.supported(sig):
            raise ValueError("MixerDecimator kernel constraints unmet; use "
                             "FreqShifter + Downsampler")
        # The decimation taps are bind-time constants (as in the JAX
        # package); only the mixer tables are params.
        self.params = _shift_param_update(n, self.denom, sig.sample_rate,
                                          shift)
        self._taps = {}

    def supported(self, sig: StreamSig) -> bool:
        """Whether the fused kernel takes ``sig``'s chunk length with this
        plan, on its polyphase form or its wide form (the port's rule:
        every aligned plan the decimation kernel takes; the JAX package
        adds a 128-lane oscillator block and its super-row rule, TPU
        layout rules).  False under the c128 stream mode, as in the JAX
        package: the kernel is float32 and has no plain form in
        float64."""
        n = sig.chunk_len
        return (_nums.stream_mode() == "c64"
                and _ofront.decimate_supported(n, self.plan, mixer=True,
                                               inner=_inner_block(n)))

    def _kernel_matrix(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._taps:
            self._taps[key] = torch.from_numpy(self.plan.kernel).to(device)
        return self._taps[key]

    def init_state(self):
        b = self.in_sig.batch
        return {"k0": np.zeros((b,), np.int32),
                "start_phase": np.zeros((b,), np.float32),
                "histr": np.zeros((b, self.plan.hist), np.float32),
                "histi": np.zeros((b, self.plan.hist), np.float32)}

    def process(self, params, state, x, reset):
        c, s = start_phasor(state, self.denom)
        # The kernel reads x, the tables and the history planes in place
        # and writes complex64 outputs; the new history planes are views.
        y, nh = _ofront.fused_mix_decimate_complex(
            x, params["table_a"], params["table_b"], c, s, state["histr"],
            state["histi"], self._kernel_matrix(x.device), self.plan.p,
            self.plan.q)
        new_state = {"k0": (state["k0"] + params["adv"]) % self.denom,
                     "start_phase": state["start_phase"],
                     "histr": nh.real,
                     "histi": nh.imag}
        return new_state, y

    def shift_params(self, shift: float):
        self.current_shift = float(shift)
        return {**self.params,
                **_shift_param_update(self.in_sig.chunk_len, self.denom,
                                      self.in_sig.sample_rate, shift)}

    def retune(self, params, state, shift: float):
        return self.shift_params(shift), fold_phase_state(state, self.denom)


class MixerDecimator(Block):
    """Fused frequency shift + decimation front end."""

    def __init__(self, shift: float, output_rate: float, bandwidth: float,
                 quality: float = 3.0, precision: float = 1.0):
        self.shift = float(shift)
        self.precision = float(precision)
        self.output_rate = float(output_rate)
        self.bandwidth = float(bandwidth)
        self.quality = float(quality)

    def bind(self, sig: StreamSig) -> _BoundMixerDecimator:
        return _BoundMixerDecimator(sig, self.shift, self.precision,
                                    self.output_rate, self.bandwidth,
                                    self.quality)


class _BoundFmDemodFilter(BoundBlock):
    @property
    def output_is_real(self):
        return True

    def shard_batch_ok(self, ndev: int) -> bool:
        # Stream pairs share a transform: the *local* batch must stay even
        # under stream sharding.
        b = self.in_sig.batch
        return b % ndev == 0 and (b // ndev) % 2 == 0

    def __init__(self, sig: StreamSig, deviation: float, freq_resp, window,
                 ir_len=None):
        self.in_sig = self.out_sig = sig
        self.valid_from = 1  # overlap-save warmup, like Filter
        self._grid = GridCache()
        n = sig.chunk_len
        m = n if ir_len is None else int(ir_len)
        if not 0 < m <= n:
            raise ValueError(f"ir_len {m} must be in (0, chunk_len {n}]")
        self.ir_len = m
        if not _ofilter.supported(n, m) or sig.batch % 2:
            raise ValueError("FmDemodFilter kernel constraints unmet "
                             "(chunk size / even batch); use FmDemod + "
                             "Filter")
        ir = design_impulse_response(freq_resp, window, m, sig.sample_rate)
        if not _is_real_ir(ir):
            raise ValueError("FmDemodFilter requires a real impulse "
                             "response (conjugate-symmetric gains)")
        self.params = {
            "response": extend_response(ir, pad=n).astype(
                _nums.stream_complex()),
            "factor": _nums.stream_real()(sig.sample_rate / deviation / TAU),
        }

    def init_state(self):
        b, rdt = self.in_sig.batch, _nums.stream_real()
        return {"plr": np.zeros((b,), rdt),
                "pli": np.zeros((b,), rdt),
                "prevd": np.zeros((b, self.ir_len), rdt),
                "last_out": np.zeros((b,), rdt),
                "have_prev": np.zeros((b,), rdt)}

    def process(self, params, state, x, reset):
        n = self.in_sig.chunk_len
        have = torch.where(reset, torch.zeros_like(state["have_prev"]),
                           state["have_prev"])
        # An interrupt also clears the filter tail.
        prevd = torch.where(reset[:, None], torch.zeros_like(state["prevd"]),
                            state["prevd"])
        y, d = _ofilter.fused_demod_filter(
            x.real.contiguous(), x.imag.contiguous(),
            state["plr"], state["pli"], prevd, state["last_out"], have,
            *self._grid.planes(params["response"]), params["factor"])
        new_state = {"plr": x[:, -1].real.contiguous(),
                     "pli": x[:, -1].imag.contiguous(),
                     "prevd": d[:, n - self.ir_len:].contiguous(),
                     "last_out": d[:, -1].contiguous(),
                     "have_prev": torch.ones_like(have)}
        return new_state, torch.complex(y, torch.zeros_like(y))


class FmDemodFilter(Block):
    """Fused quadrature FM demodulator + overlap-save filter (real impulse
    response; default window rectangular)."""

    def __init__(self, deviation: float, freq_resp, window=None,
                 ir_len=None):
        from ..windowing import Rectangular
        self.deviation = float(deviation)
        self.freq_resp = freq_resp
        self.window = window if window is not None else Rectangular()
        self.ir_len = ir_len

    def bind(self, sig: StreamSig) -> _BoundFmDemodFilter:
        return _BoundFmDemodFilter(sig, self.deviation, self.freq_resp,
                                   self.window, self.ir_len)


class _BoundFilterDemodFilter(BoundBlock):
    @property
    def output_is_real(self):
        return True

    def shard_batch_ok(self, ndev: int) -> bool:
        # Stream pairs share a transform (see _BoundFmDemodFilter).
        b = self.in_sig.batch
        return b % ndev == 0 and (b // ndev) % 2 == 0

    def __init__(self, sig: StreamSig, freq_resp, window, deviation: float,
                 deemph_resp, deemph_window, ir_len=None):
        self.in_sig = self.out_sig = sig
        # Two cascaded overlap-save warmups: chunk 0 sees zero tails in
        # both filters, chunk 1 still sees chunk 0's demod as its tail.
        self.valid_from = 2
        self.window = window
        self.deemph_window = deemph_window
        self._grids = (GridCache(), GridCache())
        n = sig.chunk_len
        m = n if ir_len is None else int(ir_len)
        if not 0 < m <= n:
            raise ValueError(f"ir_len {m} must be in (0, chunk_len {n}]")
        self.ir_len = m
        if not _ofilter.supported(n, m) or sig.batch % 2:
            raise ValueError("FilterDemodFilter kernel constraints unmet "
                             "(chunk size / even batch); use Filter + "
                             "FmDemod + Filter")
        ir2 = design_impulse_response(deemph_resp, deemph_window, m,
                                      sig.sample_rate)
        if not _is_real_ir(ir2):
            raise ValueError("FilterDemodFilter requires a real deemphasis "
                             "impulse response (conjugate-symmetric gains)")
        ir1 = design_impulse_response(freq_resp, window, m, sig.sample_rate)
        cdt = _nums.stream_complex()
        self.params = {
            "response1": extend_response(ir1, pad=n).astype(cdt),
            "response2": extend_response(ir2, pad=n).astype(cdt),
            "factor": _nums.stream_real()(sig.sample_rate / deviation / TAU),
        }

    def init_state(self):
        b, m, rdt = self.in_sig.batch, self.ir_len, _nums.stream_real()
        return {"prev": np.zeros((b, m), _nums.stream_complex()),
                "plr": np.zeros((b,), rdt),
                "pli": np.zeros((b,), rdt),
                "prevd": np.zeros((b, m), rdt),
                "last_out": np.zeros((b,), rdt),
                "have_prev": np.zeros((b,), rdt)}

    def process(self, params, state, x, reset):
        n, m = self.in_sig.chunk_len, self.ir_len
        # An interrupt clears both filter tails and the demod continuity.
        prev = torch.where(reset[:, None], torch.zeros_like(state["prev"]),
                           state["prev"])
        prevd = torch.where(reset[:, None], torch.zeros_like(state["prevd"]),
                            state["prevd"])
        have = torch.where(reset, torch.zeros_like(state["have_prev"]),
                           state["have_prev"])
        y, d, flr, fli = _ofilter.fused_filter_demod_filter(
            prev.real.contiguous(), prev.imag.contiguous(),
            x.real.contiguous(), x.imag.contiguous(),
            state["plr"], state["pli"], prevd, state["last_out"], have,
            *self._grids[0].planes(params["response1"]),
            *self._grids[1].planes(params["response2"]), params["factor"])
        new_state = {"prev": x[:, n - m:],
                     "plr": flr,
                     "pli": fli,
                     "prevd": d[:, n - m:].contiguous(),
                     "last_out": d[:, -1].contiguous(),
                     "have_prev": torch.ones_like(have)}
        return new_state, torch.complex(y, torch.zeros_like(y))

    def update_filter_params(self, freq_resp, window=None):
        """Numpy params with the channel filter's response redesigned (the
        analog of the reference's ``Filter::update``)."""
        w = window if window is not None else self.window
        ir = design_impulse_response(freq_resp, w, self.ir_len,
                                     self.in_sig.sample_rate)
        r = extend_response(ir, pad=self.in_sig.chunk_len)
        return {**self.params, "response1": r.astype(_nums.stream_complex())}


class FilterDemodFilter(Block):
    """Fused channel filter + FM demodulator + deemphasis filter (default
    windows: Kaiser null at bin 2 for the channel filter, rectangular for
    the deemphasis filter, whose impulse response must be real)."""

    def __init__(self, freq_resp, deviation: float, deemph_resp,
                 window=None, deemph_window=None, ir_len=None):
        from ..windowing import Kaiser, Rectangular
        self.freq_resp = freq_resp
        self.deviation = float(deviation)
        self.deemph_resp = deemph_resp
        self.window = (window if window is not None
                       else Kaiser.with_null_at_bin(2.0))
        self.deemph_window = (deemph_window if deemph_window is not None
                              else Rectangular())
        self.ir_len = ir_len

    def bind(self, sig: StreamSig) -> _BoundFilterDemodFilter:
        return _BoundFilterDemodFilter(sig, self.freq_resp, self.window,
                                       self.deviation, self.deemph_resp,
                                       self.deemph_window, self.ir_len)
