"""Downsampling (PyTorch port of ``Downsampler`` in the JAX package's
``blocks/resampling.py``, aligned mode: the chunk is a whole number of
resampling periods and each step emits ``chunk_len * q / p`` samples).
Phase mode, for other chunk lengths, and ``Upsampler`` are not ported
yet."""

from __future__ import annotations

import numpy as np

from ..numbers import stream_complex
from ..ops import frontend as _ofront
from ..ops.polyphase import RationalPlan, plan_downsample
from .base import Block, BoundBlock, StreamSig

__all__ = ["Downsampler"]


class _BoundResampler(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # real FIR taps preserve realness

    def __init__(self, sig: StreamSig, plan: RationalPlan,
                 output_rate: float):
        self.in_sig = sig
        self.plan = plan
        self.out_sig = StreamSig(sig.batch, plan.out_len(sig.chunk_len),
                                 output_rate)
        self.params = {"kernel": np.asarray(plan.kernel)}

    def init_state(self):
        return {"hist": np.zeros((self.in_sig.batch, self.plan.hist),
                                 stream_complex())}

    def process(self, params, state, x, reset):
        # The reference does not reset resampler state on events, so
        # ``reset`` is unused.
        plan = self.plan
        # Complex64 in and out, read and written in place by the kernel
        # (the polyphase kernel, or its wide form for plans such as 48 kHz
        # -> 44.1 kHz: every aligned plan runs on CUDA); a real input
        # filters the real planes only.
        y, nh = _ofront.decimate_complex(x, state["hist"], params["kernel"],
                                         plan.p, plan.q,
                                         real_input=self.input_is_real)
        return {"hist": nh}, y


class Downsampler(Block):
    """Reduce the sample rate; aliasing is suppressed below ``bandwidth``
    and ``quality`` scales the anti-alias FIR length.

    ``prefilter=(freq_resp, window)`` folds a preceding overlap-save
    Filter into the decimating FIR (an exact composition of LTI stages;
    the filter's impulse response is designed at the bound chunk length,
    as a standalone :class:`~radiorust_tpu_torch.blocks.filters.Filter`
    would design it)."""

    def __init__(self, output_rate: float, bandwidth: float,
                 quality: float = 3.0, prefilter=None):
        self.output_rate = float(output_rate)
        self.bandwidth = float(bandwidth)
        self.quality = float(quality)
        self.prefilter = prefilter

    def bind(self, sig: StreamSig) -> _BoundResampler:
        pre_ir = None
        if self.prefilter is not None:
            from .filters import design_impulse_response
            freq_resp, window = self.prefilter
            pre_ir = design_impulse_response(
                freq_resp, window, sig.chunk_len,
                sig.sample_rate).astype(np.complex64)
        plan = plan_downsample(sig.sample_rate, self.output_rate,
                               self.bandwidth, self.quality,
                               prefilter_ir=pre_ir)
        return _BoundResampler(sig, plan, self.output_rate)
