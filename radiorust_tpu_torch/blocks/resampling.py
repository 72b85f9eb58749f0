"""Sample-rate conversion (PyTorch port of ``Downsampler`` and
``Upsampler`` in the JAX package's ``blocks/resampling.py``).

Each block maps one input chunk to one output chunk.  When the chunk is
a whole number of resampling periods (``chunk_len % p == 0``) the output
is exactly ``chunk_len * q / p`` samples (aligned mode).  Any other chunk
length binds too (phase mode): the output chunk is a fixed
``ceil(chunk_len/p) * q`` samples whose valid prefix follows the
``valid_counts`` schedule, with exact zeros behind it, and in a compiled
chain the block must come last.
"""

from __future__ import annotations

import numpy as np

from ..numbers import stream_complex
from ..ops import frontend as _ofront
from ..ops.polyphase import RationalPlan, plan_downsample, plan_upsample
from .base import Block, BoundBlock, StreamSig

__all__ = ["Downsampler", "Upsampler"]


class _BoundResampler(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # real FIR taps preserve realness

    def __init__(self, sig: StreamSig, plan: RationalPlan,
                 output_rate: float):
        self.in_sig = sig
        self.plan = plan
        self.phase_mode = not plan.aligned(sig.chunk_len)
        if self.phase_mode:
            out_len = plan.windows_per_step(sig.chunk_len) * plan.q
            # Padded chunks: Chain.bind refuses the block anywhere but
            # last, and a graph refuses it as a node.
            self.ragged_output = True
        else:
            out_len = plan.out_len(sig.chunk_len)
        self.out_sig = StreamSig(sig.batch, out_len, output_rate)
        self.params = {"kernel": np.asarray(plan.kernel)}

    def valid_counts(self, k0: int, nsteps: int = 1):
        """Valid output samples in chunks k0..k0+nsteps (every full
        out_len in aligned mode; the periodic phase-mode schedule
        otherwise)."""
        return self.plan.valid_counts(self.in_sig.chunk_len, k0, nsteps)

    def schedule_phase(self, state) -> int:
        """The grid phase of a state tree (a host read of ``phase[0]``;
        a restored state lands mid-schedule, and the phase alone places
        it)."""
        return int(state["phase"][0]) if self.phase_mode else 0

    def advance_schedule(self, phase: int):
        """(valid output samples of the next chunk, next phase), from the
        schedule's one owner, ``RationalPlan.advance``."""
        return self.plan.advance(phase, self.in_sig.chunk_len)

    def init_state(self):
        b = self.in_sig.batch
        if self.phase_mode:
            return {"hist": np.zeros((b, self.plan.phase_hist),
                                     stream_complex()),
                    "phase": np.zeros((b,), np.int32)}
        return {"hist": np.zeros((b, self.plan.hist), stream_complex())}

    def process(self, params, state, x, reset):
        # The reference does not reset resampler state on events, so
        # ``reset`` is unused.
        plan = self.plan
        if self.phase_mode:
            # #1's phase-mode entry: the grid phase stays on the device.
            y, nh, nph = _ofront.decimate_phase_complex(
                x, state["hist"], state["phase"], params["kernel"], plan.p,
                plan.q, real_input=self.input_is_real)
            return {"hist": nh, "phase": nph}, y
        # Complex64 in and out, read and written in place by the kernel
        # (the polyphase kernel, or its wide form for plans such as 48 kHz
        # -> 44.1 kHz or 48 kHz -> 1.024 MHz: every aligned plan runs on
        # CUDA); a real input filters the real planes only.
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


class Upsampler(Block):
    """Increase the sample rate; images are suppressed above
    ``bandwidth``.  Its plans have the downsampler's layout (window 0 at
    the buffer's start, history = window minus one period), so aligned
    chunks run on the same kernel."""

    def __init__(self, output_rate: float, bandwidth: float,
                 quality: float = 3.0):
        self.output_rate = float(output_rate)
        self.bandwidth = float(bandwidth)
        self.quality = float(quality)

    def bind(self, sig: StreamSig) -> _BoundResampler:
        plan = plan_upsample(sig.sample_rate, self.output_rate,
                             self.bandwidth, self.quality)
        return _BoundResampler(sig, plan, self.output_rate)
