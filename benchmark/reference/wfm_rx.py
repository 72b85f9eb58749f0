"""Plain reference of ``wfm_rx``: radiorust 0.5.0's WFM receiver
(``examples/relm_app/simple_receiver.rs``) over whole streams.

    IQ 1.024 Msps -> shift by tune_shift -> 8:3 to 384 kHz (bw 200 kHz)
      -> +-100 kHz low-pass (Kaiser, null at bin 2)
      -> FM demod (deviation 150 kHz)
      -> 50 us deemphasis, DC block, 20 Hz - 16 kHz (rectangular window)
      -> 8:1 to 48 kHz (bw 40 kHz) -> volume

The overlap-save filters are causal FIRs of ``filter_ir_len`` taps; a
chunked run of them equals this whole-stream run once the first chunk's
zero history has passed.  Also here: the work one step of the
configuration needs of the port's kernels (:func:`kernel_work`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.counts import roofline as rl
from benchmark.reference import _dsp

INPUT_RATE, MID_RATE, AUDIO_RATE = 1024000.0, 384000.0, 48000.0


def lowpass_100k(bins, freqs):
    return np.where(np.abs(freqs) <= 100000.0, 1.0 + 0.0j, 0.0j)


def deemphasis_band(bins, freqs):
    keep = ((np.abs(bins) >= 1) & (np.abs(freqs) >= 20.0)
            & (np.abs(freqs) <= 16000.0))
    return np.where(keep, _dsp.deemphasis(50e-6, freqs), 0.0j)


def design(args: dict) -> dict:
    """The chain's filters and resamplers, from the configuration."""
    m = int(args["filter_ir_len"])
    return {
        "front": _dsp.downsampler(INPUT_RATE, MID_RATE, 200000.0),
        "channel": _dsp.design_impulse_response(
            lowpass_100k, _dsp.kaiser_null_at_bin(2.0), m, MID_RATE),
        "deemphasis": _dsp.design_impulse_response(
            deemphasis_band, _dsp.rectangular, m, MID_RATE),
        "audio": _dsp.downsampler(MID_RATE, AUDIO_RATE, 2.0 * 20000.0),
    }


def front_end(x: torch.Tensor, args: dict, d: dict,
              prec: _dsp.Precision) -> torch.Tensor:
    """Streams [B, n] at 1.024 Msps -> the channel-filtered 384 kHz IQ."""
    s = _dsp.mix(x, float(args["tune_shift"]), INPUT_RATE, prec)
    s = _dsp.decimate(s, d["front"], prec)
    return _dsp.causal_fir(s, d["channel"], prec)


def reference(chunks: torch.Tensor, args: dict,
              prec: _dsp.Precision = _dsp.FLOAT64) -> dict:
    """[C, B, n] input chunks -> {"audio": [C, B, n/8/... ] complex}: the
    receiver's output of every chunk, from a zero state before the
    first."""
    d = design(args)
    y = front_end(_dsp.streams(chunks), args, d, prec)
    dem = _dsp.fm_demod(y, MID_RATE, float(args.get("deviation", 150000.0)),
                        prec)
    a = _dsp.causal_fir(dem, d["deemphasis"], prec).real
    out = _dsp.decimate(a.to(prec.complex), d["audio"], prec).real
    out = out * float(args.get("volume", 1.0))
    n_out = chunks.shape[-1] * 3 // 8 // 8
    return {"audio": _dsp.chunked(torch.complex(out, torch.zeros_like(out)),
                                  n_out)}


def kernel_work(args: dict, batch: int, n: int) -> list:
    """The port's kernel calls one step needs: [(name, flops, bytes,
    kernel-name pattern)] from the plan and shapes (each input byte read
    once, each output byte written once)."""
    d = design(args)
    m = int(args["filter_ir_len"])
    mid = n * 3 // 8
    front, audio = d["front"], d["audio"]
    return [
        ("#2 mix_decimate", *rl.mix_decimate(front.p, front.q,
                                             front.nonzero_taps,
                                             front.history, batch, n),
         r"\bdecimate_kernel<true\b|\bmix_decimate_wide_kernel\b"),
        ("#3 channel filter", *rl.overlap_save(batch, mid, m),
         r"\bos_(forward_columns|rows|inverse_columns|column_pass|"
         r"column_generic|filter_cluster)\b"),
        ("#5 demod + deemphasis", *rl.demod_filter(batch, mid, m),
         r"\bos_cluster\b|\bdemod_pack\b"),
        ("#1 8:1 decimate", *rl.decimate(audio.p, audio.q,
                                         audio.nonzero_taps, audio.history,
                                         batch, mid, planes=1),
         r"\bdecimate_kernel<false\b|\bdecimate_wide_kernel\b"),
    ]
