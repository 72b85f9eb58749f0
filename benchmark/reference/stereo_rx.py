"""Plain reference of ``stereo_rx``: ``wfm_rx``'s front end and FM
demodulator, then the FM stereo multiplex decoded as ITU-R BS.450
defines it (mono (L+R)/2 at 0-15 kHz, a 19 kHz pilot, (L-R)/2 as DSB-SC
on 38 kHz), over whole streams:

    MPX (real, 384 kHz) -> three band filters on one stream (Kaiser, null
    at bin 2): mono |f| <= 15 kHz; pilot 18.4-19.6 kHz and subcarrier
    23-53 kHz one-sided (x2, the analytic signals)
      carrier = pilot^2 / (|pilot|^2 + 1e-12)        (38 kHz, unit)
      diff    = Re(sub * conj(carrier)) * separation  ((L-R)/2)
      L + jR  = (mono + diff) + j (mono - diff)
      -> 50 us deemphasis, DC block, 20 Hz - 16 kHz -> 8:1 to 48 kHz
      -> volume
    outputs "stereo" (L + jR at 48 kHz) and "pilot" (the analytic pilot
    at 384 kHz).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.counts import roofline as rl
from benchmark.reference import _dsp
from benchmark.reference import wfm_rx

PILOT = 19000.0


def mono_band(bins, freqs):
    return np.where(np.abs(freqs) <= 15000.0, 1.0 + 0.0j, 0.0j)


def pilot_band(bins, freqs):
    keep = (freqs >= PILOT - 600.0) & (freqs <= PILOT + 600.0)
    return np.where(keep, 2.0 + 0.0j, 0.0j)


def subcarrier_band(bins, freqs):
    keep = (freqs >= 23000.0) & (freqs <= 53000.0)
    return np.where(keep, 2.0 + 0.0j, 0.0j)


def design(args: dict) -> dict:
    m = int(args["filter_ir_len"])
    kaiser = _dsp.kaiser_null_at_bin(2.0)
    return {**wfm_rx.design(args), "bands": [
        _dsp.design_impulse_response(band, kaiser, m, wfm_rx.MID_RATE)
        for band in (mono_band, pilot_band, subcarrier_band)]}


def reference(chunks: torch.Tensor, args: dict,
              prec: _dsp.Precision = _dsp.FLOAT64) -> dict:
    """[C, B, n] input chunks -> {"stereo": [C, B, n*3/64], "pilot": [C,
    B, n*3/8]}, complex, from a zero state before the first chunk."""
    d = design(args)
    y = wfm_rx.front_end(_dsp.streams(chunks), args, d, prec)
    mpx = _dsp.fm_demod(y, wfm_rx.MID_RATE,
                        float(args.get("deviation", 150000.0)), prec)
    mono, pilot, sub = (_dsp.causal_fir(mpx, h, prec) for h in d["bands"])
    p = prec.operand(pilot)
    carrier = p * p * (1.0 / (p.abs() ** 2 + 1e-12))
    diff = (prec.operand(sub) * torch.conj(prec.operand(carrier))).real
    diff = diff * float(args.get("separation", 1.0))
    lr = torch.complex(mono.real + diff, mono.real - diff)
    lr = _dsp.causal_fir(lr, d["deemphasis"], prec)
    out = _dsp.decimate(lr, d["audio"], prec)
    out = out * float(args.get("volume", 1.0))
    mid = chunks.shape[-1] * 3 // 8
    return {"stereo": _dsp.chunked(out, mid // 8),
            "pilot": _dsp.chunked(pilot, mid)}


def kernel_work(args: dict, batch: int, n: int) -> list:
    """The port's kernel calls one step needs (see ``wfm_rx``); the FM
    demodulator, the pilot arithmetic and the matrix are not a kernel's
    work in this configuration."""
    d = design(args)
    m = int(args["filter_ir_len"])
    mid = n * 3 // 8
    front, audio = d["front"], d["audio"]
    stage = (r"\bos_(forward_columns|rows|inverse_columns|column_pass|"
             r"column_generic|filter_cluster|cluster)\b")
    return [
        ("#2 mix_decimate", *rl.mix_decimate(front.p, front.q,
                                             front.nonzero_taps,
                                             front.history, batch, n),
         r"\bdecimate_kernel<true\b|\bmix_decimate_wide_kernel\b"),
        ("#3 channel filter", *rl.overlap_save(batch, mid, m), stage),
        ("#4 3-band bank", *rl.overlap_save(batch, mid, m, bands=3,
                                            real_input=True), stage),
        ("#3 deemphasis", *rl.overlap_save(batch, mid, m), stage),
        ("#1 8:1 decimate", *rl.decimate(audio.p, audio.q,
                                         audio.nonzero_taps, audio.history,
                                         batch, mid),
         r"\bdecimate_kernel<false\b|\bdecimate_wide_kernel\b"),
    ]
