"""The yardstick of the kernels' roofline: the card's published peaks and
the operations and bytes each kernel call needs.

Frozen copies of the port's ``tools/mfu.py`` conventions, so that the
benchmark reads the same work whatever the program later changes:

- peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
  limit): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor
  cores;
- a complex FFT of N points is 5 N log2 N operations, a complex multiply
  6, a real multiply-add 2; FM demod (conjugate product, atan2 counted as
  one, scale) 8 a sample; the mixer 18 a sample;
- bytes: each input byte read once and each output byte written once
  (float32 planes, complex = 8 bytes), whatever the kernel re-reads;
  carried state counts where it is read and where it must be written (a
  history that is a slice of the input needs no write); tables and taps
  once a call.

Every function returns ``(flops, bytes)`` of one call.  A call's least
time is :func:`least_seconds`.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
DEMOD_FLOPS, MIX_FLOPS = 8, 18
F32, C64 = 4, 8


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def fft_flops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def decimate(p: int, q: int, nonzero_taps: int, history: int, batch: int,
             n: int, planes: int = 2):
    """#1: ``batch`` rows of ``n`` inputs decimated p:q over a plan of
    ``nonzero_taps`` multiply-adds a period; ``planes`` 1 for a real
    input and output, 2 for complex."""
    flops = 2 * planes * batch * (n // p) * nonzero_taps
    nbytes = (F32 * planes * batch * (n + history + n // p * q)
              + F32 * nonzero_taps)
    return flops, nbytes


def mix_decimate(p: int, q: int, nonzero_taps: int, history: int,
                 batch: int, n: int):
    """#2: the mixer on every input, then #1 on both planes; the mixer's
    tables (one oscillator period of complex phasors, at most ``n``) are
    not counted, its chunk-start phase is (a float a row)."""
    flops, nbytes = decimate(p, q, nonzero_taps, history, batch, n)
    return flops + MIX_FLOPS * batch * n, nbytes + F32 * batch


def overlap_save(batch: int, n: int, m: int, bands: int = 1,
                 real_input: bool = False):
    """#3 (``bands`` = 1) and #4: ``batch`` rows of ``n`` new samples
    against an ``m``-sample history, one forward transform of ``n + m``
    points a row, then per band a response multiply and an inverse;
    complex outputs, a response of ``n + m`` complex points a band."""
    N = n + m
    flops = batch * (fft_flops(N) + bands * (6 * N + fft_flops(N)))
    width = F32 if real_input else C64
    nbytes = (batch * (width * (n + m) + bands * C64 * n)
              + bands * C64 * N)
    return flops, nbytes


def demod_filter(batch: int, n: int, m: int):
    """#5: FM demod of ``n`` complex samples a row (the previous chunk's
    last sample carried), then a real filter of ``n + m`` points with
    stream pairs sharing a transform; real output, and the last ``m``
    demodulated samples written as the next step's history."""
    N = n + m
    flops = DEMOD_FLOPS * batch * n + (batch // 2) * (
        2 * fft_flops(N) + 6 * N)
    nbytes = (batch * (C64 * (n + 1) + F32 * m + F32 * n + F32 * m)
              + C64 * N)
    return flops, nbytes
