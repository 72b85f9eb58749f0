"""Numeric policy of the PyTorch port.

Same split as ``radiorust_tpu.numbers``: streams flow per sample in
complex64 (float32 pairs) on the device, while filter, window and
resampler design runs on the host in float64 numpy and is cast to the
stream dtype once.

The JAX package also offers a complex128 stream mode for validation.
The port does not have it yet: selecting it raises.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["REAL_DTYPE", "COMPLEX_DTYPE", "TAU", "stream_mode",
           "stream_real", "stream_complex"]

# Stream dtypes: everything that flows per sample.
REAL_DTYPE = np.float32
COMPLEX_DTYPE = np.complex64

TAU = 2.0 * np.pi


def stream_mode() -> str:
    """Always ``"c64"``.  ``RRTPU_STREAM_DTYPE=c128`` raises: the port has
    no float64 stream mode yet."""
    mode = os.environ.get("RRTPU_STREAM_DTYPE", "c64").lower()
    if mode == "c128":
        raise NotImplementedError(
            "complex128 stream mode is not ported yet")
    if mode != "c64":
        raise ValueError(f"RRTPU_STREAM_DTYPE={mode!r}: expected 'c64'")
    return mode


def stream_real():
    """Real stream dtype (numpy dtype class)."""
    stream_mode()
    return REAL_DTYPE


def stream_complex():
    """Complex stream dtype (numpy dtype class)."""
    stream_mode()
    return COMPLEX_DTYPE
