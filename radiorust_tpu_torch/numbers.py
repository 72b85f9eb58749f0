"""Numeric policy of the PyTorch port.

Same split as ``radiorust_tpu.numbers``: streams flow per sample in
complex64 (float32 pairs) on the device, while filter, window and
resampler design runs on the host in float64 numpy and is cast to the
stream dtype once.

As in the JAX package, ``c128`` is a validation mode for the CPU: bind
blocks under it (``RRTPU_STREAM_DTYPE=c128`` or :func:`set_stream_mode`)
and their params, state and steps carry float64 / complex128 end to end,
through the plain PyTorch versions of the kernels.  The mode is read at
bind time.  The kernels take float32 only, and the mode never runs on a
CUDA device: :func:`check_device`, called wherever a params or state tree
is put on a device (:func:`radiorust_tpu_torch.convert.tree_to_torch`),
raises there.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["REAL_DTYPE", "COMPLEX_DTYPE", "DESIGN_REAL_DTYPE",
           "DESIGN_COMPLEX_DTYPE", "TAU", "stream_mode", "set_stream_mode",
           "stream_real", "stream_complex", "as_stream_complex",
           "as_stream_real", "check_device"]

# Stream dtypes: everything that flows per sample.
REAL_DTYPE = np.float32
COMPLEX_DTYPE = np.complex64

# Design dtypes: filter design, window tables, tap generation (host).
DESIGN_REAL_DTYPE = np.float64
DESIGN_COMPLEX_DTYPE = np.complex128

TAU = 2.0 * np.pi

_stream_mode: str | None = None

_MODES = {
    "c64": (np.float32, np.complex64),
    "c128": (np.float64, np.complex128),
}


def stream_mode() -> str:
    """``"c64"`` (default) or ``"c128"`` (the float64 validation mode);
    env ``RRTPU_STREAM_DTYPE`` or :func:`set_stream_mode`."""
    if _stream_mode is not None:
        return _stream_mode
    mode = os.environ.get("RRTPU_STREAM_DTYPE", "c64").lower()
    if mode not in _MODES:
        raise ValueError(
            f"RRTPU_STREAM_DTYPE={mode!r}: expected one of "
            f"{sorted(_MODES)}")
    return mode


def set_stream_mode(mode: str | None) -> None:
    """Select the stream mode for blocks bound from now on; ``None``
    returns to the environment's (``RRTPU_STREAM_DTYPE``, default c64)."""
    global _stream_mode
    if mode is not None and mode.lower() not in _MODES:
        raise ValueError(f"unknown stream mode {mode!r}")
    _stream_mode = None if mode is None else mode.lower()


def stream_real():
    """Real stream dtype under the current mode (numpy dtype class)."""
    return _MODES[stream_mode()][0]


def stream_complex():
    """Complex stream dtype under the current mode (numpy dtype class)."""
    return _MODES[stream_mode()][1]


def as_stream_complex(x):
    """Cast a host design-precision array to the complex stream dtype."""
    return np.asarray(x).astype(stream_complex())


def as_stream_real(x):
    """Cast a host design-precision array to the real stream dtype."""
    return np.asarray(x).astype(stream_real())


def check_device(device) -> None:
    """Raise where the c128 mode would put a tree on a CUDA device: the
    mode is CPU-only, and no kernel takes float64.  Nothing changes under
    c64."""
    if stream_mode() == "c128" and str(device).startswith("cuda"):
        raise RuntimeError(
            f"stream mode c128 (RRTPU_STREAM_DTYPE / set_stream_mode) is a "
            f"CPU validation mode: it does not run on {device}; bind under "
            f"c64 for CUDA")
