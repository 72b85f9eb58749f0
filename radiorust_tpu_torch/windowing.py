"""Window functions (host-side design math).

Mirrors the reference's ``src/windowing.rs``: a window exposes
``relative_value_at(x)`` for ``x`` in [-1, 1], returning an un-normalized
value (callers renormalize, e.g. by preserved energy).  Vectorized over numpy
arrays so tables for a whole chunk are built in one call.
"""

from __future__ import annotations

import numpy as np

from .math import (
    kaiser_alpha_to_beta,
    kaiser_null_at_bin_to_beta,
    kaiser_rel_with_beta,
)

__all__ = ["Window", "Rectangular", "Kaiser", "CustomWindow", "window_table"]


class Window:
    """Window function protocol (``src/windowing.rs:6-10``)."""

    def relative_value_at(self, x):
        raise NotImplementedError


class Rectangular(Window):
    """Rectangular window (``src/windowing.rs:13-20``)."""

    def relative_value_at(self, x):
        return np.ones_like(np.asarray(x, dtype=np.float64))


class Kaiser(Window):
    """Kaiser window parameterized by beta (``src/windowing.rs:23-51``)."""

    def __init__(self, beta: float):
        self.beta = float(beta)

    @classmethod
    def with_beta(cls, beta: float) -> "Kaiser":
        return cls(beta)

    @classmethod
    def with_alpha(cls, alpha: float) -> "Kaiser":
        return cls(float(kaiser_alpha_to_beta(alpha)))

    @classmethod
    def with_null_at_bin(cls, n: float) -> "Kaiser":
        return cls(float(kaiser_null_at_bin_to_beta(n)))

    def relative_value_at(self, x):
        return kaiser_rel_with_beta(self.beta, x)

    def __repr__(self):
        return f"Kaiser(beta={self.beta})"


class CustomWindow(Window):
    """Window backed by a user callable (``src/windowing.rs:58-67``).

    The callable must accept a float64 numpy array of positions in [-1, 1]
    and return an array of the same shape.
    """

    def __init__(self, func):
        self.func = func

    def relative_value_at(self, x):
        return np.asarray(self.func(np.asarray(x, dtype=np.float64)),
                          dtype=np.float64)


def window_table(window: Window, n: int) -> np.ndarray:
    """Sample a window at the reference's canonical positions.

    Both the Fourier block (``src/blocks/analysis.rs:91-93``) and the filter
    design path (``src/blocks/filters.rs:204-212``) evaluate the window at
    ``2*(i+0.5)/n - 1`` for i in [0, n): bin-centered positions spanning
    (-1, 1).
    """
    i = np.arange(n, dtype=np.float64)
    return np.asarray(window.relative_value_at(2.0 * (i + 0.5) / n - 1.0),
                      dtype=np.float64)
