"""DSP math helpers (host-side, float64).

Reimplements the semantics of the reference's ``src/math.rs``:

- ``bessel_i0`` — modified Bessel function of the first kind, order zero,
  power-series summed to convergence (``src/math.rs:7-20``).
- Kaiser parameter conversions (``src/math.rs:26-39``).
- normalized ``sinc`` (``src/math.rs:42-49``).

These run on the host in float64: they are *design-time* math (window tables,
filter impulse responses) whose results are cast to the device stream dtype
once, so there is no reason to port them to the accelerator.  All functions
are vectorized over numpy arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bessel_i0",
    "round_half_away",
    "kaiser_rel_with_beta",
    "kaiser_alpha_to_beta",
    "kaiser_null_at_bin_to_beta",
    "sinc",
]


def bessel_i0(x):
    """Modified Bessel function of the first kind of order zero.

    Power series sum(k) (x^2/4)^k / (k!)^2, accumulated until the sum stops
    changing or becomes non-finite — the same convergence rule as the
    reference (``src/math.rs:7-20``), vectorized over arrays.
    """
    x = np.asarray(x, dtype=np.float64)
    scalar = x.ndim == 0
    x = np.atleast_1d(x)
    base = x * x / 4.0
    addend = np.ones_like(base)
    total = np.ones_like(base)
    active = np.isfinite(base)
    # NaN inputs must produce NaN outputs.
    total = np.where(np.isnan(base), np.nan, total)
    # Infinite inputs produce +inf.
    total = np.where(np.isinf(base), np.inf, total)
    i = 1
    with np.errstate(over="ignore", invalid="ignore"):
        while np.any(active):
            addend = np.where(active, addend * base / float(i * i), addend)
            new_total = total + np.where(active, addend, 0.0)
            # Stop where the sum converged or overflowed (matches reference).
            still = active & (new_total != total) & np.isfinite(new_total)
            total = np.where(active, new_total, total)
            active = still
            i += 1
    return float(total[0]) if scalar else total


def kaiser_rel_with_beta(beta, x):
    """Kaiser window value (up to an unknown constant) at ``x`` in [-1, 1].

    Mirrors ``src/math.rs:26-28``.
    """
    beta = np.asarray(beta, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    return bessel_i0(beta * np.sqrt(1.0 - x * x))


def kaiser_alpha_to_beta(alpha):
    """Convert Kaiser ``alpha`` to ``beta`` (``src/math.rs:31-33``)."""
    return np.asarray(alpha, dtype=np.float64) * np.pi


def kaiser_null_at_bin_to_beta(n):
    """Kaiser ``beta`` for first window null ``n`` bins out
    (``src/math.rs:37-39``)."""
    n = np.asarray(n, dtype=np.float64)
    return np.sqrt(n * n - 1.0)


def sinc(x):
    """Normalized sinc: sin(pi x) / (pi x) (``src/math.rs:42-49``)."""
    return np.sinc(np.asarray(x, dtype=np.float64))


def round_half_away(x: float) -> int:
    """Rust ``f64::round`` semantics: ties round half AWAY from zero.

    Python's built-in ``round`` is banker's rounding, which differs on
    every exact .5 tie — the reference rounds unit sample counts
    (``src/blocks/morse.rs:355-357``) and mixer rational ratios
    (``src/blocks/transform.rs:298-302``) with Rust semantics, so parity
    code must too."""
    import math
    return int(math.copysign(math.floor(abs(x) + 0.5), x))
