"""Inclusive associative scan along the last axis (plain PyTorch).

The JAX package runs its affine and clamped-affine scans (``Squelch``,
``AgcControl``) with ``lax.associative_scan`` outside any Pallas kernel;
PyTorch has no stable counterpart, so this is a Hillis-Steele doubling
scan: ``ceil(log2 n)`` rounds, round ``k`` combining every element with
the one ``2**k`` before it.  Each round is a handful of elementwise
tensor ops over the whole [..., n] operand.  ``Squelch`` runs it on
every device; ``AgcControl`` on CPU tensors only (``ops/scan.py::
agc_step_plain``), CUDA tensors taking the AGC kernel.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["associative_scan"]


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of a tuple of same-shape tensors along the last
    axis.  ``fn(earlier, later)`` combines two tuples elementwise and must
    be associative; element ``i`` of the result is
    ``fn(... fn(e[0], e[1]) ..., e[i])``."""
    elems = tuple(elems)
    n = elems[0].shape[-1]
    d = 1
    while d < n:
        earlier = tuple(e[..., :-d] for e in elems)
        later = tuple(e[..., d:] for e in elems)
        combined = fn(earlier, later)
        elems = tuple(torch.cat([e[..., :d], c], dim=-1)
                      for e, c in zip(elems, combined))
        d *= 2
    return elems
