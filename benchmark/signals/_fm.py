"""What the broadcast FM kinds share: two seeded tones, and a carrier
near ``carrier_hz`` frequency-modulated by a message."""

from __future__ import annotations

import math

import torch

TAU = 2.0 * math.pi


def tones(spec, t, draw, b):
    """(two tones [b, 2, samples] of seeded frequency and phase, the
    seeded phases [b, 3, 1] (the third for a pilot), a seeded share of
    the first tone [b, 1] in 0.2-0.8)."""
    lo, hi = spec["tone_hz"]
    freqs = draw(lo, hi, (b, 2, 1))
    phases = draw(0.0, TAU, (b, 3, 1))
    two = torch.sin(TAU * freqs * t[:, None, :] + phases[:, :2])
    return two, phases, draw(0.2, 0.8, (b, 1))


def modulate(spec, t, draw, msg):
    """The carrier at ``carrier_hz`` plus a seeded offset within
    ``carrier_spread_hz``, at ``deviation_hz`` peak for a full-scale
    message, from a seeded start phase."""
    dt = float(t[0, 1] - t[0, 0])
    b = msg.shape[0]
    spread = float(spec["carrier_spread_hz"])
    carrier = float(spec["carrier_hz"]) + draw(-spread, spread, (b, 1))
    start = draw(0.0, TAU, (b, 1))
    phase = (TAU * float(spec["deviation_hz"]) * dt
             * torch.cumsum(msg, dim=-1) + TAU * carrier * t + start)
    return torch.polar(torch.ones_like(phase), torch.remainder(phase, TAU))
