"""A stereo broadcast FM station, the ITU-R BS.450 multiplex: one seeded
tone an ear, (L+R)/2 at baseband and (L-R)/2 on a 38 kHz subcarrier
locked to twice the 19 kHz pilot's phase, ``1 - pilot_level`` of program
and ``pilot_level`` of pilot."""

import math

import torch

from benchmark.signals import _fm


def clean(spec, t, draw, b):
    two, phases, share = _fm.tones(spec, t, draw, b)
    left, right = share * two[:, 0], (1.0 - share) * two[:, 1]
    pilot = 2.0 * math.pi * 19000.0 * t + phases[:, 2]
    level = float(spec["pilot_level"])
    msg = ((1.0 - level) * (0.5 * (left + right)
                            + 0.5 * (left - right) * torch.cos(2 * pilot))
           + level * torch.cos(pilot))
    return _fm.modulate(spec, t, draw, msg)
