"""A mono broadcast FM station: two seeded tones whose amplitudes sum to
0.9 of full scale."""

from benchmark.signals import _fm


def clean(spec, t, draw, b):
    two, _, share = _fm.tones(spec, t, draw, b)
    msg = 0.9 * (share * two[:, 0] + (1.0 - share) * two[:, 1])
    return _fm.modulate(spec, t, draw, msg)
