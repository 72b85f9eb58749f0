"""The 95th percentile over every chunk of the window of one chunk's
latency, from the host issuing its copy to the card to its outputs being
complete in host memory, in us."""

import numpy as np


def read(ctx):
    lat = ctx.window.latency_s
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, 95)) * 1e6
