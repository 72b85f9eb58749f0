"""The general input generator: what a configuration's receivers hear,
made on the device from the seed.

The configuration's ``signal`` names a kind, ``benchmark/signals/
<kind>.py``, whose ``clean(spec, t, draw, batch)`` gives each stream's
noiseless complex baseband at the SDR ([batch, samples], complex128)
from the time base ``t`` and seeded uniform draws ``draw(lo, hi,
shape)``; this
module adds complex Gaussian noise at a seeded SNR in ``snr_db``.  The
streams are continuous over ``n_chunks`` chunks, and every seed gives the
same sizes: only the content differs.
"""

from __future__ import annotations

import importlib
import math

import torch


def make(config: dict, n_chunks: int, seed: int, device,
         batch: int = None) -> torch.Tensor:
    """[n_chunks, batch, chunk_len] complex64 on ``device``."""
    sig, spec = config["sig"], config["signal"]
    b = int(sig["batch"] if batch is None else batch)
    n, rate = int(sig["chunk_len"]), float(sig["sample_rate"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))

    def draw(lo, hi, shape):
        u = torch.rand(shape, generator=g, device=device,
                       dtype=torch.float64)
        return lo + (hi - lo) * u

    t = torch.arange(n_chunks * n, dtype=torch.float64,
                     device=device)[None, :] / rate
    kind = importlib.import_module(f"benchmark.signals.{spec['kind']}")
    x = kind.clean(spec, t, draw, b)
    lo_db, hi_db = spec["snr_db"]
    sigma = (10.0 ** (-draw(lo_db, hi_db, (b, 1)) / 20.0)
             / math.sqrt(2.0)).to(torch.float32)
    noise = torch.complex(
        torch.randn((b, n_chunks * n), generator=g, device=device),
        torch.randn((b, n_chunks * n), generator=g, device=device))
    x = x.to(torch.complex64) + sigma * noise
    return x.reshape(b, n_chunks, n).permute(1, 0, 2).contiguous()
