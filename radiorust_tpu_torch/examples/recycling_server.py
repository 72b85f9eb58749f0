"""Long-lived serving with checkpoint-based worker recycling.

``serve_recycling`` bounds each worker process's lifetime: serve N
chunks, checkpoint the live stream state
(:meth:`RuntimeBlock.save_checkpoint`), exit; a fresh process resumes
bit-exactly: no Warmup re-emission, no seam in the audio.  Here 12
chunks of an FM station (a 1 kHz tone, 5 kHz off the tuned frequency)
go through three generations of four chunks each.

The supervisor (this process) creates no CUDA context; worker
generations run strictly one after another, so each owns the card
alone.  The ``if __name__ == "__main__"`` guard is REQUIRED: workers are
spawn processes, which re-import this module.

    python -m radiorust_tpu_torch.examples.recycling_server [--device cpu]
"""

import os
import tempfile

import numpy as np

from ..blocks.base import Chain
from ..blocks.filters import Filter
from ..blocks.modulation import FmDemod
from ..blocks.transform import FreqShifter
from ..runtime import serve_recycling
from ..runtime.blocks import resolve_device
from ._common import cli, dominant_tone

RATE = 256000.0
CHUNK = 2048


def spec():
    """Rebuilt by every worker generation; only the stream state rides
    the checkpoint."""
    return Chain(
        FreqShifter.with_shift(5000.0),
        Filter.new(lambda bins, f: np.where(np.abs(f) <= 50e3, 1.0, 0.0)),
        FmDemod(75000.0),
    )


def main(device="cuda"):
    device = str(resolve_device(device))
    t = np.arange(12 * CHUNK) / RATE
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 75000.0 / RATE * np.cumsum(audio))
                - 1j * 2 * np.pi * 5000.0 * t).astype(np.complex64)
    chunks = list(iq.reshape(12, CHUNK))

    stats = []
    with tempfile.TemporaryDirectory() as tmp:
        outs, gens, warmups = serve_recycling(
            spec, chunks, RATE, chunks_per_worker=4,
            ckpt_path=os.path.join(tmp, "recycling_server_ckpt.npz"),
            device=device, stats=stats)

    out = np.concatenate(outs)
    peak = dominant_tone(np.real(out[len(out) // 2:]), RATE)
    print(f"served {len(out)} samples across {gens} worker generations "
          f"(warmups per gen: {warmups}), dominant tone {peak:.0f} Hz")
    assert gens == 3 and warmups == [1, 0, 0], (gens, warmups)
    assert abs(peak - 1000.0) < 5.0, peak
    # What each generation reported it ran on and launched.
    return {"tone": peak, "generations": gens, "warmups": warmups,
            "audio": out, "devices": [s["device"] for s in stats],
            "launches": [s["launches"] for s in stats]}


if __name__ == "__main__":
    cli(main, __doc__)
