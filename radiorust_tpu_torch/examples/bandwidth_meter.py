"""Occupied-bandwidth meter (radiorust's ``examples/bandwidth_meter/main.rs``
analog).

Tunes into a synthetic SDR stream, decimates to 102.4 kHz, low-passes,
overlaps chunks, transforms them with a Kaiser window, and prints the
largest occupied bandwidth over the run; the analysis runs on the device.

    python -m radiorust_tpu_torch.examples.bandwidth_meter [--device cpu]
"""

import asyncio

from ..metering import bandwidth
from ..models.bandwidth_meter import bandwidth_meter_chain
from ..runtime import ArraySink, Rechunker, RuntimeBlock, wait_until
from ..runtime.io import SdrRx, SyntheticSdrDriver
from ..runtime.blocks import resolve_device
from ._common import cli


async def session(device):
    max_bandwidth = 50e3
    quality = 4
    sdr = SdrRx(SyntheticSdrDriver(1024000.0,
                                   tones=((5000.0, 1.0), (-4000.0, 0.7)),
                                   noise=0.001))
    rechunk = Rechunker(10240)
    chain = RuntimeBlock(
        bandwidth_meter_chain(max_bandwidth=max_bandwidth, quality=quality),
        name="bw_meter", device=device)
    sink = ArraySink()
    rechunk.feed_from(sdr)
    chain.feed_from(rechunk)
    sink.feed_from(chain)

    await sdr.activate()
    await wait_until(  # fail fast if any actor failed
        lambda: len(sink.chunks) >= 12, sdr, rechunk, chain, sink)
    await sdr.deactivate()

    values = [bandwidth(0.01, sink.sample_rate, c)
              for c in sink.chunks[quality + 1:]]
    print(f"analysis rate {sink.sample_rate} Hz; "
          f"max occupied bandwidth {max(values):.0f} Hz "
          f"(expect ~>9 kHz for tones at +5 kHz and -4 kHz)")
    return {"bandwidth": max(values), "values": values,
            "devices": [chain.device]}


def main(device="cuda"):
    return asyncio.run(session(resolve_device(device)))


if __name__ == "__main__":
    cli(main, __doc__)
