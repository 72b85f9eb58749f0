"""Morse RF transmitter (radiorust's ``examples/morse_rf/main.rs`` analog).

Keys a message, FM-modulates it, and transmits through an SDR TX block,
deactivating the transmitter when the keyer signals EndOfMessages: the
reference's event-driven TX lifecycle (``morse_rf/main.rs:72-98``).

    python -m radiorust_tpu_torch.examples.morse_rf [--device cpu]
"""

import asyncio

import numpy as np

from ..blocks.morse import EndOfMessages, Speed
from ..models.morse_tx import morse_rf_chain
from ..runtime import KeyerSource, RuntimeBlock
from ..runtime.io import LoopbackSdrDriver, SdrTx
from ..runtime.blocks import resolve_device
from ._common import cli, fm_tone


class _SentDriver(LoopbackSdrDriver):
    """The loopback driver, keeping every chunk transmitted."""

    def __init__(self, sample_rate: float):
        super().__init__(sample_rate)
        self.sent = []

    def write(self, chunk) -> None:
        self.sent.append(np.asarray(chunk, np.complex64).copy())
        super().write(chunk)


async def session(device):
    rate = 128000.0
    keyer = KeyerSource(8192, rate, Speed.from_paris_wpm(20.0),
                        message="CQ CQ")
    chain = RuntimeBlock(morse_rf_chain(deviation=2500.0), name="morse_rf",
                         device=device)
    driver = _SentDriver(rate)
    tx = SdrTx(driver)
    chain.feed_from(keyer)
    tx.feed_from(chain)

    await tx.activate()
    await asyncio.wait_for(
        tx.wait_for_event(lambda e: isinstance(e, EndOfMessages)), 120.0)
    await tx.deactivate()
    print("message transmitted; TX deactivated on EndOfMessages")
    iq = np.concatenate(driver.sent)
    tone, deviation = fm_tone(iq, rate)
    print(f"transmitted {len(iq)} samples: FM tone {tone:.0f} Hz, peak "
          f"deviation {deviation:.0f} Hz")
    return {"iq": iq, "tone": tone, "deviation": deviation,
            "devices": [chain.device]}


def main(device="cuda"):
    return asyncio.run(session(resolve_device(device)))


if __name__ == "__main__":
    cli(main, __doc__)
