"""The port's graph and two-actor examples (``spectrum_receiver``,
``stereo_receiver``, ``am_ssb_receiver``) run as subprocesses on the CPU
(``--device cpu``) with the assertions of the JAX package's smoke tests
(``tests/test_io.py``, ``tests/test_analog.py``), and the ISB tones; a
failure in one of two actors fed from one ``Rechunker`` surfaces."""

import asyncio

import pytest

from radiorust_tpu_torch.examples._common import check_output
from torch_examples import run_example


@pytest.mark.parametrize("name", ["spectrum_receiver", "stereo_receiver",
                                  "am_ssb_receiver"])
def test_example_runs_on_the_cpu(name):
    r = run_example(name, "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    check_output(name, r.stdout)


def test_a_failing_actor_beside_another_surfaces():
    """am_ssb_receiver's shape (two actors off one Rechunker): a failure
    in one surfaces through ``wait_until`` instead of hanging the other,
    which goes on receiving."""
    from radiorust_tpu_torch.blocks.filters import Filter
    from radiorust_tpu_torch.examples.am_ssb_receiver import (
        AM_OFFSET, TwoStationDriver)
    from radiorust_tpu_torch.models.analog import (ANALOG_INPUT_CHUNK,
                                                   ANALOG_INPUT_RATE,
                                                   am_receiver)
    from radiorust_tpu_torch.runtime import (ArraySink, Rechunker,
                                             RuntimeBlock, wait_until)
    from radiorust_tpu_torch.runtime.io import SdrRx

    async def main():
        sdr = SdrRx(TwoStationDriver(ANALOG_INPUT_RATE, tones=(), noise=0.0))
        rechunk = Rechunker(ANALOG_INPUT_CHUNK)
        am = RuntimeBlock(am_receiver(tune_shift=-AM_OFFSET), name="am",
                          device="cpu")
        # A scalar-style design closure: the vectorized call raises.
        bad = RuntimeBlock(Filter.new(lambda b, f: 1.0 if f > 0 else 0.0),
                           name="bad", device="cpu")
        am_sink, bad_sink = ArraySink(), ArraySink()
        rechunk.feed_from(sdr)
        am.feed_from(rechunk)
        bad.feed_from(rechunk)
        am_sink.feed_from(am)
        bad_sink.feed_from(bad)
        await sdr.activate()
        with pytest.raises(RuntimeError, match="bad failed"):
            await wait_until(lambda: False, sdr, rechunk, am, bad, am_sink,
                             bad_sink, timeout=30.0)
        assert isinstance(bad.failure, ValueError) and am.failure is None
        before = len(am_sink.chunks)
        await wait_until(lambda: len(am_sink.chunks) >= before + 3, am,
                         timeout=30.0)
        await sdr.deactivate()

    asyncio.run(asyncio.wait_for(main(), 90.0), debug=True)
