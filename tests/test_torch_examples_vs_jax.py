"""The port's examples against the JAX package's (``examples/``) on the
same synthetic drivers, both in this process on the CPU: ``morse``'s
played audio, ``morse_rf``'s transmitted IQ and ``bandwidth_meter``'s
occupied bandwidth chunk by chunk, each within 3e-4 (the runtime's limit
against the JAX actors in ``test_torch_runtime.py``)."""

import asyncio
import importlib.util
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
ATOL = 3e-4


def _jax_example(name, **patches):
    """``examples/<name>.py`` as a module, with ``patches`` set on it."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, value in patches.items():
        setattr(mod, key, value)
    return mod


def _kept(cls, made):
    """A subclass of ``cls`` that appends each instance to ``made``."""
    class Kept(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)
    return Kept


def test_morse_plays_what_the_jax_example_plays():
    from radiorust_tpu.runtime.io import LoopbackAudioDriver
    from radiorust_tpu_torch.examples import morse

    drivers = []
    asyncio.run(_jax_example("morse", LoopbackAudioDriver=_kept(
        LoopbackAudioDriver, drivers)).main())
    want = np.concatenate(drivers[0].played)
    got = morse.main(device="cpu")["audio"]
    assert got.shape == want.shape
    assert float(np.abs(want).max()) > 0.4
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_morse_rf_transmits_what_the_jax_example_transmits():
    from radiorust_tpu.runtime.io import LoopbackSdrDriver
    from radiorust_tpu_torch.examples import morse_rf

    drivers = []
    asyncio.run(_jax_example("morse_rf", LoopbackSdrDriver=_kept(
        LoopbackSdrDriver, drivers)).main())
    want = np.concatenate(drivers[0]._buf)
    got = morse_rf.main(device="cpu")["iq"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bandwidth_meter_measures_what_the_jax_example_measures():
    from radiorust_tpu.runtime import ArraySink
    from radiorust_tpu_torch.examples import bandwidth_meter

    sinks = []
    mod = _jax_example("bandwidth_meter", ArraySink=_kept(ArraySink, sinks))
    asyncio.run(mod.main())
    sink = sinks[0]
    want = [mod.bandwidth(0.01, sink.sample_rate, c)
            for c in sink.chunks[5:]]
    got = bandwidth_meter.main(device="cpu")["values"]
    n = min(len(got), len(want))
    assert n >= 7
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-3)
