"""Spec builders for ``test_torch_recycle.py``: picklable top-level
callables, as ``serve_recycling`` requires (its spawn workers import this
module by name).  The chains are ``tests/test_recycle.py``'s, built in
either package."""

import numpy as np


def _chain(lib):
    import importlib
    base = importlib.import_module(f"{lib}.blocks.base")
    filters = importlib.import_module(f"{lib}.blocks.filters")
    transform = importlib.import_module(f"{lib}.blocks.transform")
    return base.Chain(
        transform.FreqShifter.with_shift(1000.0),
        filters.Filter.new(
            lambda b, f: np.where(np.abs(f) <= 200.0, 1.0, 0.0)),
        transform.GainControl(0.5),
    )


def port_spec():
    return _chain("radiorust_tpu_torch")


def jax_spec():
    return _chain("radiorust_tpu")


def ragged_spec():
    from radiorust_tpu_torch.blocks.resampling import Downsampler
    return Downsampler(384.0, 200.0)  # phase mode at chunk 100


def dying_spec():
    import os
    os._exit(3)  # a worker killed before it can report


def chunks(t=7, n=256, seed=3):
    rng = np.random.default_rng(seed)
    return list((rng.standard_normal((t, n))
                 + 1j * rng.standard_normal((t, n))).astype(np.complex64))
