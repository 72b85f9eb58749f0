"""radiorust_tpu_torch: the PyTorch and CUDA port of radiorust_tpu.

The same block specs and the same ``bind(sig) -> (params, init_state(),
process(params, state, x, reset))`` contract as the JAX package, on
torch tensors.  Filter, window and resampler design runs on the host in
float64 numpy; the per-sample path runs in complex64 on the device the
tensors live on.  On an NVIDIA H100 the hot kernels are hand-written CUDA
(``csrc/``, built with ``nvcc`` at first use); on CPU tensors each kernel
wrapper runs its plain PyTorch version.

This package imports torch and numpy, and never jax.
"""

from . import math, metering, numbers, windowing  # noqa: F401
from .blocks import morse  # noqa: F401

__version__ = "0.1.0"
