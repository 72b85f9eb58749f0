"""The measurement tools of the port: the JAX package's ``tools/``
benchmarks and soak on torch, each run as ``python -m
radiorust_tpu_torch.tools.<name>`` (``bench_configs``, ``bench_latency``,
``bench_channelizer``, ``soak``, ``bench_serving``).

Each runs on CUDA by default, takes ``--device cpu`` (the kernels' plain
versions, for tests) and raises without a card unless it is given the
CPU.  Each keeps its JAX counterpart's configs, defaults, environment
variables and JSON fields, and adds the platform and the card's name.
``main(argv)`` runs a tool in-process and returns its records.
"""
