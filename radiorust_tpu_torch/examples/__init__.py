"""Runnable applications of the port: the JAX package's ``examples/`` on
torch, each run as ``python -m radiorust_tpu_torch.examples.<name>``.

Every example but ``audiopipe`` (host-only) takes ``--device`` (default
``cuda``; ``--device cpu`` runs the kernels' plain versions) and raises
without a card unless it is given the CPU.  ``main(device=...)`` runs the
same session in-process and returns what it measured.
"""
