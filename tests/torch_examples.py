"""Runs an example of the port as its users do:
``python -m radiorust_tpu_torch.examples.<name> [args]`` from the root of
the repository."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_example(name, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", f"radiorust_tpu_torch.examples.{name}",
         *args], capture_output=True, text=True, timeout=timeout, cwd=REPO)
