"""The port's receiver examples (``radiorust_tpu_torch/examples``) run as
subprocesses on the CPU (``--device cpu``) and pass the assertions of the
JAX package's smoke tests of its examples (``tests/test_io.py``,
``tests/test_tuner_example.py``; ``recycling_server`` across three
spawned worker generations); without a card and without
``--device`` an example raises.  The graph and transmit examples are in
``test_torch_examples_graphs.py`` and ``test_torch_examples_tx.py``."""

import pytest
import torch

from radiorust_tpu_torch.examples._common import check_output
from torch_examples import run_example


@pytest.mark.parametrize("name, args", [
    ("wfm_receiver", ()),
    ("tuner", ("--auto",)),
    ("audio_44k_receiver", ()),
    ("bandwidth_meter", ()),
    ("recycling_server", ()),
])
def test_example_runs_on_the_cpu(name, args):
    r = run_example(name, *args, "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    check_output(name, r.stdout)


def test_example_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    r = run_example("wfm_receiver", timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "dominant tone" not in r.stdout
