"""The port's transmit and host-only examples (``morse``, ``morse_rf``,
``audiopipe``) run as subprocesses on the CPU with the assertions of the
JAX package's smoke tests (``tests/test_io.py``); ``audiopipe`` takes no
device."""

import pytest

from radiorust_tpu_torch.examples._common import check_output
from torch_examples import run_example


@pytest.mark.parametrize("name, args", [
    ("morse", ("--device", "cpu")),
    ("morse_rf", ("--device", "cpu")),
    ("audiopipe", ()),
])
def test_example_runs_on_the_cpu(name, args):
    r = run_example(name, *args)
    assert r.returncode == 0, r.stdout + r.stderr
    check_output(name, r.stdout)


def test_check_output_refuses_a_wrong_tone():
    with pytest.raises(AssertionError):
        check_output("stereo_receiver", "stereo audio: L tone 1000 Hz, "
                     "R tone 2400 Hz; pilot 0.100 -> STEREO")
    check_output("stereo_receiver", "stereo audio: L tone 1001 Hz, "
                 "R tone 2503 Hz; pilot 0.100 -> STEREO")
    with pytest.raises(AssertionError):
        check_output("morse", "played 0 samples")


@pytest.mark.parametrize("name, out", [
    ("morse", "played 143360 samples (2.99s of keyed audio)\n"
              "keyed tone 700 Hz, peak 0.051"),
    ("morse", "played 8192 samples (0.17s of keyed audio)\n"
              "keyed tone 700 Hz, peak 0.510"),
    ("morse", "played 143360 samples (2.99s of keyed audio)\n"
              "keyed tone 350 Hz, peak 0.510"),
    ("morse_rf", "message transmitted; TX deactivated on EndOfMessages\n"
                 "transmitted 524290 samples: FM tone 700 Hz, peak "
                 "deviation 2500 Hz"),
    ("bandwidth_meter", "analysis rate 102400.0 Hz; max occupied bandwidth "
                        "4000 Hz (expect ~>9 kHz)"),
    ("spectrum_receiver", "audio: 48000.0 Hz, 25344 samples, dominant tone "
                          "1001 Hz; occupied bandwidth 15.4 kHz"),
])
def test_check_output_refuses_wrong_numbers(name, out):
    """The examples whose reference checks only a text they always print
    are held to the numbers they print."""
    with pytest.raises(AssertionError):
        check_output(name, out)
