"""What the examples share: the command line (``--device``), a synthetic
FM station, the host-side tone analysis, and the checks their output must
pass."""

from __future__ import annotations

import argparse
import re

import numpy as np

from ..runtime.io import SyntheticSdrDriver

__all__ = ["cli", "dominant_tone", "fm_tone", "FmToneDriver",
           "check_output"]


def cli(main, doc: str, *flags: str, device: bool = True):
    """Run ``main`` from the command line: ``--device`` (default
    ``cuda``) and each of ``flags`` as a switch, passed as keywords."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if device:
        p.add_argument("--device", default="cuda",
                       help="torch device of the blocks: cuda (default), "
                            "cuda:N or cpu")
    for flag in flags:
        p.add_argument(flag, action="store_true")
    return main(**vars(p.parse_args()))


def dominant_tone(signal, rate: float) -> float:
    """The frequency of the largest Hann-windowed spectral peak of a real
    signal."""
    signal = np.asarray(signal)
    spec = np.abs(np.fft.rfft(signal * np.hanning(len(signal))))
    return float(np.fft.rfftfreq(len(signal), 1.0 / rate)[np.argmax(spec)])


def fm_tone(iq, rate: float):
    """(dominant tone, peak deviation) in Hz of the instantaneous frequency
    of an FM signal."""
    iq = np.asarray(iq)
    freq = np.angle(iq[1:] * np.conj(iq[:-1])) * rate / (2 * np.pi)
    return dominant_tone(freq, rate), float(np.abs(freq).max())


class FmToneDriver(SyntheticSdrDriver):
    """Synthesizes an FM carrier modulated with a 1 kHz tone (150 kHz
    deviation, amplitude 0.5)."""

    _phase = 0.0

    def read(self, n):
        t = (np.arange(self._pos, self._pos + n)) / self.sample_rate
        self._pos += n
        audio = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
        phase = self._phase + np.cumsum(
            2 * np.pi * 150000.0 * audio / self.sample_rate)
        self._phase = float(phase[-1]) % (2 * np.pi)
        return np.exp(1j * phase).astype(np.complex64)


def _near(pattern: str, want, tol: float, rel: bool = False):
    """The numbers ``pattern`` captures, each within ``tol`` of its
    ``want`` (``tol`` a fraction of it if ``rel``)."""
    def check(out: str):
        m = re.search(pattern, out)
        wants = want if isinstance(want, tuple) else (want,)
        if not (m and all(abs(float(g) - w) <= (tol * w if rel else tol)
                          for g, w in zip(m.groups(), wants))):
            raise AssertionError(f"want {pattern} at {wants} "
                                 f"(+-{tol}{' of it' if rel else ''}):\n"
                                 f"{out}")
    return check


def _has(*texts: str, any_of: bool = False):
    def check(out: str):
        found = [t in out for t in texts]
        if not (any(found) if any_of else all(found)):
            raise AssertionError(f"want {texts}:\n{out}")
    return check


# What each example must print: the assertions of the JAX package's smoke
# tests of its examples (tests/test_io.py, tests/test_analog.py,
# tests/test_tuner_example.py), the ISB tones am_ssb_receiver prints, and
# the numbers the other examples print, held to what their signals make:
# two tones 9 kHz apart (bandwidth_meter); FM at 75 kHz peak deviation of
# a 1 kHz tone, 152 kHz by Carson's rule (spectrum_receiver); a 700 Hz
# tone keyed at gain 0.5 (morse), "VVV" and a word gap at 16 wpm: 40
# units of 75 ms, 144000 samples at 48 kHz, played in whole chunks of
# 4096; and FM of that tone at 2500 Hz deviation, 1250 Hz at gain 0.5
# (morse_rf).
_CHECKS = {
    "wfm_receiver": [_has("dominant tone 1000 Hz")],
    "tuner": [_has("auto session OK")],
    "audio_44k_receiver": [_has("44100 Hz"),
                           _near(r"dominant tone (\d+) Hz", 1000.0, 5)],
    "bandwidth_meter": [_near(r"max occupied bandwidth (\d+) Hz", 9000.0,
                              0.05, rel=True)],
    "spectrum_receiver": [
        _near(r"dominant tone (\d+) Hz", 1000.0, 5),
        _near(r"occupied bandwidth ([\d.]+) kHz", 152.0, 0.1, rel=True)],
    "stereo_receiver": [_near(r"L tone (\d+) Hz, R tone (\d+) Hz",
                              (1000.0, 2500.0), 5), _has("STEREO")],
    "am_ssb_receiver": [_has("AM  program tone: 1000 Hz",
                             "SSB program tone: 1500 Hz"),
                        _near(r"ISB usb program tone: (\d+) Hz", 1000.0, 5),
                        _near(r"ISB lsb program tone: (\d+) Hz", 2000.0, 5)],
    "morse": [_has("keyed audio"),
              _near(r"played (\d+) samples", 144000.0, 4096),
              _near(r"keyed tone (\d+) Hz", 700.0, 5),
              _near(r"keyed tone \d+ Hz, peak ([\d.]+)", 0.5, 0.1,
                    rel=True)],
    "morse_rf": [_has("TX deactivated on EndOfMessages"),
                 _near(r"FM tone (\d+) Hz", 700.0, 5),
                 _near(r"peak deviation (\d+) Hz", 1250.0, 0.1, rel=True)],
    "audiopipe": [_has("piped", "real audio", any_of=True)],
    "fleet_receiver": [_has("fleet: 16/16", "wideband: 3/3",
                            "Hz recovered (ok")],
    "recycling_server": [_has("across 3 worker generations",
                              "warmups per gen: [1, 0, 0]"),
                         _near(r"dominant tone (\d+) Hz", 1000.0, 5)],
}

def check_output(name: str, out: str) -> None:
    """Raise :class:`AssertionError` unless ``out``, what example ``name``
    printed, passes that example's checks."""
    for check in _CHECKS[name]:
        check(out)
