"""The frozen yardstick (``benchmark/counts/``) at small plans, against
numbers worked by hand, so it cannot drift with the program's own
accounting."""

import pytest

from benchmark.counts import roofline as rl
from benchmark.harness import trace
from benchmark.reference import _dsp


def test_peaks_and_least_time():
    assert rl.PEAK_BYTES_S == 3.35e12 and rl.PEAK_FLOPS == 67e12
    assert rl.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert rl.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert rl.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)


def test_kernel_counts_by_hand():
    # #1, 8:1 on a real plane: 2 rows of 64, 288 taps, 287 history.
    assert rl.decimate(8, 1, 288, 287, 2, 64, planes=1) == (
        2 * 2 * 8 * 288, 4 * 2 * (64 + 287 + 8) + 4 * 288)
    assert rl.decimate(8, 1, 288, 287, 2, 64, planes=1) == (9216, 4024)
    # #2, 8:3 over 102 multiply-adds a period, both planes, the mixer.
    assert rl.mix_decimate(8, 3, 102, 33, 2, 64) == (8832, 2352)
    # #3: 2 rows, 8 new samples, 8 of history (a 16-point transform:
    # 5 * 16 * 4 = 320 a transform, 6 * 16 a response multiply).
    assert rl.overlap_save(2, 8, 8) == (1472, 512)
    # #4: three bands on a real input.
    assert rl.overlap_save(2, 8, 8, bands=3, real_input=True) == (3136, 896)
    # #5: demod of 2 x 8, one paired row of 16 points.
    assert rl.demod_filter(2, 8, 8) == (864, 464)


def test_resampler_plans():
    front = _dsp.downsampler(1024000.0, 384000.0, 200000.0)
    assert (front.p, front.q, len(front.taps)) == (8, 3, 34)
    assert front.offsets == (2, 5, 7) and front.nonzero_taps == 102
    audio = _dsp.downsampler(384000.0, 48000.0, 40000.0)
    assert (audio.p, audio.q, len(audio.taps)) == (8, 1, 288)
    assert audio.offsets == (7,) and audio.history == 287


def test_port_kernel_names():
    rx = trace.port_regex()
    assert rx.search("void decimate_kernel<true, 2, 4>(DecimArgs, int)")
    assert rx.search("void (anonymous namespace)::os_rows<4, 32>(float)")
    assert rx.search("os_cluster<8, 32, false>")
    assert not rx.search("void at::native::vectorized_elementwise_kernel")
    assert not rx.search("Memcpy DtoD (Device -> Device)")
    assert not rx.search("my_decimate_kernel_v2")
