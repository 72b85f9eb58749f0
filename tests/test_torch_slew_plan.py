"""The segmented slew-scan kernel's index and repair logic, on the CPU.

``csrc/scan.cu`` (``slew_segments``) splits each stream's T samples into
segments of L samples, walks every segment from a guessed carry (the input
sample just before it; segment 0 from the true carry), then repairs in
passes: a segment whose predecessor's last output differs bit for bit
from the carry it last walked from re-walks from that output and stops
where its p meets the stored output in both planes: at any sample on the
kernel's device-memory path, at a quad's last sample on its shared-memory
path (T a multiple of 4).  The model below follows that logic step for
step (segments vectorised, each step the plain version's own float32
operations), on the path the kernel takes for each T, and is held bit for
bit
against ``slew_scan_plain`` on the keyer envelopes the morse chains feed
it, on random input that is clamped at every sample, on input with NaNs,
at several segment lengths and on T that is not a multiple of L.  It
also counts the steps on the kernel's critical path.  Nothing here needs
a GPU.
"""

import numpy as np
import pytest
import torch

from radiorust_tpu_torch.blocks.morse import Keyer, Speed
from radiorust_tpu_torch.ops import scan as tscan

MESSAGES = ("CQ CQ DE K1ABC K", "TEST DE W1AW", "QRZ? DE DL1XYZ",
            "<SK> 73 DE G4ABC")
CHUNK = 4096


def _bits(t):
    return t.contiguous().view(torch.int32)


def _step(pr, pi, xr, xi, md, rsqrt):
    """One step of ``slew_scan_plain`` on [n] float32 tensors."""
    md2 = md * md
    one = torch.ones((), dtype=torch.float32)
    dr = xr - pr
    di = xi - pi
    n2 = dr * dr + di * di
    if rsqrt:
        scale = torch.where(n2 > md2, md * torch.rsqrt(n2), one)
    else:
        norm = torch.sqrt(n2)
        scale = torch.where(norm > md, md / norm, one)
    return pr + dr * scale, pi + di * scale


def segmented(xr, xi, prev_r, prev_i, max_diff, rsqrt, seg):
    """``slew_segments`` on [B, T] planes at segment length seg.  Returns
    (yr, yi, carry r, carry i, passes, critical steps): the passes that
    re-walked some segment, and the steps on the longest path (the first
    walk's L, then per pass the most steps any segment walked)."""
    md = torch.as_tensor(max_diff, dtype=torch.float32).reshape(())
    B, T = xr.shape
    quads = T % 4 == 0   # the shared-memory path: compare at quad ends
    S = -(-T // seg)
    assert S <= tscan._MAX_SEGMENTS
    t0 = torch.arange(S) * seg                      # [S]
    t1 = torch.clamp(t0 + seg, max=T)
    yr = torch.full((B, T), float("nan"))
    yi = torch.full((B, T), float("nan"))
    rows = torch.arange(B)[:, None].expand(B, S)
    # The carries walked from: the true one for segment 0, else the input
    # sample before the segment.
    cr = torch.where(t0 == 0, prev_r[:, None], xr[:, (t0 - 1).clamp(min=0)])
    ci = torch.where(t0 == 0, prev_i[:, None], xi[:, (t0 - 1).clamp(min=0)])

    def walk(active, pr, pi, repair):
        """Walk the segments where ``active`` ([B, S]) from (pr, pi); with
        ``repair``, a segment stops where it meets the stored outputs.
        Returns (p at the end, reached the end, most steps walked)."""
        going = active.clone()
        most = 0
        for i in range(seg):
            t = t0 + i
            lane = going & (t < t1)[None, :]
            if not lane.any():
                break
            b, k = rows[lane], torch.arange(S).expand(B, S)[lane]
            tt = t[k]
            nr, ni = _step(pr[lane], pi[lane], xr[b, tt], xi[b, tt], md,
                           rsqrt)
            if repair:
                met = ((_bits(nr) == _bits(yr[b, tt]))
                       & (_bits(ni) == _bits(yi[b, tt])))
                if quads and i % 4 != 3:
                    met = torch.zeros_like(met)
                keep = ~met
                yr[b[keep], tt[keep]] = nr[keep]
                yi[b[keep], tt[keep]] = ni[keep]
                stop = torch.zeros_like(going)
                stop[lane] = met
                going &= ~stop
            else:
                yr[b, tt] = nr
                yi[b, tt] = ni
            pr, pi = pr.clone(), pi.clone()
            pr[lane], pi[lane] = nr, ni
            most = i + 1
        return pr, pi, going, most

    live = torch.ones((B, S), dtype=torch.bool)
    lr, li, _, critical = walk(live, cr.clone(), ci.clone(), False)
    passes = 0
    while True:
        pred_r = torch.roll(lr, 1, dims=1)
        pred_i = torch.roll(li, 1, dims=1)
        need = ((_bits(pred_r) != _bits(cr)) | (_bits(pred_i) != _bits(ci)))
        need[:, 0] = False
        if not need.any():
            break
        passes += 1
        assert passes <= S
        cr = torch.where(need, pred_r, cr)
        ci = torch.where(need, pred_i, ci)
        pr, pi, ended, most = walk(need, cr.clone(), ci.clone(), True)
        critical += most
        lr = torch.where(ended, pr, lr)
        li = torch.where(ended, pi, li)
    return yr, yi, lr[:, -1], li[:, -1], passes, critical


def keyer_planes(streams, chunks, rate):
    """[chunks, streams, CHUNK] keyer envelopes (the morse chains'
    input): MESSAGES in turn at 30 down to 15 wpm."""
    env = np.stack([Keyer(CHUNK, rate, Speed.from_paris_wpm(30 - s % 16),
                          MESSAGES[s % len(MESSAGES)]).envelope(chunks)
                    for s in range(streams)], axis=1)
    return (torch.from_numpy(np.ascontiguousarray(env.real)),
            torch.from_numpy(np.ascontiguousarray(env.imag)))


def block_max_diff(rate):
    """SlewRateLimiter(100)'s step bound at ``rate``, as the block forms
    it (a float32 division of tensors)."""
    return (torch.tensor(100.0, dtype=torch.float32)
            / torch.tensor(rate, dtype=torch.float32))


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("rsqrt", [True, False], ids=["rsqrt", "sqrt/div"])
@pytest.mark.parametrize("rate", [48000.0, 128000.0], ids=["audio", "rf"])
def test_keyer_envelopes_bit_equal_and_short_path(rate, rsqrt):
    """Path E's input, chunk by chunk with the carry handed on: bit-equal
    outputs and carries, and a critical path of the longest ramp (1 / md
    samples) plus a few segments, far under the chunk's 4096 steps."""
    xr, xi = keyer_planes(6, 3, rate)
    md = block_max_diff(rate)
    seg = tscan.segment_length(CHUNK)
    assert seg == 64
    pr = pi = torch.zeros(xr.shape[1])
    ramp = int(np.ceil(1.0 / float(md)))
    for c in range(xr.shape[0]):
        want = tscan.slew_scan_plain(xr[c], xi[c], pr, pi, md, rsqrt=rsqrt)
        *got, passes, critical = segmented(xr[c], xi[c], pr, pi, md, rsqrt,
                                           seg)
        assert_bit_equal(got, want)
        assert critical <= ramp + 3 * seg, (critical, ramp)
        pr, pi = want[2], want[3]


@pytest.mark.parametrize("rsqrt", [True, False], ids=["rsqrt", "sqrt/div"])
@pytest.mark.parametrize("seg, T", [(64, 4096), (16, 1000), (4, 257),
                                    (256, 1001)])
def test_random_all_clamped_bit_equal(seg, T, rsqrt):
    """Random input at path E's md is clamped at every sample and never
    converges: every segment repairs, T / L passes, T + L steps at most;
    still the serial loop's outputs bit for bit (T not a multiple of L
    included)."""
    rng = np.random.default_rng(seg + T)
    x = torch.from_numpy(rng.standard_normal((2, 3, T)).astype(np.float32))
    prev = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    md = block_max_diff(48000.0)
    want = tscan.slew_scan_plain(x[0], x[1], prev[0], prev[1], md,
                                 rsqrt=rsqrt)
    *got, passes, critical = segmented(x[0], x[1], prev[0], prev[1], md,
                                       rsqrt, seg)
    assert_bit_equal(got, want)
    S = -(-T // seg)
    assert passes == S - 1 and critical <= T + seg


@pytest.mark.parametrize("rsqrt", [True, False], ids=["rsqrt", "sqrt/div"])
@pytest.mark.parametrize("seg", [4, 32])
def test_nan_bearing_input_bit_equal(seg, rsqrt):
    """NaNs in the input make every later carry NaN; the repair meets
    NaNs of equal bits, and the result is the loop's, NaNs included."""
    rng = np.random.default_rng(seg)
    T = 600
    x = rng.standard_normal((2, 4, T)).astype(np.float32) * 0.3
    x[0, 1, 250] = np.nan
    x[1, 2, 37] = np.nan
    x[:, 3, 500:] = np.nan
    x = torch.from_numpy(x)
    zeros = torch.zeros(4)
    md = torch.tensor(0.4, dtype=torch.float32)
    want = tscan.slew_scan_plain(x[0], x[1], zeros, zeros, md, rsqrt=rsqrt)
    *got, _, _ = segmented(x[0], x[1], zeros, zeros, md, rsqrt, seg)
    assert bool(torch.isnan(want[0][1, 250:]).all())
    assert_bit_equal(got, want)


@pytest.mark.parametrize("seg", [4, 8, 64, 128])
def test_mixed_steps_at_several_lengths(seg):
    """A slow random walk with md near its steps: runs of clamped and
    unclamped samples, segments that meet the stored outputs mid-way."""
    rng = np.random.default_rng(7 * seg)
    T = 1024         # 256 segments of 4: one block's most
    walk = np.cumsum(rng.standard_normal((2, 5, T)) * 0.01, axis=-1)
    walk[:, :, 500:600] += 0.5        # a jump: a clamped ramp
    x = torch.from_numpy(walk.astype(np.float32))
    prev = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    md = torch.tensor(0.02, dtype=torch.float32)
    for rsqrt in (True, False):
        want = tscan.slew_scan_plain(x[0], x[1], prev[0], prev[1], md,
                                     rsqrt=rsqrt)
        *got, _, _ = segmented(x[0], x[1], prev[0], prev[1], md, rsqrt,
                               seg)
        assert_bit_equal(got, want)


def test_segment_length():
    """64 samples a segment while the segments fit one block of 256
    threads, doubled past that; always a multiple of 4 (quads)."""
    assert tscan.segment_length(4096) == 64
    assert tscan.segment_length(1) == 64
    assert tscan.segment_length(16384) == 64
    assert tscan.segment_length(16385) == 128
    for t in (1, 63, 4096, 10 ** 5, 10 ** 6):
        seg = tscan.segment_length(t)
        assert seg % 4 == 0 and -(-t // seg) <= tscan._MAX_SEGMENTS
