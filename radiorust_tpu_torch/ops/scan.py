"""Per-sample feedback recurrences: the complex slew-rate clamp and the
feedback AGC loop.

Counterparts of ``radiorust_tpu/ops/pallas_scan.py``:

- :func:`slew_scan` of ``slew_scan``: ``SlewRateLimiter`` over [B, T]
  float32 planes, the carry being the previous output sample; the
  ``rsqrt`` form (the one the block uses) compares the squared norm and
  scales by ``md * rsqrt(|d|^2)``;
- :func:`agc_scan` of ``agc_scan``: the feedback AGC loop
  ``y = g x; g = clip(g + rate (ref - |y|), 0, max_gain)`` over [B, T]
  float32 planes, the carry being the loop gain; and :func:`agc_step`,
  the same kernel on complex64 rows read and written in place, which
  ``AgcControl`` calls (one launch a step).

The slew recurrence has no associative form, so its plain version and
:func:`agc_scan_plain` are loops over time on [B] tensors with the exact
steps of the JAX package's kernels.  :func:`agc_step_plain` is
``AgcControl``'s own route in the JAX package: the loop's clamped-affine
maps composed by a log-depth associative scan (``ops/assoc_scan.py``).
On CUDA tensors each wrapper launches its kernel of ``csrc/scan.cu``,
which takes any B and T, and counts the launch in its ``launches``
attribute (:func:`agc_step` on ``agc_scan.launches``); on CPU tensors it
runs the plain version.  A counter counts where a wrapper is called: under a
captured CUDA graph (``jit_step``, ``make_scan``) that is at capture, and a
replay counts nothing.

The slew kernel splits each stream's T samples into segments of
:func:`segment_length` samples, walks each from a guessed carry and
repairs them in passes until they meet the serial walk bit for bit.  The
AGC kernel gives each of a block's lanes a segment of samples
(:func:`agc_geometry`), composes each segment's maps, scans them across
the block for each segment's entry gain and walks the segments with the
loop's own step (the head of ``csrc/scan.cu``).  ``tests/
test_torch_slew_plan.py`` and ``tests/test_torch_agc_plan.py`` model that
arithmetic on the CPU.
"""

from __future__ import annotations

import torch

from . import _build

from .assoc_scan import associative_scan

__all__ = ["slew_scan", "slew_scan_plain", "agc_scan", "agc_scan_plain",
           "agc_step", "agc_step_plain", "segment_length", "agc_geometry"]

_SEGMENT = 64         # samples a slew segment, while T / 64 segments fit
_MAX_SEGMENTS = 256   # kMaxSegments in csrc/scan.cu: threads of a block
_AGC_THREADS = 256    # AGC lanes of a block (the sweep in PERF.md)
_AGC_TILE = 4096      # kAgcTile in csrc/scan.cu: samples staged at once


def segment_length(t: int) -> int:
    """Samples of one slew segment at T = t: 64, doubled until the
    ceil(t / L) segments of a stream fit one block of 256 threads."""
    seg = _SEGMENT
    while -(-t // seg) > _MAX_SEGMENTS:
        seg *= 2
    return seg


def agc_geometry(t: int, threads: int = _AGC_THREADS) -> tuple[int, int]:
    """(lanes, samples a lane) of the AGC kernel at T = t: ``threads``
    lanes, fewer for a row of fewer samples (whole warps), each owning
    ceil(t / lanes) consecutive samples of a tile, at most
    ``_AGC_TILE / lanes``; a longer row goes through in tiles.  The
    wrappers always take the default of 256 lanes; ``threads`` exists
    only for the lane sweep of ``chip_smoke.py`` and the CPU model in
    ``tests/test_torch_agc_plan.py``, which check the other lane counts
    (the sweep behind the choice of 256)."""
    lanes = min(threads, -(-t // 32) * 32)
    return lanes, min(-(-t // lanes), _AGC_TILE // lanes)


def _scalar(v, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(())


def _check_planes(xr, xi, *carries):
    if xr.dim() != 2 or xr.shape != xi.shape:
        raise ValueError(f"planes must be [B, T] of one shape, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    b, t = xr.shape
    if b == 0 or t == 0:
        raise ValueError(f"empty planes [{b}, {t}]")
    for c in carries:
        if c.shape != (b,):
            raise ValueError(f"carry {tuple(c.shape)} != ({b},)")


def slew_scan_plain(xr, xi, prev_r, prev_i, max_diff, rsqrt: bool = False):
    """Plain PyTorch version of :func:`slew_scan`: one step per sample,
    in the planes' dtype."""
    md = _scalar(max_diff, xr.device, xr.dtype)
    md2 = md * md
    one = torch.ones((), dtype=xr.dtype, device=xr.device)
    pr, pi = prev_r, prev_i
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    for t in range(xr.shape[1]):
        dr = xr[:, t] - pr
        di = xi[:, t] - pi
        n2 = dr * dr + di * di
        if rsqrt:
            scale = torch.where(n2 > md2, md * torch.rsqrt(n2), one)
        else:
            norm = torch.sqrt(n2)
            scale = torch.where(norm > md, md / norm, one)
        pr = pr + dr * scale
        pi = pi + di * scale
        yr[:, t] = pr
        yi[:, t] = pi
    return yr, yi, pr, pi


def slew_scan(xr, xi, prev_r, prev_i, max_diff, rsqrt: bool = False):
    """SlewRateLimiter over [B, T] float32 planes.

    ``prev_r/prev_i``: [B] previous output sample; ``max_diff``: the
    largest step, a float or a 0-d tensor.  Returns (yr, yi, new prev_r,
    new prev_i).
    """
    _check_planes(xr, xi, prev_r, prev_i)
    if not _build.on_cuda(xr, xi, prev_r, prev_i):
        return slew_scan_plain(xr, xi, prev_r, prev_i, max_diff, rsqrt)
    b, t = xr.shape
    dev = xr.device
    md = _scalar(max_diff, dev).reshape(1)
    yr, yi = (torch.empty((b, t), dtype=torch.float32, device=dev)
              for _ in range(2))
    pr, pi = (torch.empty((b,), dtype=torch.float32, device=dev)
              for _ in range(2))
    ptr = _build.f32_ptr
    slew_scan.launches += 1
    err = _build.lib().rr_slew_scan(
        ptr(xr, "xr"), ptr(xi, "xi"), ptr(prev_r, "prev_r"),
        ptr(prev_i, "prev_i"), ptr(md, "max_diff"), yr.data_ptr(),
        yi.data_ptr(), pr.data_ptr(), pi.data_ptr(), b, t,
        segment_length(t), int(rsqrt), _build.stream_handle(dev))
    _build.check(err, "slew_scan")
    return yr, yi, pr, pi


slew_scan.launches = 0


def agc_scan_plain(xr, xi, gain, rate, reference, max_gain):
    """Plain PyTorch version of :func:`agc_scan`: one step per sample,
    in the planes' dtype."""
    dev = xr.device
    rate, ref, max_gain = (_scalar(v, dev, xr.dtype)
                           for v in (rate, reference, max_gain))
    zero = torch.zeros((), dtype=xr.dtype, device=dev)
    g = gain
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    for t in range(xr.shape[1]):
        sr = xr[:, t] * g
        si = xi[:, t] * g
        env = torch.sqrt(sr * sr + si * si)
        g = g + rate * (ref - env)
        g = torch.clamp(g, zero, max_gain)
        yr[:, t] = sr
        yi[:, t] = si
    return yr, yi, g


def _knob_ptrs(knobs, device):
    """(the three knobs as 0-d float32 tensors on ``device``, their
    pointers).  The caller holds the tensors until its launch is queued:
    a freed knob's memory could take the next knob's value first."""
    held = [_scalar(v, device) for v in knobs]
    return held, [_build.f32_ptr(v, name) for v, name in
                  zip(held, ("rate", "reference", "max_gain"))]


def agc_scan(xr, xi, gain, rate, reference, max_gain):
    """The feedback AGC loop over [B, T] float32 planes.

    ``gain``: [B] loop gain; ``rate``, ``reference``, ``max_gain``: floats
    or 0-d tensors.  Returns (yr, yi, new gain).
    """
    _check_planes(xr, xi, gain)
    if not _build.on_cuda(xr, xi, gain):
        return agc_scan_plain(xr, xi, gain, rate, reference, max_gain)
    b, t = xr.shape
    dev = xr.device
    yr, yi = (torch.empty((b, t), dtype=torch.float32, device=dev)
              for _ in range(2))
    g = torch.empty((b,), dtype=torch.float32, device=dev)
    held, knobs = _knob_ptrs((rate, reference, max_gain), dev)
    ptr = _build.f32_ptr
    agc_scan.launches += 1
    err = _build.lib().rr_agc_scan(
        ptr(xr, "xr"), ptr(xi, "xi"), ptr(gain, "gain"), *knobs,
        yr.data_ptr(), yi.data_ptr(), g.data_ptr(), b, t, *agc_geometry(t),
        _build.stream_handle(dev))
    _build.check(err, "agc_scan")
    return yr, yi, g


agc_scan.launches = 0

# Slope and offset cap of the composed clamped-affine maps: under
# sustained overdrive the slope products grow exponentially and would
# overflow float32 to inf, then compose to NaN.  At |a| = 1e18 the
# unclamped interval of initial gains is narrower than max_gain / 1e18,
# far below float32 resolution of [0, max_gain], so the cap is exact for
# every representable gain while 1e18^2 stays finite.
_AGC_CAP = 1e18


def _agc_elems(rate, reference, max_gain, x):
    """Per-sample clamped-affine maps of the AGC loop: sample n sends the
    loop gain through ``g -> clip(a g + b, lo, hi)`` with
    ``a = 1 - rate |x[n]|``, ``b = rate reference``."""
    absx = torch.abs(x)
    a = torch.clamp(1.0 - rate * absx, -_AGC_CAP, _AGC_CAP)
    b = (rate * reference).expand(a.shape)
    lo = torch.zeros_like(a)
    hi = max_gain.expand(a.shape)
    return a, b, lo, hi


def _agc_compose(e1, e2):
    """``(f2 . f1)(g)`` of clamped-affine maps ``f(g) = clip(a g + b, lo,
    hi)``, ``e1`` the earlier.  The family is closed under composition for
    either slope sign, so the element stays four numbers and the scan is
    exact; slope and offset saturate at ``_AGC_CAP``."""
    a1, b1, l1, h1 = e1
    a2, b2, l2, h2 = e2
    a = torch.clamp(a1 * a2, -_AGC_CAP, _AGC_CAP)
    b = torch.clamp(a2 * b1 + b2, -_AGC_CAP, _AGC_CAP)
    inner_lo = torch.minimum(a2 * l1, a2 * h1) + b2
    inner_hi = torch.maximum(a2 * l1, a2 * h1) + b2
    return (a, b, torch.clamp(inner_lo, l2, h2),
            torch.clamp(inner_hi, l2, h2))


def _check_step(x, gain):
    if x.dim() != 2 or not x.is_complex():
        raise ValueError(f"x must be [B, T] complex, got {tuple(x.shape)} "
                         f"{x.dtype}")
    b, t = x.shape
    if b == 0 or t == 0:
        raise ValueError(f"empty rows [{b}, {t}]")
    if gain.shape != (b,):
        raise ValueError(f"carry {tuple(gain.shape)} != ({b},)")


def agc_step_plain(x, gain, rate, reference, max_gain):
    """Plain PyTorch version of :func:`agc_step`: the loop's per-sample
    clamped-affine maps composed by a log-depth associative scan, as the
    JAX package's ``AgcControl`` runs them, in the rows' real dtype."""
    dev = x.device
    rate, ref, max_gain = (_scalar(v, dev, x.real.dtype)
                           for v in (rate, reference, max_gain))
    pa, pb, plo, phi = associative_scan(_agc_compose,
                                        _agc_elems(rate, ref, max_gain, x))
    g_inc = torch.clamp(pa * gain[:, None] + pb, plo, phi)
    # y[n] uses the gain before sample n's update (exclusive form).
    g_exc = torch.cat([gain[:, None], g_inc[:, :-1]], dim=-1)
    return x * g_exc, g_inc[:, -1]


def agc_step(x, gain, rate, reference, max_gain):
    """One ``AgcControl`` step: the feedback AGC loop over [B, T]
    complex64 rows.

    ``gain``: [B] float32 loop gain; ``rate``, ``reference``,
    ``max_gain``: floats or 0-d tensors (the block's params).  Returns
    (y = x g [B, T] complex64, new gain [B]).  On CUDA one launch of the
    AGC kernel, counted on ``agc_scan.launches``.
    """
    _check_step(x, gain)
    if not _build.on_cuda(x, gain):
        return agc_step_plain(x, gain, rate, reference, max_gain)
    if x.dtype != torch.complex64 or not x.is_contiguous():
        raise ValueError(f"x: kernel takes a contiguous complex64 tensor, "
                         f"got {x.dtype}, contiguous={x.is_contiguous()}")
    b, t = x.shape
    dev = x.device
    y = torch.empty_like(x)
    g = torch.empty((b,), dtype=torch.float32, device=dev)
    held, knobs = _knob_ptrs((rate, reference, max_gain), dev)
    agc_scan.launches += 1
    err = _build.lib().rr_agc_step(
        x.data_ptr(), _build.f32_ptr(gain, "gain"), *knobs, y.data_ptr(),
        g.data_ptr(), b, t, *agc_geometry(t), _build.stream_handle(dev))
    _build.check(err, "agc_step")
    return y, g
