"""Per-sample feedback recurrences: the complex slew-rate clamp and the
sequential AGC loop.

Counterparts of ``radiorust_tpu/ops/pallas_scan.py``:

- :func:`slew_scan` of ``slew_scan``: ``SlewRateLimiter`` over [B, T]
  float32 planes, the carry being the previous output sample; the
  ``rsqrt`` form (the one the block uses) compares the squared norm and
  scales by ``md * rsqrt(|d|^2)``;
- :func:`agc_scan` of ``agc_scan``: the feedback AGC loop
  ``y = g x; g = clip(g + rate (ref - |y|), 0, max_gain)``, the carry
  being the loop gain.  No block calls it: ``AgcControl`` runs the exact
  clamped-affine associative scan, as in the JAX package.

The slew recurrence has no associative form, so the plain versions
(``*_plain``) are loops over time on [B] tensors with the exact steps of
the JAX package's kernels.  On CUDA tensors each wrapper launches its
kernel of ``csrc/scan.cu``, which takes any T, and counts the launch in
its ``launches`` attribute; on CPU tensors it runs the plain version.

The slew kernel splits each stream's T samples into segments of
:func:`segment_length` samples, walks each from a guessed carry and
repairs them in passes until they meet the serial walk bit for bit (the
head of ``csrc/scan.cu``); ``tests/test_torch_slew_plan.py`` models that
arithmetic on the CPU.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["slew_scan", "slew_scan_plain", "agc_scan", "agc_scan_plain",
           "segment_length"]

_SEGMENT = 64         # samples a slew segment, while T / 64 segments fit
_MAX_SEGMENTS = 256   # kMaxSegments in csrc/scan.cu: threads of a block


def segment_length(t: int) -> int:
    """Samples of one slew segment at T = t: 64, doubled until the
    ceil(t / L) segments of a stream fit one block of 256 threads."""
    seg = _SEGMENT
    while -(-t // seg) > _MAX_SEGMENTS:
        seg *= 2
    return seg


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


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
    """Plain PyTorch version of :func:`slew_scan`: one step per sample."""
    md = _scalar(max_diff, xr.device)
    md2 = md * md
    one = torch.ones((), dtype=torch.float32, device=xr.device)
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
    """Plain PyTorch version of :func:`agc_scan`: one step per sample."""
    dev = xr.device
    rate, ref, max_gain = (_scalar(v, dev) for v in (rate, reference,
                                                     max_gain))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
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
    sc = torch.stack([_scalar(v, dev) for v in (rate, reference, max_gain)])
    yr, yi = (torch.empty((b, t), dtype=torch.float32, device=dev)
              for _ in range(2))
    g = torch.empty((b,), dtype=torch.float32, device=dev)
    ptr = _build.f32_ptr
    agc_scan.launches += 1
    err = _build.lib().rr_agc_scan(
        ptr(xr, "xr"), ptr(xi, "xi"), ptr(gain, "gain"), sc.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), g.data_ptr(), b, t,
        _build.stream_handle(dev))
    _build.check(err, "agc_scan")
    return yr, yi, g


agc_scan.launches = 0
