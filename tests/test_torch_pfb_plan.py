"""The channelizer kernel's plan (``csrc/pfb_demod.cu``), on the CPU.

A numpy model follows the kernel's index arithmetic: the blocks' frame
tiles and the staged span of [hist || chunk] (zeros where a stream is
reset, or outside its frames) in padded shared frames, the lane ->
branch map m = l + 8 j, the branch FIR in registers, the 64-point FFT as
a radix-8 pass across a lane's registers, the twiddle from the float32
root table, the 8 x 8 exchange through the padded tile and a second
radix-8 pass, the halo frame of each block, the demod against the group
before (or, for a warp's first group, the warp before's last through
shared memory), the first-frame repeat, and
the writes: frame-major planes, or channel-major complex rows with the new
history and last outputs.  It is held against the plain versions
(``fused_pfb_demod_plain``, ``pfb_demod_step_plain``) and the JAX
package's Pallas kernel in interpret mode at ``highest`` precision, within
atol 2e-5 on occupied channels (the JAX package's fused-vs-unfused
channelizer bound); empty channels demodulate float32 noise and are only
checked finite.  Nothing here needs a GPU.
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import radiorust_tpu.ops.pallas_channelizer as pch
from radiorust_tpu import config
from radiorust_tpu_torch.blocks.base import StreamSig, scan
from radiorust_tpu_torch.blocks.channelize import ChannelizerDemod
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.ops import channelizer as tch
from radiorust_tpu_torch.ops import filter as tfl

M = 64
GROUPS, WARPS = 4, 4                     # kGroups, kWarps
TILE = WARPS * GROUPS - 1                # kTile
FRAME_STRIDE, TILE_ROW, EDGE_ROW = M + 8, 8 * GROUPS + 1, 9
ATOL = 2e-5
OCCUPIED = (3, 10, 41, 50)


@pytest.fixture(autouse=True)
def interpret_pallas_highest(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pch.pl, "pallas_call", interp)
    config.set_matmul_precision("highest")
    yield
    config.set_matmul_precision(None)


def _roots():
    re, im = tfl.fft_roots(M)
    return (re + 1j * im).astype(np.complex64)


def _dft8(a):
    """DFT_8 over the last axis, with the eighth roots of the table."""
    j = np.arange(8)
    w = _roots()[(np.outer(j, j) % 8) * 8]               # [k, j]
    return np.einsum("...j,kj->...k", a, w).astype(np.complex64)


def fm_input(batch, samples, seed=0):
    """[batch, samples] complex64: an FM tone near the centre of each
    occupied channel, its own modulation per stream."""
    tt = np.arange(samples)
    x = np.zeros((batch, samples), np.complex128)
    for s in range(batch):
        for c in OCCUPIED:
            x[s] += np.exp(1j * (2 * np.pi * c * tt / M + 0.8 * np.sin(
                2 * np.pi * tt / (97.0 + 13 * s) + c + seed)))
    return x.astype(np.complex64)


def kernel_model(frame, taps, fac, count, first, frames_in, batch,
                 step=None):
    """The kernel on ``frame(s, f)`` (input frame f of stream s, 64
    complex samples, or None outside the stream or where it reads zeros).
    Returns d [batch, count, 64] as the demod computes it, before the
    step mode's first-frame repeat; ``step`` = (have_prev, reset,
    last_in) applies it."""
    k = taps.shape[0]
    tw = _roots()[np.outer(np.arange(8), np.arange(8))]   # [l, k1]
    d = np.full((batch, count, M), np.nan, np.float32)
    writes = np.zeros((batch, count), int)
    g = np.arange(GROUPS)[:, None]
    lane = np.arange(8)[None, :]
    for s in range(batch):
        for bx in range(-(-count // TILE)):
            o0 = bx * TILE
            t0 = first + o0
            # The block's frame q is frame t0 - 1 + q (q = 0: the halo);
            # staged frame fl is input frame t0 - 1 + fl.
            sx = np.zeros((TILE + k, FRAME_STRIDE), np.complex64)
            for fl in range(TILE + k):
                f = t0 - 1 + fl
                if 0 <= f < frames_in and frame(s, f) is not None:
                    sx[fl, :M] = frame(s, f)
            edge = np.full(WARPS * 8 * EDGE_ROW, np.nan, np.complex64)
            ys = []
            for warp in range(WARPS):
                q = warp * GROUPS + g                              # [g, 1]
                v = np.zeros((GROUPS, 8, 8), np.complex64)     # [g, l, r]
                for j in range(k):
                    for r in range(8):
                        m = lane + 8 * r
                        v[:, :, r] += (sx[q + j, m]
                                       * taps[j, m]).astype(np.complex64)
                v = _dft8(v) * tw[None]                        # [g, l, k1]
                tile = np.full(8 * TILE_ROW, np.nan, np.complex64)
                for k1 in range(8):
                    at = k1 * TILE_ROW + g * 8 + lane
                    assert np.isnan(tile[at]).all()            # once each
                    tile[at] = v[:, :, k1]
                v = np.stack([tile[lane * TILE_ROW + g * 8 + jj]
                              for jj in range(8)], axis=-1)     # [g, l, j]
                y = _dft8(v)                    # [g, l, k2]: c = l + 8 k2
                y[(t0 - 1 + q < 0)[:, 0]] = 0
                for r in range(8):
                    edge[(warp * 8 + lane[0]) * EDGE_ROW + r] = y[-1, :, r]
                ys.append(y)
            for warp in range(WARPS):
                y = ys[warp]
                prev = np.concatenate([y[-1:], y[:-1]])   # shuffle from g - 1
                if warp > 0:
                    prev[0] = np.stack(
                        [edge[((warp - 1) * 8 + lane[0]) * EDGE_ROW + r]
                         for r in range(8)], axis=-1)
                re = y.real * prev.real + y.imag * prev.imag
                im = y.imag * prev.real - y.real * prev.imag
                dv = (np.arctan2(im, re) * fac[s]).astype(np.float32)
                for gg in range(GROUPS):
                    q = warp * GROUPS + gg
                    u = o0 + q - 1
                    if q == 0 or u >= count:
                        continue
                    # Lane l, register r: channel l + 8 r.
                    d[s, u] = dv[gg].T.reshape(M)
                    writes[s, u] += 1
    assert (writes == 1).all()      # every frame once, by one group
    if step is not None:
        have_prev, reset, last_in = step
        keep = have_prev & ~reset
        d[~keep, 0] = last_in[~keep]
    return d


def plane_model(x, fac, taps):
    """rr_pfb_demod on planes of [history || chunk]: d [b, frames * 64]."""
    b, total = x.shape
    k = taps.shape[0]
    frames_in = total // M
    count = frames_in - (k - 1)
    d = kernel_model(lambda s, f: x[s, f * M:(f + 1) * M], taps, fac, count,
                     0, frames_in, b)
    return d.reshape(b, count * M)


def step_model(hist, x, reset, have_prev, last_in, fac, taps):
    """rr_pfb_demod_step: (y [b * 64, T] complex64, new hist, last out)."""
    b, n = x.shape
    k = taps.shape[0]
    h = (k + 1) * M
    count = n // M

    def frame(s, f):
        if f <= k:
            return None if reset[s] else hist[s, f * M:(f + 1) * M]
        return x[s, (f - k - 1) * M:(f - k) * M]

    d = kernel_model(frame, taps, fac, count, 2, count + 2 + k - 1, b,
                     (have_prev, reset, last_in))
    y = d.transpose(0, 2, 1).reshape(b * M, count).astype(np.complex64)
    # The new history: sample i + n of [hist || chunk].
    src = np.concatenate([np.where(reset[:, None], 0, hist), x], axis=1)
    new_hist = src[:, n:n + h].astype(np.complex64)
    return y, new_hist, d[:, -1].copy()


def _occupied_frames(d, b):
    """Frame-major d [b, frames * 64] -> occupied channels from frame 2."""
    return d.reshape(b, -1, M)[:, tch.HIST_FRAMES:, list(OCCUPIED)]


# (K, chunk): path D's K = 8 (16 output frames a step, 18 a plane call:
# a ragged second tile), K = 1, K = 16, 44 frames (a tile of 14 after two
# of 15), and chunks shorter than the history, whose new history spans
# both pointers.  Chunks are whole 128-sample rows, as the JAX kernel takes.
CASES = [(8, 1024), (1, 1024), (16, 1024), (8, 2816), (8, 256), (16, 128)]


@pytest.mark.parametrize("k, n", CASES)
def test_plane_model_matches_plain_and_jax(k, n):
    b = 2
    taps = tch.design_prototype(M, k).reshape(k, M).astype(np.float32)
    total = (k + 1) * M + n
    x = fm_input(b, total, seed=k)
    fac = np.array([0.7, 1.3], np.float32)
    got = plane_model(x, fac, taps)
    t = torch.from_numpy
    plain = tch.fused_pfb_demod_plain(
        t(np.ascontiguousarray(x.real)), t(np.ascontiguousarray(x.imag)),
        t(fac), t(taps)).numpy()
    want = np.asarray(pch.fused_pfb_demod(
        jnp.asarray(x.real), jnp.asarray(x.imag), jnp.asarray(fac),
        jnp.asarray(taps)))
    assert got.shape == plain.shape == want.shape == (b, n + 2 * M)
    for ref in (plain, want):
        np.testing.assert_allclose(_occupied_frames(got, b),
                                   _occupied_frames(ref, b), atol=ATOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("k, n", CASES)
def test_step_model_matches_plain_over_a_scan(k, n):
    """Chunk after chunk with the state handed on, a reset on stream 0 at
    chunk 2; y on occupied rows, the new history exactly, last_out on
    occupied channels."""
    b, chunks = 2, 4
    taps = tch.design_prototype(M, k).reshape(k, M).astype(np.float32)
    xs = fm_input(b, chunks * n, seed=k).reshape(b, chunks, n)
    fac = np.float32(0.9)
    h = (k + 1) * M
    hist = np.zeros((b, h), np.complex64)
    last = np.zeros((b, M), np.float32)
    have = np.zeros(b, bool)
    rows = [s * M + c for s in range(b) for c in OCCUPIED]
    t = torch.from_numpy
    for c in range(chunks):
        x = np.ascontiguousarray(xs[:, c])
        reset = np.array([c == 2, False])
        got = step_model(hist, x, reset, have, last, np.full(b, fac), taps)
        want = tuple(v.numpy() for v in tch.pfb_demod_step_plain(
            t(hist), t(x), t(reset), t(have), t(last), torch.tensor(fac),
            t(taps)))
        assert got[0].shape == want[0].shape == (b * M, n // M)
        np.testing.assert_allclose(got[0][rows], want[0][rows], atol=ATOL)
        assert np.all(got[0].imag == 0) and np.isfinite(got[0]).all()
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2][:, list(OCCUPIED)],
                                   want[2][:, list(OCCUPIED)], atol=ATOL)
        hist, last, have = want[1], want[2], np.ones(b, bool)


def test_staged_reads_and_exchange_are_conflict_free():
    """Shared-memory banks of a warp's 8-byte accesses, 16 lanes a phase:
    the FIR's reads of 4 consecutive staged frames (72 samples a frame),
    the exchange tile's writes and reads (33 complex a row)."""
    lane = np.arange(32)
    g, l = lane // 8, lane % 8

    def conflict_free(addr):     # addr: complex (8-byte) offsets, [32]
        return all(len(set(addr[h:h + 16] % 16)) == 16 for h in (0, 16))

    for base in range(0, 40):
        for r in range(8):
            assert conflict_free((base + g) * FRAME_STRIDE + l + 8 * r)
    for k1 in range(8):
        assert conflict_free(k1 * TILE_ROW + g * 8 + l)
        assert conflict_free(l * TILE_ROW + g * 8 + k1)
    # A warp's last frame: group 3 writes, the next warp's group 0 reads,
    # 8 lanes of 9-complex rows.
    assert len(set(np.arange(8) * EDGE_ROW % 16)) == 8


def test_smem_bytes_and_supported_taps():
    assert tch._smem_bytes(8) == 8 * (
        (TILE + 8) * FRAME_STRIDE + WARPS * 8 * (TILE_ROW + EDGE_ROW)) + 4 * 8 * M
    assert tch.pfb_demod_supported(65536, M, 8)
    assert tch.pfb_demod_supported(64, M, 256)
    assert not tch.pfb_demod_supported(64, M, 257)


def _old_block_process(bound, params, state, x, reset):
    """ChannelizerDemod's step before it called pfb_demod_step, verbatim."""
    b, m = x.shape[0], bound.m
    t_out = bound.out_sig.chunk_len
    hist = torch.where(reset[:, None], torch.zeros_like(state["hist"]),
                       state["hist"])
    have = state["have_prev"] & ~reset
    xp = torch.cat([hist, x], dim=-1)
    d = tch.fused_pfb_demod(xp.real.contiguous(), xp.imag.contiguous(),
                            params["factor"], params["taps"])
    d = d[:, tch.HIST_FRAMES * m:]
    first = torch.where(have[:, None], d[:, :m], state["last_out"])
    d = torch.cat([first, d[:, m:]], dim=-1)
    y = d.reshape(b, t_out, m).transpose(1, 2).reshape(b * m, t_out)
    new_state = {"hist": xp[:, -bound.hist_len:],
                 "last_out": d[:, -m:],
                 "have_prev": torch.ones_like(have)}
    return new_state, torch.complex(y, torch.zeros_like(y))


def test_step_plain_is_the_old_block_bit_for_bit():
    n, chunks = 2048, 4
    bound = ChannelizerDemod(M, 16000.0).bind(StreamSig(2, n, 16384000.0))
    xs = torch.from_numpy(fm_input(2, chunks * n).reshape(2, chunks, n)
                          .transpose(1, 0, 2).copy())
    resets = torch.zeros((chunks, 2), dtype=torch.bool)
    resets[2, 1] = True
    params = tree_to_torch(bound.params, "cpu")
    state0 = tree_to_torch(bound.init_state(), "cpu")
    st_new, ys_new = scan(bound, params, state0, xs, resets)
    state, ys_old = state0, []
    for c in range(chunks):
        state, y = _old_block_process(bound, params, state, xs[c], resets[c])
        ys_old.append(y)
    assert torch.equal(ys_new, torch.stack(ys_old))
    for key in state:
        assert torch.equal(st_new[key], state[key]), key
