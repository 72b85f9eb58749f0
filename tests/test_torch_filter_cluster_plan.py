"""The cluster route of #3 (``os_filter_cluster`` in
``radiorust_tpu_torch/csrc/overlap_save.cu``), on the CPU.

One launch runs each stream's whole filter on a thread block cluster of
C = min(4, n2) blocks, one cluster a stream (grid (C, X)); block r owns
the strip of W = n2 / C columns r W .. r W + W - 1 of the stream's
[prev || cur] grid and keeps it in its shared memory.  With one stream a
cluster an odd X (path O at batch 1, F's and M's pair-packed X = b / 2)
masks nothing: every cluster holds a stream.  The numpy model below moves
the data as the kernel does, on the ``Cluster`` model of
``tests/test_torch_demod_filter_plan.py`` (its strips, owners, warp rows,
row phase and output map) and the passes of
``tests/test_torch_fft_plan.py``.  The model is held against
``fused_overlap_save_plain`` within the kernel checks' 2.4e-5, and
against the JAX package's Pallas kernel in interpret mode at ``highest``
precision.  The route rule (:func:`filter_cluster_size`: the cluster
route up to n1 = 96 rows, the measured crossover) is checked on both
sides of its boundary and at every geometry the paths bind.  #4 has one
route, the stage route.  Nothing here needs a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import radiorust_tpu.ops.pallas_filter as pfl
from test_torch_demod_filter_plan import Cluster, _twiddle
from test_torch_kernels import interpret_pallas_highest  # noqa: F401

from radiorust_tpu_torch.ops import filter as tfl

PLAIN_REL = 2.4e-5   # the kernel checks' FILTER_BOUND
THREADS = 256        # kClusterThreads
SMS, SM_SMEM, BLOCK_RESERVE = 132, 233472, 1024   # H100 SXM: 228 KB an SM
MIN_BLOCKS = 3       # kClusterMinBlocks: registers capped for 3 an SM
# (m, n, X) of #3 on the cluster route: E's 8192 = 64 x 128; F's 2048 at
# an odd X (its pair-packed streams, b / 2); J's 1536; K's and M's 12288
# (96 rows, the longest the rule takes); the time shards of A's chain in
# paths T and Q (6144 + 4608, + 2304, + 1152); a 16-point row (1520 =
# 95 x 16: W = 4) and a two-point row (190 = 95 x 2: C = 2, one column a
# block).
E = (4096, 4096, 2)
F_ODD = (1024, 1024, 3)
J = (768, 768, 2)
KM = (6144, 6144, 1)
T2 = (6144, 4608, 2)
Q4 = (6144, 2304, 1)
T1 = (6144, 1152, 3)
ROW16 = (760, 760, 2)
ROW2 = (95, 95, 1)
# A's 15360 = 120 x 128 (A, C, Q, T, N): the stage route by the rule.
A = (6144, 9216, 2)
G_BANK = (1024, 1024, 3, 2)   # (m, n, X, K) of G's ISB bank


def _share(n1, n2):
    """Shared bytes of a block of #3's cluster (``filter_cluster_bytes`` in
    csrc/overlap_save.cu): two strip buffers of W = n2 / min(4, n2)
    columns, re and im planes of n1 rows, and the n1 column and n2 row
    roots."""
    return 4 * (4 * n1 * (n2 // min(4, n2)) + 2 * n1 + 2 * n2)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _planes(*zs):
    return [torch.from_numpy(np.ascontiguousarray(p))
            for z in zs for p in (z.real, z.imag)]


def _load(cl, prev, cur):
    """Each block stages its strip of the stream's [prev || cur] grid."""
    z = np.concatenate([prev, cur])
    cl.load(lambda _, t: z[t])


def overlap_save_model(prev, cur, grid):
    """#3 on the cluster route, one cluster a stream: [X, n] complex64."""
    X, n = cur.shape
    m = prev.shape[1]
    n1, n2 = tfl.kernel_factors(m + n)
    tw = _twiddle(n1, n2)
    out = np.empty((X, n), np.complex64)
    for s in range(X):
        cl = Cluster(n1, n2, 1, most=4)
        _load(cl, prev[s], cur[s])
        cl.filter(grid, tw)
        y = cl.output(n)
        out[s] = y[0] + 1j * y[1]
    return out


def _case(m, n, X, K, seed):
    """Inputs and response grids (complex64 [K, n1, n2], torch planes)."""
    rng = np.random.default_rng(seed)
    prev, cur = _c64(rng, X, m), _c64(rng, X, n)
    resp = _c64(rng, K, m + n)
    grid = tfl.response_grid(torch.from_numpy(resp))
    return prev, cur, resp, grid


@pytest.mark.parametrize(
    "m, n, X", [A, E, F_ODD, J, KM, T2, Q4, T1, ROW16, ROW2],
    ids=["A (stage route by the rule)", "E", "F odd X", "J", "K M",
         "T2 shard", "Q shard", "T1 shard", "16-point rows",
         "two-point rows"])
def test_overlap_save_cluster_model_matches_plain(m, n, X):
    n1, n2 = tfl.kernel_factors(m + n)
    assert tfl.filter_cluster_size(m + n) == (min(4, n2) if n1 <= 96
                                              else 0)
    prev, cur, _, grid = _case(m, n, X, 1, m + n + X)
    got = overlap_save_model(prev, cur, grid[0].numpy())
    yr, yi = tfl.fused_overlap_save_plain(*_planes(prev, cur),
                                          grid[0].real.contiguous(),
                                          grid[0].imag.contiguous())
    assert _rel(got, (yr + 1j * yi).numpy()) <= PLAIN_REL


@pytest.mark.parametrize("m, n, X", [A, E, F_ODD, KM],
                         ids=["A", "E", "F odd X", "K M"])
def test_overlap_save_cluster_model_matches_jax(m, n, X):
    """The model against ``fused_overlap_save`` of the JAX package (Pallas
    in interpret mode, matmuls at ``highest``) on the same numpy inputs,
    at the geometries its plan takes (J's 1536 and the time shards are
    not among them)."""
    prev, cur, resp, grid = _case(m, n, X, 1, 7 * (m + n) + X)
    jgrid = np.asarray(pfl.response_grid(jnp.asarray(resp[0])))
    np.testing.assert_array_equal(grid[0].numpy(), jgrid)
    wr, wi = pfl.fused_overlap_save(*(jnp.asarray(v) for v in (
        prev.real, prev.imag, cur.real, cur.imag, jgrid.real, jgrid.imag)))
    got = overlap_save_model(prev, cur, grid[0].numpy())
    assert _rel(got, np.asarray(wr) + 1j * np.asarray(wi)) <= PLAIN_REL


@pytest.mark.parametrize("n1, n2, cluster", [
    (96, 128, True), (97, 128, False), (95, 64, True), (97, 64, False),
    (95, 32, True), (97, 32, False), (95, 16, True), (97, 16, False),
    (95, 8, True), (97, 8, False), (95, 4, True), (97, 4, False),
    (95, 2, True), (97, 2, False), (95, 1, True), (97, 1, False),
    (385, 256, False)])
def test_filter_route_on_both_sides_of_its_boundary(n1, n2, cluster):
    """``filter_cluster_size``: C = min(4, n2) up to n1 = 96 rows, 0 (the
    stage route) one row past them, at every row length; never at
    256-point rows (n1 past 384 there).  Every geometry it takes fits a
    block's share in shared memory with room for three blocks an SM."""
    N = n1 * n2
    assert tfl.kernel_factors(N) == (n1, n2)
    assert tfl.filter_cluster_size(N) == (min(4, n2) if cluster else 0)
    if cluster:
        assert 3 * (_share(n1, n2) + BLOCK_RESERVE) <= SM_SMEM


@pytest.mark.parametrize("m, n, cluster", [
    (6144, 9216, False), (4096, 4096, True), (1024, 1024, True),
    (768, 768, True), (6144, 6144, True), (6144, 4608, True),
    (6144, 2304, True), (6144, 1152, True), (98304, 98304, False),
    (10001, 10001, False)],
    ids=["A, C, Q, T, N", "E", "F, L", "J", "K, M", "T2 (t = 2)",
         "Q (t = 4)", "T1 (t = 8)", "H", "past a strip"])
def test_the_paths_geometries_take_the_route_the_rule_gives(m, n, cluster):
    """Every geometry the paths bind #3 at, whole and time-sharded: one
    cluster launch up to 96 rows; the stage route at A's 120 x 128 grid,
    H's 768 x 256 and a column past a one-column strip."""
    assert bool(tfl.filter_cluster_size(m + n)) == cluster
    assert (tfl.kernel_factors(m + n)[0] <= 96) == cluster


def test_blocks_an_sm_at_batch_64():
    """K's and M's #3 (96 x 128: 50.9 KB a block) at batch 64: 64 clusters
    of 4, 256 blocks.  It fits three blocks an SM by shared memory and
    registers, where the card holds 92 clusters of 4 (its
    cudaOccupancyMaxActiveClusters, read on the chip): one wave."""
    nbytes = _share(96, 128)
    assert nbytes == 50944
    per_sm = min(MIN_BLOCKS, SM_SMEM // (nbytes + BLOCK_RESERVE))
    assert per_sm == 3 and SMS * per_sm >= 64 * 4


def test_strips_tile_the_block():
    """A block's threads tile its strip's columns (W divides 256, as
    ``Lanes`` needs) and the strip's rows of W columns are whole 16-byte
    quads where W >= 4 (stage_strip's cp.async copies)."""
    for n2 in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        W = n2 // min(4, n2)
        assert THREADS % W == 0 and (W < 4 or W % 4 == 0)


def test_crossover_sweep_straddles_the_rule():
    """``tools/filter_split.py --crossover`` times both routes at column
    lengths on both sides of the rule's boundary, each a whole 128-point
    row plan with a chunk past A's history."""
    from radiorust_tpu_torch.tools import filter_split
    n1s = filter_split.CROSSOVER_N1
    assert min(n1s) <= 96 < max(n1s) and 120 in n1s
    for n1 in n1s:
        assert tfl.kernel_factors(128 * n1) == (n1, 128)
        assert 128 * n1 - 6144 > 0


def test_wrappers_count_no_launch_on_the_cpu():
    """On CPU tensors both wrappers run their plain versions: no counter
    moves.  #4 has one route and no cluster counter."""
    prev, cur, _, grid = _case(*G_BANK, 1)
    os_, bank = tfl.fused_overlap_save, tfl.fused_filter_bank
    before = (os_.launches, os_.cluster_launches, bank.launches)
    os_(*_planes(prev, cur), grid[0].real.contiguous(),
        grid[0].imag.contiguous())
    bank(*_planes(prev, cur), grid.real.contiguous(), grid.imag.contiguous())
    assert (os_.launches, os_.cluster_launches, bank.launches) == before
    assert not hasattr(bank, "cluster_launches")
