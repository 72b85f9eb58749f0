"""The port's process groups (``parallel/multiprocess.py``), a mesh that
spans processes (``parallel/mesh.py``), ``CrossProcessPipeline`` and the
sharded checkpoints, across real processes on CPU tensors (gloo): each
scenario of ``tests/torch_multiprocess_worker.py`` holds every process's
part against the same computation in one process, bit for bit.  Also
what must refuse: another backend than gloo, CUDA without a card, and a
compiled sharded step over a mesh that spans processes."""

import pathlib

import numpy as np
import pytest
import torch

from radiorust_tpu_torch.parallel import multiprocess as mp
from radiorust_tpu_torch.parallel.mesh import Mesh, Shards

WORKER = str(pathlib.Path(__file__).with_name("torch_multiprocess_worker.py"))
CPU = torch.device("cpu")


def run(scenario, nproc, loc, path="", timeout=240.0):
    codes, outputs = mp.launch_local_cluster(
        WORKER, num_processes=nproc, local_devices=loc,
        args=("--scenario", scenario, "--path", path), timeout=timeout)
    joined = "\n".join(outputs)
    assert codes == [0] * nproc, (codes, joined)
    assert joined.count("SCENARIO OK") == nproc, joined
    return outputs


@pytest.mark.parametrize("nproc,loc", [(2, 2), (4, 2), (2, 3)])
def test_collectives_across_processes_equal_one_process(nproc, loc):
    """ring_left (with and without its wrap), all_gather, psum and the
    carry's share over a line across 2-4 processes, float, complex and
    bool values, bit for bit the one-process results; a line within one
    process exchanges nothing."""
    run("collectives", nproc, loc)


def test_each_process_runs_only_its_own_shards():
    """A counter on every block's ``process``: each of 4 processes calls
    it twice a group step (its 2 entries of 8), and its output pieces are
    exactly its entries, equal to the one-process run's bit for bit."""
    outs = run("ownership", 4, 2)
    assert all("calls {0: 4, 1: 4, 2: 4, 3: 4, 4: 4}" in o for o in outs)


def test_cross_process_pipeline_equals_pipelined_chain():
    """``CrossProcessPipeline`` with 1 group of 4 stages and 2 groups of 2
    equal to ``PipelinedChain`` bit for bit; ``None`` off the last
    stage."""
    run("pipeline", 4, 1)


def test_sharded_checkpoint_same_and_smaller_mesh(tmp_path):
    """``save_sharded`` of a carry whose rows live on different processes,
    ``load_sharded`` whole and onto the rows (the continuation bit for
    bit), a second save over it refused on every process; then a job of
    2 processes loads the 4 processes' checkpoint."""
    path = str(tmp_path / "ckpt")
    run("checkpoint", 4, 2, path)
    manifest = (tmp_path / "ckpt" / "manifest.json").read_text()
    assert '"process_count": 4' in manifest
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "manifest.json", "rank0.npz", "rank1.npz", "rank2.npz", "rank3.npz"]
    run("checkpoint_smaller", 2, 2, path)


def test_backends_and_devices_refuse_rather_than_switch():
    with pytest.raises(NotImplementedError, match="NCCL"):
        mp.initialize("127.0.0.1:1", 2, 0, backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        mp.initialize("127.0.0.1:1", 2, 0, backend="mpi")
    if not torch.cuda.is_available():
        from radiorust_tpu_torch.tools import fake_cluster
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fake_cluster.worker(["--process-id", "0", "--coordinator",
                                 "127.0.0.1:1", "--num-processes", "2",
                                 "--device", "cuda"])
    assert mp.process_index() == 0 and mp.process_count() == 1
    assert mp.all_processes_ok(True) and not mp.all_processes_ok(False)


def test_compiled_steps_refuse_a_mesh_that_spans_processes():
    """Over a mesh with entries of another rank the compiled forms raise
    (a CUDA graph cannot hold a gloo exchange); the eager ``process`` is
    the way, and nothing switches silently."""
    from radiorust_tpu_torch.blocks.base import (StreamSig, jit_step_sharded,
                                                 shard_map_step)
    from radiorust_tpu_torch.models.channelizer import channelized_receiver
    from radiorust_tpu_torch.models.wfm import wfm_receiver
    from radiorust_tpu_torch.parallel.channel_shard import \
        ChannelShardedChain
    from radiorust_tpu_torch.parallel.time_shard import (TimeShardedChain,
                                                         TimeShardedGraph)
    from radiorust_tpu_torch.blocks.graph import linear_bound_graph
    spans = Mesh(np.full(4, CPU, dtype=object), ("t",), [0, 0, 1, 1])
    assert spans.spans_processes and not spans.single_device
    assert spans.home == CPU and spans.line("t").spans
    bound = wfm_receiver().bind(StreamSig(4, 2048, 1024000.0))
    with pytest.raises(NotImplementedError, match="spans processes"):
        jit_step_sharded(bound, spans, "t")
    with pytest.raises(NotImplementedError, match="spans processes"):
        shard_map_step(bound.process, spans, "t")
    with pytest.raises(NotImplementedError, match="spans processes"):
        TimeShardedChain(bound, spans).jit_step()
    with pytest.raises(NotImplementedError, match="spans processes"):
        TimeShardedGraph(linear_bound_graph(bound), spans).jit_step()
    ch = channelized_receiver().bind(StreamSig(1, 4096, 16384000.0))
    with pytest.raises(NotImplementedError, match="spans processes"):
        ChannelShardedChain(ch, spans, axis="t").jit_step()
    # Not this process's entries at all: refused where it is made.
    with pytest.raises(ValueError, match="owns no entry"):
        Mesh(np.full(2, CPU, dtype=object), ("t",), [1, 1])


def test_assert_addressable_allclose_checks_only_its_pieces():
    want = np.arange(24, dtype=np.float32).reshape(4, 6)
    got = Shards(want.shape, [
        ((slice(0, 2), slice(3, 6)), torch.from_numpy(want[0:2, 3:6]))])
    mp.assert_addressable_allclose(got, want, 0.0)
    bad = want.copy()
    bad[0, 3] += 1.0
    with pytest.raises(AssertionError, match="shard"):
        mp.assert_addressable_allclose(got, bad, 0.5)
    # skip: positions of the last axis before it are left out.
    mp.assert_addressable_allclose(got, bad, 0.5, skip=4)
    # rows: a mask over axis 0.
    mp.assert_addressable_allclose(got, bad, 0.5,
                                   rows=np.array([False, True, True, True]))
    bad[3, 0] += 1.0                     # outside this piece: unread
    mp.assert_addressable_allclose(got, bad, 0.5, skip=4)
    assert got.get((slice(1, 2), slice(4, 6))).tolist() == [[10.0, 11.0]]
    with pytest.raises(KeyError):
        got.get((slice(2, 4),))


@pytest.mark.parametrize("n_devices", [8, 4])
def test_dryrun_multichip_over_one_process(n_devices):
    """The JAX dry run's cases over a one-process mesh of CPU entries,
    each within its bound of the sequential scan."""
    from radiorust_tpu_torch.tools.dryrun_multichip import dryrun_multichip
    res = dryrun_multichip(n_devices, device="cpu")
    assert len(res) == 11, sorted(res)
    assert max(res.values()) <= 5e-4, res
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(n_devices)
