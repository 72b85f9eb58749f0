"""Execution across processes (PyTorch port of the JAX package's
``parallel/multiprocess.py``).

A job is N identical processes, each owning some entries of one mesh
(multi-controller SPMD).  This module brings a job up and checks it:

- :func:`initialize` joins the job's process group
  (``torch.distributed``, gloo).  After it, :func:`~radiorust_tpu_torch.
  parallel.mesh.make_mesh` builds the job's grid: each entry has a rank as
  well as a device, and the sharded executors
  (:class:`~radiorust_tpu_torch.parallel.time_shard.TimeShardedChain`,
  :class:`~radiorust_tpu_torch.parallel.channel_shard.ChannelShardedChain`)
  run over it unchanged in meaning: each process computes only its own
  shards, and the values that cross a rank boundary go through the
  process group.
- :func:`launch_local_cluster` starts an N-process cluster on one
  machine, each process owning ``local_devices`` entries of its device
  (on a card, ``cuda:0`` shared by every process).
  ``radiorust_tpu_torch/tools/fake_cluster.py`` drives the executors over
  it.
- :func:`assert_addressable_allclose` checks this process's output shards
  against the matching slices of a reference, and
  :func:`all_processes_ok` agrees on one verdict.

The process group is gloo on the CPU and on the card alike: NCCL needs a
card per rank, and this slice's processes share one.  The collectives
stage CUDA tensors through pinned host buffers (:mod:`.mesh`).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "initialize", "launch_local_cluster", "free_port",
    "assert_addressable_allclose", "all_processes_ok", "process_index",
    "process_count", "local_entries",
]

# The number of mesh entries a worker of launch_local_cluster owns: the
# port's counterpart of the JAX package's virtual device count.
LOCAL_ENTRIES_ENV = "RRTPU_LOCAL_ENTRIES"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               heartbeat_timeout_seconds: Optional[int] = None,
               backend: str = "gloo") -> None:
    """Join the job's process group over ``tcp://<coordinator_address>``.

    ``heartbeat_timeout_seconds`` becomes the group's ``timeout``: the
    longest a survivor waits in a collective for a peer (by default
    torch's own, 30 minutes for gloo).  A peer that dies closes its
    connections, and a survivor's pending exchange with it raises at
    once; the timeout bounds the wait for a peer that hangs.

    ``backend``: ``"gloo"``, the only one of this slice.  ``"nccl"``
    raises ``NotImplementedError``: it needs a card per rank (ROADMAP.md,
    "NCCL process groups across cards").  Nothing chooses another
    backend, and nothing switches after a failure."""
    import torch.distributed as dist
    if backend == "nccl":
        raise NotImplementedError(
            "backend='nccl' is not part of the port yet (ROADMAP.md, "
            "queue 1: NCCL process groups across cards); use 'gloo'")
    if backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}: 'gloo'")
    kw = {}
    if heartbeat_timeout_seconds is not None:
        kw["timeout"] = datetime.timedelta(
            seconds=float(heartbeat_timeout_seconds))
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def _group():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    """This process's rank (0 outside a job)."""
    d = _group()
    return d.get_rank() if d else 0


def process_count() -> int:
    """The job's process count (1 outside a job)."""
    d = _group()
    return d.get_world_size() if d else 1


def local_entries(default: int = 1) -> int:
    """The mesh entries this worker owns, as :func:`launch_local_cluster`
    set them (``default`` elsewhere)."""
    return int(os.environ.get(LOCAL_ENTRIES_ENV, str(default)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _command(script: str) -> List[str]:
    """``script`` as a command: a path, or ``-m <module>``."""
    parts = script.split()
    if parts[0] == "-m":
        if len(parts) != 2:
            raise ValueError(f"script {script!r}: '-m <module>'")
        return [sys.executable, "-m", parts[1]]
    return [sys.executable, script]


def launch_local_cluster(script: str, num_processes: int = 2,
                         local_devices: int = 4,
                         args: Sequence[str] = (),
                         timeout: float = 900.0,
                         env_extra: Optional[dict] = None):
    """Start ``num_processes`` copies of ``script`` (a path, or ``-m
    <module>``) as a cluster on the local machine.

    Each worker owns ``local_devices`` mesh entries
    (:func:`local_entries`), runs with ``OMP_NUM_THREADS=1``, finds this
    package on its path, and gets the argv tail ``--process-id I
    --coordinator 127.0.0.1:PORT --num-processes N`` (parse these and call
    :func:`initialize`).  Returns ``(returncodes, outputs)``; the caller
    decides what a nonzero code means.  A worker still running when the
    shared ``timeout`` deadline passes is killed and reported with code
    ``None``: a hang, which the failure drills assert against (a dead
    peer must make the survivors error out, not wait in a collective)."""
    import time as _time
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env.update(env_extra or {})
    env["OMP_NUM_THREADS"] = "1"
    env[LOCAL_ENTRIES_ENV] = str(local_devices)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    # Each worker writes to a file of its own: a worker filling a pipe
    # that is not being read would block, and its peers with it.
    logs = [tempfile.TemporaryFile() for _ in range(num_processes)]
    procs = []
    for i in range(num_processes):
        procs.append(subprocess.Popen(
            [*_command(script), *args,
             "--process-id", str(i),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(num_processes)],
            env=env, stdout=logs[i], stderr=subprocess.STDOUT))
    deadline = _time.monotonic() + timeout
    codes: List[Optional[int]] = []
    outputs: List[str] = []
    try:
        for p in procs:
            left = max(1.0, deadline - _time.monotonic())
            try:
                codes.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                codes.append(None)      # hang: killed by the launcher
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.seek(0)
            outputs.append(f.read().decode(errors="replace"))
            f.close()
    return codes, outputs


def assert_addressable_allclose(local_shards, want: np.ndarray,
                                atol: float, rows=None, label: str = "",
                                skip: int = 0) -> None:
    """Compare this process's shards of a value (a
    :class:`~radiorust_tpu_torch.parallel.mesh.Shards`, or a tensor,
    which holds the whole value) against the matching slices of the host
    reference ``want``.

    ``rows``: an optional boolean mask over axis 0 (the channel-energy
    guard of demodulated channel outputs).  ``skip``: ignore the first
    ``skip`` positions of the LAST axis (warm-up outputs)."""
    from .mesh import Shards
    if isinstance(local_shards, Shards):
        pieces = local_shards.pieces
    else:
        pieces = [(tuple(slice(None) for _ in want.shape), local_shards)]
    for index, data in pieces:
        got = np.asarray(data.detach().cpu().numpy() if hasattr(data, "cpu")
                         else data)
        ref = want[index]
        if rows is not None:
            mask = rows[index[0]]
            got, ref = got[mask], ref[mask]
        if skip:
            # The global positions of the last axis this shard covers:
            # compare only those at or after ``skip``.
            start = index[-1].start or 0
            cut = max(0, skip - start)
            got, ref = got[..., cut:], ref[..., cut:]
        np.testing.assert_allclose(
            got, ref, atol=atol,
            err_msg=f"{label} shard {index} on process {process_index()}")


def all_processes_ok(ok: bool) -> bool:
    """The AND of ``ok`` across the job's processes, by one
    ``all_gather`` of a flag (so every worker exits with the same verdict
    even where only one saw a mismatch).  Outside a job: ``ok``."""
    import torch
    d = _group()
    if d is None:
        return bool(ok)
    flags = [torch.zeros(1, dtype=torch.uint8)
             for _ in range(d.get_world_size())]
    d.all_gather(flags, torch.tensor([1 if ok else 0], dtype=torch.uint8))
    return bool(all(int(f[0]) for f in flags))
