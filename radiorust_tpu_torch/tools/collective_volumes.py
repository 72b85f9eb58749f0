"""Bytes the sharded executors' collectives deliver per shard per step
(the port's ``tools/collective_volumes.py``).

    python -m radiorust_tpu_torch.tools.collective_volumes [--device cpu]

The JAX tool reads each collective's bytes from the partitioned HLO of a
compiled step.  The port's collectives are functions
(``parallel/mesh.py``), so it counts them where they happen:
``mesh.TRAFFIC`` adds the bytes each collective delivers to a shard, by
kind (``ring_left``, the JAX package's ``collective-permute``;
``all_gather``; ``share``, the carry sent across ranks) and mesh axis.
One group step over a one-process mesh of ``d`` entries, on zero input,
divided by ``d``: bytes per shard per step, for the JAX tool's three
measurements:

- the WFM chain time-sharded ``t=8`` (batch 1 and 8, ``overlap`` 1 and
  4, chunk 16384): the blocks' halos;
- the 64-channel channelizer channel-sharded ``c=8`` (chunk 16384): the
  branch ``all_gather``;
- the fused chain time-sharded ``t=8`` (batch 2): the mixed-domain and
  demodulated halos.

Where the halos are laid out as the JAX package's, the counts equal the
JAX tool's; the JAX step also sums the carry out of the last shard with
a ``psum`` (an ``all-reduce`` of the state, counted there), which a
process of the port moves without a collective.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..runtime.blocks import resolve_device

__all__ = ["measure_time_sharded_wfm", "measure_channel_sharded",
           "measure_fused_time_sharded", "volumes"]

RATE = 1024000.0


def volumes(step, d: int) -> dict:
    """``step()`` once with ``mesh.TRAFFIC`` cleared: {kind: bytes per
    shard} over the ``d`` entries."""
    from ..parallel.mesh import TRAFFIC
    TRAFFIC.clear()
    step()
    out: dict = {}
    for (kind, _axis), nbytes in TRAFFIC.items():
        out[kind] = out.get(kind, 0) + nbytes / d
    return out


def _time_sharded(bound, d, overlap, device):
    from ..convert import tree_to_torch
    from ..parallel.mesh import make_mesh
    from ..parallel.time_shard import TimeShardedChain
    ts = TimeShardedChain(bound, make_mesh((d,), ("t",), device),
                          overlap=overlap)
    sig = bound.in_sig
    x = torch.zeros((sig.batch, d * sig.chunk_len), dtype=torch.complex64,
                    device=device)
    params = tree_to_torch(ts.params, device)
    state = tree_to_torch(ts.init_state(), device)
    return volumes(lambda: ts.process(params, state, x), d)


def measure_time_sharded_wfm(n: int = 16384, batch: int = 1, d: int = 8,
                             overlap: int = 1, device=None) -> dict:
    """The WFM chain time-sharded ``t=d``; on the card unless ``device``
    names another (without a card and a device it raises)."""
    from ..blocks.base import StreamSig
    from ..models.wfm import wfm_receiver
    device = resolve_device(device)
    return _time_sharded(wfm_receiver().bind(StreamSig(batch, n, RATE)), d,
                         overlap, device)


def measure_channel_sharded(d: int = 8, device=None) -> dict:
    """The channelizer channel-sharded ``c=d``; on the card unless
    ``device`` names another."""
    from ..blocks.base import StreamSig
    from ..convert import tree_to_torch
    from ..models.channelizer import channelized_receiver
    from ..parallel.channel_shard import ChannelShardedChain
    from ..parallel.mesh import make_mesh
    device = resolve_device(device)
    bound = channelized_receiver(num_channels=64, input_rate=RATE).bind(
        StreamSig(1, 16384, RATE))
    cs = ChannelShardedChain(bound, make_mesh((d,), ("c",), device),
                             axis="c")
    x = torch.zeros((1, 16384), dtype=torch.complex64, device=device)
    params = tree_to_torch(cs.params, device)
    state = tree_to_torch(cs.init_state(), device)
    return volumes(lambda: cs.process(params, state, x), d)


def measure_fused_time_sharded(d: int = 8, device=None) -> dict:
    """The fused chain time-sharded ``t=d``; on the card unless ``device``
    names another."""
    from ..blocks.base import StreamSig
    from ..models.wfm import wfm_receiver
    device = resolve_device(device)
    return _time_sharded(wfm_receiver(fuse_frontend=True, fuse_demod=True)
                         .bind(StreamSig(2, 16384, RATE)), d, 1, device)


MEASUREMENTS = (
    ("WFM time-sharded t=8 (batch 1, n=16384)",
     lambda dev: measure_time_sharded_wfm(device=dev)),
    ("WFM t=8 batch 8, overlap=1",
     lambda dev: measure_time_sharded_wfm(batch=8, device=dev)),
    ("WFM t=8 batch 8, overlap=4",
     lambda dev: measure_time_sharded_wfm(batch=8, overlap=4, device=dev)),
    ("WFM fused t=8 (batch 2, n=16384)",
     lambda dev: measure_fused_time_sharded(device=dev)),
    ("Channelizer 64ch channel-sharded c=8 (n=16384)",
     lambda dev: measure_channel_sharded(device=dev)),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    rows = {}
    print("| configuration | bytes/shard/step | breakdown |")
    print("|---|---|---|")
    for name, fn in MEASUREMENTS:
        vols = fn(dev)
        rows[name] = vols
        detail = ", ".join(f"{k} {v / 1024:.1f} kB"
                           for k, v in sorted(vols.items()))
        print(f"| {name} | {sum(vols.values()) / 1024:.1f} kB | {detail} |")
    print(json.dumps({"collective_volumes": {"device": str(dev),
                                             "rows": rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
