"""Device compute latency per real-time chunk at batch 1.

The JAX package's ``tools/bench_latency.py`` on the port.  The reference's
operating point is one receiver taking 16384-sample chunks at 1.024 Msps,
a chunk every 16 ms.  Chunks depend on each other through the carried
state, so ``BENCH_T`` steps (default 16) of one ``make_scan`` CUDA graph,
replayed ``BENCH_REPS`` times (default 256), take that many times the
latency of one chunk; the best of three runs is timed with CUDA events on
input made on the card, as ``bench_configs`` does.  Configs, at
``BENCH_BATCH`` streams (default 1):

- wfm: ``wfm_receiver(fuse_frontend=True)``, ``fuse_demod`` only at an
  even batch (the pair-packed kernel needs one);
- wfm_wide: the same at chunk 24576 with 6144-tap filters;
- wfm_unfused: ``wfm_receiver()``;
- stereo: ``wfm_stereo_receiver()``.

    python -m radiorust_tpu_torch.tools.bench_latency [names ...]
        [--device cuda]

Prints one JSON line per config: ``us_per_chunk``, ``chunk_budget_us``
(the chunk's duration) and ``realtime_headroom`` (budget over latency),
with the platform and card.  A config that fails raises.  Without a card
it raises unless ``--device cpu``.
"""

from __future__ import annotations

import json
import sys

from ._common import device_label, env_int, graphed_loop, parse_args, \
    port_lib

CONFIGS = ("wfm", "wfm_wide", "wfm_unfused", "stereo")


def build(name: str, batch: int, lib=port_lib):
    """(bound, chunk length, sample rate, graph?) of config ``name`` at
    ``batch`` streams, bound through ``lib``."""
    wfm = lib("models.wfm")
    StreamSig = lib("blocks.base").StreamSig
    n, rate = wfm.WFM_INPUT_CHUNK, wfm.WFM_INPUT_RATE
    if name == "wfm":
        chain = wfm.wfm_receiver(fuse_frontend=True,
                                 fuse_demod=batch % 2 == 0)
    elif name == "wfm_unfused":
        chain = wfm.wfm_receiver()
    elif name == "wfm_wide":
        n = 24576
        chain = wfm.wfm_receiver(fuse_frontend=True,
                                 fuse_demod=batch % 2 == 0,
                                 filter_ir_len=6144)
    elif name == "stereo":
        chain = lib("models.stereo").wfm_stereo_receiver()
    else:
        raise ValueError(f"unknown config {name!r}: one of {CONFIGS}")
    graph = name == "stereo"
    sig = StreamSig(batch, n, rate)
    return chain.bind({"iq": sig} if graph else sig), n, rate, graph


def measure(name: str, device, batch: int, t: int, reps: int) -> dict:
    bound, n, rate, graph = build(name, batch)
    best, checksum = graphed_loop(bound, graph, t, reps, device, name=name)
    us = best / (t * reps) * 1e6
    budget_us = n / rate * 1e6
    return {"metric": f"{name}_batch{batch}_compute_latency",
            "us_per_chunk": round(us, 1),
            "chunk_budget_us": round(budget_us, 1),
            "realtime_headroom": round(budget_us / us, 1),
            "checksum": checksum, **device_label(device)}


def main(argv=None) -> list:
    args = parse_args(__doc__, argv)
    batch = env_int("BENCH_BATCH", 1)
    t = env_int("BENCH_T", 16)
    reps = env_int("BENCH_REPS", 256)
    records = []
    for name in args.names or CONFIGS:
        rec = measure(name, args.device, batch, t, reps)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
