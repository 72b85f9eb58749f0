"""Throughput of the BASELINE.json configurations on one card.

The JAX package's ``tools/bench_configs.py`` on the port: each config is
bound at ``BENCH_BATCH`` streams (default 64), its ``BENCH_T`` chunk steps
(default 16) are one ``make_scan`` CUDA graph, replayed ``BENCH_REPS``
times (default 256) on input made on the card from a seeded generator,
and the best of three such runs is timed with CUDA events.  The output
energy of every replay (plus the bandwidth meter's hertz) is summed on
the card and fetched once as a checksum, which must be finite and
positive.  Configs:

1. morse, morse_rf: ``morse_audio_chain()`` at 48 kHz, ``morse_rf_chain()``
   at 128 kHz, chunk 4096;
2. audiopipe: FreqShifter -> Filter -> 2:1 Downsampler at 2.4 Msps;
3. bw_meter: ``bandwidth_meter_chain(fuse_frontend=BENCH_FUSE_FRONTEND)``
   at 1.024 Msps, chunk 10240, then ``measure_bandwidth``;
4. stereo, stereo_wide: ``wfm_stereo_receiver(fuse_frontend=True)`` at
   chunk 16384, and at 24576 with 6144-tap filters.

    python -m radiorust_tpu_torch.tools.bench_configs [names ...]
        [--device cuda]

Prints one JSON line per config (the JAX tool's fields, and the platform
and card); a config that fails raises, and the tool exits non-zero.
Without a card it raises unless ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from ._common import device_label, env_int, graphed_loop, parse_args, \
    port_lib

CONFIGS = ("morse", "morse_rf", "audiopipe", "bw_meter", "stereo",
           "stereo_wide")
DEFAULT = ("morse", "audiopipe", "bw_meter")


def build(name: str, batch: int, lib=port_lib):
    """(bound, chunk length, graph?, post) of config ``name`` at ``batch``
    streams, bound through ``lib`` (:func:`~._common.port_lib`)."""
    StreamSig = lib("blocks.base").StreamSig
    post = None
    if name == "morse":
        chain, n, rate = lib("models.morse_tx").morse_audio_chain(), 4096, \
            48000.0
    elif name == "morse_rf":
        chain, n, rate = lib("models.morse_tx").morse_rf_chain(), 4096, \
            128000.0
    elif name == "audiopipe":
        def lp(bins, freqs):
            return np.where(np.abs(freqs) <= 500000.0, 1.0 + 0.0j, 0.0j)

        chain = lib("blocks.base").Chain(
            lib("blocks.transform").FreqShifter.with_shift(-100000.0),
            lib("blocks.filters").Filter.new(lp),
            lib("blocks.resampling").Downsampler(1200000.0, 1000000.0))
        n, rate = 16384, 2400000.0
    elif name == "bw_meter":
        bwm = lib("models.bandwidth_meter")
        fuse = os.environ.get("BENCH_FUSE_FRONTEND", "1") == "1"
        chain = bwm.bandwidth_meter_chain(fuse_frontend=fuse)
        n, rate = 10240, 1024000.0

        def post(ys, bound):
            return bwm.measure_bandwidth(ys, bound.out_sig.sample_rate).sum()
    elif name in ("stereo", "stereo_wide"):
        wide = name.endswith("wide")
        n, rate = (24576 if wide else 16384), 1024000.0
        chain = lib("models.stereo").wfm_stereo_receiver(
            fuse_frontend=True, filter_ir_len=6144 if wide else None)
    else:
        raise ValueError(f"unknown config {name!r}: one of {CONFIGS}")
    graph = hasattr(chain, "input")
    sig = StreamSig(batch, n, rate)
    bound = chain.bind({"iq": sig} if graph else sig)
    return bound, n, graph, post


def measure(name: str, device, batch: int, t: int, reps: int) -> dict:
    """One config's JSON record."""
    t0 = time.perf_counter()
    bound, n, graph, post = build(name, batch)
    best, checksum = graphed_loop(bound, graph, t, reps, device, post,
                                  name=name)
    print(f"# {name}: {time.perf_counter() - t0:.1f}s with warm-up",
          flush=True)
    return {"metric": f"{name}_input_throughput",
            "value": round(batch * n * t * reps / best / 1e6, 2),
            "unit": "Msamples/s/chip",
            "us_per_step": round(best / (t * reps) * 1e6, 1),
            "checksum": checksum, **device_label(device)}


def main(argv=None) -> list:
    args = parse_args(__doc__, argv)
    batch = env_int("BENCH_BATCH", 64)
    t = env_int("BENCH_T", 16)
    reps = env_int("BENCH_REPS", 256)
    records = []
    for name in args.names or DEFAULT:
        rec = measure(name, args.device, batch, t, reps)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
