"""Throughput of the 64-channel channelized receiver (BASELINE.json
config 5) on one card.

The JAX package's ``tools/bench_channelizer.py`` on the port: one wideband
stream a row, a 64-channel polyphase filterbank and an FM demodulator per
channel, ``channelized_receiver(num_channels=64)`` at ``BENCH_BATCH`` (4)
x ``BENCH_CHUNK`` (65536) samples at 16.384 Msps.  As there, the chain is
the unfused default: its steps are PyTorch calls and launch no kernel of
the port.  ``BENCH_T`` steps (8) are one ``make_scan`` CUDA graph,
replayed ``BENCH_REPS`` times (4096), timed as ``bench_configs`` times.

``vs_baseline`` divides by the reference-style CPU rate recorded in
``CHANNELIZER_BASELINE.json`` beside the package (its
``channelizer_pipelined_msps``: 64 per-sample mixer, decimator and demod
chains on host threads), which the tool only reads; where the file is
missing the line has no ``vs_baseline``.

    python -m radiorust_tpu_torch.tools.bench_channelizer [--device cuda]

Prints one JSON line; raises on a bad checksum, and without a card unless
``--device cpu``.
"""

from __future__ import annotations

import json
import pathlib
import sys

from ._common import device_label, env_int, graphed_loop, parse_args, \
    port_lib

BASELINE_FILE = (pathlib.Path(__file__).resolve().parents[2]
                 / "CHANNELIZER_BASELINE.json")
BASELINE_KEY = "channelizer_pipelined_msps"
RATE = 16384000.0


def baseline_msps():
    """The CPU rate of ``CHANNELIZER_BASELINE.json``, or None where the
    file is missing."""
    if not BASELINE_FILE.exists():
        return None
    return float(json.loads(BASELINE_FILE.read_text())[BASELINE_KEY])


def build(batch: int, n: int, lib=port_lib):
    """The channelized receiver bound at ``batch`` x ``n``."""
    chain = lib("models.channelizer").channelized_receiver(
        num_channels=64, input_rate=RATE)
    return chain.bind(lib("blocks.base").StreamSig(batch, n, RATE))


def main(argv=None) -> dict:
    args = parse_args(__doc__, argv, names=False)
    batch = env_int("BENCH_BATCH", 4)
    n = env_int("BENCH_CHUNK", 65536)
    t = env_int("BENCH_T", 8)
    reps = env_int("BENCH_REPS", 4096)
    best, checksum = graphed_loop(build(batch, n), False, t, reps,
                                  args.device, name="channelizer64")
    msps = batch * n * t * reps / best / 1e6
    rec = {"metric": "channelizer64_input_throughput",
           "value": round(msps, 2), "unit": "Msamples/s/chip",
           "channels": 64, "checksum": checksum,
           **device_label(args.device)}
    base = baseline_msps()
    if base is not None:
        rec["vs_baseline"] = round(msps / base, 2)
        rec["baseline"] = {"file": BASELINE_FILE.name, "key": BASELINE_KEY,
                           "msps": base}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
