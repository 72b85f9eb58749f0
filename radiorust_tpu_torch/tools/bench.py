"""Throughput of the WFM receive chain on one card (the port's
``bench.py``).

Metric: complex IQ input Msamples/s through the fused chain
``wfm_receiver(fuse_frontend=BENCH_FUSE_FRONTEND,
fuse_demod=BENCH_FUSE_DEMOD, filter_ir_len=BENCH_IR)`` (shift + 8:3
decimation, the channel filter, FM demod + deemphasis, 8:1 decimation,
gain) bound at ``StreamSig(BENCH_BATCH, BENCH_CHUNK, 1.024e6)``; the
defaults are the JAX bench's: 64 streams of 24576 samples, 6144-tap
filters, both fusions on.  ``vs_baseline`` divides by the pipelined CPU
reference rate of ``BASELINE_MEASURED.json`` (read, never written).

The timed loop is ``tools/_common.py`` ``graphed_loop``: ``BENCH_T``
chunk steps (default 16) in one ``make_scan`` CUDA graph, replayed
``BENCH_REPS`` times (default 256) on seeded input made on the card, each
replay's output energy summed there and fetched once; the best of five
runs by CUDA events.  The FLOP and byte fields come from
``tools/mfu.py`` ``analyze`` of the very chain timed, in this process:
``mfu`` against 67 TFLOP/s float32, ``hbm_fraction`` against 3.35 TB/s.
``BENCH_TRACE=dir`` writes a device trace of one more replay there.

    python -m radiorust_tpu_torch.tools.bench [--device cuda]

Prints one JSON line: the JAX bench's fields, the device, and on the card
its name and power limit.  Any failure (the chain, the accounting, the
card, a missing baseline) raises; without a card it raises unless
``--device cpu``.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

from . import mfu
from ._common import card, device_label, env_int, graphed_loop, \
    parse_args, port_lib

__all__ = ["BASELINE_FILE", "RATE", "chain", "build", "baseline_msps",
           "main"]

BASELINE_FILE = (pathlib.Path(__file__).resolve().parents[2]
                 / "BASELINE_MEASURED.json")
RATE = 1024000.0   # WFM_INPUT_RATE


def chain(ir: int, fuse: bool, fuse_d: bool, lib=port_lib):
    """The bench's chain spec, through ``lib``
    (:func:`~._common.port_lib`, or the JAX package's modules)."""
    return lib("models.wfm").wfm_receiver(fuse_frontend=fuse,
                                          fuse_demod=fuse_d,
                                          filter_ir_len=ir)


def build(batch: int, chunk: int, ir: int, fuse: bool, fuse_d: bool,
          lib=port_lib):
    """The bench's chain bound at ``StreamSig(batch, chunk, 1.024e6)``."""
    return chain(ir, fuse, fuse_d, lib).bind(
        lib("blocks.base").StreamSig(batch, chunk, RATE))


def baseline_msps() -> float:
    """``pipelined_msps`` of ``BASELINE_MEASURED.json``; raises where the
    file is missing."""
    if not BASELINE_FILE.exists():
        raise FileNotFoundError(f"{BASELINE_FILE} is missing: the bench "
                                f"reads the CPU reference rate from it")
    return float(json.loads(BASELINE_FILE.read_text())["pipelined_msps"])


def main(argv=None) -> dict:
    args = parse_args(__doc__, argv, names=False)
    base = baseline_msps()
    batch = env_int("BENCH_BATCH", 64)
    t = env_int("BENCH_T", 16)
    chunk = env_int("BENCH_CHUNK", 24576)
    ir = env_int("BENCH_IR", 6144)
    reps = env_int("BENCH_REPS", 256)
    fuse = os.environ.get("BENCH_FUSE_FRONTEND", "1") == "1"
    fuse_d = os.environ.get("BENCH_FUSE_DEMOD", "1") == "1"
    bound = build(batch, chunk, ir, fuse, fuse_d)
    best, checksum = graphed_loop(bound, False, t, reps, args.device,
                                  name="wfm", runs=5,
                                  trace=os.environ.get("BENCH_TRACE"))
    steps = t * reps
    msps = batch * chunk * steps / best / 1e6
    acct = mfu.analyze("wfm", bound, chunk, RATE, batch, args.device)
    achieved_tflops = acct["flops_per_step"] * steps / best / 1e12
    hbm_gbps = acct["hbm_bytes_per_step"] * steps / best / 1e9
    record = {
        "metric": "wfm_chain_input_throughput",
        "value": msps,
        "unit": "Msamples/s/chip",
        "vs_baseline": msps / base,
        "flops_per_input_sample": acct["flops_per_input_sample"],
        "achieved_tflops": achieved_tflops,
        "mfu": achieved_tflops / acct["peak_f32_tflops"],
        "hbm_model_gbps": hbm_gbps,
        "hbm_fraction": hbm_gbps / acct["peak_hbm_gbps"],
        "us_per_step": best / steps * 1e6,
        "checksum": checksum,
        **device_label(args.device)}
    if args.device.type == "cuda":
        record["card"] = card()
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
