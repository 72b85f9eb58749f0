"""Serving-runtime soak: the actor stack under sustained load.

The JAX package's ``tools/soak.py`` on the port.  It drives

    SdrRx(SyntheticSdrDriver) -> Rechunker(SOAK_CHUNK) ->
    RuntimeBlock(wfm_receiver(fuse_frontend=True, filter_ir_len=SOAK_IR),
                 pipeline_depth=SOAK_PIPELINE_DEPTH) -> Buffer -> Blackhole

for ``SOAK_SECONDS`` of wall time (default 330; chunk 24576, 6144-tap
filters, depth 2), the source unthrottled (``SOAK_THROTTLE=1`` paces it
at its sample rate, as a live SDR is paced: then the rate checks ask
whether the stack keeps real time), and samples every 5 s (less for
short runs): the audio samples delivered to the sink, the actor's
processed chunks, the host RSS (``/proc/self/statm``), the card's
``torch.cuda.memory_allocated``, and the Buffer's queued duration and
entries.  It fails on

- throughput decay: a post-warm-up bucket's sink rate below
  ``DECAY_FRAC`` (0.7) of the best post-warm-up bucket;
- host-memory creep: RSS growth from the end of the warm-up to the end
  of the run above ``RSS_BUDGET_MB`` (300);
- queue growth: the Buffer's queued duration past its ``max_capacity``
  (plus 0.5 s).

The card's allocated memory after the warm-up and at the end is
recorded beside the RSS.  Prints the record (JSON) and exits non-zero on
failure; writes it to a file only where ``--out PATH`` is given.

    python -m radiorust_tpu_torch.tools.soak [--device cuda] [--out PATH]

Without a card it raises unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import sys
import time

import torch

from ..runtime.recycle import rss_mb
from ._common import device_label, parse_args, port_lib


def device_mb(device):
    """Bytes the caching allocator holds in tensors on ``device``, in MB
    (None on the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 1e6


def build(chunk: int = 24576, ir_len: int = 6144, lib=port_lib):
    """The soak's receive chain (a spec: the actor binds it at one
    stream of ``chunk`` samples)."""
    return lib("models.wfm").wfm_receiver(fuse_frontend=True,
                                          filter_ir_len=ir_len)


async def _soak(device, duration: float, sample_every: float, chunk: int,
                ir_len: int, depth: int, max_cap: float,
                throttle: bool) -> list:
    from ..models.wfm import WFM_INPUT_RATE
    from ..runtime import Blackhole, Buffer, Rechunker, RuntimeBlock
    from ..runtime.io import SdrRx, SyntheticSdrDriver
    # An FM-band tone carrier in the passband and light noise; unpaced,
    # the source outruns the device block, so the rate is the serving
    # path's own.
    driver = SyntheticSdrDriver(WFM_INPUT_RATE, tones=((57000.0, 0.7),),
                                noise=0.05, throttle=throttle)
    src = SdrRx(driver)
    rechunk = Rechunker(chunk)
    # SdrRx serves one stream (the actor binds batch 1): the pair-packed
    # FmDemodFilter needs an even batch, so only the front end fuses.
    wfm = RuntimeBlock(build(chunk, ir_len), name="soak_wfm",
                       pipeline_depth=depth, device=device)
    buf = Buffer(initial_capacity=0.1, min_capacity=0.05,
                 max_capacity=max_cap, max_age=4.0)
    sink = Blackhole()
    rechunk.feed_from(src)
    wfm.feed_from(rechunk)
    buf.feed_from(wfm)
    sink.feed_from(buf)
    await src.activate()
    t0 = time.monotonic()
    samples = []
    try:
        while True:
            await asyncio.sleep(sample_every)
            now = time.monotonic() - t0
            for actor in (src, rechunk, wfm, buf, sink):
                if getattr(actor, "failure", None) is not None:
                    raise actor.failure
            samples.append({
                "t_s": round(now, 1),
                "sink_samples": int(sink.samples_seen),
                "chunks_processed": int(wfm.chunks_processed),
                "rss_mb": round(rss_mb(), 1),
                "device_mb": device_mb(device),
                "queue_s": round(buf._queue.duration, 3),
                "queue_entries": len(buf._queue),
            })
            if now >= duration:
                break
    finally:
        await src.deactivate()
        await src.close()
    return samples


def soak(device, duration: float, chunk: int = 24576, ir_len: int = 6144,
         depth: int = 2, decay_frac: float = 0.7, rss_budget: float = 300.0,
         throttle: bool = False) -> dict:
    """Run the soak on ``device`` for ``duration`` seconds; its record."""
    sample_every = min(5.0, max(1.0, duration / 8))
    max_cap = 2.0
    t_start = time.monotonic()
    samples = asyncio.run(_soak(device, duration, sample_every, chunk,
                                ir_len, depth, max_cap, throttle))
    wall = time.monotonic() - t_start

    # Rate between consecutive probes, grouped in buckets of 60 s (a
    # quarter of a short run, so that the decay check has >= 3 buckets).
    bucket_s = 60.0 if duration >= 240 else max(duration / 4, 2.0)
    rates = {}
    for a, b in zip(samples, samples[1:]):
        d_t = b["t_s"] - a["t_s"]
        if d_t > 0:
            rates.setdefault(int(b["t_s"] // bucket_s), []).append(
                (b["sink_samples"] - a["sink_samples"]) / d_t)
    bucket_msps = {str(k): round(sum(v) / len(v) / 1e6, 3)
                   for k, v in sorted(rates.items())}
    # The warm-up (the kernels' build, the capture, the Buffer's fill)
    # rides the first minute, or the first third of a short run.
    warmup_s = 60.0 if duration >= 240 else duration / 3
    k_min = int(math.ceil(warmup_s / bucket_s))
    post = ([sum(v) / len(v) for k, v in sorted(rates.items())
             if k >= k_min]
            or [sum(v) / len(v) for _, v in sorted(rates.items())])
    best, worst = (max(post), min(post)) if post else (0.0, 0.0)
    warm_idx = next((i for i, s in enumerate(samples)
                     if s["t_s"] >= warmup_s), len(samples) - 1)
    rss_growth = samples[-1]["rss_mb"] - samples[warm_idx]["rss_mb"]
    window_chunks = (samples[-1]["chunks_processed"]
                     - samples[warm_idx]["chunks_processed"])
    dev_warm, dev_end = (samples[warm_idx]["device_mb"],
                         samples[-1]["device_mb"])
    max_queue = max(s["queue_s"] for s in samples)
    throughput_ok = best > 0 and worst >= decay_frac * best
    rss_ok = rss_growth <= rss_budget
    queue_ok = max_queue <= max_cap + 0.5
    chunks = samples[-1]["chunks_processed"]
    ok = bool(throughput_ok and rss_ok and queue_ok and chunks > 0)
    return {
        "ok": ok,
        **device_label(device),
        "duration_s": round(wall, 1),
        "chunks_processed": chunks,
        "input_msamples": round(chunks * chunk / 1e6, 1),
        "sink_samples": samples[-1]["sink_samples"],
        "bucket_s": bucket_s,
        "bucket_sink_msps": bucket_msps,
        "throughput_ok": bool(throughput_ok),
        "worst_over_best": round(worst / best, 3) if best else None,
        "rss_start_mb": samples[0]["rss_mb"],
        "rss_end_mb": samples[-1]["rss_mb"],
        "rss_growth_after_warmup_mb": round(rss_growth, 1),
        "rss_growth_per_chunk_kb": round(
            rss_growth * 1e3 / max(window_chunks, 1), 1),
        "rss_ok": bool(rss_ok),
        "device_mem_after_warmup_mb": dev_warm,
        "device_mem_end_mb": dev_end,
        "device_mem_growth_mb": (None if dev_warm is None
                                 else dev_end - dev_warm),
        "max_queue_s": round(max_queue, 3),
        "queue_ok": bool(queue_ok),
        "pipeline_depth": depth,
        "chunk": chunk,
        "throttled": throttle,
        "probes": samples if duration < 240 else samples[::3],
    }


def main(argv=None) -> dict:
    args = parse_args(__doc__, argv, names=False)
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None,
                   help="also write the record to this file")
    out = p.parse_args(args.rest).out
    record = soak(args.device,
                  float(os.environ.get("SOAK_SECONDS", "330")),
                  chunk=int(os.environ.get("SOAK_CHUNK", "24576")),
                  ir_len=int(os.environ.get("SOAK_IR", "6144")),
                  depth=int(os.environ.get("SOAK_PIPELINE_DEPTH", "2")),
                  decay_frac=float(os.environ.get("DECAY_FRAC", "0.7")),
                  rss_budget=float(os.environ.get("RSS_BUDGET_MB", "300")),
                  throttle=os.environ.get("SOAK_THROTTLE", "0") == "1")
    text = json.dumps(record, indent=1)
    if out:
        with open(out, "w") as f:
            f.write(text)
    print(text, flush=True)
    if not record["ok"]:
        raise SystemExit(1)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
