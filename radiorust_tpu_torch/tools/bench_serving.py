"""Serving-path benchmark: host chunks through the runtime actor
(``RuntimeBlock`` around ``wfm_receiver()``) to a host sink.

The JAX package's ``tools/bench_serving.py`` on the port.  Where
``bench_configs`` times graphed steps on input already on the card, a live
receiver's chunk arrives from an SDR on the host, is staged and copied to
the card, runs one replay of the actor's ``jit_step``, and its audio
comes back to the host: this tool times that path, for five variants of
chunk length, ``pipeline_depth`` (chunks in flight) and streams a
message: 16384 at depth 0 and 8, 65536 at depth 0, one stream; 16384 at
depth 0 and 8, 64 streams.  Each variant sends 3 warm chunks, then times
``SERVE_CHUNKS`` (64) chunks from the first send to the last output at
the sink (every output is on the host, and is checked finite).

    python -m radiorust_tpu_torch.tools.bench_serving [variants ...]
        [--device cuda]

Prints one JSON line per variant (``chunk<n>_depth<d>_x<streams>``:
``msps_aggregate``, ``ms_per_chunk``, ``chunks``, the platform and card).
A variant that fails raises.  Without a card it raises unless
``--device cpu``.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

import numpy as np

from ._common import device_label, parse_args, port_lib

VARIANTS = ((16384, 0, 1), (16384, 8, 1), (65536, 0, 1), (16384, 0, 64),
            (16384, 8, 64))


def variant_name(chunk: int, depth: int, streams: int) -> str:
    return f"chunk{chunk}_depth{depth}_x{streams}"


def build(lib=port_lib):
    """The served chain (a spec: the actor binds it at the message's
    streams and chunk length)."""
    return lib("models.wfm").wfm_receiver()


async def _run_variant(device, chunk: int, depth: int, n_chunks: int,
                       streams: int, warm: int = 3) -> float:
    from ..models.wfm import WFM_INPUT_RATE
    from ..runtime import ArraySink, RuntimeBlock, wait_until
    from ..runtime.flow import new_sender
    from ..signal import Samples
    rng = np.random.default_rng(0)
    shape = (streams, chunk) if streams > 1 else (chunk,)
    data = (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sender, connector = new_sender()
    blk = RuntimeBlock(build(), pipeline_depth=depth, device=device)
    sink = ArraySink()
    blk.feed_from(type("P", (), {"sender_connector": connector})())
    sink.feed_from(blk)
    # The warm chunks build the kernels and capture the binding's step.
    for _ in range(warm):
        await sender.send(Samples(WFM_INPUT_RATE, data))
    await wait_until(lambda: len(sink.chunks) >= warm, blk, sink,
                     poll=0.002, timeout=900.0)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        await sender.send(Samples(WFM_INPUT_RATE, data))
    await wait_until(lambda: len(sink.chunks) >= warm + n_chunks, blk, sink,
                     poll=0.002, timeout=900.0)
    dt = time.perf_counter() - t0
    audio = np.concatenate(sink.chunks[warm:], axis=-1)
    if not (audio.size and np.all(np.isfinite(audio))):
        raise RuntimeError("bad serving output")
    sender.close()
    await asyncio.sleep(0)
    return dt


def measure(device, chunk: int, depth: int, streams: int,
            n_chunks: int) -> dict:
    dt = asyncio.run(_run_variant(device, chunk, depth, n_chunks, streams))
    return {"variant": variant_name(chunk, depth, streams),
            "msps_aggregate": round(streams * chunk * n_chunks / dt / 1e6,
                                    2),
            "ms_per_chunk": round(dt / n_chunks * 1e3, 3),
            "chunks": n_chunks, **device_label(device)}


def main(argv=None) -> list:
    args = parse_args(__doc__, argv)
    n_chunks = int(os.environ.get("SERVE_CHUNKS", "64"))
    by_name = {variant_name(*v): v for v in VARIANTS}
    unknown = [n for n in args.names if n not in by_name]
    if unknown:
        raise ValueError(f"unknown variants {unknown}: {sorted(by_name)}")
    records = []
    for name in args.names or list(by_name):
        rec = measure(args.device, *by_name[name], n_chunks)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
