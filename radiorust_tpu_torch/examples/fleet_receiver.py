"""A receiver fleet on a device mesh: the parallel serving APIs.

The radiorust way to serve many receivers is many independent block
graphs, one per stream, scheduled by Tokio across cores
(``src/blocks/mod.rs:27-34``).  Here a mesh serves them, in three ways:

1. **Stream sharding**: one ``RuntimeBlock(wfm_receiver(), mesh=...)``
   actor demodulates 16 independent FM stations; each batched
   ``[streams, n]`` chunk splits its stream axis over the mesh (per-stream
   state splits, params replicate, nothing crosses between shards).
2. **Channel sharding**: one wideband stream splits into 64 channels by
   the polyphase filterbank, its branch groups, DFT columns and
   per-channel FM demod split over the mesh (``ChannelShardedChain``,
   one gather a step).
3. **Time sharding**: one stream served by the whole mesh; each group
   chunk of D * 2048 samples runs as D consecutive chunks with halo
   exchange (``RuntimeBlock(..., shard="time")``).

The meshes are four entries of the chosen device (one card serves four
shards; the JAX package's example uses eight virtual CPU devices).

    python -m radiorust_tpu_torch.examples.fleet_receiver [--device cpu]
"""

import asyncio

import numpy as np

from ..blocks.base import StreamSig
from ..convert import tree_to_numpy, tree_to_torch
from ..models.channelizer import channelized_receiver
from ..models.wfm import WFM_INPUT_RATE, wfm_receiver
from ..parallel.channel_shard import ChannelShardedChain
from ..parallel.mesh import make_mesh
from ..runtime import ArraySink, RuntimeBlock, wait_until
from ..runtime.blocks import resolve_device
from ..runtime.flow import new_sender
from ..signal import Samples
from ._common import cli, dominant_tone

CHUNK = 2048
STEPS = 4
SHARDS = 4


def fm_modulate(tone_hz, rate, n, deviation, phase0=0.0):
    t = np.arange(n) / rate
    audio = 0.5 * np.sin(2 * np.pi * tone_hz * t)
    phase = phase0 + 2 * np.pi * deviation * np.cumsum(audio) / rate
    return np.exp(1j * phase).astype(np.complex64)


def _feed(actor):
    sender, connector = new_sender()
    actor.feed_from(type("P", (), {"sender_connector": connector})())
    return sender


async def serve_fleet(mesh):
    """16 independent FM stations through ONE stream-sharded actor."""
    tones = np.linspace(400.0, 3400.0, 16)
    xs = np.stack([
        fm_modulate(t, WFM_INPUT_RATE, STEPS * CHUNK, 75000.0, phase0=i)
        for i, t in enumerate(tones)])                  # [16, steps*n]
    xs = np.moveaxis(xs.reshape(16, STEPS, CHUNK), 1, 0)

    fleet = RuntimeBlock(wfm_receiver(), mesh=mesh, name="fleet")
    sender = _feed(fleet)
    sink = ArraySink()
    sink.feed_from(fleet)
    for s in range(STEPS):
        await sender.send(Samples(WFM_INPUT_RATE, xs[s]))
    await wait_until(lambda: len(sink.chunks) >= STEPS, fleet, sink)

    audio = np.concatenate(sink.chunks, axis=-1).real  # [16, steps*out]
    audio_rate = sink.sample_rate
    found = [dominant_tone(audio[i, CHUNK // 64:], audio_rate)
             for i in range(16)]
    hits = sum(abs(f - t) < audio_rate / audio.shape[-1] * 2
               for f, t in zip(found, tones))
    devices = sorted({str(d) for d in mesh.devices.flat})
    print(f"fleet: {hits}/16 streams demodulated to their tone "
          f"({mesh.size} shards on {devices}, stream axis sharded, "
          f"{fleet.executor} executor)")
    fleet.stop()
    return {"hits": hits, "executor": fleet.executor,
            "device": fleet.device}


def wideband(mesh, device):
    """One 16.4 Msps wideband stream -> 64 channels, channel-sharded."""
    rate = 16384000.0
    chain = channelized_receiver(num_channels=64, input_rate=rate)
    bound = chain.bind(StreamSig(1, 8192, rate))
    cs = ChannelShardedChain(bound, mesh, axis="c")

    # Stations on channels 7, 21, 42.
    n_total = STEPS * 8192
    t = np.arange(n_total) / rate
    x = np.zeros(n_total, np.complex128)
    stations = {7: 700.0, 21: 2100.0, 42: 1300.0}
    for c, tone in stations.items():
        iq = fm_modulate(tone, rate, n_total, 0.25 * rate / 64)
        x += iq * np.exp(2j * np.pi * (c * rate / 64) * t)
    xs = tree_to_torch(x.astype(np.complex64).reshape(STEPS, 1, 8192),
                       device)

    # The compiled step, as RuntimeBlock(shard="channels") drives it: one
    # CUDA graph of every shard's work on a card.
    step = cs.jit_step()
    state = tree_to_torch(cs.init_state(), device)
    params = tree_to_torch(cs.params, device)
    outs = []
    for s in range(STEPS):
        state, y = step(params, state, xs[s])
        outs.append(tree_to_numpy(y))
    audio = np.concatenate(outs[1:], axis=-1).real      # skip warmup chunk
    ch_rate = rate / 64
    ok = 0
    for c, tone in stations.items():
        got = dominant_tone(audio[c], ch_rate)
        ok += abs(got - tone) < ch_rate / audio.shape[-1] * 2
    print(f"wideband: {ok}/{len(stations)} stations found on their "
          f"channels (64-ch PFB, channel axis sharded over {cs.ndev})")
    return {"stations": ok}


async def single_stream_time_sharded(mesh):
    """ONE stream served by the whole mesh: ``shard="time"`` runs each
    group chunk of D * chunk_len samples as D consecutive chunks with
    halo exchange."""
    d = mesh.size
    tone = 1200.0
    x = fm_modulate(tone, WFM_INPUT_RATE, STEPS * d * CHUNK, 75000.0)
    groups = x.reshape(STEPS, 1, d * CHUNK)

    rx = RuntimeBlock(wfm_receiver(), mesh=mesh, shard="time",
                      name="single")
    sender = _feed(rx)
    sink = ArraySink()
    sink.feed_from(rx)
    for s in range(STEPS):
        await sender.send(Samples(WFM_INPUT_RATE, groups[s]))
    await wait_until(lambda: len(sink.chunks) >= STEPS, rx, sink)

    audio = np.concatenate(sink.chunks, axis=-1).real[0]
    got = dominant_tone(audio[CHUNK // 8:], sink.sample_rate)
    ok = abs(got - tone) < sink.sample_rate / audio.size * 4
    print(f"single stream: tone {got:.0f} Hz recovered "
          f"({'ok' if ok else 'WRONG'}; {d} shards, time axis sharded, "
          f"{rx.executor} executor)")
    rx.stop()
    return {"tone": got, "ok": bool(ok), "executor": rx.executor,
            "device": rx.device}


def main(device="cuda"):
    dev = resolve_device(device)
    fleet = asyncio.run(serve_fleet(
        make_mesh((SHARDS,), ("streams",), dev)))
    wide = wideband(make_mesh((SHARDS,), ("c",), dev), dev)
    single = asyncio.run(single_stream_time_sharded(
        make_mesh((SHARDS,), ("t",), dev)))
    return {"fleet": fleet, "wideband": wide, "single": single,
            "devices": [fleet["device"], single["device"]]}


if __name__ == "__main__":
    cli(main, __doc__)
