"""The runtime's mesh modes (``RuntimeBlock`` / ``RuntimeGraph`` with
``mesh=``, ``shard="streams" | "channels" | "time"``) on CPU tensors:
each against the unsharded actor on the same chunks and against the JAX
package's mesh actor on its virtual CPU devices, following
``tests/test_parallel.py`` and ``tests/test_channel_shard.py``; the
fallbacks to the single-device step with their warning, at construction;
``mesh_axis`` validation; and ``fleet_receiver --device cpu``.

Tolerances: the JAX tests' (atol 5e-4; FM from the third output chunk,
past the chaotic warm-up).  The port's sharded executors equal its
unsharded step bit for bit on CPU tensors, and that is held where the
batch splits keep every pair-packed filter's pairs."""

import asyncio
import logging

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import radiorust_tpu.runtime as jrt
import radiorust_tpu.runtime.flow as jflow
import radiorust_tpu.signal as jsig
import radiorust_tpu_torch.runtime as prt
import radiorust_tpu_torch.runtime.flow as pflow
import radiorust_tpu_torch.signal as psig
from torch_examples import run_example
from torch_parallel import (J, P, interpret_pallas_highest,  # noqa: F401
                            lowpass, make_iq)
from radiorust_tpu_torch.examples._common import check_output
from radiorust_tpu_torch.parallel.mesh import make_mesh

ATOL = 5e-4
PORT = (prt, pflow, psig)
JAXRT = (jrt, jflow, jsig)


def run(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _drive(make, chunks, rate, rt=PORT, outputs=None, setter=None):
    """Feed ``chunks`` to the actor ``make()`` and collect each output
    until the input closes: ({output: [chunks]}, actor).  ``setter`` =
    (i, fn) calls ``fn(actor)`` once i chunks came out."""
    runtime, flow, signal = rt
    actor = make()
    sender, connector = flow.new_sender()
    actor.feed_from(type("P", (), {"sender_connector": connector})())
    sinks = {}
    for name in outputs or [None]:
        sinks[name] = runtime.ArraySink()
        sinks[name].feed_from(actor if name is None else actor.out(name))
    for i, c in enumerate(chunks):
        if setter is not None and i == setter[0]:
            while min(len(s.chunks) for s in sinks.values()) < i:
                await asyncio.sleep(0.01)
            setter[1](actor)
        await sender.send(signal.Samples(rate, c))
    sender.close()
    await asyncio.gather(*[s._task for s in sinks.values()])
    assert actor.failure is None
    return {k: s.chunks for k, s in sinks.items()}, actor


def _cat(chunks):
    return np.concatenate(chunks, axis=-1)


def groups_of(xs, d):
    """[T, b, n] -> T/d group chunks [b, d*n]."""
    t = xs.shape[0]
    return [np.concatenate(list(xs[g * d:(g + 1) * d]), axis=-1)
            for g in range(t // d)]


def pmesh(d, name):
    return make_mesh((d,), (name,), "cpu")


def jmesh(d, name):
    return JMesh(np.array(jax.devices()[:d]), (name,))


def P_rt_block(spec, mesh=None, **kw):
    """The port's actor: on the mesh (its device the mesh's), or on the
    CPU without one."""
    if mesh is None:
        return prt.RuntimeBlock(spec, device="cpu", **kw)
    return prt.RuntimeBlock(spec, mesh=mesh, **kw)


def test_runtime_block_stream_sharded():
    """``shard="streams"``: batched chunks split their stream axis over
    the mesh (bit for bit the unsharded actor); a 1-D chunk, which cannot
    split, runs the single-device step."""
    xs = make_iq(4, 8, 128, seed=5)
    chunks = list(xs) + [xs[0, 0]]

    def port(mesh):
        return lambda: P_rt_block(P.FreqShifter.with_shift(500.0), mesh)

    got, actor = run(_drive(port(pmesh(4, "streams")), chunks, 8000.0))
    assert actor.mesh_axis == "streams" and actor.executor == "single"
    assert [b.executor for b in actor._bindings.values()] == ["streams",
                                                              "single"]
    want, _ = run(_drive(port(None), chunks, 8000.0))
    jwant, _ = run(_drive(lambda: jrt.RuntimeBlock(
        J.FreqShifter.with_shift(500.0), mesh=jmesh(4, "streams")),
        chunks, 8000.0, JAXRT))
    for g, w, j in zip(got[None], want[None], jwant[None]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, j, atol=ATOL)


def test_runtime_block_wfm_fleet_stream_sharded():
    """16 WFM streams through one stream-sharded actor: chunk for chunk
    the unsharded actor, state carried across chunks."""
    n, streams, steps = 2048, 16, 3
    tt = np.arange(steps * n) / 1024000.0
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * tt)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / 1024000.0 * np.cumsum(audio)))
    phases = np.exp(1j * np.linspace(0.0, 1.0, streams))
    xs = (iq[None, :] * phases[:, None]).astype(np.complex64)
    xs = np.moveaxis(xs.reshape(streams, steps, n), 1, 0)
    got, actor = run(_drive(lambda: P_rt_block(
        P.wfm_receiver(), pmesh(8, "streams")), list(xs), 1024000.0))
    assert actor.executor == "streams"
    want, _ = run(_drive(lambda: P_rt_block(P.wfm_receiver()), list(xs),
                         1024000.0))
    for g, w in zip(got[None], want[None]):
        np.testing.assert_array_equal(g, w)


def test_runtime_block_time_sharded():
    """``shard="time"``: each group chunk of D*n samples runs as D chunks
    with halo exchange; the same samples as the unsharded actor fed chunk
    by chunk (a gain set before streaming reaches the executor's params),
    as the JAX package's time-sharded actor, and ``overlap=2`` within
    ulps (a sub-batch of one stream unpacks the real filter's pairs)."""
    d, n, steps = 4, 1024, 3
    xs = make_iq(steps * d, 2, n, seed=31)
    groups = groups_of(xs, d)

    def gain(a):
        a.set_gain(0.25)

    got, actor = run(_drive(lambda: P_rt_block(
        P.wfm_receiver(), pmesh(d, "t"), shard="time"), groups, 1024000.0,
        setter=(0, gain)))
    assert actor.executor == "time"
    want, _ = run(_drive(lambda: P_rt_block(P.wfm_receiver()), list(xs),
                         1024000.0, setter=(0, gain)))
    got, want = _cat(got[None]), _cat(want[None])
    assert got.shape == want.shape
    out_n = got.shape[-1] // (steps * d)
    np.testing.assert_array_equal(got, want)
    jgot, _ = run(_drive(lambda: jrt.RuntimeBlock(
        J.wfm_receiver(), mesh=jmesh(d, "t"), shard="time"), groups,
        1024000.0, JAXRT, setter=(0, gain)))
    np.testing.assert_allclose(got[:, 2 * out_n:],
                               _cat(jgot[None])[:, 2 * out_n:], atol=ATOL)
    ov, actor = run(_drive(lambda: P_rt_block(
        P.wfm_receiver(), pmesh(d, "t"), shard="time", overlap=2), groups,
        1024000.0, setter=(0, gain)))
    assert actor.executor == "time"
    np.testing.assert_allclose(_cat(ov[None])[:, 2 * out_n:],
                               got[:, 2 * out_n:], atol=1e-5)


def test_runtime_block_time_shard_set_shift():
    """A phase-continuous ``set_shift`` mid-stream on the time-sharded
    actor: the same samples as the unsharded actor retuned at the same
    stream position."""
    d, n, steps = 4, 1024, 4
    xs = make_iq(steps * d, 2, n, seed=8)

    def retune(a):
        a.set_shift(-57000.0)

    got, _ = run(_drive(lambda: P_rt_block(
        P.wfm_receiver(tune_shift=100e3, fuse_frontend=True),
        pmesh(d, "t"), shard="time"), groups_of(xs, d), 1024000.0,
        setter=(2, retune)))
    want, _ = run(_drive(lambda: P_rt_block(
        P.wfm_receiver(tune_shift=100e3, fuse_frontend=True)), list(xs),
        1024000.0, setter=(2 * d, retune)))
    np.testing.assert_array_equal(_cat(got[None]), _cat(want[None]))


@pytest.mark.parametrize("case", ["slew", "overlap", "pair_packed",
                                  "chunk"])
def test_runtime_block_falls_back_at_construction(case, caplog):
    """A binding that cannot shard logs a warning and runs the
    single-device step, at construction (never at the first chunk): a
    chain time sharding rejects (the slew limiter), a batch-1 stream with
    ``overlap=2``, a pair-packed block whose local batch would be odd, a
    chunk that does not divide the time axis.  The values are the
    unsharded actor's."""
    if case == "slew":
        spec, shard, kw, rate = P.morse_audio_chain(), "time", {}, 48000.0
        chunks = [np.ones((2, 512), np.complex64)] * 2
        mesh, warn = pmesh(4, "t"), "cannot time-shard"
    elif case == "overlap":
        spec, shard, kw, rate = P.wfm_receiver(), "time", {"overlap": 2}, \
            1024000.0
        chunks = groups_of(make_iq(8, 1, 1024, seed=33), 4)
        mesh, warn = pmesh(4, "t"), "not divisible by overlap"
    elif case == "pair_packed":
        spec, shard, kw, rate = P.FmDemodFilter(150000.0,
                                                P.deemphasis_band), \
            "streams", {}, 384000.0
        chunks = list(make_iq(2, 8, 512, seed=9))
        mesh, warn = pmesh(8, "streams"), None
    else:
        spec, shard, kw, rate = P.Chain(P.FreqShifter.with_shift(500.0),
                                        P.Filter.new(lowpass(2000.0))), \
            "time", {}, 8000.0
        chunks = list(make_iq(2, 1, 66, seed=3))
        mesh, warn = pmesh(4, "t"), "not divisible by the time axis"
    with caplog.at_level(logging.WARNING):
        got, actor = run(_drive(lambda: P_rt_block(spec, mesh, shard=shard,
                                                   **kw), chunks, rate))
    assert actor.executor == "single"
    if warn is not None:
        assert any(warn in r.getMessage() for r in caplog.records), \
            caplog.text
    want, _ = run(_drive(lambda: P_rt_block(spec), chunks, rate))
    np.testing.assert_array_equal(_cat(got[None]), _cat(want[None]))


def test_runtime_block_channel_sharded():
    """``shard="channels"``: one wideband 1-D stream served by the mesh,
    folded channel outputs; a live ``set_shift`` (phase-continuous on the
    [batch, M] state) and a non-channelizer spec's fallback; as the
    unsharded and the JAX package's actors."""
    def chain(L):
        return L.Chain(L.Channelizer(16, taps_per_branch=4),
                       L.FreqShifter.with_shift(50.0), L.GainControl(0.5))
    xs = list(make_iq(4, 1, 512, seed=8)[:, 0])

    def retune(a):
        a.set_shift(75.0)

    got, actor = run(_drive(lambda: P_rt_block(
        chain(P), pmesh(8, "c"), shard="channels"), xs, 16000.0,
        setter=(2, retune)))
    assert actor.executor == "channels" and got[None][0].shape == (16, 32)
    want, _ = run(_drive(lambda: P_rt_block(chain(P)), xs, 16000.0,
                         setter=(2, retune)))
    jwant, _ = run(_drive(lambda: jrt.RuntimeBlock(
        chain(J), mesh=jmesh(8, "c"), shard="channels"), xs, 16000.0,
        JAXRT, setter=(2, retune)))
    for g, w, j in zip(got[None], want[None], jwant[None]):
        np.testing.assert_allclose(g, w, atol=ATOL)
        np.testing.assert_allclose(g, j, atol=ATOL)
    plain, actor = run(_drive(lambda: P_rt_block(
        P.Chain(P.GainControl(2.0)), pmesh(8, "c"), shard="channels"), xs,
        16000.0))
    assert actor.executor == "single"
    np.testing.assert_allclose(np.stack(plain[None]), 2.0 * np.stack(xs),
                               atol=1e-6)


def test_channel_sharded_actor_checkpoint_resume(tmp_path):
    """A channel-sharded actor's state (its [batch, M] per-channel leaves
    included) checkpoints and resumes bit for bit."""
    chain = P.channelized_receiver(num_channels=16, input_rate=16000.0)
    xs = list(make_iq(4, 1, 512, seed=11)[:, 0])
    path = str(tmp_path / "cs.ckpt.npz")

    def make():
        return P_rt_block(chain, pmesh(8, "c"), shard="channels")

    want, _ = run(_drive(make, xs, 16000.0))

    async def save_after_two():
        out, actor = await _drive(make, xs[:2], 16000.0)
        actor.save_checkpoint(path)
        return out

    first = run(save_after_two())

    def resumed():
        a = make()
        a.load_checkpoint(path)
        return a

    rest, _ = run(_drive(resumed, xs[2:], 16000.0))
    for g, w in zip(first[None] + rest[None], want[None]):
        np.testing.assert_array_equal(g, w)


def _fanout(L):
    g = L.Graph()
    mid = g.add(L.FreqShifter.with_shift(500.0), g.input("iq"))
    g.output("filt", g.add(L.Filter.new(lowpass(2000.0)), mid))
    g.output("demod", g.add(L.FmDemod(1500.0), mid))
    return g


def test_runtime_graph_stream_sharded():
    """``RuntimeGraph(mesh=...)``: the graph's dict-valued chunks and
    resets split their streams like the chain's; both outputs equal the
    unsharded graph actor's and are within 5e-4 of the JAX package's."""
    xs = list(make_iq(3, 8, 256, seed=13))
    outs = ["filt", "demod"]
    got, actor = run(_drive(lambda: prt.RuntimeGraph(
        _fanout(P), mesh=pmesh(8, "streams")), xs, 8000.0,
        outputs=outs))
    assert actor.executor == "streams"
    want, _ = run(_drive(lambda: prt.RuntimeGraph(_fanout(P), device="cpu"),
                         xs, 8000.0, outputs=outs))
    jwant, _ = run(_drive(lambda: jrt.RuntimeGraph(
        _fanout(J), mesh=jmesh(8, "streams")), xs, 8000.0, JAXRT,
        outputs=outs))
    for k in outs:
        np.testing.assert_array_equal(_cat(got[k]), _cat(want[k]))
        np.testing.assert_allclose(_cat(got[k]), _cat(jwant[k]), atol=ATOL)


def test_runtime_graph_time_sharded():
    """``RuntimeGraph(mesh=..., shard="time")``: the DAG time-sharded, D
    chunks a group step; both outputs as the graph actor fed chunk by
    chunk (demod past its zero-primed first chunk against the JAX
    package's); a batch-1 stream with ``overlap=2`` falls back at
    construction."""
    d, n, steps = 4, 256, 3
    xs = make_iq(steps * d, 2, n, seed=17)
    outs = ["filt", "demod"]
    got, actor = run(_drive(lambda: prt.RuntimeGraph(
        _fanout(P), mesh=pmesh(d, "t"), shard="time"), groups_of(xs, d),
        8000.0, outputs=outs))
    assert actor.executor == "time"
    want, _ = run(_drive(lambda: prt.RuntimeGraph(_fanout(P), device="cpu"),
                         list(xs), 8000.0, outputs=outs))
    jgot, _ = run(_drive(lambda: jrt.RuntimeGraph(
        _fanout(J), mesh=jmesh(d, "t"), shard="time"), groups_of(xs, d),
        8000.0, JAXRT, outputs=outs))
    for k in outs:
        np.testing.assert_array_equal(_cat(got[k]), _cat(want[k]))
    np.testing.assert_allclose(_cat(got["filt"]), _cat(jgot["filt"]),
                               atol=ATOL)
    np.testing.assert_allclose(_cat(got["demod"])[:, n:],
                               _cat(jgot["demod"])[:, n:], atol=ATOL)
    one = groups_of(make_iq(2 * d, 1, n, seed=19), d)
    fb, actor = run(_drive(lambda: prt.RuntimeGraph(
        _fanout(P), mesh=pmesh(d, "t"), shard="time", overlap=2), one,
        8000.0, outputs=["filt"]))
    assert actor.executor == "single"
    ref, _ = run(_drive(lambda: prt.RuntimeGraph(_fanout(P), device="cpu"),
                        one, 8000.0, outputs=["filt"]))
    np.testing.assert_array_equal(_cat(fb["filt"]), _cat(ref["filt"]))


def test_runtime_mesh_arguments_validated_at_construction():
    """A typo'd mesh_axis, a mesh_axis without a mesh, a mode that needs a
    mesh, an unknown mode, and a mesh that is not the port's raise where
    the actor is made."""
    async def main():
        mesh = pmesh(4, "streams")
        with pytest.raises(ValueError, match="not an axis"):
            prt.RuntimeBlock(P.GainControl(1.0), mesh=mesh,
                             mesh_axis="stream")
        with pytest.raises(ValueError, match="without a mesh"):
            prt.RuntimeBlock(P.GainControl(1.0), mesh_axis="streams",
                             device="cpu")
        with pytest.raises(ValueError, match="requires a mesh"):
            prt.RuntimeBlock(P.GainControl(1.0), shard="channels",
                             device="cpu")
        with pytest.raises(ValueError, match="streams.*channels"):
            prt.RuntimeBlock(P.GainControl(1.0), mesh=mesh, shard="rows")
        with pytest.raises(ValueError, match="streams.*time"):
            prt.RuntimeGraph(_fanout(P), mesh=mesh, shard="channels")
        with pytest.raises(TypeError, match="Mesh"):
            prt.RuntimeBlock(P.GainControl(1.0), mesh=jmesh(4, "streams"))
        two = make_mesh((2, 2), ("s", "t"), "cpu")
        blk = prt.RuntimeBlock(P.GainControl(1.0), mesh=two, mesh_axis="t")
        assert blk.mesh_axis == "t" and blk.device.type == "cpu"
        assert prt.RuntimeBlock(P.GainControl(1.0),
                                mesh=two).mesh_axis == "s"
    run(main())


def test_runtime_mesh_rejects_phase_mode_tails():
    """A phase-mode resampler tail (padded chunks) cannot be served
    channel- or time-sharded (their group steps bypass the actor's
    schedule trimming): the binding raises, as the JAX package's does;
    stream sharding takes it."""
    async def main():
        chain = P.Chain(P.Downsampler(384.0, 200.0))     # chunk 100: phase
        blk = P_rt_block(chain, pmesh(4, "t"), shard="time")
        with pytest.raises(ValueError, match="phase-mode"):
            blk._get_bound(100, 1024.0, 2)
        blk = P_rt_block(chain, pmesh(2, "streams"))
        assert blk._get_bound(100, 1024.0, 2).executor == "streams"
    run(main())


def test_fleet_receiver_example_runs():
    """``fleet_receiver --device cpu`` prints the three lines the JAX
    package's smoke test asserts (``tests/test_io.py``)."""
    out = run_example("fleet_receiver", "--device", "cpu", timeout=300)
    assert out.returncode == 0, out.stderr
    check_output("fleet_receiver", out.stdout)
    assert "streams executor" in out.stdout
    assert "time executor" in out.stdout
