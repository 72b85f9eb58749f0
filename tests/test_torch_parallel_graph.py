"""The port's ``TimeShardedGraph`` on CPU tensors against the JAX
package's on its virtual CPU devices and against the port's own
``graph_scan``, on the same seeded inputs: a fan-out DAG, the WFM receiver
graph with its spectrum tap, and a live retune, at the JAX tests'
tolerances (``tests/test_parallel.py``: atol 2e-4; audio 5e-4 from chunk
2, the spectrum 2e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parallel import (CPU, J, P, RATE, fm_iq, group,
                            interpret_pallas_highest,  # noqa: F401
                            lowpass, make_iq, port_mesh, ungroup)
from radiorust_tpu.parallel.time_shard import \
    TimeShardedGraph as JTimeShardedGraph
from radiorust_tpu_torch.convert import tree_to_numpy, tree_to_torch
from radiorust_tpu_torch.parallel.time_shard import TimeShardedGraph

D = 4


def fanout(L, sig):
    g = L.Graph()
    mid = g.add(L.FreqShifter.with_shift(500.0), g.input("iq"))
    g.output("a", g.add(L.Filter.new(lowpass(2000.0)), mid))
    g.output("b", g.add(L.FmDemod(1000.0), mid))
    return g.bind(L.StreamSig(*sig))


def _run(ts, bg, xs, steps, port, retune=None):
    """{output: [T, b, n]} of a TimeShardedGraph; ``retune`` = (step,
    shift) calls ``set_shift`` before that step."""
    if port:
        state = tree_to_torch(ts.init_state(), CPU)
    else:
        state = ts.init_state()
    got = {k: [] for k in bg.out_sigs}
    b = xs.shape[1]
    for s in range(steps):
        if retune is not None and s == retune[0]:
            state = ts.set_shift(tree_to_numpy(state) if port else state,
                                 retune[1])
            if port:
                state = tree_to_torch(state, CPU)
        x = group(xs, s, D)
        if port:
            state, ys = ts.process(tree_to_torch(ts.params, CPU), state,
                                   {"iq": torch.from_numpy(x)})
            ys = {k: v.numpy() for k, v in ys.items()}
        else:
            state, ys = ts.process(ts.params, state, {"iq": jnp.asarray(x)})
        for k in got:
            got[k].append(ungroup(ys[k], D, b, bg.out_sigs[k].chunk_len))
    return {k: np.concatenate(v) for k, v in got.items()}


def _seq(bg, xs, retune=None):
    """The port's graph_scan, retuned between the two halves."""
    params = tree_to_torch(bg.params, CPU)
    state = tree_to_torch(bg.init_state(), CPU)
    if retune is None:
        _, ys = P.graph_scan(bg, params, state, {"iq": torch.from_numpy(xs)})
        return {k: v.numpy() for k, v in ys.items()}
    half = retune[0] * D
    st, ys_a = P.graph_scan(bg, params, state,
                            {"iq": torch.from_numpy(xs[:half])})
    params, state = list(bg.params), list(tree_to_numpy(st))
    for i, blk in enumerate(bg.bound):
        if blk is not None and hasattr(blk, "retune"):
            params[i], state[i] = blk.retune(params[i], state[i], retune[1])
    _, ys_b = P.graph_scan(bg, tree_to_torch(tuple(params), CPU),
                           tree_to_torch(tuple(state), CPU),
                           {"iq": torch.from_numpy(xs[half:])})
    return {k: np.concatenate([ys_a[k].numpy(), ys_b[k].numpy()])
            for k in ys_a}


def _three(build, sig, xs, steps, retune=None):
    pbg, jbg = build(P, sig), build(J, sig)
    got = _run(TimeShardedGraph(pbg, port_mesh()), pbg, xs, steps, True,
               retune)
    want = _run(JTimeShardedGraph(jbg, jax.make_mesh((D,), ("t",))), jbg,
                xs, steps, False, retune)
    return got, want, _seq(build(P, sig), xs, retune)


def test_time_sharded_graph_fanout():
    """A fan-out tap: both outputs as graph_scan over the same chunks."""
    xs = make_iq(3 * D, 2, 64, seed=11)
    got, want, seq = _three(fanout, (2, 64, 8000.0), xs, 3)
    for k in ("a", "b"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-4)
        np.testing.assert_array_equal(got[k], seq[k])


def test_time_sharded_graph_wfm_spectrum():
    """The WFM receiver graph (audio and a spectrum tap) time-sharded."""
    n, steps = 2048, 2
    xs = fm_iq(steps * D, n)

    def build(L, sig):
        return L.wfm_receiver_graph().bind(L.StreamSig(*sig))

    got, want, seq = _three(build, (2, n, RATE), xs, steps)
    np.testing.assert_allclose(got["audio"][2:], want["audio"][2:],
                               atol=5e-4)
    np.testing.assert_allclose(got["spectrum"], want["spectrum"], atol=2e-2)
    for k in got:
        np.testing.assert_array_equal(got[k], seq[k])


def test_time_sharded_graph_live_retune():
    """``set_shift`` against a running TimeShardedGraph: both outputs go
    on phase-continuously, as the sequentially retuned graph_scan."""
    xs = make_iq(4 * D, 2, 64, seed=33)
    got, want, seq = _three(fanout, (2, 64, 8000.0), xs, 4,
                            retune=(2, -700.0))
    for k in ("a", "b"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-4)
        np.testing.assert_array_equal(got[k], seq[k])
