"""The port's fake cluster (``radiorust_tpu_torch/tools/fake_cluster.py``)
on CPU tensors: 4 real worker processes, 2 mesh entries each, one gloo
process group.  Its seven cases run against the JAX package's sequential
outputs, computed here on the same seeded numpy inputs and handed to the
workers as an npz (the JAX cases' tolerances: 5e-4 from chunk 2, the
channel-energy mask on channelizer rows), and against each worker's own
sequential run of the port; then its drills: a one-sided failure, a
SIGKILLed peer and the elastic resume end by verdict or error, none
hung."""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from radiorust_tpu_torch.tools import fake_cluster as fc
from torch_parallel import interpret_pallas_highest  # noqa: F401

NPROC, LOC = 4, 2
ARGS = ("--device", "cpu", "--width", "small")


def _jax_scan(chain, sig, xs, retune_at=None, shift=None):
    from radiorust_tpu.blocks.base import StreamSig, scan
    from radiorust_tpu.blocks.transform import _BoundFreqShifter
    bound = chain.bind(StreamSig(*sig))
    if retune_at is None:
        _, ys = scan(bound, bound.params, bound.init_state(), jnp.asarray(xs))
        return np.asarray(ys)
    st, ya = scan(bound, bound.params, bound.init_state(),
                  jnp.asarray(xs[:retune_at]))
    params, state = list(bound.params), list(st)
    for i, blk in enumerate(bound.blocks):
        if isinstance(blk, _BoundFreqShifter):
            params[i], state[i] = blk.retune(params[i], state[i], shift)
    _, yb = scan(bound, tuple(params), tuple(state),
                 jnp.asarray(xs[retune_at:]))
    return np.concatenate([np.asarray(ya), np.asarray(yb)])


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """The JAX package's sequential outputs of every case, by case name,
    at the small width (its fake cluster's sizes and signals)."""
    from radiorust_tpu.models.channelizer import channelized_receiver
    from radiorust_tpu.models.wfm import wfm_receiver
    w, d = fc.WIDTHS["small"], NPROC * LOC
    n, rate = w["n"], w["rate"]
    c = fc.CASES
    out = {
        c[0]: _jax_scan(wfm_receiver(tune_shift=w["shift0"]), (2, n, rate),
                        fc.chunks(3 * d, 2, n, rate), retune_at=2 * d,
                        shift=fc.SHIFT1),
        c[1]: _jax_scan(wfm_receiver(), (2 * NPROC, n, rate),
                        fc.chunks(3 * LOC, 2 * NPROC, n, rate)),
        c[2]: _jax_scan(channelized_receiver(num_channels=64,
                                             input_rate=w["ch_rate"]),
                        (1, w["ch_n"], w["ch_rate"]),
                        fc.channel_input("small", 3, 1, w["ch_n"],
                                         w["ch_rate"], 6)),
        c[2] + "_fused": _jax_scan(
            channelized_receiver(num_channels=64, input_rate=w["ch_rate"],
                                 fuse=True), (1, w["ch_n"], w["ch_rate"]),
            fc.channel_input("small", 3 * d, 1, w["ch_n"], w["ch_rate"], 8)),
        c[4]: _jax_scan(wfm_receiver(), (2, n, rate),
                        fc.chunks(w["pipe_steps"], 2, n, rate)),
        c[5]: _jax_scan(channelized_receiver(num_channels=64,
                                             input_rate=w["ch_rate"]),
                        (NPROC, w["ch_n"], w["ch_rate"]),
                        fc.channel_input("small", 3, NPROC, w["ch_n"],
                                         w["ch_rate"], 7)),
        c[6]: _jax_scan(wfm_receiver(), (4, n, rate),
                        fc.chunks(6, 4, n, rate)),
    }
    path = tmp_path_factory.mktemp("jax") / "want.npz"
    np.savez(path, **out)
    return str(path)


def _results(records, name):
    for rec in records:
        res = rec["cases"][name]
        if name == fc.CASES[2]:
            yield from (res["channel"], res["fused"])
        else:
            yield res


def test_cases_against_the_jax_package_across_processes(jax_outputs):
    ok, records, codes, outputs = fc.run_cases(
        fc.SCRIPT, NPROC, LOC, ARGS + ("--want", jax_outputs), timeout=300.0)
    assert ok, (codes, "\n".join(outputs))
    assert sorted(r["rank"] for r in records) == list(range(NPROC))
    for name in fc.CASES:
        for res in _results(records, name):
            if name == fc.CASES[3]:            # bit for bit, inside the case
                assert res["bytes"] > 0 and res["steps"] == 4, res
                continue
            errs = res["errors"]
            if "stage" in res and res["stage"][1] != NPROC // (
                    2 if name == fc.CASES[6] else 1) - 1:
                assert errs == {}, res          # not a last stage
                continue
            assert errs["seq"] <= fc.ATOL and errs["ref"] <= fc.ATOL, (
                name, errs)
    # Each process stepped its own entries: case 1's pieces are its two
    # time shards, case 2's its rows, case 6's its stream's channel rows.
    for rec in records:
        r = rec["rank"]
        assert rec["cases"][fc.CASES[0]]["shards"] == [
            [0, 2, 2 * r], [0, 2, 2 * r + 1]]
        assert rec["cases"][fc.CASES[1]]["shards"] == [
            [2 * r, 2 * r + 2, 0], [2 * r, 2 * r + 2, 1]]
        assert rec["cases"][fc.CASES[2]]["channel"]["shards"] == [
            [16 * r, 16 * r + 16]]
        assert rec["cases"][fc.CASES[5]]["shards"] == [[64 * r, 64 * r + 64]]
        # Halos cross processes in case 1, not in case 2 (time within).
        assert rec["cases"][fc.CASES[0]]["hops"]["exchanges"] > 0
        assert rec["cases"][fc.CASES[1]]["hops"]["exchanges"] == 0


def test_one_sided_failure_converges_on_the_joint_verdict():
    """Process 1 fails after case 2's exchanges: every worker runs the
    remaining cases and exits 1 by the joint verdict, long before the
    exchanges' timeout (120 s) could end it."""
    t0 = time.monotonic()
    ok, records, codes, outputs = fc.run_cases(
        fc.SCRIPT, NPROC, LOC, ARGS,
        {"FAKE_CLUSTER_FAIL": fc.CASES[1]}, timeout=300.0)
    took = time.monotonic() - t0
    joined = "\n".join(outputs)
    assert not ok and codes == [1] * NPROC, (codes, joined)
    assert f"[p1] {fc.CASES[1]} FAILED: RuntimeError: injected" in joined
    assert f"[p0] {fc.CASES[1]} ok" in joined
    assert all(f"[p{r}] {fc.CASES[6]} ok" in joined for r in range(NPROC))
    assert [r["ok"] for r in records] == [False] * NPROC
    assert took < 100.0, took


@pytest.mark.parametrize("case", fc.KILL_HOOKED)
def test_sigkilled_peer_makes_the_survivors_error_out(case):
    drill, outputs = fc.run_kill_drill(fc.SCRIPT, NPROC, LOC, ARGS,
                                       kill_case=case, timeout=300.0)
    assert drill["ok"], (drill, "\n".join(outputs))
    assert drill["victim_code"] == -9 and drill["hung"] == 0, drill
    assert all(c not in (0, None) for c in drill["survivor_codes"]), drill
    with pytest.raises(ValueError, match="no hook"):
        fc.run_kill_drill(fc.SCRIPT, NPROC, LOC, ARGS,
                          kill_case=fc.CASES[2])


def test_elastic_drill_detects_then_resumes_on_a_smaller_job():
    drill, outputs = fc.run_elastic_drill(fc.SCRIPT, NPROC, LOC, ARGS,
                                          timeout=300.0)
    assert drill["ok"], (drill, "\n".join(outputs))
    assert drill["detect_s"] < 15.0 and drill["victim_code"] == -9
    assert drill["resume_codes"] == [0] * (NPROC - 1)
    res = drill["resume"]
    assert res["mesh_entries"] == (NPROC - 1) * LOC
    assert res["resumed_from_chunk"] == 2 * NPROC * LOC
    assert res["chunks_recovered"] == fc.WIDTHS["small"]["elastic"] - 16
    assert drill["max_abs_err"] <= fc.ATOL


def test_the_tool_writes_only_with_out(tmp_path, monkeypatch):
    """The launcher's summary lands in ``--out``; without it the tool
    writes no file (the drills' directories are temporary)."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "summary.json"
    assert fc.main(["--device", "cpu", "--skip-kill-drill",
                    "--skip-elastic", "--out", str(out)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["summary.json"]
    assert '"ok": true' in out.read_text()


def test_collective_volumes_against_the_jax_tool():
    """The port counts each collective's bytes where it happens; the JAX
    tool reads them from the partitioned HLO (the conftest's 8 virtual
    devices).  The halos and the branch gather are laid out alike, so
    their bytes agree, with two differences named here: the JAX step
    ``psum``s the carry out of the last shard (its ``all-reduce``), which
    one process of the port moves without a collective; and the port's
    demodulated halo of the fused chain does not wrap (shard 0 takes the
    carry), so it moves the m-sample tail of 2 streams once less, 6144
    bytes a shard at m = 6144."""
    import importlib.util
    import pathlib

    from radiorust_tpu_torch.tools import collective_volumes as port
    spec = importlib.util.spec_from_file_location(
        "jax_collective_volumes", pathlib.Path(__file__).resolve().parents[1]
        / "tools" / "collective_volumes.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    for kw in ({}, {"batch": 8}, {"batch": 8, "overlap": 4}):
        got = port.measure_time_sharded_wfm(**kw)
        _, want, _ = jax_tool.measure_time_sharded_wfm(**kw)
        assert set(got) == {"ring_left"}, got
        assert got["ring_left"] == want["collective-permute"], (kw, got,
                                                                want)
        assert want["all-reduce"] > 0           # the carry's psum
    got = port.measure_channel_sharded()
    _, want, _ = jax_tool.measure_channel_sharded()
    assert got == {"all_gather": want["all-gather"]}, (got, want)
    got = port.measure_fused_time_sharded()
    _, want, _ = jax_tool.measure_fused_time_sharded()
    m, streams = 6144, 2
    assert got["ring_left"] + m * streams * 4 / 8 == \
        want["collective-permute"], (got, want)
