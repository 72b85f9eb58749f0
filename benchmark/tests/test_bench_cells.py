"""CPU runs of every cell at a tiny size (2 streams, a ring of 4 chunks,
the port's plain versions): the run's result line, what the process has
loaded, and the refusal without a card.  The same cells on the card, at
their own size, are the last test."""

import json
import subprocess
import sys
import textwrap

import pytest

from benchmark import run as bench
from benchmark.harness import cells

ROOT = cells.ROOT
WORKLOADS = [w["name"] for w in cells.spec()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cpu_run_is_correct(workload):
    res = bench.run(workload, 2**33 + 11, 0.3, False, device="cpu",
                    batch=2, ring=4, log=lambda m: None)
    assert list(res) == KEYS + ["checks"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    cell = cells.load(workload)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("workload", ["wfm.fleet", "stereo.live"])
def test_cpu_traced_run_has_a_breakdown(workload):
    res = bench.run(workload, 5, 0.3, True, device="cpu", batch=2, ring=4,
                    log=lambda m: None)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    cell = cells.load(workload)
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    # No device: nothing traced on one, so no device metric is made up.
    assert not any(k.startswith(("kernel_", "glue_", "launches_"))
                   for k in res["metrics"])


def test_nothing_loads_jax_or_the_jax_package():
    out = _python("""
        import json, sys
        from benchmark import run as bench, control
        from benchmark.harness import cells
        spec = cells.spec()
        for m in spec["end_to_end"] + spec["per_layer"]:
            cells.reader(m["name"])
        for w in spec["workloads"]:
            bench.run(w["name"], 17, 0.2, False, device="cpu", batch=2,
                      ring=4, log=lambda m: None)
        print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
    """)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert "radiorust_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "radiorust_tpu"}


def test_references_import_nothing_of_the_program():
    out = _python("""
        import json, sys
        from benchmark.harness import cells, signals
        spec = cells.spec()
        import importlib
        for c in spec["configs"]:
            importlib.import_module("benchmark.reference." + c["name"])
        import benchmark.counts.roofline
        for w in spec["workloads"]:
            cell = cells.load(w["name"])
            xs = signals.make(cell.config, 4, 3, "cpu", batch=2)
            cell.reference.reference(xs, cell.config["args"])
        print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
    """)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not top & {"radiorust_tpu_torch", "jax", "radiorust_tpu"}


def test_a_run_without_a_card_fails():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wfm.fleet",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_card_run_is_correct(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "4000000123", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
