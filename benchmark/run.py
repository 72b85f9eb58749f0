"""The benchmark of the PyTorch and CUDA port (``radiorust_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run of one cell of ``BENCHMARK.json``, from the root of a checkout:
its files are found by name (``harness/cells.py``), its inputs made on the
card from the seed, the program bound and warmed up (every shape the
window uses, the graphs captured), then the window measured for
``--seconds``.  ``--trace 1`` measures the same window, then traces a
further window of the traffic's ``trace_seconds`` with ``torch.profiler``
and reports the per-layer metrics and a breakdown instead of the
end-to-end ones.  Once the window has closed, the outputs it kept are
compared with the configuration's plain reference.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its
limit); the compared numbers are also the last lines of standard error.
Without a CUDA card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it exits with
code 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

_T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "radiorust_tpu")
# Chunks of the ring the reference runs first, from a zero state: more
# than the longest chain's memory (three 16384-tap filters at 384 kHz and
# the resamplers' windows, under 2.7 chunks of 49152 at 1.024 Msps).
REF_WARMUP = 4


def process_age() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernel library builds into ``build/radiorust_tpu_torch``
    there by itself)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _keep(seed: int, window_calls: int, k: int) -> set:
    """Indices of the window's calls whose outputs the comparison reads,
    drawn from the seed (the window's last call is read as well)."""
    import numpy as np
    rng = np.random.default_rng([int(seed), 7])
    n = max(1, window_calls)
    return {int(i) for i in rng.choice(n, size=min(k, n), replace=False)}


def reference_outputs(cell, xs, device, prec=None) -> dict:
    """The configuration's reference output at each of the ring's
    positions, {output: [ring, B, n]}: the reference run over the ring
    from a zero state ``REF_WARMUP`` chunks before it, in ``prec`` (the
    reference's float64 where None)."""
    import torch
    ring = xs.shape[0]
    chunks = torch.cat([xs[ring - REF_WARMUP:], xs]).to(device)
    args = cell.config["args"]
    ref = (cell.reference.reference(chunks, args) if prec is None
           else cell.reference.reference(chunks, args, prec))
    return {k: v[REF_WARMUP:] for k, v in ref.items()}


def compare(cell, xs, kept, limits: dict, device):
    """Each output's widest gap over the kept calls: max |port - ref| over
    max |ref| (:func:`reference_outputs`).  Returns (checks, the kept
    chunks over a limit or not finite)."""
    import torch
    ref = reference_outputs(cell, xs, device)
    scale = {k: float(v.abs().max()) for k, v in ref.items()}
    gaps = {k: 0.0 for k in ref}
    bad = 0
    for pos, outs in kept:
        over = torch.zeros(len(pos), dtype=torch.bool)
        for name, r in ref.items():
            y = outs[name].to(device=r.device, dtype=r.dtype)
            d = ((y - r[pos]).abs().flatten(1).amax(1) / scale[name]).cpu()
            d = torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))
            gaps[name] = max(gaps[name], float(d.max()))
            lim = limits.get(name)
            over |= d > (math.inf if lim is None else lim)
            over |= ~torch.isfinite(d)
        bad += int(over.sum())
    checks = {k: {"value": gaps[k], "limit": limits.get(k)} for k in ref}
    return checks, bad


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", batch: int = None, ring: int = None, wrap=None,
        log=None) -> dict:
    """One run of ``workload``; returns the result object.  ``batch`` and
    ``ring`` shrink the cell, for the CPU tests only; ``wrap(entry,
    program, xs)`` replaces the compiled entry (the control and the
    planted faults, never in the benchmark's own runs)."""
    import torch

    from benchmark.counts.roofline import least_seconds
    from benchmark.harness import cells, signals, trace as tr
    from benchmark.harness.program import Program, launch_counters
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = cells.load(workload)
    traffic = dict(cell.traffic)
    if ring is not None:
        traffic["ring_chunks"] = ring
    n_ring = int(traffic["ring_chunks"])
    if n_ring < REF_WARMUP:
        raise ValueError(f"a ring of {n_ring} chunks is shorter than the "
                         f"reference's warm-up of {REF_WARMUP}")
    xs = signals.make(cell.config, n_ring, seed, device, batch)
    prog = Program(cell.config, device, batch)
    loop = cells.loop(traffic["loop"])(prog, xs, traffic, wrap)
    t0 = time.perf_counter()
    loop.warm(1)
    log(f"first call (kernel library load or build, capture): "
        f"{time.perf_counter() - t0:.3f} s")
    per_call = loop.warm(max(1, int(traffic["warmup_calls"]) - 1))
    setup_s = process_age()
    keep = _keep(seed, int(seconds / max(per_call, 1e-6)),
                 int(traffic["compare_calls"]) - 1)
    win = loop.window(seconds, keep)
    traced, summary = None, None
    if trace:
        with tr.Profiled(device) as prof:
            traced = loop.window(min(seconds,
                                       float(traffic["trace_seconds"])),
                                   spans=True)
        summary = prof.summary
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counters = launch_counters()
    ctx = SimpleNamespace(
        cell=cell, window=win, traced=traced, trace=summary,
        setup_s=setup_s, counters=counters,
        work=cell.reference.kernel_work(cell.config["args"],
                                        xs.shape[1], xs.shape[2]))
    metrics = {}
    for m in cell.metrics(trace):
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    log(f"kernel launch counters (at capture): {json.dumps(counters)}")
    if summary is not None:
        log(f"traced window: {traced.steps} steps in {summary.window_s:.6f} "
            f"s, busy {summary.busy_s:.6f} s, port kernels "
            f"{summary.port_s:.6f} s, glue and copies {summary.glue_s:.6f} "
            f"s, {summary.n_ops} device operations")
        groups = {}
        for name, flops, nbytes, pattern in ctx.work:
            g = groups.setdefault(pattern, [[], 0.0])
            g[0].append(name)
            g[1] += least_seconds(flops, nbytes) * traced.steps
        for pattern, (names, least) in groups.items():
            dev_s = summary.matched_s(pattern)
            share = f"{100 * least / dev_s:.2f}%" if dev_s else "not run"
            log(f"roofline {' + '.join(names)}: least {least:.6f} s, "
                f"device {dev_s:.6f} s, {share}")
    # The program's state and outputs go before the reference runs.
    kept, attempted = win.kept, win.steps
    del loop, prog
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = compare(cell, xs, kept, cell.config["limits"],
                                device)
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {
        "correct": correct,
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps()}
    result["checks"] = checks
    return result


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from benchmark.harness import cells
    chips = cells.load(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 1
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6e} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
