"""The readings a cell's comparison limits are set from, in one process
on the card:

- the program's: ``run.py``'s run of the cell (a short window at the
  cell's own load, the same comparison) on ``--seeds`` seeds;
- the control's: the same run with the plain reference computed in TF32
  (every operand of a product rounded to TF32's 10-bit mantissa, float32
  arithmetic; the configuration states float32 with TF32 off) put in the
  program's place (:func:`tf32_in_place`), on ``--control-seeds`` seeds.
  Its outputs go through the run's own comparison, and ``correct`` has
  to come out false.

    python3 benchmark/control.py --workload wfm.fleet --seeds 12 \
        --control-seeds 3 --seconds 2 --first-seed 1000

Prints one JSON line a run and last a summary: the largest program
reading and the smallest control reading of each output, and whether
every control run read ``correct`` false.  The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tf32_in_place(cell):
    """A ``wrap`` for ``run.run``: the entry replaced by the TF32
    reference's outputs at the ring positions it is called on (the whole
    ring for a scan over it, else the next chunk of the ring in turn)."""
    from benchmark import run as bench
    from benchmark.reference import _dsp

    def wrap(entry, prog, xs):
        ctl = bench.reference_outputs(cell, xs, xs.device, _dsp.TF32)
        ring, calls = xs.shape[0], [0]

        def step(params, state, x, reset=None):
            chunk = x["iq"] if isinstance(x, dict) else x
            if chunk.dim() == 3:
                y = ctl
            else:
                pos = calls[0] % ring
                calls[0] += 1
                y = {k: v[pos] for k, v in ctl.items()}
            return state, (y if prog.graph else y[prog.outputs[0]])
        return step
    return wrap


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run as bench
    bench.set_cache_dirs()
    import torch
    from benchmark.harness import cells
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 1
    cell = cells.load(args.workload)
    readings = {"program": {}, "control": {}}
    control_correct = []
    sides = [("program", args.seeds, None),
             ("control", args.control_seeds, tf32_in_place(cell))]
    for side, n, wrap in sides:
        for i in range(n):
            seed = args.first_seed + 7919 * i
            t0 = time.perf_counter()
            res = bench.run(args.workload, seed, args.seconds, False,
                            wrap=wrap, log=lambda msg: None)
            got = {k: c["value"] for k, c in res["checks"].items()}
            pick = max if side == "program" else min
            for k, v in got.items():
                seen = readings[side].get(k)
                readings[side][k] = v if seen is None else pick(seen, v)
            if side == "control":
                control_correct.append(res["correct"])
            print(json.dumps({"side": side, "seed": seed, "readings": got,
                              "correct": res["correct"],
                              "failed": res["failed"],
                              "attempted": res["attempted"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    print(json.dumps({"workload": args.workload,
                      "program_max": readings["program"],
                      "control_min": readings["control"],
                      "control_never_correct": not any(control_correct),
                      "card": bench.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
