"""Device time by launch of the overlap-save kernels #3-#6 at the
geometries the paths bind them at.

Binds the fused WFM receivers of paths A (``fuse_demod``) and B
(``fuse_mid``) at batch 64 x 24576 (mid chunk 9216, a 6144-tap response:
N = 15360 = 120 x 128) for ``fused_overlap_save`` (#3),
``fused_demod_filter`` (#5) and ``fused_filter_demod_filter`` (#6) on the
blocks' own response grids and FM that is continuous across [history ||
chunk]; then, on random response grids, #4 (``fused_filter_bank``) at
C's geometry (K = 3) and G's (2048, K = 2), #3 at E's (8192), F's (2048,
batch / 2: its pair-packed streams), J's (1536), K's and M's (12288),
H's (196608 = 768 x 256, batch 8: the stage route) and past a
one-column strip (m = n = 10001: the stage route, columns in device
memory), and #4 there (K = 3).  For each:

- holds the kernel against its plain version (max |diff| / max |ref|,
  the kernel checks' 2.4e-5);
- reads each wrapper's launch counters (``launches``, and
  ``cluster_launches`` where the wrapper has one) over one eager call,
  and names the route it took (``cluster`` or ``stage``);
- times a CUDA graph of 10 calls replayed ``--reps`` times (CUDA events:
  device us a call);
- profiles the same replays (``torch.profiler``) and splits a call's
  device time by kernel name, with the launches a call;
- with ``--clocks``, also runs #3 at K's and M's geometry, #5 and #6
  once each from the development build (``-DRR_OS_CLOCKS``:
  ``_build.lib(("RR_OS_CLOCKS",))``, its own build directory), whose
  cluster routes stamp ``clock64()`` at each phase of each block, and
  prints the phases' mean cycles over the blocks (``CLOCK_PHASES``)
  beside the SM clock ``nvidia-smi`` reads;
- with ``--crossover``, times #3 by both of its routes (the wrapper's
  launch with the route given, ``ops/filter.py _overlap_save_launch``)
  at --batch streams of 6144 + (128 n1 - 6144) for each n1 of
  ``CROSSOVER_N1``, each held against the plain version: the crossover
  that :func:`~radiorust_tpu_torch.ops.filter.filter_cluster_size`
  takes as its boundary.

    python -m radiorust_tpu_torch.tools.filter_split [--device cuda]
        [--reps 20] [--batch 64] [--clocks] [--crossover]

One JSON line per case (and per clocked kernel and crossover row), then
``{"card": ...}``.  ``--device cpu`` runs the plain versions once and
prints no time.  A copy of this file in an older checkout's ``tools/``
times that checkout the same way (without ``--clocks`` where its
development build stamps no #3, and without ``--crossover`` where #3 has
one route).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ._common import card, parse_args

BOUND = 2.4e-5
CHAIN = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
             filter_ir_len=6144)
MID = dict(CHAIN, fuse_demod=False, fuse_mid=True)
CHUNK, RATE = 24576, 1.024e6


def _rel(got, want) -> float:
    rel = 0.0
    for g, w in zip(got, want):
        d = float((g - w).abs().max())
        rel = max(rel, d / max(float(w.abs().max()), 1e-30))
    return rel


def _graph_replays(fn, calls: int, reps: int):
    """(graph, device ms a call by CUDA events) of ``calls`` calls of
    ``fn`` captured in one CUDA graph, replayed ``reps`` times."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return graph, start.elapsed_time(end) / (reps * calls)


def _split(graph, calls: int, reps: int) -> list:
    """[(kernel name, device us a call, launches a call)] over ``reps``
    replays of ``graph`` (``calls`` calls each), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        rows.append((evt.key, us / (reps * calls),
                     evt.count / (reps * calls)))
    return sorted(rows, key=lambda r: -r[1])


def cases(device, batch: int):
    """(name, wrapper, plain, args) of #3, #5 and #6 at A's and B's
    geometry, then of #3 and #4 at the other geometries, on ``device``."""
    from ..blocks.base import StreamSig
    from ..models.wfm import wfm_receiver
    from ..ops import filter as ofl

    sig = StreamSig(batch, CHUNK, RATE)
    bound = wfm_receiver(**CHAIN).bind(sig)
    filt, demod = bound.blocks[1:3]
    fdf = wfm_receiver(**MID).bind(sig).blocks[1]
    n = bound.blocks[0].out_sig.chunk_len
    m = filt.ir_len
    rng = np.random.default_rng(0)

    def real(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    def planes(z):
        return z.real.contiguous(), z.imag.contiguous()

    def grid(resp):
        return planes(ofl.response_grid(torch.from_numpy(resp).to(device)))

    def random_grids(bands, N):
        return planes(ofl.response_grid(torch.complex(real(bands, N),
                                                      real(bands, N))))

    fm = torch.exp(1j * torch.cumsum(0.3 * real(batch, m + n), dim=1))
    prev = torch.complex(real(batch, m), real(batch, m))
    cur = torch.complex(real(batch, n), real(batch, n))
    have = (torch.arange(batch, device=device) % 3 > 0).to(torch.float32)
    last = torch.exp(1j * real(batch))
    out = [
        (f"fused_overlap_save at A ({batch} x {m} + {n})",
         ofl.fused_overlap_save, ofl.fused_overlap_save_plain,
         (*planes(prev), *planes(cur), *grid(filt.params["response"]))),
        (f"fused_demod_filter at A ({batch} x {m} + {n})",
         ofl.fused_demod_filter, ofl.fused_demod_filter_plain,
         (*planes(fm[:, m:]), *planes(last), real(batch, m), real(batch),
          have, *grid(demod.params["response"]),
          torch.tensor(demod.params["factor"], device=device))),
        (f"fused_filter_demod_filter at B ({batch} x {m} + {n})",
         ofl.fused_filter_demod_filter, ofl.fused_filter_demod_filter_plain,
         (*planes(fm[:, :m]), *planes(fm[:, m:]), *planes(last),
          real(batch, m), real(batch), have,
          *grid(fdf.params["response1"]), *grid(fdf.params["response2"]),
          torch.tensor(fdf.params["factor"], device=device))),
    ]
    for label, m_, n_, rows, bands in GEOMETRIES:
        rows = rows or batch
        if rows < 0:
            rows = max(1, batch // -rows)
        gr, gi = random_grids(bands, m_ + n_)
        name = "fused_filter_bank" if bands > 1 else "fused_overlap_save"
        args = (real(rows, m_), real(rows, m_), real(rows, n_),
                real(rows, n_), *((gr, gi) if bands > 1 else (gr[0], gi[0])))
        what = f" (K = {bands})" if bands > 1 else ""
        out.append((f"{name}{what} at {label} ({rows} x {m_} + {n_})",
                    getattr(ofl, name), getattr(ofl, f"{name}_plain"),
                    args))
    return out


# (label, m, n, batch, bands) of the geometries beside A's and B's chains:
# batch 0 takes --batch, -d --batch / d (F's pair-packed streams).
GEOMETRIES = (("C", 6144, 9216, 0, 3), ("G", 1024, 1024, 0, 2),
              ("E", 4096, 4096, 0, 1), ("F", 1024, 1024, -2, 1),
              ("J", 768, 768, 0, 1), ("K, M", 6144, 6144, 0, 1),
              ("H", 98304, 98304, 8, 1),
              ("chunk 10001, columns in device memory", 10001, 10001, 0, 1),
              ("chunk 10001, columns in device memory", 10001, 10001, 8, 3))


# The cluster routes' stamps (csrc/overlap_save.cu OS_MARK) by kernel: the
# phase that ends at each mark.  15 is the end of the tables' load
# (within the first phase); 16 and 17 the block's start and end on
# %globaltimer (ns); 18 the block's SM.  #5's first phase ends at 8, #6's
# marks 1-7 are its channel filter and demod.
_FILTER = {9: "forward columns", 10: "cluster barrier (columns done)",
           11: "rows", 12: "cluster barrier (rows done)",
           13: "inverse columns", 14: "output"}
CLOCK_PHASES = {
    "fused_demod_filter": {8: "demod and pack", **_FILTER},
    "fused_filter_demod_filter": {
        1: "load (#6)", 2: "forward columns (#6)",
        3: "cluster barrier (#6, columns done)", 4: "rows (#6)",
        5: "cluster barrier (#6, rows done)", 6: "inverse columns (#6)",
        7: "cluster barrier (#6)", 8: "demod and pack", **_FILTER},
    "fused_overlap_save": {1: "load", 2: "forward columns",
                           3: "cluster barrier (columns done)", 4: "rows",
                           5: "cluster barrier (rows done)",
                           6: "inverse columns", 14: "output"}}
# Each clocked kernel's cluster route (rr_cluster_occupancy's kind).
CLOCK_KINDS = {"fused_demod_filter": 0, "fused_filter_demod_filter": 1,
               "fused_overlap_save": 2}
# The cases clocked: each kernel at a geometry its cluster route runs.
CLOCKED = ("fused_overlap_save at K, M", "fused_demod_filter at A",
           "fused_filter_demod_filter at B")
MARKS = 19
# Column lengths n1 (n2 = 128) of --crossover: the paths' 64 (E) and 96
# (K, M), A's 120, and between and past them (104 = 8 x 13 and 112 =
# 16 x 7 take a generic prime pass on both routes).
CROSSOVER_N1 = (64, 96, 100, 104, 108, 112, 120, 128, 144)


def clocks(dev, batch: int, reps: int) -> list:
    """The cluster routes' phase split on the development build, for #3 at
    K's and M's geometry, #5 and #6 (``CLOCKED``): device us a call (10-call graphs), the clusters
    the card holds at once, mean cycles a block between consecutive
    stamps, from %globaltimer the spread of the blocks' starts and the
    span from the first start to the last end, and the blocks an SM ran
    with each one's mean time by that count."""
    import subprocess

    from ..ops import _build
    from ..ops import filter as ofl
    dev_lib = _build.lib(("RR_OS_CLOCKS",))
    real_lib = _build.lib
    _build.lib = lambda defines=(): dev_lib
    out = []
    try:
        for name, fn, _, fargs in cases(dev, batch):
            if not name.startswith(CLOCKED):
                continue
            kind = CLOCK_KINDS[fn.__name__]
            n = fargs[2].shape[1] if kind != 0 else fargs[0].shape[1]
            # The history: #5's prevd, #6's and #3's prev planes.
            m = fargs[4 if kind == 0 else 0].shape[1]
            n1, n2 = ofl.kernel_factors(m + n)
            fn(*fargs)
            _, ms = _graph_replays(lambda: fn(*fargs), 10, reps)
            rows = 8 * batch   # at most a cluster of 8 a stream
            clk = torch.zeros(rows * MARKS, dtype=torch.int64, device=dev)
            torch.cuda.synchronize()
            dev_lib.rr_cluster_clocks(clk.data_ptr())
            fn(*fargs)
            torch.cuda.synchronize()
            dev_lib.rr_cluster_clocks(None)
            st = clk.view(rows, MARKS).cpu().numpy()
            st = st[st[:, 16] != 0]
            sm_mhz = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60).stdout.split()[0]
            names = CLOCK_PHASES[fn.__name__]
            marks = [k for k in range(15) if (st[:, k] != 0).all()]
            phases = {"prologue (tables)": float((st[:, 15]
                                                  - st[:, 0]).mean())}
            phases.update({names[k]: float((st[:, k] - st[:, p]).mean())
                           for p, k in zip(marks, marks[1:])})
            row = {"clocked": name,
                   "device_us": ms * 1e3, "blocks": len(st),
                   "clusters_at_once": dev_lib.rr_cluster_occupancy(
                       n1, n2, kind),
                   "cycles": phases,
                   "block_cycles_mean": float((st[:, marks[-1]]
                                               - st[:, 0]).mean()),
                   "block_cycles_max": float((st[:, marks[-1]]
                                              - st[:, 0]).max()),
                   "start_spread_us": float(st[:, 16].max()
                                            - st[:, 16].min()) / 1e3,
                   "span_us": float(st[:, 17].max() - st[:, 16].min())
                   / 1e3,
                   "sm_mhz": float(sm_mhz)}
            sms, per_sm = np.unique(st[:, 18], return_counts=True)
            load = dict(zip(sms, per_sm))
            blocks_on = np.array([load[s_] for s_ in st[:, 18]])
            row["sms_used"] = int(len(sms))
            row["block_us_by_blocks_on_its_sm"] = {
                int(k): float((st[blocks_on == k, 17]
                               - st[blocks_on == k, 16]).mean()) / 1e3
                for k in np.unique(blocks_on)}
            row["sms_by_blocks"] = {int(k): int((per_sm == k).sum())
                                    for k in np.unique(per_sm)}
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        _build.lib = real_lib
    return out


def crossover(dev, batch: int, reps: int) -> list:
    """#3 by each route at ``batch`` streams of 6144 + (128 n1 - 6144) for
    n1 in ``CROSSOVER_N1``: device us a call (10-call graphs) of each,
    and each route's max |diff| / max |ref| against the plain version."""
    from ..ops import filter as ofl
    rng = np.random.default_rng(1)
    out = []
    for n1 in CROSSOVER_N1:
        m, n = 6144, 128 * n1 - 6144
        args = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for shape in ((batch, m),) * 2
                + ((batch, n),) * 2 + ((n1, 128),) * 2]
        want = ofl.fused_overlap_save_plain(*args)
        row = {"crossover_n1": n1, "m": m, "n": n, "batch": batch,
               "rule": "cluster" if ofl.filter_cluster_size(m + n)
               else "stage"}
        for route, cluster in (("cluster", True), ("stage", False)):
            def run(cluster=cluster):
                return ofl._overlap_save_launch(*args, cluster=cluster)
            row[f"{route}_rel"] = _rel(run(), want)
            row[f"{route}_us"] = _graph_replays(run, 10, reps)[1] * 1e3
            if not row[f"{route}_rel"] <= BOUND:
                raise AssertionError(f"#3 by the {route} route at n1 = "
                                     f"{n1} disagrees with its plain "
                                     f"version")
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def counters(fn) -> dict:
    return {k: getattr(fn, k) for k in ("launches", "cluster_launches")
            if hasattr(fn, k)}


def main(argv=None) -> list:
    args = parse_args(__doc__, sys.argv[1:] if argv is None else argv,
                      names=False)
    reps, batch = 20, 64
    for flag in ("--reps", "--batch"):
        if flag in args.rest:
            value = int(args.rest[args.rest.index(flag) + 1])
            reps, batch = (value, batch) if flag == "--reps" else (reps,
                                                                   value)
    dev = args.device
    on_card = dev.type == "cuda"
    out = []
    for name, fn, plain, fargs in cases(dev, batch):
        before = counters(fn)
        res = fn(*fargs)
        moved = {k: v - before[k] for k, v in counters(fn).items()}
        rel = _rel(res, plain(*fargs))
        route = ("cluster" if moved.get("cluster_launches") else
                 "stage" if moved["launches"] else None)
        row = {"kernel": name, "rel": rel, "bound": BOUND,
               "counters": moved, "route": route, "device_us": None,
               "split": None}
        if on_card:
            graph, ms = _graph_replays(lambda: fn(*fargs), 10, reps)
            row["device_us"] = ms * 1e3
            row["split"] = [{"name": k[:80], "us": us, "launches": c}
                            for k, us, c in _split(graph, 10, reps)]
        print(json.dumps(row), flush=True)
        if not rel <= BOUND:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({rel:.3e} > {BOUND:g})")
        out.append(row)
    if on_card and "--clocks" in args.rest:
        out += clocks(dev, batch, reps)
    if on_card and "--crossover" in args.rest:
        out += crossover(dev, batch, reps)

    print(json.dumps({"card": card() if on_card else "cpu"}), flush=True)
    return out


if __name__ == "__main__":
    main()
