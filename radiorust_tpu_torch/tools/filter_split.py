"""Device time by launch of the overlap-save kernels #3, #5 and #6 at the
receive chain's geometry.

Binds the fused WFM receivers of paths A (``fuse_demod``) and B
(``fuse_mid``) at batch 64 x 24576 (mid chunk 9216, a 6144-tap response:
N = 15360 = 120 x 128) and, for each of ``fused_overlap_save`` (#3),
``fused_demod_filter`` (#5) and ``fused_filter_demod_filter`` (#6) on the
blocks' own response grids and FM that is continuous across [history ||
chunk]:

- holds the kernel against its plain version (max |diff| / max |ref|,
  the kernel checks' 2.4e-5);
- times a CUDA graph of 10 calls replayed ``--reps`` times (CUDA events:
  device us a call);
- profiles the same replays (``torch.profiler``) and splits a call's
  device time by kernel name, with the launches a call;
- reads each wrapper's launch counters (``launches``, and
  ``cluster_launches`` where the wrapper has one) over one eager call;
- with ``--clocks``, also runs #5 and #6 once each from the development
  build (``-DRR_OS_CLOCKS``: ``_build.lib(("RR_OS_CLOCKS",))``, its own
  build directory), whose cluster route stamps ``clock64()`` at each
  phase of each block, and prints the phases' mean cycles over the
  blocks (``CLOCK_PHASES``) beside the SM clock ``nvidia-smi`` reads.

    python -m radiorust_tpu_torch.tools.filter_split [--device cuda]
        [--reps 20] [--batch 64] [--clocks]

One JSON line per kernel (and per clocked kernel), then ``{"card":
...}``.  ``--device cpu`` runs the plain versions once and prints no
time.
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
    geometry, on ``device``."""
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

    fm = torch.exp(1j * torch.cumsum(0.3 * real(batch, m + n), dim=1))
    prev = torch.complex(real(batch, m), real(batch, m))
    cur = torch.complex(real(batch, n), real(batch, n))
    have = (torch.arange(batch, device=device) % 3 > 0).to(torch.float32)
    last = torch.exp(1j * real(batch))
    return [
        (f"fused_overlap_save ({batch} x {m} + {n})",
         ofl.fused_overlap_save, ofl.fused_overlap_save_plain,
         (*planes(prev), *planes(cur), *grid(filt.params["response"]))),
        (f"fused_demod_filter ({batch} x {m} + {n})",
         ofl.fused_demod_filter, ofl.fused_demod_filter_plain,
         (*planes(fm[:, m:]), *planes(last), real(batch, m), real(batch),
          have, *grid(demod.params["response"]),
          torch.tensor(demod.params["factor"], device=device))),
        (f"fused_filter_demod_filter ({batch} x {m} + {n})",
         ofl.fused_filter_demod_filter, ofl.fused_filter_demod_filter_plain,
         (*planes(fm[:, :m]), *planes(fm[:, m:]), *planes(last),
          real(batch, m), real(batch), have,
          *grid(fdf.params["response1"]), *grid(fdf.params["response2"]),
          torch.tensor(fdf.params["factor"], device=device))),
    ]


# The cluster route's stamps (csrc/overlap_save.cu OS_MARK): the phase
# that ends at each mark.  Marks 1-7 are #6's channel filter and demod;
# 15 the end of the tables' load (within the first phase); 16 and 17 the
# block's start and end on %globaltimer (ns); 18 the block's SM.
CLOCK_PHASES = {1: "load (#6)", 2: "forward columns (#6)",
                3: "cluster barrier (#6)", 4: "rows (#6)",
                5: "cluster barrier (#6)", 6: "inverse columns (#6)",
                7: "cluster barrier (#6)", 8: "demod and pack",
                9: "forward columns", 10: "cluster barrier", 11: "rows",
                12: "cluster barrier", 13: "inverse columns",
                14: "output"}
MARKS = 19


def clocks(dev, batch: int, reps: int) -> list:
    """#5's and #6's phase split on the development build: its device us
    a call (10-call graphs), the clusters the card holds at once, mean
    cycles a block between consecutive stamps, from %globaltimer the
    spread of the blocks' starts and the span from the first start to the
    last end, and the blocks an SM ran with each one's mean time by that
    count."""
    import subprocess

    from ..ops import _build
    from ..ops import filter as ofl
    dev_lib = _build.lib(("RR_OS_CLOCKS",))
    real_lib = _build.lib
    _build.lib = lambda defines=(): dev_lib
    out = []
    try:
        for name, fn, _, fargs in cases(dev, batch)[1:]:
            merged = "filter_demod" in name
            n = fargs[2 if merged else 0].shape[1]
            m = fargs[6 if merged else 4].shape[1]   # prevd
            n1, n2 = ofl.kernel_factors(m + n)
            fn(*fargs)
            _, ms = _graph_replays(lambda: fn(*fargs), 10, reps)
            rows = 8 * (batch // 2)    # at most 8 blocks a pair
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
            marks = [k for k in range(15) if (st[:, k] != 0).all()]
            phases = {"prologue (tables)": float((st[:, 15]
                                                  - st[:, 0]).mean())}
            phases.update({CLOCK_PHASES[k]: float((st[:, k]
                                                   - st[:, p]).mean())
                           for p, k in zip(marks, marks[1:])})
            row = {"clocked": name,
                   "device_us": ms * 1e3, "blocks": len(st),
                   "clusters_at_once": dev_lib.rr_cluster_occupancy(
                       n1, n2, int(merged)),
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
        row = {"kernel": name, "rel": rel, "bound": BOUND,
               "counters": moved, "device_us": None, "split": None}
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

    print(json.dumps({"card": card() if on_card else "cpu"}), flush=True)
    return out


if __name__ == "__main__":
    main()
