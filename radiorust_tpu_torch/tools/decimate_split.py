"""Device time of #1's wide form and phase-mode entry and of #2's wide
form at every geometry they run at, beside #1's polyphase form and #2 at
path A's plans.

For each geometry, at batch 64 on complex64 streams made from a seed:

- holds the kernel's call against its plain version on the same CUDA
  tensors: max |diff| / max |ref| within the kernel checks' 1e-5, the new
  history (and in phase mode the new phase) equal bit for bit (#2: the
  mixed history);
- times CUDA graphs of 1 and of 10 calls, replayed ``--reps`` times
  (CUDA events: device us a call);
- reads the wrapper's launch counter over one eager call.

The geometries: path I (48 kHz -> 44.1 kHz at chunk 1600), 384 kHz ->
44.1 kHz at 12800, path J's upsample 48 kHz -> 1.024 MHz at 768 (all
aligned, ``rr_decimate_wide``); in phase mode (``rr_decimate_phase``,
grid phase 0) path K's 384 kHz -> 44.1 kHz at 6144, 1.024 MHz -> 44.1
kHz and 22.05 kHz at 16384, 8:3 at 60, 100 and 7, and the upsample 384
-> 1024 at 64; #2's wide form (``rr_mix_decimate_wide``) at path U's
plans (2.048 MHz -> 240 kHz and -> 12 kHz at 16384, 48 kHz -> 44.1 kHz at
1600), 1.024 MHz -> 200 kHz at 16384, 2.048 MHz -> 12 kHz at 1024 (a
history longer than the chunk) and 48 kHz -> 44.1 kHz at 1760 (an
oscillator block of 110 samples); and, as references the wide kernel
leaves alone, ``decimate`` at A's tail and ``fused_mix_decimate`` at A's
head.  The
tool uses only the wrappers' public calls, so a copy of it in an older
checkout's ``tools/`` times that checkout's kernels the same way.

#2's wide form's rows also give its route (``ops/frontend.py
mix_wide_route``: "mma", a 3xTF32 product on the tensor cores, or "fma"),
the share of the route's multiplies that meet a nonzero tap, the tensor-
core product's share, and the launch's tile (``mix_wide_config``).

With ``--clocks`` it then runs the wide geometries (#1's and #2's) once
each on the development build (``-DRR_DECIM_CLOCKS``:
``_build.lib(("RR_DECIM_CLOCKS",))``, its own build directory), whose
wide kernels stamp ``clock64()``
at each phase of each block, and prints the phases' mean cycles a block
(``CLOCK_PHASES``; #2's wide form ``MIX_PHASES`` by route: copies,
history, mix, product or sums, reduction or shuffles, stores), the
blocks' span on %globaltimer and the blocks an SM ran, beside the SM
clock ``nvidia-smi`` reads.

    python -m radiorust_tpu_torch.tools.decimate_split [--device cuda]
        [--reps 50] [--batch 64] [--clocks]

One JSON line per geometry (and per clocked geometry), then ``{"card":
...}``.  ``--device cpu`` runs the plain versions once and prints no
time.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ._common import card, parse_args

BOUND = 1e-5          # the FIR kernel checks' max |diff| / max |ref|
BATCH = 64


def mixer_geometries():
    """(label, plan, chunk, input rate, shift) of #2's wide form: path
    U's three plans, then the other checks of chip_smoke.py."""
    from ..ops.polyphase import plan_downsample
    u1 = plan_downsample(2.048e6, 240e3, 200e3)
    u2 = plan_downsample(2.048e6, 12e3, 10e3)
    u3 = plan_downsample(48e3, 44100.0, 20e3)
    return (
        ("U1: 2.048 MHz -> 240 kHz at 16384", u1, 16384, 2.048e6, -300e3),
        ("U2: 2.048 MHz -> 12 kHz at 16384", u2, 16384, 2.048e6, -250e3),
        ("U3: 48 kHz -> 44.1 kHz at 1600", u3, 1600, 48e3, -7e3),
        ("1.024 MHz -> 200 kHz at 16384",
         plan_downsample(1.024e6, 200e3, 150e3), 16384, 1.024e6, -250e3),
        ("2.048 MHz -> 12 kHz at 1024 (history 6143)", u2, 1024, 2.048e6,
         -250e3),
        ("48 kHz -> 44.1 kHz at 1760 (oscillator block 110)", u3, 1760,
         48e3, -7e3))


def _geometries(batch: int = BATCH):
    """(label, kind, plan, chunk): kind "wide" (aligned, the wide form),
    "phase" (phase mode), "polyphase" (#1 at A's tail, real input),
    "mixer" (#2 at A's head) or "mixer wide" (#2's wide form; the
    chunk's shift tables at its input rate)."""
    from ..blocks.base import StreamSig
    from ..models.wfm import wfm_receiver
    from ..ops.polyphase import plan_downsample, plan_upsample
    a = wfm_receiver(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
                     filter_ir_len=6144).bind(StreamSig(batch, 24576,
                                                        1.024e6))
    eight_three = plan_downsample(1024.0, 384.0, 200.0)
    return (
        ("I: 48 kHz -> 44.1 kHz at 1600", "wide",
         plan_downsample(48000.0, 44100.0, 20000.0), 1600),
        ("384 kHz -> 44.1 kHz at 12800", "wide",
         plan_downsample(384000.0, 44100.0, 16000.0), 12800),
        ("J: upsample 48 kHz -> 1.024 MHz at 768", "wide",
         plan_upsample(48000.0, 1024000.0, 40000.0), 768),
        ("K: phase, 384 kHz -> 44.1 kHz at 6144", "phase",
         plan_downsample(384000.0, 44100.0, 36000.0), 6144),
        ("phase, 1.024 MHz -> 44.1 kHz at 16384", "phase",
         plan_downsample(1024000.0, 44100.0, 17640.0), 16384),
        ("phase, 1.024 MHz -> 22.05 kHz at 16384", "phase",
         plan_downsample(1024000.0, 22050.0, 8820.0), 16384),
        ("phase, 8:3 at 60", "phase", eight_three, 60),
        ("phase, 8:3 at 100", "phase", eight_three, 100),
        ("phase, 8:3 at 7", "phase", eight_three, 7),
        ("phase, upsample 384 -> 1024 at 64", "phase",
         plan_upsample(384.0, 1024.0, 300.0), 64),
        ("polyphase: A's tail, 8:1 real input at 9216", "polyphase",
         a.blocks[3].plan, 9216),
        ("mixer (#2): A's head, 8:3 at 24576", "mixer", a.blocks[0].plan,
         24576),
        *((f"mixer wide (#2): {label}", "mixer wide", plan, n)
          for label, plan, n, _, _ in mixer_geometries()),
    )


def cases(dev, batch: int = BATCH):
    """(label, kind, plan, wrapper, plain, args, compare) of every
    geometry on ``dev``; ``compare(got, want)`` returns max |diff| /
    max |ref| of the outputs and raises where a history or phase
    differs."""
    from ..blocks.transform import _shift_tables
    from ..ops import frontend as ofe
    rng = np.random.default_rng(0)

    def cplx(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 + 1j * rng.standard_normal(shape))
                                .astype(np.complex64)).to(dev)

    def rel(g, w):
        d = float((g - w).abs().max())
        return d / max(float(w.abs().max()), 1e-30)

    def exact(label, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: not bit for bit")

    tables = {f"mixer wide (#2): {label}": (rate, shift)
              for label, _, _, rate, shift in mixer_geometries()}
    out = []
    for label, kind, plan, n in _geometries(batch):
        w = torch.from_numpy(plan.kernel).to(dev)
        p, q = plan.p, plan.q
        if kind == "phase":
            x, h = cplx(batch, n), cplx(batch, w.shape[1] - 1)
            ph = torch.zeros(batch, dtype=torch.int32, device=dev)

            def compare(got, want, label=label):
                exact(label + " history", got[1], want[1])
                exact(label + " phase", got[2], want[2])
                return rel(got[0], want[0])
            out.append((label, kind, plan, ofe.decimate_phase_complex,
                        ofe.rational_fir_phase, (x, h, ph, w, p, q),
                        compare))
        elif kind in ("mixer", "mixer wide"):
            rate, shift = tables.get(label, (1024000, 100000))
            ta, tb, _ = _shift_tables(n, int(rate), int(shift))
            ta, tb = (torch.from_numpy(t).to(dev) for t in (ta, tb))
            phase = torch.from_numpy(rng.standard_normal(batch).astype(
                np.float32)).to(dev)
            hr = torch.from_numpy(rng.standard_normal(
                (batch, plan.hist)).astype(np.float32)).to(dev)
            hi = torch.from_numpy(rng.standard_normal(
                (batch, plan.hist)).astype(np.float32)).to(dev)

            def compare(got, want, label=label):
                exact(label + " history", got[1], want[1])
                return rel(got[0], want[0])
            out.append((label, kind, plan, ofe.fused_mix_decimate_complex,
                        ofe.fused_mix_decimate_complex_plain,
                        (cplx(batch, n), ta, tb, torch.cos(phase),
                         torch.sin(phase), hr, hi, w, p, q), compare))
        else:
            real = kind == "polyphase"
            x, h = cplx(batch, n), cplx(batch, plan.hist)

            def compare(got, want, label=label):
                exact(label + " history", got[1], want[1])
                return rel(got[0], want[0])
            out.append((label, kind, plan, ofe.decimate_complex,
                        ofe.decimate_complex_plain,
                        (x, h, w, p, q, real), compare))
    return out


def _graph_us(fn, calls: int, reps: int) -> float:
    """Device us a call of ``calls`` calls of ``fn`` captured in one CUDA
    graph and replayed ``reps`` times (CUDA events)."""
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
    return start.elapsed_time(end) * 1e3 / (reps * calls)


# #1's wide kernel's stamps (csrc/decimate.cu DW_MARK): the phase that
# ends at each mark; 7 and 8 the block's start and end on %globaltimer
# (ns), 9 its SM.
CLOCK_PHASES = {1: "issue copies (bands, span)", 2: "history share",
                3: "copies land", 4: "sums", 5: "lane-group shuffles",
                6: "stores"}
MARKS = 10
# #2's wide kernel's (csrc/mix_decimate_wide.cu MW_MARK), 6-8 by route;
# 9 and 10 the block's start and end, 11 its SM.
_MIX_COMMON = {1: "issue copies (span, taps, tables)",
               2: "history from the sources", 3: "copies land", 4: "mix",
               5: "history from the span"}
MIX_PHASES = {
    "mma": {**_MIX_COMMON, 6: "product", 7: "partial-Z reduction",
            8: "diagonal sums and stores"},
    "fma": {**_MIX_COMMON, 6: "sums", 7: "lane-group shuffles",
            8: "stores"}}
MIX_MARKS = 12


def mix_wide_shape(plan, n: int, batch: int):
    """(layout, launch shape) of #2's wide form at this plan and chunk."""
    from ..blocks.transform import _inner_block
    from ..ops import frontend as ofe
    lay = ofe.mix_wide_layout(plan.kernel, plan.p)
    inner = _inner_block(n)
    return lay, ofe.mix_wide_config(lay.shape, plan.p, n // plan.p, batch,
                                    inner, n // inner, plan.hist)


def clocks(dev, reps: int, batch: int = BATCH) -> list:
    """The wide geometries' phase split on the development build: device
    us a call (10-call graphs), mean cycles a block between consecutive
    stamps, from %globaltimer the spread of the blocks' starts and the
    span from the first start to the last end, and the blocks an SM
    ran."""
    import subprocess

    from ..ops import _build
    from ..ops import frontend as ofe
    dev_lib = _build.lib(("RR_DECIM_CLOCKS",))
    real_lib = _build.lib
    _build.lib = lambda defines=(): dev_lib
    out = []
    try:
        for label, kind, plan, fn, _, fargs, _ in cases(dev, batch):
            if kind not in ("wide", "phase", "mixer wide"):
                continue
            x = fargs[0]
            windows = (-(-x.shape[1] // plan.p) if kind == "phase"
                       else x.shape[1] // plan.p)
            if kind == "mixer wide":
                lay, sh = mix_wide_shape(plan, x.shape[1], x.shape[0])
                blocks = len(lay.wide.zband) * sh.tiles * x.shape[0]
                threads, marks = sh.threads, MIX_MARKS
                phases = MIX_PHASES[lay.route]
                stamp = dev_lib.rr_mix_wide_clocks
            else:
                lay = ofe.wide_layout(plan.kernel)
                ws, nw, _, _, threads, _ = ofe.wide_config(
                    lay.shape, plan.p, windows, x.shape[0], 2)
                blocks = (len(lay.zband) * -(-windows // (ws * nw))
                          * x.shape[0])
                marks, phases = MARKS, CLOCK_PHASES
                stamp = dev_lib.rr_decim_clocks
            fn(*fargs)
            us = _graph_us(lambda: fn(*fargs), 10, reps)
            clk = torch.zeros(blocks * marks, dtype=torch.int64, device=dev)
            torch.cuda.synchronize()
            stamp(clk.data_ptr())
            fn(*fargs)
            torch.cuda.synchronize()
            stamp(None)
            st = clk.view(blocks, marks).cpu().numpy()
            last = max(phases)
            sm_mhz = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60).stdout.split()[0]
            sms, per_sm = np.unique(st[:, last + 3], return_counts=True)
            t0, t1 = st[:, last + 1], st[:, last + 2]
            row = {"clocked": label, "device_us": us, "blocks": blocks,
                   "threads": threads,
                   "cycles": {phases[k]: float((st[:, k]
                                                - st[:, k - 1]).mean())
                              for k in phases},
                   "block_cycles_mean": float((st[:, last]
                                               - st[:, 0]).mean()),
                   "block_cycles_max": float((st[:, last] - st[:, 0]).max()),
                   "start_spread_us": float(t0.max() - t0.min()) / 1e3,
                   "span_us": float(t1.max() - t0.min()) / 1e3,
                   "sms_used": int(len(sms)),
                   "sms_by_blocks": {int(k): int((per_sm == k).sum())
                                     for k in np.unique(per_sm)},
                   "sm_mhz": float(sm_mhz)}
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        _build.lib = real_lib
    return out


def main(argv=None) -> list:
    args = parse_args(__doc__, sys.argv[1:] if argv is None else argv,
                      names=False)
    reps, batch = 50, BATCH
    for flag in ("--reps", "--batch"):
        if flag in args.rest:
            value = int(args.rest[args.rest.index(flag) + 1])
            reps, batch = (value, batch) if flag == "--reps" else (reps,
                                                                   value)
    dev = args.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from ..ops import frontend as ofe
    # The counter each wrapper counts its launches on.
    counters = {"phase": ofe.decimate_phase_complex,
                "mixer": ofe.fused_mix_decimate,
                "mixer wide": ofe.fused_mix_decimate}
    out = []
    for label, kind, plan, fn, plain, fargs, compare in cases(dev, batch):
        counter = counters.get(kind, ofe.decimate)
        before = counter.launches
        got = fn(*fargs)
        launches = counter.launches - before
        rel = compare(got, plain(*fargs))
        row = {"geometry": label, "p": plan.p, "q": plan.q,
               "kw": int(plan.kernel.shape[1]), "rel": rel, "bound": BOUND,
               "launches": launches, "us_graph_1": None,
               "us_graph_10": None}
        if kind == "mixer wide":
            lay, sh = mix_wide_shape(plan, fargs[0].shape[1],
                                     fargs[0].shape[0])
            row.update(route=lay.route, useful=lay.useful, dense=lay.dense,
                       tile=dict(tm=sh.tm, tiles=sh.tiles, mt=sh.mt,
                                 threads=sh.threads, smem=sh.smem))
        if on_card:
            row["us_graph_1"] = _graph_us(lambda: fn(*fargs), 1, reps)
            row["us_graph_10"] = _graph_us(lambda: fn(*fargs), 10, reps)
        print(json.dumps(row), flush=True)
        if not rel <= BOUND:
            raise AssertionError(f"{label}: kernel disagrees with its plain "
                                 f"version ({rel:.3e} > {BOUND:g})")
        out.append(row)
    if on_card and "--clocks" in args.rest:
        out += clocks(dev, reps, batch)
    print(json.dumps({"card": card() if on_card else "cpu"}), flush=True)
    return out


if __name__ == "__main__":
    main()
