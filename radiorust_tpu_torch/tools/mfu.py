"""FLOP and HBM-byte accounting of the port's chains on the H100 (the
port's ``tools/mfu.py``), and the one roofline model the kernel checks of
``chip_smoke.py`` and the bench share.

The model:

- the card's peaks: 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside
  the tensor cores (H100 SXM data sheet; the port keeps TF32 off);
- a call's bound (:func:`bound_of`): the larger of its bytes (each input
  read once, each output written once, :func:`io_bytes`) over the memory
  rate and its operations over the float32 rate;
- one count function per kernel (#1 to #9, ``*_flops`` below), each
  from the kernel's structure: a complex FFT of N points is 5 N log2 N,
  a complex multiply 6, a multiply-add 2; FM demod (conjugate product,
  atan2 counted as one, scale) 8 a sample; the mixer's two complex
  multiplies and the oscillator's product 18; one slew-limiter step 12,
  one AGC step 10;
- :func:`stage_flops`: the operations of one step of a bound block, from
  its bound geometry (plans, transform sizes, taps, batch).  A block that
  runs a kernel counts through that kernel's count function; a block that
  runs PyTorch calls counts by the same conventions.  A block the model
  does not know raises.

Bytes per step follow the JAX tool's kernel-boundary model: each stage
reads its input chunk, its carried state and its params, and writes its
output and its new state (input + state x 2 + params + output); the
output is that of one eager step of the stage on the device the caller
names.  A graph (stereo) gives totals only, as the JAX tool does.

The FLOP counts differ from the JAX tool's by design: those come from
XLA's cost analysis of the TPU formulation (the bf16 3-pass split, the
matmul DFT), these from the port's kernels.  Do not compare the two FLOP
totals.

    python -m radiorust_tpu_torch.tools.mfu [names ...] [--json-only]
        [--out PATH] [--device cuda]

Prints a roofline table per config (``--json-only``: one JSON line per
config); writes a file only where ``--out`` names one.  Without a card it
raises unless ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ._common import device_label, env_int, parse_args, port_lib, \
    seeded_input

__all__ = ["PEAK_BYTES_S", "PEAK_FLOPS", "DEMOD_FLOPS", "MIX_FLOPS",
           "SLEW_FLOPS", "AGC_FLOPS", "CONFIGS", "tensors",
           "io_bytes", "bound_of", "fft_flops", "nonzero_taps",
           "decimate_flops", "decimate_phase_flops", "decimate_bytes",
           "mix_decimate_flops", "mix_decimate_bytes",
           "overlap_save_flops", "filter_bank_flops", "demod_filter_flops",
           "filter_demod_filter_flops", "pfb_demod_flops", "slew_flops",
           "agc_flops", "stage_flops", "config", "analyze", "main"]

PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, bytes/s (NVIDIA's data sheet)
PEAK_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
# Operations per sample where the work is not a product of taps.
DEMOD_FLOPS, MIX_FLOPS, SLEW_FLOPS, AGC_FLOPS = 8, 18, 12, 10
# A complex sample times a real scale (GainControl, Fourier's window); FM
# modulation (scale, running sum, modulo, cos, sin, each counted as one).
SCALE_FLOPS, FMMOD_FLOPS = 2, 5

CONFIGS = ("wfm", "stereo", "wfm_unfused", "morse", "morse_rf",
           "audiopipe", "bw_meter", "channelizer")


# -- the roofline ---------------------------------------------------------

def tensors(obj) -> list:
    """The tensors of a nested tuple, list or dict of arguments or
    results."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensors(o)]
    return []


def io_bytes(args, results) -> int:
    """Bytes a call must move: each input tensor read once, each output
    written once (a complex tensor's ``.real`` and ``.imag`` views count
    as its two halves; a tensor passed twice, once)."""
    seen, total = set(), 0
    for t in tensors(args) + tensors(results):
        key = (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def bound_of(nbytes: float, flops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fft_flops(n: int) -> float:
    """A complex FFT of ``n`` points."""
    return 5.0 * n * np.log2(n)


def nonzero_taps(plan) -> int:
    """Multiply-adds of one decimation period over its q phases: the
    nonzero taps of the kernel matrix (each row of a downsample plan is
    the prototype at its own offset, L = Kw - p + 1 taps of Kw)."""
    return int(np.count_nonzero(plan.kernel))


# -- one count per kernel -------------------------------------------------

def decimate_flops(plan, batch: int, n: int, planes: int = 2) -> float:
    """#1 (``pallas_decimate``; its wide form the same): ``batch`` rows of
    an ``n``-sample chunk, ``planes`` real planes (1 for a real input)."""
    return 2 * planes * batch * (n // plan.p) * nonzero_taps(plan)


def decimate_phase_flops(plan, batch: int, valid: int,
                         planes: int = 2) -> float:
    """#1's phase-mode entry: ``valid`` output samples a row (the
    schedule's, over the steps counted)."""
    return 2 * planes * batch * (valid // plan.q) * nonzero_taps(plan)


def decimate_bytes(plan, inputs, results, calls: int = 1) -> int:
    """Bytes #1 must move in ``calls`` calls (any form: polyphase, wide,
    phase mode): its sample tensors (input, history, phase; ``inputs``
    without any taps tensor) and ``results`` by :func:`io_bytes`, plus
    the plan's nonzero taps (float32) read once a call.  The taps count
    the same whatever layout a kernel reads them in (the dense W, the
    polyphase re-layout, the wide form's bands)."""
    return io_bytes(inputs, results) + calls * 4 * nonzero_taps(plan)


def mix_decimate_flops(plan, batch: int, n: int) -> float:
    """#2 (``fused_mix_decimate``, either form): the mixer on every input
    sample, then #1 on both planes over the plan's nonzero taps (a wide
    plan's rows are bands of Kw)."""
    return decimate_flops(plan, batch, n) + MIX_FLOPS * batch * n


def mix_decimate_bytes(plan, inputs, results, tables, calls: int = 1) -> int:
    """Bytes #2 must move in ``calls`` calls (either form): its sample
    tensors (input, history planes, start phasor; ``inputs`` without the
    taps or the tables) and ``results`` by :func:`io_bytes`, the plan's
    nonzero taps once a call (:func:`decimate_bytes`), and the oscillator
    tables ``tables`` (A and B, whatever their layout) read once a
    call."""
    return (decimate_bytes(plan, inputs, results, calls)
            + calls * io_bytes(tables, ()))


def overlap_save_flops(rows: int, n: int, bands: int = 1) -> float:
    """#3 (``fused_overlap_save``): one forward transform of ``n`` points
    a row, then per band a response multiply and an inverse."""
    return rows * (fft_flops(n) + bands * (6 * n + fft_flops(n)))


def filter_bank_flops(rows: int, n: int, bands: int) -> float:
    """#4 (``fused_filter_bank``): #3 with ``bands`` responses sharing the
    forward transform."""
    return overlap_save_flops(rows, n, bands)


def demod_filter_flops(batch: int, m: int, n: int) -> float:
    """#5 (``fused_demod_filter``): FM demod of the ``n`` new samples, then
    a real filter of ``m + n`` points with stream pairs in one
    transform."""
    return DEMOD_FLOPS * batch * n + overlap_save_flops(batch // 2, m + n)


def filter_demod_filter_flops(batch: int, m: int, n: int) -> float:
    """#6 (``fused_filter_demod_filter``): a complex filter, FM demod, then
    #5's real filter."""
    return (overlap_save_flops(batch, m + n) + DEMOD_FLOPS * batch * n
            + overlap_save_flops(batch // 2, m + n))


def pfb_demod_flops(batch: int, frames: int, k: int, m: int = 64) -> float:
    """#7 (``fused_pfb_demod``): per output frame, ``k`` real taps on ``m``
    complex samples, an ``m``-point FFT, ``m`` demods."""
    return batch * frames * (4 * k * m + fft_flops(m) + DEMOD_FLOPS * m)


def slew_flops(rows: int, n: int) -> float:
    """#8 (``slew_scan``)."""
    return SLEW_FLOPS * rows * n


def agc_flops(rows: int, n: int) -> float:
    """#9 (``agc_scan``)."""
    return AGC_FLOPS * rows * n


# -- a bound block's step ---------------------------------------------------

def _map_flops():
    """Operations a sample of the sample maps the models bind (the stereo
    decoder's): z^2 / |z|^2 (a complex square, |z|^2, the epsilon, a
    reciprocal, a complex times a real scale), s * conj(c), and the L/R
    matrix's two adds."""
    from ..models import stereo
    return {stereo._double_phase: 6 + 3 + 1 + 1 + SCALE_FLOPS,
            stereo._mix_subcarrier: 6, stereo._lr_matrix: 2}


def stage_flops(block) -> float:
    """The operations of one step of the bound ``block`` (a chain or
    graph: of all its blocks), from its bound geometry.  Raises
    ``TypeError`` for a block the model does not count."""
    from ..blocks import analysis, base, channelize, chunks, filters, \
        frontend, graph, modulation, resampling, transform
    if isinstance(block, (base._BoundChain, graph.BoundGraph)):
        inner = (block.blocks if isinstance(block, base._BoundChain)
                 else [b for b in block.bound if b is not None])
        return float(sum(stage_flops(b) for b in inner))
    sig = block.in_sig
    b, n = sig.batch, sig.chunk_len
    kind = type(block)
    if kind is frontend._BoundMixerDecimator:
        return mix_decimate_flops(block.plan, b, n)
    if kind is filters._BoundFilter:
        # Two real streams share a transform (the block's pair_real).
        pair = block.input_is_real and block._real_ir and b % 2 == 0
        return overlap_save_flops(b // 2 if pair else b, n + block.ir_len)
    if kind is filters._BoundFilterBank:
        return filter_bank_flops(b, n + block.ir_len, block.num_outputs)
    if kind is frontend._BoundFmDemodFilter:
        return demod_filter_flops(b, block.ir_len, n)
    if kind is frontend._BoundFilterDemodFilter:
        return filter_demod_filter_flops(b, block.ir_len, n)
    if kind is resampling._BoundResampler:
        planes = 1 if block.input_is_real else 2
        if block.phase_mode:
            # The first step's windows, from the schedule's phase 0.
            return decimate_phase_flops(
                block.plan, b, int(block.valid_counts(0)[0]), planes)
        return decimate_flops(block.plan, b, n, planes)
    if kind is channelize._BoundChannelizerDemod:
        return pfb_demod_flops(b, n // block.m, block.k, block.m)
    if kind is filters._BoundSlewRateLimiter:
        return slew_flops(b, n)
    if kind is transform._BoundAgc:
        return agc_flops(b, n)
    if kind is channelize._BoundChannelizer:
        # The unfused analysis bank (ops/channelizer.py pfb_channelize):
        # per frame the branch FIR on two planes, the DFT as four real
        # [M] x [M, M] products and their two sums.
        m, k = block.m, block.k
        return b * (n // m) * (4 * k * m + 8 * m * m + 2 * m)
    if kind is transform._BoundFreqShifter:
        return MIX_FLOPS * b * n
    if kind is modulation._BoundFmDemod:
        return DEMOD_FLOPS * b * n
    if kind is modulation._BoundFmMod:
        return FMMOD_FLOPS * b * n
    if kind is transform._BoundGain:
        return SCALE_FLOPS * b * n
    if kind is analysis._BoundFourier:
        # The window, then one transform a row (the roll moves data).
        return b * (SCALE_FLOPS * n + fft_flops(n))
    if kind in (chunks._BoundOverlapper, graph._BoundSelect):
        return 0.0      # data movement only: a concatenation, a view
    if kind in (transform._BoundMap, transform._BoundCombine):
        per = _map_flops().get(block.fn)
        if per is None:
            raise TypeError(f"stage_flops: no count for the sample map "
                            f"{getattr(block.fn, '__qualname__', block.fn)}")
        return per * b * n
    raise TypeError(f"stage_flops: no count for {kind.__name__}")


# -- the configs and their accounting ------------------------------------

def config(name: str, lib=port_lib):
    """(spec, chunk length, sample rate) of config ``name`` of the JAX
    tool (``tools/mfu.py``), built through ``lib``.  "wfm" is the bench's
    chain at its knobs (``BENCH_CHUNK``, ``BENCH_IR``,
    ``BENCH_FUSE_FRONTEND``, ``BENCH_FUSE_DEMOD``)."""
    wfm = lib("models.wfm")
    chunk, rate = wfm.WFM_INPUT_CHUNK, wfm.WFM_INPUT_RATE
    fuse = os.environ.get("BENCH_FUSE_FRONTEND", "1") == "1"
    if name == "wfm":
        from .bench import chain
        return (chain(env_int("BENCH_IR", 6144), fuse,
                      os.environ.get("BENCH_FUSE_DEMOD", "1") == "1", lib),
                env_int("BENCH_CHUNK", 24576), rate)
    if name == "stereo":
        return lib("models.stereo").wfm_stereo_receiver(), chunk, rate
    if name == "wfm_unfused":
        return wfm.wfm_receiver(), chunk, rate
    if name == "morse":
        return lib("models.morse_tx").morse_audio_chain(), 4096, 48000.0
    if name == "morse_rf":
        return lib("models.morse_tx").morse_rf_chain(), 4096, 128000.0
    if name == "audiopipe":
        def lp(bins, freqs):
            return np.where(np.abs(freqs) <= 500000.0, 1.0 + 0.0j, 0.0j)

        return (lib("blocks.base").Chain(
            lib("blocks.transform").FreqShifter.with_shift(-100000.0),
            lib("blocks.filters").Filter.new(lp),
            lib("blocks.resampling").Downsampler(1200000.0, 1000000.0)),
            16384, 2400000.0)
    if name == "bw_meter":
        return (lib("models.bandwidth_meter").bandwidth_meter_chain(
            fuse_frontend=fuse), 10240, 1024000.0)
    if name == "channelizer":
        return (lib("models.channelizer").channelized_receiver(), 65536,
                8192000.0)
    raise ValueError(f"unknown config {name!r}: one of {CONFIGS}")


def _nbytes(tree) -> int:
    from ..blocks.base import _leaves
    return int(sum(leaf.numel() * leaf.element_size()
                   if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf).nbytes for leaf in _leaves(tree)))


def analyze(name: str, spec, n: int, rate: float, batch: int,
            device) -> dict:
    """The JAX tool's record of config ``name``: ``spec`` (a chain or
    graph, or one already bound at ``StreamSig(batch, n, rate)``) stepped
    once, stage by stage, on seeded input made on ``device``; operations
    from :func:`stage_flops`, bytes from the kernel-boundary model (each
    stage's input, output, state and params bytes beside them)."""
    from ..blocks.base import StreamSig
    from ..blocks.graph import BoundGraph
    from ..convert import tree_to_torch
    sig = StreamSig(batch, n, rate)
    if hasattr(spec, "bind"):
        bound = spec.bind({"iq": sig} if hasattr(spec, "input") else sig)
    else:
        bound = spec
    is_graph = isinstance(bound, BoundGraph)
    got = (next(iter(bound.in_sigs.values())) if is_graph
           else bound.in_sig)
    if (got.batch, got.chunk_len, got.sample_rate) != (batch, n, rate):
        raise ValueError(f"{name}: bound at {got}, not {sig}")
    x = seeded_input(1, batch, n, device, seed=7)[0]
    record = {"config": name, "batch": batch, "chunk": n}
    with torch.no_grad():
        if is_graph:
            params = tree_to_torch(bound.params, device)
            state = tree_to_torch(bound.init_state(), device)
            _, y = bound.process(params, state, {"iq": x})
            parts = {"input_bytes": _nbytes(x), "state_bytes": _nbytes(state),
                     "params_bytes": _nbytes(params),
                     "output_bytes": _nbytes(y)}
            record.update(parts)
            stages = []
            total_flops = stage_flops(bound)
            total_bytes = (parts["input_bytes"] + 2 * parts["state_bytes"]
                           + parts["params_bytes"] + parts["output_bytes"])
        else:
            blocks = getattr(bound, "blocks", None) or (bound,)
            stages, xcur = [], x
            for blk in blocks:
                params = tree_to_torch(blk.params, device)
                state = tree_to_torch(blk.init_state(), device)
                # Blocks that fold channels into the batch axis change the
                # stream count mid-chain: the reset follows it.
                reset = torch.zeros((xcur.shape[0],), dtype=torch.bool,
                                    device=device)
                _, y = blk.process(params, state, xcur, reset)
                parts = {"input_bytes": _nbytes(xcur),
                         "state_bytes": _nbytes(state),
                         "params_bytes": _nbytes(params),
                         "output_bytes": _nbytes(y)}
                stages.append({
                    "stage": type(blk).__name__.lstrip("_"),
                    "flops": stage_flops(blk),
                    "hbm_bytes": (parts["input_bytes"]
                                  + 2 * parts["state_bytes"]
                                  + parts["params_bytes"]
                                  + parts["output_bytes"]),
                    **parts})
                xcur = y
            total_flops = sum(s["flops"] for s in stages)
            total_bytes = sum(s["hbm_bytes"] for s in stages)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    in_samples = batch * n
    record.update({
        "flops_per_step": total_flops,
        "flops_per_input_sample": total_flops / in_samples,
        "hbm_bytes_per_step": total_bytes,
        "hbm_bytes_per_input_sample": total_bytes / in_samples,
        "arithmetic_intensity": total_flops / max(total_bytes, 1),
        "peak_f32_tflops": PEAK_FLOPS / 1e12,
        "peak_hbm_gbps": PEAK_BYTES_S / 1e9,
        "matmul_precision": "float32",
        "stages": stages,
        **device_label(device)})
    return record


def main(argv=None) -> list:
    args = parse_args(__doc__, argv)
    json_only = "--json-only" in args.rest
    out_path = None
    if "--out" in args.rest:
        out_path = args.rest[args.rest.index("--out") + 1]
    batch = env_int("BENCH_BATCH", 64)
    records, out = [], {}
    for name in args.names or CONFIGS:
        spec, n, rate = config(name)
        r = analyze(name, spec, n, rate, batch, args.device)
        records.append(r)
        out[name] = r
        if json_only:
            print(json.dumps(r), flush=True)
            continue
        print(f"\n## {name}  (batch {r['batch']}, chunk {r['chunk']}, "
              f"{r['matmul_precision']}, {r['device']})")
        print(f"total: {r['flops_per_input_sample']:.1f} FLOP/sample, "
              f"{r['hbm_bytes_per_input_sample']:.1f} HBM B/sample, "
              f"intensity {r['arithmetic_intensity']:.2f} FLOP/B")
        print("| stage | MFLOP/step | FLOP/sample | HBM kB/step |")
        print("|---|---|---|---|")
        for s in r["stages"]:
            print(f"| {s['stage']} | {s['flops'] / 1e6:.2f} | "
                  f"{s['flops'] / (r['batch'] * r['chunk']):.1f} | "
                  f"{s['hbm_bytes'] / 1e3:.1f} |", flush=True)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"\nwrote {out_path}")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
