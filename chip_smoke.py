#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name, power limit), the torch and CUDA versions, and
   turns TF32 off.
2. Builds the port's CUDA kernels from ``radiorust_tpu_torch/csrc`` (at
   first use) and holds each kernel against its plain PyTorch version on
   the same CUDA tensors at the receive chain's shapes (batch 64).
3. Drives the main path, ``wfm_receiver(tune_shift=100e3,
   fuse_frontend=True, fuse_demod=True, filter_ir_len=6144)`` bound at
   ``StreamSig(64, 24576, 1.024e6)``, over 16 chunks of FM-tone input, and
   checks that every kernel was launched, that the output is finite, that
   the audio tones come out at their frequencies, and that the first two
   streams equal the same chain run on CPU tensors.
4. Times the whole chain and each kernel beside its plain version with
   CUDA events; ``--profile`` adds the device time by kernel of the
   chain (torch.profiler).

Any failure raises and exits non-zero; without a CUDA device, or without
the package beside this script, it exits non-zero before any result.  The
second-to-last line is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
BATCH, CHUNK, RATE, T = 64, 24576, 1024000.0, 16
CHAIN = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
             filter_ir_len=6144)
FIR_BOUND = 1e-5      # kernel vs plain, max |diff| / max |ref|
FILTER_BOUND = 2.4e-5
CPU_ATOL = 3e-4       # main path vs the same chain on CPU tensors
TONE_HZ = 30.0        # audio peak within this many Hz of its tone


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of ``fn`` on the current stream, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want):
    """(max |diff|, max |diff| / max |ref|) over paired output tensors."""
    torch.cuda.synchronize()
    abs_err, rel = 0.0, 0.0
    for g, w in zip(got, want):
        d = float((g - w).abs().max())
        abs_err = max(abs_err, d)
        rel = max(rel, d / max(float(w.abs().max()), 1e-30))
    return abs_err, rel


def fm_tones(tones, t_chunks, n, offset, deviation=150000.0):
    """[T, streams, n] complex64: one FM-modulated audio tone per stream
    with its carrier at ``offset`` Hz, synthesized in numpy float64."""
    t = np.arange(t_chunks * n) / RATE
    out = np.empty((t_chunks, len(tones), n), np.complex64)
    for i, f in enumerate(tones):
        audio = 0.5 * np.sin(2 * np.pi * f * t)
        phase = (2 * np.pi * deviation / RATE * np.cumsum(audio)
                 + 2 * np.pi * offset * t)
        out[:, i, :] = np.exp(1j * phase).astype(np.complex64).reshape(
            t_chunks, n)
    return out


def profile_chain(run, steps: int, tag: str) -> None:
    """Device time by kernel over ``steps`` chain steps (torch.profiler),
    and the device's busy share of the window's wall time."""
    import time

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        # Kernel events only: an aten op's self device time repeats the
        # time of the kernels it launched.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile over {steps} steps: wall {wall_us:.1f} us, device busy "
          f"{busy:.1f} us ({100 * busy / wall_us:.1f}%) {tag}")
    for dev_us, count, key in rows[:15]:
        print(f"  {dev_us / steps:9.1f} us/step  {count // steps:3d} "
              f"calls/step  {key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; there is no CPU run")
    if not (HERE / "radiorust_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: radiorust_tpu_torch is not beside this script")
    sys.path.insert(0, str(HERE))
    from radiorust_tpu_torch.blocks.base import StreamSig, scan
    from radiorust_tpu_torch.convert import tree_to_torch
    from radiorust_tpu_torch.models.wfm import wfm_receiver
    from radiorust_tpu_torch.ops import _build
    from radiorust_tpu_torch.ops import filter as ofl
    from radiorust_tpu_torch.ops import frontend as ofe

    name = card()
    tag = f"[{name}]"
    print(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # -- build ------------------------------------------------------------
    _build.lib()
    log = (_build.build_dir() / "build.log").read_text()
    for line in log.splitlines():
        if "Compiling entry function" in line or "Used " in line:
            print("ptxas:", line.split("info    :")[-1].strip())

    # -- kernel vs plain at the main path's shapes --------------------------
    sig = StreamSig(BATCH, CHUNK, RATE)
    bound = wfm_receiver(**CHAIN).bind(sig)
    mixdec, filt, demod, tail = bound.blocks[:4]
    kernels = []

    def check(name, source, replaces, bound_, kernel, plain, args,
              outputs=None):
        got = kernel(*args)
        want = plain(*args)
        got = got if outputs is None else outputs(got)
        want = want if outputs is None else outputs(want)
        abs_err, rel = compare(got, want)
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        print(f"{name}: max|diff|={abs_err:.3e} max|diff|/max|ref|="
              f"{rel:.3e} (bound {bound_:g}); kernel {ms * 1e3:.1f} us, "
              f"plain {plain_ms * 1e3:.1f} us per call {tag}")
        if not rel <= bound_:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({rel:.3e} > {bound_:g})")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=abs_err,
                            ms=ms, plain_ms=plain_ms))

    flat = lambda res: [t for part in res for t in
                        (part if isinstance(part, tuple) else (part,))]

    n_mid = mixdec.out_sig.chunk_len
    plan = tail.plan
    check("decimate", "radiorust_tpu_torch/csrc/decimate.cu",
          "radiorust_tpu/ops/pallas_frontend.py:181", FIR_BOUND,
          ofe.decimate, ofe.decimate_plain,
          ((randn(BATCH, n_mid),), (randn(BATCH, plan.hist),),
           torch.from_numpy(plan.kernel).to(dev), plan.p, plan.q),
          outputs=flat)

    ta = torch.from_numpy(mixdec.params["table_a"]).to(dev)
    tb = torch.from_numpy(mixdec.params["table_b"]).to(dev)
    ph = randn(BATCH)
    check("fused_mix_decimate", "radiorust_tpu_torch/csrc/decimate.cu",
          "radiorust_tpu/ops/pallas_frontend.py:241", FIR_BOUND,
          ofe.fused_mix_decimate, ofe.fused_mix_decimate_plain,
          (randn(BATCH, CHUNK), randn(BATCH, CHUNK),
           ta.real.contiguous(), ta.imag.contiguous(),
           tb.real.contiguous(), tb.imag.contiguous(),
           torch.cos(ph), torch.sin(ph),
           randn(BATCH, mixdec.plan.hist), randn(BATCH, mixdec.plan.hist),
           torch.from_numpy(mixdec.plan.kernel).to(dev),
           mixdec.plan.p, mixdec.plan.q))

    m = filt.ir_len
    g = ofl.response_grid(torch.from_numpy(filt.params["response"]).to(dev))
    check("fused_overlap_save", "radiorust_tpu_torch/csrc/overlap_save.cu",
          "radiorust_tpu/ops/pallas_filter.py:547", FILTER_BOUND,
          ofl.fused_overlap_save, ofl.fused_overlap_save_plain,
          (randn(BATCH, m), randn(BATCH, m), randn(BATCH, n_mid),
           randn(BATCH, n_mid), g.real.contiguous(), g.imag.contiguous()))

    g2 = ofl.response_grid(
        torch.from_numpy(demod.params["response"]).to(dev))
    fm = torch.exp(1j * torch.cumsum(0.3 * randn(BATCH, n_mid), dim=1))
    have = (torch.arange(BATCH, device=dev) % 3 > 0).to(torch.float32)
    check("fused_demod_filter", "radiorust_tpu_torch/csrc/overlap_save.cu",
          "radiorust_tpu/ops/pallas_filter.py:778", FILTER_BOUND,
          ofl.fused_demod_filter, ofl.fused_demod_filter_plain,
          (fm.real.contiguous(), fm.imag.contiguous(), randn(BATCH),
           randn(BATCH), randn(BATCH, m), randn(BATCH), have,
           g2.real.contiguous(), g2.imag.contiguous(),
           torch.tensor(demod.params["factor"], device=dev)))

    # -- the main path ------------------------------------------------------
    tones = 400.0 + 190.0 * np.arange(BATCH)
    xs_host = fm_tones(tones, T, CHUNK, offset=-100e3)
    xs = torch.from_numpy(xs_host).to(dev)
    params = tree_to_torch(bound.params, dev)
    wrappers = [ofe.decimate, ofe.fused_mix_decimate, ofl.fused_overlap_save,
                ofl.fused_demod_filter]
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    _, ys = scan(bound, params, tree_to_torch(bound.init_state(), dev), xs)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    print(f"main path launches over {T} chunks: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the "
                                 f"main path")
    assert ys.shape == (T, BATCH, bound.out_sig.chunk_len), ys.shape
    if not bool(torch.isfinite(ys.real).all()):
        raise AssertionError("non-finite output")
    v = bound.valid_from
    audio_rate = bound.out_sig.sample_rate
    ys_host = ys.cpu().numpy()
    for s in (0, 1, BATCH - 1):
        audio = ys_host[v:, s, :].real.reshape(-1)
        spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
        peak = np.fft.rfftfreq(len(audio), 1 / audio_rate)[np.argmax(spec)]
        print(f"stream {s}: tone {tones[s]:.1f} Hz, audio peak {peak:.1f} Hz")
        if abs(peak - tones[s]) > TONE_HZ:
            raise AssertionError(f"stream {s}: peak {peak} Hz, tone "
                                 f"{tones[s]} Hz")

    # Chunks before valid_from are the overlap-save warmup: the channel
    # filter's output ramps up from a zero history, and the FM phase of
    # its near-zero first samples is chaotic in the last bits.  Compare
    # the 4 chunks from valid_from on, as the JAX package's tests do.
    small = wfm_receiver(**CHAIN).bind(StreamSig(2, CHUNK, RATE))
    _, ys_cpu = scan(small, tree_to_torch(small.params, "cpu"),
                     tree_to_torch(small.init_state(), "cpu"),
                     torch.from_numpy(xs_host[:v + 4, :2]))
    diff = float(np.abs(ys_host[v:v + 4, :2] - ys_cpu.numpy()[v:]).max())
    print(f"streams 0-1, chunks {v}-{v + 3} vs CPU tensors: "
          f"max|diff|={diff:.3e} (atol {CPU_ATOL:g})")
    if not diff <= CPU_ATOL:
        raise AssertionError("main path disagrees with the CPU run")

    # -- timing -------------------------------------------------------------
    state0 = tree_to_torch(bound.init_state(), dev)
    chain_ms = cuda_ms(lambda: scan(bound, params, state0, xs), reps=5)
    step_us = chain_ms * 1e3 / T
    msps = BATCH * CHUNK * T / (chain_ms * 1e-3) / 1e6
    print(f"whole chain: {step_us:.1f} us per chunk step "
          f"(batch {BATCH} x {CHUNK}), {msps:.1f} Msamples/s input {tag}")
    for k in kernels:
        print(f"  {k['name']}: kernel {k['ms'] * 1e3:.1f} us, plain "
              f"{k['plain_ms'] * 1e3:.1f} us per call {tag}")

    if "--profile" in sys.argv[1:]:
        profile_chain(lambda: scan(bound, params, state0, xs), T, tag)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
