#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. Prints the card (name, power limit), the torch and CUDA versions, and
   turns TF32 off.
2. Builds the port's CUDA kernels from ``radiorust_tpu_torch/csrc`` (at
   first use, one nvcc per source) and holds each of the seven kernels
   against its plain PyTorch version on the same CUDA tensors at the
   shapes of the path that runs it (and #1 at the ``fuse_deemphasis``
   plan too).
3. Drives four paths, 16 chunks each, with every launch counter set to 0
   just before and read just after, and checks that each kernel of the
   path was launched, that the output is finite and right, and that the
   first streams equal the same path run on CPU tensors:

   A. ``wfm_receiver(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
      filter_ir_len=6144)`` at ``StreamSig(64, 24576, 1.024e6)``: FM
      tones; audio peaks within 30 Hz of each tone;
   B. the same with ``fuse_mid=True`` in place of ``fuse_demod``;
   C. ``wfm_stereo_receiver(tune_shift=100e3, fuse_frontend=True,
      filter_ir_len=6144)`` at ``{"iq": StreamSig(64, 24576, 1.024e6)}``
      through ``Graph.bind`` and ``graph_scan``: FM stereo composites; L
      and R apart by more than 30 dB, their level ratio within 10% of
      design, the pilot's median magnitude above 0.05;
   D. ``channelized_receiver(fuse=True)`` at ``StreamSig(4, 65536,
      16.384e6)``: FM tones in four channels; each peaks at its tone.
4. Times each path and each kernel beside its plain version with CUDA
   events; ``--profile`` adds each path's device time by kernel
   (torch.profiler).

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
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
BATCH, CHUNK, RATE, T = 64, 24576, 1024000.0, 16
CHAIN = dict(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
             filter_ir_len=6144)
MID = dict(CHAIN, fuse_demod=False, fuse_mid=True)
STEREO = dict(tune_shift=100e3, fuse_frontend=True, filter_ir_len=6144)
CH_BATCH, CH_CHUNK, CH_RATE = 4, 65536, 16384000.0
CH_TONES = {1: 1000.0, 5: 2500.0, 20: 4000.0, 41: 7000.0}  # channel: Hz
FIR_BOUND = 1e-5      # kernel vs plain, max |diff| / max |ref|
FILTER_BOUND = 2.4e-5
CPU_ATOL = 3e-4       # a path vs the same path on CPU tensors
CH_CPU_ATOL = 2e-5    # the channelizer's, on occupied channels
TONE_HZ = 30.0        # audio peak within this many Hz of its tone
SEPARATION_DB = 30.0  # stereo: each ear over the other's tone
LEVEL_REL = 0.10      # stereo: L/R level ratio vs design
PILOT_MIN = 0.05      # stereo: median pilot magnitude
F_L, F_R, A_L, A_R = 1000.0, 2500.0, 0.25, 0.15


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


def stereo_fm(t_chunks, streams, n, offset, deviation=150000.0):
    """[T, streams, n] complex64: FM of a stereo composite ((L+R)/2,
    19 kHz pilot at 0.1, (L-R)/2 on 38 kHz) with L = A_L sin(F_L), R =
    A_R sin(F_R) on even streams and the levels swapped on odd ones."""
    ts = np.arange(t_chunks * n) / RATE
    rows = []
    for a_l, a_r in ((A_L, A_R), (A_R, A_L)):
        left = a_l * np.sin(2 * np.pi * F_L * ts)
        right = a_r * np.sin(2 * np.pi * F_R * ts)
        th = 2 * np.pi * 19000.0 * ts + 0.3
        mpx = (0.5 * (left + right) + 0.5 * (left - right) * np.cos(2 * th)
               + 0.1 * np.cos(th))
        phase = (2 * np.pi * deviation / RATE * np.cumsum(mpx)
                 + 2 * np.pi * offset * ts)
        rows.append(np.exp(1j * phase).astype(np.complex64).reshape(
            t_chunks, n))
    return np.stack([rows[s % 2] for s in range(streams)], axis=1)


def channel_fm(t_chunks, streams, n, deviation=16000.0):
    """[T, streams, n] complex64: an FM tone at the centre of each channel
    of CH_TONES (audio CH_TONES[c] Hz, peak deviation 16 kHz)."""
    ts = np.arange(t_chunks * n) / CH_RATE
    x = np.zeros(t_chunks * n, np.complex128)
    for c, f in CH_TONES.items():
        x += np.exp(1j * (2 * np.pi * c * CH_RATE / 64 * ts
                          + deviation / f * np.sin(2 * np.pi * f * ts)))
    x = x.astype(np.complex64).reshape(t_chunks, 1, n)
    return np.repeat(x, streams, axis=1)


def peak_hz(signal, rate):
    spec = np.abs(np.fft.rfft(signal * np.hanning(len(signal))))
    return np.fft.rfftfreq(len(signal), 1 / rate)[np.argmax(spec)]


def tone_levels(signal, rate):
    """Windowed spectrum peaks around F_L and F_R."""
    n = len(signal)
    spec = np.abs(np.fft.rfft(signal * np.hanning(n)))
    freqs = np.fft.rfftfreq(n, 1.0 / rate)
    out = []
    for f in (F_L, F_R):
        i = int(np.argmin(np.abs(freqs - f)))
        out.append(float(spec[max(i - 2, 0): i + 3].max()))
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
    from radiorust_tpu_torch.blocks.filters import deemphasis_factor
    from radiorust_tpu_torch.blocks.graph import graph_scan
    from radiorust_tpu_torch.convert import tree_to_torch
    from radiorust_tpu_torch.models.channelizer import channelized_receiver
    from radiorust_tpu_torch.models.stereo import wfm_stereo_receiver
    from radiorust_tpu_torch.models.wfm import wfm_receiver
    from radiorust_tpu_torch.ops import _build
    from radiorust_tpu_torch.ops import channelizer as och
    from radiorust_tpu_torch.ops import filter as ofl
    from radiorust_tpu_torch.ops import frontend as ofe

    t_start = time.perf_counter()
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

    def phase(label, t0):
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
        return time.perf_counter()

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    log = (_build.build_dir() / "build.log").read_text()
    for line in log.splitlines():
        if "Compiling entry function" in line or "Used " in line:
            print("ptxas:", line.split("info    :")[-1].strip())
    t0 = phase("build", t0)

    # -- kernel vs plain at each path's shapes ------------------------------
    sig = StreamSig(BATCH, CHUNK, RATE)
    bound = wfm_receiver(**CHAIN).bind(sig)
    mixdec, filt, demod, tail = bound.blocks[:4]
    bound_mid = wfm_receiver(**MID).bind(sig)
    bound_st = wfm_stereo_receiver(**STEREO).bind({"iq": sig})
    ch_sig = StreamSig(CH_BATCH, CH_CHUNK, CH_RATE)
    bound_ch = channelized_receiver(fuse=True).bind(ch_sig)
    kernels = []

    def check(name, source, replaces, bound_, kernel, plain, args,
              outputs=None, record=True):
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
        if record:
            kernels.append(dict(name=name, route="cuda", source=source,
                                replaces=replaces, max_abs_err=abs_err,
                                ms=ms, plain_ms=plain_ms))

    flat = lambda res: [t for part in res for t in
                        (part if isinstance(part, tuple) else (part,))]
    planes = lambda z: (z.real.contiguous(), z.imag.contiguous())
    grid_planes = lambda r: planes(ofl.response_grid(
        torch.from_numpy(r).to(dev)))

    n_mid = mixdec.out_sig.chunk_len
    plan = tail.plan
    check("decimate", "radiorust_tpu_torch/csrc/decimate.cu",
          "radiorust_tpu/ops/pallas_frontend.py:181", FIR_BOUND,
          ofe.decimate, ofe.decimate_plain,
          ((randn(BATCH, n_mid),), (randn(BATCH, plan.hist),),
           torch.from_numpy(plan.kernel).to(dev), plan.p, plan.q),
          outputs=flat)
    deemph = wfm_receiver(**dict(CHAIN, fuse_demod=False,
                                 fuse_deemphasis=True)).bind(sig)
    dplan = deemph.blocks[3].plan
    check(f"decimate at the fuse_deemphasis plan ({dplan.kernel.shape[1]} "
          f"taps, {dplan.p}:{dplan.q})", "", "", FIR_BOUND,
          ofe.decimate, ofe.decimate_plain,
          ((randn(BATCH, n_mid),), (randn(BATCH, dplan.hist),),
           torch.from_numpy(dplan.kernel).to(dev), dplan.p, dplan.q),
          outputs=flat, record=False)

    ta = torch.from_numpy(mixdec.params["table_a"]).to(dev)
    tb = torch.from_numpy(mixdec.params["table_b"]).to(dev)
    ph = randn(BATCH)
    check("fused_mix_decimate", "radiorust_tpu_torch/csrc/decimate.cu",
          "radiorust_tpu/ops/pallas_frontend.py:241", FIR_BOUND,
          ofe.fused_mix_decimate, ofe.fused_mix_decimate_plain,
          (randn(BATCH, CHUNK), randn(BATCH, CHUNK), *planes(ta),
           *planes(tb), torch.cos(ph), torch.sin(ph),
           randn(BATCH, mixdec.plan.hist), randn(BATCH, mixdec.plan.hist),
           torch.from_numpy(mixdec.plan.kernel).to(dev),
           mixdec.plan.p, mixdec.plan.q))

    m = filt.ir_len
    check("fused_overlap_save", "radiorust_tpu_torch/csrc/overlap_save.cu",
          "radiorust_tpu/ops/pallas_filter.py:547", FILTER_BOUND,
          ofl.fused_overlap_save, ofl.fused_overlap_save_plain,
          (randn(BATCH, m), randn(BATCH, m), randn(BATCH, n_mid),
           randn(BATCH, n_mid), *grid_planes(filt.params["response"])))

    # FM at the mid-chain rate, continuous across [history || chunk]:
    # where the filtered signal has a magnitude, its demod is not chaotic.
    fm = torch.exp(1j * torch.cumsum(0.3 * randn(BATCH, m + n_mid), dim=1))
    have = (torch.arange(BATCH, device=dev) % 3 > 0).to(torch.float32)
    last = torch.exp(1j * randn(BATCH))
    check("fused_demod_filter", "radiorust_tpu_torch/csrc/overlap_save.cu",
          "radiorust_tpu/ops/pallas_filter.py:778", FILTER_BOUND,
          ofl.fused_demod_filter, ofl.fused_demod_filter_plain,
          (*planes(fm[:, m:]), *planes(last), randn(BATCH, m),
           randn(BATCH), have, *grid_planes(demod.params["response"]),
           torch.tensor(demod.params["factor"], device=dev)))

    fdf = bound_mid.blocks[1]
    check("fused_filter_demod_filter",
          "radiorust_tpu_torch/csrc/overlap_save.cu",
          "radiorust_tpu/ops/pallas_filter.py:886", FILTER_BOUND,
          ofl.fused_filter_demod_filter, ofl.fused_filter_demod_filter_plain,
          (*planes(fm[:, :m]), *planes(fm[:, m:]), *planes(last),
           randn(BATCH, m), randn(BATCH), have,
           *grid_planes(fdf.params["response1"]),
           *grid_planes(fdf.params["response2"]),
           torch.tensor(fdf.params["factor"], device=dev)))

    bank = next(b for b in bound_st.bound
                if type(b).__name__ == "_BoundFilterBank")
    mpx_prev, mpx_cur = randn(BATCH, bank.ir_len), randn(BATCH, n_mid)
    check("fused_filter_bank", "radiorust_tpu_torch/csrc/overlap_save.cu",
          "radiorust_tpu/ops/pallas_filter.py:632", FILTER_BOUND,
          ofl.fused_filter_bank, ofl.fused_filter_bank_plain,
          (mpx_prev, torch.zeros_like(mpx_prev), mpx_cur,
           torch.zeros_like(mpx_cur),
           *grid_planes(bank.params["responses"])))

    chd = bound_ch.blocks[0]
    ch_x = torch.from_numpy(channel_fm(1, CH_BATCH, chd.hist_len + CH_CHUNK)
                            [0]).to(dev)
    occupied = sorted(CH_TONES)
    hist_lanes = och.HIST_FRAMES * 64

    def occupied_frames(d):
        return [d[:, hist_lanes:].reshape(CH_BATCH, -1, 64)[..., occupied]]

    ch_args = (*planes(ch_x), torch.tensor(chd.params["factor"], device=dev),
               torch.from_numpy(chd.params["taps"]).to(dev))
    check("fused_pfb_demod", "radiorust_tpu_torch/csrc/pfb_demod.cu",
          "radiorust_tpu/ops/pallas_channelizer.py:130", FILTER_BOUND,
          och.fused_pfb_demod, och.fused_pfb_demod_plain, ch_args,
          outputs=occupied_frames)
    if not bool(torch.isfinite(och.fused_pfb_demod(*ch_args)).all()):
        raise AssertionError("fused_pfb_demod: non-finite output")
    t0 = phase("kernel checks", t0)

    # -- the paths ------------------------------------------------------------
    wrappers = [ofe.decimate, ofe.fused_mix_decimate, ofl.fused_overlap_save,
                ofl.fused_filter_bank, ofl.fused_demod_filter,
                ofl.fused_filter_demod_filter, och.fused_pfb_demod]

    def drive(label, run, want):
        """Run a path with every launch counter at 0 just before and read
        just after; fail unless each kernel of ``want`` was launched."""
        torch.cuda.synchronize()
        for w in wrappers:
            w.launches = 0
        out = run()
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers}
        print(f"path {label} launches over {T} chunks: {launches}")
        for w in want:
            if launches[w.__name__] < 1:
                raise AssertionError(f"{w.__name__} was not launched on "
                                     f"path {label}")
        return out, launches

    def finite(label, ys):
        if not all(bool(torch.isfinite(torch.view_as_real(y)).all())
                   for y in ys):
            raise AssertionError(f"path {label}: non-finite output")

    def vs_cpu(label, got, want, atol):
        diff = float(np.abs(got - want).max())
        print(f"path {label}: streams vs CPU tensors max|diff|={diff:.3e} "
              f"(atol {atol:g})")
        if not diff <= atol:
            raise AssertionError(f"path {label} disagrees with the CPU run")

    def timed(label, run, samples_per_step):
        step_ms = cuda_ms(run, reps=3) / T
        msps = samples_per_step / (step_ms * 1e-3) / 1e6
        print(f"path {label}: {step_ms * 1e3:.1f} us per chunk step, "
              f"{msps:.1f} Msamples/s input {tag}")
        if "--profile" in sys.argv[1:]:
            profile_chain(run, T, f"path {label} {tag}")
        return step_ms

    def chain_paths(label, kw, bound_, want):
        tones = 400.0 + 190.0 * np.arange(BATCH)
        xs_host = fm_tones(tones, T, CHUNK, offset=-100e3)
        xs = torch.from_numpy(xs_host).to(dev)
        params = tree_to_torch(bound_.params, dev)
        state0 = tree_to_torch(bound_.init_state(), dev)
        (_, ys), launches = drive(
            label, lambda: scan(bound_, params, state0, xs), want)
        assert ys.shape == (T, BATCH, bound_.out_sig.chunk_len), ys.shape
        finite(label, [ys])
        v = bound_.valid_from
        ys_host = ys.cpu().numpy()
        for s in (0, 1, BATCH - 1):
            peak = peak_hz(ys_host[v:, s, :].real.reshape(-1),
                           bound_.out_sig.sample_rate)
            print(f"path {label} stream {s}: tone {tones[s]:.1f} Hz, audio "
                  f"peak {peak:.1f} Hz")
            if abs(peak - tones[s]) > TONE_HZ:
                raise AssertionError(f"path {label} stream {s}: peak {peak} "
                                     f"Hz, tone {tones[s]} Hz")
        # Chunks before valid_from are the overlap-save warm-up: the FM
        # phase of the channel filter's ramping-up output is chaotic in
        # the last bits, so compare the 4 chunks from valid_from on.
        small = wfm_receiver(**kw).bind(StreamSig(2, CHUNK, RATE))
        _, ys_cpu = scan(small, tree_to_torch(small.params, "cpu"),
                         tree_to_torch(small.init_state(), "cpu"),
                         torch.from_numpy(xs_host[:v + 4, :2]))
        vs_cpu(label, ys_host[v:v + 4, :2], ys_cpu.numpy()[v:], CPU_ATOL)
        timed(label, lambda: scan(bound_, params, state0, xs), BATCH * CHUNK)
        return launches

    launches_a = chain_paths("A", CHAIN, bound,
                             [ofe.fused_mix_decimate, ofl.fused_overlap_save,
                              ofl.fused_demod_filter, ofe.decimate])
    t0 = phase("path A", t0)
    launches_b = chain_paths("B", MID, bound_mid,
                             [ofe.fused_mix_decimate,
                              ofl.fused_filter_demod_filter, ofe.decimate])
    t0 = phase("path B", t0)

    # Path C: the stereo receiver graph.
    xs_host = stereo_fm(T, BATCH, CHUNK, offset=-100e3)
    xs = {"iq": torch.from_numpy(xs_host).to(dev)}
    params = tree_to_torch(bound_st.params, dev)
    state0 = tree_to_torch(bound_st.init_state(), dev)
    (_, ys), launches_c = drive(
        "C", lambda: graph_scan(bound_st, params, state0, xs),
        [ofe.fused_mix_decimate, ofl.fused_overlap_save,
         ofl.fused_filter_bank, ofe.decimate])
    finite("C", ys.values())
    v = bound_st.valid_from["stereo"]
    stereo = ys["stereo"].cpu().numpy()
    assert stereo.shape == (T, BATCH, bound_st.out_sigs["stereo"].chunk_len)
    for s in (0, 1):
        audio = stereo[v:, s, :].reshape(-1)
        l_at_fl, l_at_fr = tone_levels(audio.real, 48000.0)
        r_at_fl, r_at_fr = tone_levels(audio.imag, 48000.0)
        sep_l = 20 * np.log10(l_at_fl / (l_at_fr + 1e-9))
        sep_r = 20 * np.log10(r_at_fr / (r_at_fl + 1e-9))
        a_l, a_r = (A_L, A_R) if s % 2 == 0 else (A_R, A_L)
        want = (a_l * abs(deemphasis_factor(50e-6, F_L))
                / (a_r * abs(deemphasis_factor(50e-6, F_R))))
        ratio = l_at_fl / r_at_fr
        print(f"path C stream {s}: separation L {sep_l:.1f} dB, R "
              f"{sep_r:.1f} dB; L/R level {ratio:.4f} (design {want:.4f})")
        if not (sep_l > SEPARATION_DB and sep_r > SEPARATION_DB
                and abs(ratio / want - 1) < LEVEL_REL):
            raise AssertionError(f"path C stream {s}: stereo decode wrong")
    vp = bound_st.valid_from["pilot"]
    pilot = float(ys["pilot"][vp:].abs().median())
    print(f"path C: pilot median magnitude {pilot:.4f} (above {PILOT_MIN})")
    if not pilot > PILOT_MIN:
        raise AssertionError("path C: pilot too weak")
    small = wfm_stereo_receiver(**STEREO).bind(
        {"iq": StreamSig(2, CHUNK, RATE)})
    _, ys_cpu = graph_scan(small, tree_to_torch(small.params, "cpu"),
                           tree_to_torch(small.init_state(), "cpu"),
                           {"iq": torch.from_numpy(xs_host[:v + 4, :2])})
    for k, vk in bound_st.valid_from.items():
        vs_cpu(f"C {k}", ys[k][vk:v + 4, :2].cpu().numpy(),
               ys_cpu[k][vk:].numpy(), CPU_ATOL)
    timed("C", lambda: graph_scan(bound_st, params, state0, xs),
          BATCH * CHUNK)
    t0 = phase("path C", t0)

    # Path D: the channelizer.
    xs_host = channel_fm(T, CH_BATCH, CH_CHUNK)
    xs = torch.from_numpy(xs_host).to(dev)
    params = tree_to_torch(bound_ch.params, dev)
    state0 = tree_to_torch(bound_ch.init_state(), dev)
    (_, ys), launches_d = drive(
        "D", lambda: scan(bound_ch, params, state0, xs),
        [och.fused_pfb_demod])
    finite("D", [ys])
    out = ys.cpu().numpy().real          # [T, CH_BATCH * 64, chunk / 64]
    assert out.shape == (T, CH_BATCH * 64, CH_CHUNK // 64), out.shape
    ch_rate = bound_ch.out_sig.sample_rate
    for c, f in CH_TONES.items():
        for s in (0, CH_BATCH - 1):
            peak = peak_hz(out[1:, s * 64 + c].reshape(-1), ch_rate)
            print(f"path D stream {s} channel {c}: tone {f:.1f} Hz, peak "
                  f"{peak:.1f} Hz")
            if abs(peak - f) > TONE_HZ:
                raise AssertionError(f"path D channel {c}: peak {peak} Hz")
    small = channelized_receiver(fuse=True).bind(
        StreamSig(2, CH_CHUNK, CH_RATE))
    _, ys_cpu = scan(small, tree_to_torch(small.params, "cpu"),
                     tree_to_torch(small.init_state(), "cpu"),
                     torch.from_numpy(xs_host[:4, :2]))
    rows = [s * 64 + c for s in range(2) for c in occupied]
    vs_cpu("D", out[:4, rows], ys_cpu.numpy().real[:, rows], CH_CPU_ATOL)
    timed("D", lambda: scan(bound_ch, params, state0, xs),
          CH_BATCH * CH_CHUNK)
    t0 = phase("path D", t0)

    # Each kernel's launches are those of the path it was checked at.
    path_of = {"decimate": launches_a, "fused_mix_decimate": launches_a,
               "fused_overlap_save": launches_a,
               "fused_demod_filter": launches_a,
               "fused_filter_demod_filter": launches_b,
               "fused_filter_bank": launches_c,
               "fused_pfb_demod": launches_d}
    for k in kernels:
        k["launches"] = path_of[k["name"]][k["name"]]
        print(f"  {k['name']}: kernel {k['ms'] * 1e3:.1f} us, plain "
              f"{k['plain_ms'] * 1e3:.1f} us per call, {k['launches']} "
              f"launches on its path {tag}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
