"""Model-level validation of the port on a card: each of the 15 models of
the JAX package's ``tools/validate_tpu.py`` runs graphed (``make_scan``,
one CUDA graph of its chunk loop) on CUDA tensors, where every kernel
wrapper launches its kernel, and again on CPU tensors, where every
wrapper runs its plain PyTorch version, on the same inputs; the two must
agree within the model's tolerance (``TOL``, copied from the reference).

The method is the reference's: T = 4 chunks; per chunk the output energy
and a fingerprint ``sum(y * w)`` with fixed +-1 weights ``w``, normalised
by sqrt(E * N) (a +-1-weighted sum is a random walk of that size, so
tones that cancel over whole periods cannot blow the relative error up);
chunk 0 is warm-up (zero-primed filter tails, chaotic through atan2) and
is left out.  Inputs, weights and noise are made once on the host with
numpy from ``--seed`` and copied to both devices, so both sides see the
same samples.  TF32 is off.

    python -m radiorust_tpu_torch.validate [models ...] [--device cuda]
        [--seed 0]

Prints one line per model and a ``{"validate": {model: steady_rel}}``
JSON line; exits non-zero when a model is past its tolerance.  Without a
card it raises unless ``--device cpu``, which compares the CPU with
itself (for tests).  The builders take a ``lib`` that imports a module of
a package by its name in the package (``"models.wfm"``): the port by
default, so that another package with the same module names can be bound
to the same models.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .blocks.base import make_scan
from .convert import tree_to_torch
from .runtime.blocks import resolve_device

T = 4

# Per-model steady-state tolerance (tools/validate_tpu.py): noise-driven FM
# demod is chaotic (ulps amplify through atan2), tone-driven chains are
# smooth; FmMod's carried phase accumulates summation-order ulps over
# chunks (morse_rf, wfm_tx); stereo and bw_meter were sized for the TPU's
# bf16 3-pass matmul mode.
TOL = {"wfm": 2e-2, "wfm_fused": 2e-2, "wfm_wide": 2e-2, "stereo": 6e-3,
       "stereo_wide": 6e-3,
       "channelizer": 1e-2, "channelizer_fused": 1e-2,
       "am": 1e-3, "ssb": 1e-3, "morse": 1e-3,
       "morse_rf": 1e-2, "bw_meter": 9e-3, "audiopipe": 1e-3,
       "wfm_tx": 1e-2, "isb": 1e-3}
MODELS = tuple(TOL)


def port_lib(name: str):
    """A module of this package by its name in the package."""
    return importlib.import_module(f"{__package__}.{name}")


@dataclass
class Case:
    """A bound model and its inputs: ``xs`` [T, batch, n] complex64 on the
    host; ``post(ys, bound)`` maps the stacked outputs to more leaves to
    fingerprint (the bandwidth meter's hertz)."""
    bound: Any
    xs: np.ndarray
    graph: bool
    post: Optional[Callable] = None


def _chunks(x: np.ndarray, batch: int) -> np.ndarray:
    """[batch, T * n] -> [T, batch, n] complex64."""
    return np.ascontiguousarray(
        x.astype(np.complex64).reshape(batch, T, -1).swapaxes(0, 1))


def _phases(batch: int, end: float) -> np.ndarray:
    return np.exp(1j * np.linspace(0.0, end, batch))[:, None]


def noise(batch: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((T, batch, n), dtype=np.float32)
    b = rng.standard_normal((T, batch, n), dtype=np.float32)
    return (a + 1j * b).astype(np.complex64)


def keyed_envelope(batch: int, n: int, period: int = 1536) -> np.ndarray:
    key = ((np.arange(T * n) // period) % 2).astype(np.float64)
    amp = np.linspace(0.6, 1.0, batch)[:, None]
    return _chunks(amp * key[None, :], batch)


def _fm_sum(t, comps, dev):
    """Closed-form phase of FM by a sum of sinusoids (no cumsum)."""
    theta = np.zeros_like(t)
    for amp, f in comps:
        theta += amp * dev / f * (1.0 - np.cos(2 * np.pi * f * t))
    return theta


def _carriers(n: int, rate: float, k_audio_amp, cycle: int, dev: float,
              batch: int, end: float) -> np.ndarray:
    """FM tones on carriers k / cycle cycles a sample (exact integer
    phase), each with its own audio tone."""
    idx = np.arange(T * n)
    t = idx / rate
    x = np.zeros(T * n, np.complex128)
    for k, audio, amp in k_audio_amp:
        carrier = ((idx * k) % cycle) / cycle
        th = 2 * np.pi * carrier + _fm_sum(t, ((0.3, audio),), dev)
        x += amp * np.exp(1j * th)
    return _chunks(x[None, :] * _phases(batch, end), batch)


def build(model: str, seed: int = 0, lib: Callable = port_lib) -> Case:
    """The model's binding (the reference's builder, signature and batch)
    and its inputs."""
    sig = lib("blocks.base").StreamSig
    if model in ("wfm", "wfm_fused", "wfm_wide"):
        wfm = lib("models.wfm")
        if model == "wfm_wide":
            # Chunk 24576 with the filter IRs held at 6144 taps.
            batch, n = 8, 24576
            spec = wfm.wfm_receiver(fuse_frontend=True, fuse_demod=True,
                                    filter_ir_len=6144)
        else:
            f = model.endswith("fused")
            batch, n = 8, wfm.WFM_INPUT_CHUNK
            spec = wfm.wfm_receiver(fuse_frontend=f, fuse_demod=f)
        return Case(spec.bind(sig(batch, n, wfm.WFM_INPUT_RATE)),
                    noise(batch, n, seed), False)
    if model in ("stereo", "stereo_wide"):
        wfm, stereo = lib("models.wfm"), lib("models.stereo")
        wide = model.endswith("wide")
        batch, n = 4, (24576 if wide else wfm.WFM_INPUT_CHUNK)
        rate = wfm.WFM_INPUT_RATE
        bound = stereo.wfm_stereo_receiver(
            filter_ir_len=6144 if wide else None).bind(
            {"iq": sig(batch, n, rate)})
        # Stereo MPX (mono + 19 kHz pilot + 38 kHz DSB-SC); the pilot must
        # be there, or the decoder normalises a near-zero vector.
        t = np.arange(T * n) / rate
        theta = _fm_sum(t, ((0.45, 1000.0), (0.1, 19000.0),
                            (0.225, 39200.0), (-0.225, 36800.0)), 150000.0)
        x = np.exp(1j * theta)[None, :] * _phases(batch, 1.0)
        return Case(bound, _chunks(x, batch), True)
    if model in ("channelizer", "channelizer_fused"):
        ch = lib("models.channelizer")
        batch, n, rate = 2, 65536, 16384000.0
        bound = ch.channelized_receiver(fuse=model.endswith("fused")).bind(
            sig(batch, n, rate))
        # An FM tone in EVERY channel: an empty channel's demod is atan2
        # of leakage noise, chaotic in ulps.
        tones = [(k, 300.0 + 23.0 * k, 1.0) for k in range(64)]
        return Case(bound, _carriers(n, rate, tones, 64, 0.25 * rate / 64.0,
                                     batch, 0.5), False)
    if model in ("morse", "morse_rf"):
        tx = lib("models.morse_tx")
        batch, n = 4, 4096
        if model == "morse":
            bound = tx.morse_audio_chain().bind(sig(batch, n, 48000.0))
        else:
            bound = tx.morse_rf_chain().bind(sig(batch, n, 128000.0))
        return Case(bound, keyed_envelope(batch, n), False)
    if model == "bw_meter":
        bwm = lib("models.bandwidth_meter")
        batch, n, rate = 4, 10240, 1024000.0
        bound = bwm.bandwidth_meter_chain().bind(sig(batch, n, rate))
        # A populated band: tones at +5 and -4 kHz inside +-25 kHz.
        xs = _carriers(n, rate, ((5, 150.0, 1.0), (1024 - 4, 230.0, 0.7)),
                       1024, 1000.0, batch, 0.5)

        def post(ys, bound):
            return [bwm.measure_bandwidth(ys, bound.out_sig.sample_rate)]

        return Case(bound, xs, False, post)
    if model == "audiopipe":
        # Shift -> low-pass Filter -> 2x Downsampler at 2.4 Msps.
        base = lib("blocks.base")
        filters, resampling = lib("blocks.filters"), lib("blocks.resampling")
        transform = lib("blocks.transform")

        def lp(bins, freqs):
            return np.where(np.abs(freqs) <= 500000.0, 1.0 + 0.0j, 0.0j)

        chain = base.Chain(transform.FreqShifter.with_shift(-100000.0),
                           filters.Filter.new(lp),
                           resampling.Downsampler(1200000.0, 1000000.0))
        batch, n = 4, 16384
        return Case(chain.bind(sig(batch, n, 2400000.0)),
                    noise(batch, n, seed), False)
    if model == "wfm_tx":
        wfm = lib("models.wfm")
        batch, n = 4, 768
        bound = wfm.wfm_transmitter().bind(sig(batch, n, 48000.0))
        # Two tones at exact integer phases: 1 kHz and 3 kHz at 48 kHz.
        idx = np.arange(T * n)
        a = (0.4 * np.sin(2 * np.pi * (idx % 48) / 48.0)
             + 0.2 * np.sin(2 * np.pi * (idx % 16) / 16.0))
        amp = np.linspace(0.6, 1.0, batch)[:, None]
        return Case(bound, _chunks(amp * a[None, :], batch), False)
    if model in ("am", "ssb", "isb"):
        analog = lib("models.analog")
        batch, n = 4, analog.ANALOG_INPUT_CHUNK
        rate = analog.ANALOG_INPUT_RATE
        t = np.arange(T * n) / rate
        if model == "am":
            bound = analog.am_receiver().bind(sig(batch, n, rate))
            base_ = 1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)
        elif model == "ssb":  # USB: the audio tone up in the sideband
            bound = analog.ssb_receiver().bind(sig(batch, n, rate))
            base_ = np.exp(2j * np.pi * 1500.0 * t)
        else:  # a program on each sideband of a carrier at DC
            bound = analog.isb_receiver().bind({"iq": sig(batch, n, rate)})
            base_ = (0.5 * np.exp(2j * np.pi * 1000.0 * t)
                     + 0.5 * np.exp(-2j * np.pi * 2000.0 * t))
        amp = np.linspace(0.5, 1.0, batch)[:, None]
        return Case(bound, _chunks(base_[None, :] * amp, batch),
                    model == "isb")
    raise ValueError(f"unknown model {model!r}; models: {', '.join(MODELS)}")


def output_leaves(ys, bound, post=None) -> list:
    """The stacked outputs ([T, ...] each; a graph's by output name in
    sorted order), then ``post``'s, as host numpy."""
    leaves = [ys[k] for k in sorted(ys)] if isinstance(ys, dict) else [ys]
    if post is not None:
        leaves += list(post(ys, bound))
    return [np.asarray(l.cpu() if torch.is_tensor(l) else l)
            for l in leaves]


def fingerprint(leaves, seed: int = 0) -> np.ndarray:
    """[4, T]: per chunk the energy, the +-1-weighted sum's real and
    imaginary parts, and the sample count, in float64."""
    out = np.zeros((4, leaves[0].shape[0]))
    for i, leaf in enumerate(leaves):
        leaf = leaf.astype(np.complex128)
        w = np.random.default_rng(seed + 100 + i).choice(
            (-1.0, 1.0), size=leaf.shape[1:])
        axes = tuple(range(1, leaf.ndim))
        out[0] += (np.abs(leaf) ** 2).sum(axis=axes)
        f = (leaf * w).sum(axis=axes)
        out[1] += f.real
        out[2] += f.imag
        out[3] += w.size
    return out


def steady_rel(ref: np.ndarray, got: np.ndarray) -> float:
    """The largest relative difference over chunks 1.. : energy against
    itself, the fingerprints against sqrt(E * N)."""
    e_r, fr_r, fi_r, n_r = ref
    e_g, fr_g, fi_g, _ = got
    scale = np.sqrt(np.maximum(e_r * n_r, 1e-12))
    rel = np.stack([np.abs(e_r - e_g) / np.maximum(e_r, 1e-9),
                    np.abs(fr_r - fr_g) / scale,
                    np.abs(fi_r - fi_g) / scale])
    return float(rel[:, 1:].max())


def run(model: str, device, seed: int = 0) -> np.ndarray:
    """The model's fingerprint, run through ``make_scan`` on ``device``."""
    case = build(model, seed)
    bound = case.bound
    xs = torch.from_numpy(case.xs).to(device)
    _, ys = make_scan(bound)(tree_to_torch(bound.params, device),
                             tree_to_torch(bound.init_state(), device),
                             {"iq": xs} if case.graph else xs)
    return fingerprint(output_leaves(ys, bound, case.post), seed)


def validate(models=MODELS, device="cuda", seed: int = 0) -> dict:
    """Each model on ``device`` against CPU tensors: {model: steady_rel};
    prints a line per model."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for model in models:
        rel = steady_rel(run(model, torch.device("cpu"), seed),
                         run(model, device, seed))
        results[model] = rel
        good = not past_tolerance({model: rel})
        print(f"{model}: max steady rel {rel:.3e} "
              f"({'OK' if good else 'FAIL'} @ {TOL[model]:g})", flush=True)
    return results


def past_tolerance(results: dict) -> list:
    """The models of ``results`` ({model: steady_rel}) not within their
    ``TOL`` (NaN included)."""
    return [m for m, r in results.items() if not r < TOL[m]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("models", nargs="*",
                   help=f"models to validate (default: all): "
                        f"{', '.join(MODELS)}")
    p.add_argument("--device", default="cuda",
                   help="device held against the CPU (default cuda)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    results = validate(args.models or MODELS, args.device, args.seed)
    print(json.dumps({"validate": results}))
    bad = past_tolerance(results)
    if bad:
        print(f"past tolerance: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
