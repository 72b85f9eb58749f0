"""Checkpoint-based worker recycling on the card: the drill.

The JAX package's ``tools/recycle_onchip.py`` on the port.  It serves an
FM stream (``FreqShifter`` -> ``Filter`` -> ``FmDemod``, 8 chunks of
2048 at 256 kHz) across two worker generations of
``runtime/recycle.py::serve_recycling`` and holds the stitched output
against one generation serving the same chunks.  Then the retention
drill (``RECYCLE_RETENTION=1``, the default): ``Chain(GainControl(1.0))``
on ``2 x RECYCLE_RET_BUDGET`` chunks of ``RECYCLE_RET_CHUNK`` samples
(default 400 of 24576), two generations against one process serving
all of them, bit for bit, with each one's peak RSS.

Prints one JSON line: the JAX tool's fields, each generation's wall
seconds (spawn to report), device and kernel launches as it reported
them, the platform and the card's name and power
limit as ``nvidia-smi`` prints them; exits non-zero unless ``ok``.  It
writes no file beside its checkpoints, which live in a temporary
directory.

    python -m radiorust_tpu_torch.tools.recycle_onchip [--device cuda]

Without a card it raises unless ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from ..blocks.base import Chain
from ..blocks.filters import Filter
from ..blocks.modulation import FmDemod
from ..blocks.transform import FreqShifter, GainControl
from ..runtime import serve_recycling
from ._common import card, env_int, parse_args

RATE = 256000.0
CHUNK = 2048
N_CHUNKS = 8
BUDGET = 4  # chunks per worker generation -> 2 generations


def spec():
    # A small chain WITH a filter: the checkpoint must carry real
    # overlap-save history across the generation boundary, and the cold
    # generation must emit exactly one Warmup (valid_from > 0) while
    # resumed generations emit none.
    return Chain(
        FreqShifter.with_shift(5000.0),
        Filter.new(lambda bins, f: np.where(np.abs(f) <= 50e3, 1.0, 0.0)),
        FmDemod(75000.0),
    )


def make_chunks():
    t = np.arange(N_CHUNKS * CHUNK) / RATE
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 75000.0 / RATE * np.cumsum(audio))
                - 1j * 2 * np.pi * 5000.0 * t).astype(np.complex64)
    return list(iq.reshape(N_CHUNKS, CHUNK))


def gain_spec():
    # Compute-trivial chain for the retention drill: the input stream
    # dominates, which is what a process's retention would track.
    return Chain(GainControl(1.0))


def _walls(stats):
    return [s["wall_s"] for s in stats]


def retention_drill(device, tmp, chunk: int, budget: int) -> dict:
    """2 generations x ``budget`` chunks vs one process serving all of
    them: bit for bit, and each one's peak RSS."""
    n = 2 * budget
    rng = np.random.default_rng(0)
    big = [(rng.standard_normal(chunk).astype(np.float32)
            + 1j * rng.standard_normal(chunk).astype(np.float32)
            ).astype(np.complex64) for _ in range(n)]
    st_rec, st_one = [], []
    outs_r, gens_r, _ = serve_recycling(
        gain_spec, big, RATE, chunks_per_worker=budget,
        ckpt_path=os.path.join(tmp, "ret.npz"), device=device,
        timeout=600.0, stats=st_rec)
    outs_1, gens_1, _ = serve_recycling(
        gain_spec, big, RATE, chunks_per_worker=n + 1,
        ckpt_path=os.path.join(tmp, "ret1.npz"), device=device,
        timeout=600.0, stats=st_one)
    if (gens_r, gens_1) != (2, 1):
        raise RuntimeError(f"retention drill: {gens_r} and {gens_1} "
                           f"generations, not 2 and 1")
    np.testing.assert_array_equal(np.concatenate(outs_r),
                                  np.concatenate(outs_1))
    return {
        "chunks": n, "chunk_len": chunk,
        "upload_mb_per_generation": round(chunk * 8 * budget / 1e6, 1),
        "gen_maxrss_mb": [s["maxrss_mb"] for s in st_rec],
        "single_maxrss_mb": st_one[0]["maxrss_mb"],
        "single_minus_worst_gen_mb": round(
            st_one[0]["maxrss_mb"] - max(s["maxrss_mb"] for s in st_rec),
            1),
        "gen_wall_s": _walls(st_rec), "single_wall_s": _walls(st_one)[0],
    }


def main(argv=None) -> dict:
    args = parse_args(__doc__, argv, names=False)
    device = str(args.device)
    chunks = make_chunks()
    st_rec = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs, gens, warmups = serve_recycling(
            spec, chunks, RATE, chunks_per_worker=BUDGET,
            ckpt_path=os.path.join(tmp, "gen.npz"), device=device,
            timeout=600.0, stats=st_rec)
        t_rec = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref, gens_ref, _ = serve_recycling(
            spec, chunks, RATE, chunks_per_worker=N_CHUNKS + 1,
            ckpt_path=os.path.join(tmp, "ref.npz"), device=device,
            timeout=600.0)
        t_ref = time.perf_counter() - t0
        got = np.concatenate(outs)
        want = np.concatenate(ref)
        err = (float(np.max(np.abs(got - want))) if len(got)
               else float("nan"))
        result = {
            "generations": gens,
            "warmups_per_gen": warmups,
            "chunks": N_CHUNKS,
            "chunks_per_worker": BUDGET,
            "samples_out": int(got.size),
            "max_abs_err_vs_single_gen": err,
            "bitwise_equal": bool(np.array_equal(got, want)),
            "recycled_wall_s": t_rec,
            "single_gen_wall_s": t_ref,
            "gen_wall_s": _walls(st_rec),
            "gen_devices": [s["device"] for s in st_rec],
            "gen_launches": [s["launches"] for s in st_rec],
            "platform": "gpu" if args.device.type == "cuda" else "cpu",
            "card": card() if args.device.type == "cuda" else "cpu",
            "ok": bool(gens == 2 and gens_ref == 1
                       and warmups == [1, 0] and err < 1e-5),
        }
        if os.environ.get("RECYCLE_RETENTION", "1") == "1":
            result["retention"] = retention_drill(
                device, tmp, env_int("RECYCLE_RET_CHUNK", 24576),
                env_int("RECYCLE_RET_BUDGET", 400))
    print(json.dumps(result), flush=True)
    if not result["ok"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
