"""What the measurement tools share: the command line, the device label,
the input made on the device, and the timed loop of graphed steps."""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Optional

import torch

from ..blocks.base import _leaves, make_scan
from ..convert import tree_to_torch
from ..runtime.blocks import resolve_device
from ..validate import port_lib

__all__ = ["port_lib", "env_int", "parse_args", "device_label", "card",
           "seeded_input", "energy", "timed", "graphed_loop"]


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def parse_args(doc: str, argv, names: bool = True):
    """``[names ...] [--device cuda]``: the device defaults to ``cuda``
    and is resolved (without a card, ``cuda`` raises)."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if names:
        p.add_argument("names", nargs="*", help="configs (default: the "
                       "tool's default set)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    args, rest = p.parse_known_args(argv)
    args.device = resolve_device(args.device)
    args.rest = rest
    return args


def device_label(device) -> dict:
    """``{"platform": "gpu" | "cpu", "device": name}``: the card's name
    (``torch.cuda.get_device_name``) on CUDA."""
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu",
                "device": torch.cuda.get_device_name(device)}
    return {"platform": "cpu", "device": "cpu"}


def card() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (its
    first line)."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def seeded_input(t: int, batch: int, n: int, device, seed: int = 0):
    """[t, batch, n] complex64 of unit normal re and im, made on ``device``
    from a seeded ``torch.Generator``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    a = torch.randn((t, batch, n), generator=g, device=device)
    b = torch.randn((t, batch, n), generator=g, device=device)
    return torch.complex(a, b)


def energy(tree) -> torch.Tensor:
    """sum |y|^2 over every tensor of an output tree, a 0-d float64 tensor
    on its device."""
    return sum(torch.sum(torch.abs(leaf) ** 2, dtype=torch.float64)
               for leaf in _leaves(tree))


def timed(fn: Callable, device) -> tuple:
    """(``fn()``, its seconds): CUDA events around the work it queues on
    the card, the host clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop) / 1e3


def graphed_loop(bound, graph: bool, t: int, reps: int, device,
                 post: Optional[Callable] = None,
                 name: str = "config", runs: int = 3,
                 trace: Optional[str] = None) -> tuple:
    """Time ``reps`` replays of one ``make_scan`` of ``t`` chunk steps
    (one CUDA graph on the card; eager on the CPU) on seeded input made on
    the device, the state carried from replay to replay.  Each replay's
    output energy (plus ``post(ys, bound)``, a 0-d tensor) is summed on
    the device.  Returns (best seconds of ``runs`` timed runs, checksum:
    the sum over the timed runs, fetched once); raises unless the warm-up
    replay and the checksum are finite and positive.  ``trace``: a
    directory where a device trace of one more replay is written
    (``utils/profiling.py`` ``device_trace``)."""
    batch = (next(iter(bound.in_sigs.values())).batch if graph
             else bound.in_sig.batch)
    n = (next(iter(bound.in_sigs.values())).chunk_len if graph
         else bound.in_sig.chunk_len)
    params = tree_to_torch(bound.params, device)
    state0 = tree_to_torch(bound.init_state(), device)
    xs = seeded_input(t, batch, n, device)
    xs = {"iq": xs} if graph else xs
    run = make_scan(bound)

    def replays(k: int) -> torch.Tensor:
        st = state0
        acc = torch.zeros((), dtype=torch.float64, device=device)
        for _ in range(k):
            st, ys = run(params, st, xs)
            acc = acc + energy(ys)
            if post is not None:
                acc = acc + post(ys, bound).to(torch.float64)
        return acc

    warm = float(replays(1))           # captures the graph on the card
    if not (math.isfinite(warm) and warm > 0.0):
        raise RuntimeError(f"{name}: bad warm-up checksum {warm}")
    best, total = math.inf, None
    for _ in range(runs):
        acc, seconds = timed(lambda: replays(reps), device)
        best = min(best, seconds)
        total = acc if total is None else total + acc
    checksum = float(total)
    if not (math.isfinite(checksum) and checksum > 0.0):
        raise RuntimeError(f"{name}: bad checksum {checksum}")
    if trace:
        from ..utils.profiling import device_trace
        with device_trace(trace):
            float(replays(1))
    return best, checksum
