"""The traced window: ``torch.profiler`` around it, its Chrome trace
written under ``TMPDIR`` and read back, every device operation in the
window classified as one of the port's kernels (the frozen name lists
``benchmark/counts/port_kernels*.txt``), a copy, or glue (every other
kernel: PyTorch's elementwise kernels, cuFFT, reductions)."""

from __future__ import annotations

import bisect
import json
import re
import shutil
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cuda_runtime", "cpu_op")
COUNTS = Path(__file__).resolve().parents[1] / "counts"


def port_kernel_names() -> list:
    names = []
    for f in sorted(COUNTS.glob("port_kernels*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                names.append(line)
    return names


def port_regex(names=None):
    names = port_kernel_names() if names is None else names
    alt = "|".join(re.escape(n) for n in names)
    return re.compile(rf"(?<![A-Za-z0-9_])(?:{alt})(?![A-Za-z0-9_])")


@dataclass
class Op:
    name: str
    cat: str
    ts: float    # us
    dur: float   # us


@dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)
    port_s: float = 0.0
    glue_s: float = 0.0
    h2d_s: float = 0.0
    gaps: list = field(default_factory=list)    # [(label, seconds)]

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def device_ops(self, top: int = 10) -> list:
        tot = defaultdict(float)
        for op in self.ops:
            tot[op.name[:160]] += op.dur * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        tot = defaultdict(float)
        for label, s in self.gaps:
            tot[label] += s
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def matched_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(op.dur for op in self.ops
                   if op.cat == "kernel" and rx.search(op.name)) * 1e-6


class Profiled:
    """``with Profiled(device) as p: ...``; ``p.summary`` afterwards."""

    def __init__(self, device):
        self.cuda = str(device).startswith("cuda")
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._rf = record_function(WINDOW)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            tmp = Path(tempfile.mkdtemp(prefix="bench-trace-"))
            try:
                path = tmp / "trace.json"
                self._prof.export_chrome_trace(str(path))
                self.summary = summarize(json.loads(path.read_text()))
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        return False


def summarize(trace: dict, rx=None) -> Summary:
    rx = port_regex() if rx is None else rx
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace has no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = sorted((Op(e["name"], e["cat"], float(e["ts"]), float(e["dur"]))
                  for e in events if e.get("cat") in DEVICE_CATS
                  and w0 <= float(e["ts"]) < w1), key=lambda o: o.ts)
    s = Summary(window_s=(w1 - w0) * 1e-6, busy_s=0.0, ops=ops)
    for op in ops:
        if op.cat == "kernel" and rx.search(op.name):
            s.port_s += op.dur * 1e-6
        else:
            s.glue_s += op.dur * 1e-6
        if op.cat == "gpu_memcpy" and op.name.startswith("Memcpy HtoD"):
            s.h2d_s += op.dur * 1e-6
    # The union of the device's busy intervals, and the gaps between.
    gaps, cur0, cur1 = [], None, None
    for op in ops:
        a, b = op.ts, min(op.ts + op.dur, w1)
        if cur1 is None or a > cur1:
            if cur1 is not None:
                s.busy_s += (cur1 - cur0) * 1e-6
                gaps.append((cur1, a))
            else:
                gaps.append((w0, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        s.busy_s += (cur1 - cur0) * 1e-6
        gaps.append((cur1, w1))
    else:
        gaps.append((w0, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("name") != WINDOW),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = "host: none"
        # The latest-starting host event that covers the gap's middle: the
        # innermost of nested spans and calls.
        last = bisect.bisect_right(starts, mid)
        for j in range(last - 1, max(-1, last - 65), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        s.gaps.append((label[:120], (b - a) * 1e-6))
    return s
