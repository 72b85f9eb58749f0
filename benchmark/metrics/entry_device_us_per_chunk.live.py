"""The entry's device time a call: the program's CUDA events from before
its first copy in to after its last clone (``rr.entry.device``), the
mean over the traced window's calls, in us."""

from benchmark.harness import spans


def read(ctx):
    s = spans.span("rr.entry.device")
    return None if s is None else s["total_ns"] / s["count"] / 1e3
