"""Host time of every graph capture of the run, warm-up included
(``rr.entry.capture``'s self time: the kernel library's load,
``rr.ops.load``, left out), in s."""

from benchmark.harness import spans


def read(ctx):
    s = spans.span("rr.entry.capture")
    return None if s is None else s["self_ns"] / 1e9
